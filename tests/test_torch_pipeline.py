"""Port parity: the async input pipeline (``io/pipeline.py``) and
``Module.fit`` through it, on the CPU.

``tests/test_input_pipeline.py``'s cases over the port's pipeline:
ordered multi-worker delivery, bit-identity with the eager path, epoch
boundaries and reset, error surfacing, no leaked threads, ``data_wait``
only when the queue runs dry, and the h2d ledger. The placer's CUDA
stream and the hand-off's ``record_stream`` need the card
(``chip_smoke.py`` phase 18); here batches are placed on ``cpu()``.
A Module ``fit`` through the pipeline follows JAX's per-batch losses
(both packages with the pipeline on) within ``TOL``, ROADMAP rule 5's
fp32 tolerance.

Every test that starts a pipeline closes it in a ``finally``; every
wait here is bounded.
"""
import collections
import gc
import threading
import time

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import telemetry
from mxnet_tpu_torch.io import (AsyncInputPipeline, NDArrayIter,
                                PrefetchingIter, ResizeIter)
from mxnet_tpu_torch.io.io import DataBatch, DataDesc, DataIter

TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True)
def _port_on_cpu(monkeypatch):
    monkeypatch.setenv("MXNET_DEFAULT_CONTEXT", "cpu")
    monkeypatch.delenv("MXNET_DATA_PIPELINE", raising=False)


def _ndarray_iter(n=40, dim=3, batch=8, shuffle=False):
    x = np.arange(n * dim, dtype=np.float32).reshape(n, dim)
    y = np.arange(n, dtype=np.float32)
    return NDArrayIter(x, y, batch_size=batch, shuffle=shuffle)


def _drain(it):
    out = []
    while True:
        try:
            out.append(it.next())
        except StopIteration:
            return out


class _JitterSource(DataIter):
    """Split-protocol source whose decodes finish OUT of submission
    order; delivery must still be in order."""

    def __init__(self, n=12, batch=4):
        super().__init__(batch)
        self._n = n
        self._seq = 0
        self.provide_data = [DataDesc("data", (batch, 1))]
        self.provide_label = [DataDesc("softmax_label", (batch,))]

    def reset(self):
        self._seq = 0

    def next_raw(self):
        if self._seq >= self._n:
            raise StopIteration
        self._seq += 1
        return self._seq - 1

    def decode_raw(self, seq):
        time.sleep(0.002 * ((self._n - seq) % 3))
        data = np.full((self.batch_size, 1), seq, np.float32)
        return DataBatch([tmx.nd.array(data)], [tmx.nd.array(data[:, 0])],
                         pad=0)

    def next(self):
        return self.decode_raw(self.next_raw())


def _settle_threads(baseline, timeout=5.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if threading.active_count() <= baseline:
            break
        time.sleep(0.02)
    return threading.active_count()


def _pipe_threads():
    return [t for t in threading.enumerate()
            if t.name.startswith("mxio-")]


def test_ordered_multiworker_delivery():
    pipe = AsyncInputPipeline(_JitterSource(n=12), num_workers=4,
                              prefetch_depth=3)
    try:
        seqs = [float(b.data[0].asnumpy()[0, 0]) for b in _drain(pipe)]
    finally:
        pipe.close()
    assert seqs == [float(i) for i in range(12)]


@pytest.mark.parametrize("workers", [1, 4])
def test_bit_identical_vs_eager_and_jax(workers):
    np.random.seed(3)
    eager = [b.data[0].asnumpy() for b in _drain(_ndarray_iter(shuffle=True))]
    np.random.seed(3)
    pipe = AsyncInputPipeline(_ndarray_iter(shuffle=True),
                              num_workers=workers, prefetch_depth=2)
    np.random.seed(3)
    jpipe = jmx.io.AsyncInputPipeline(
        jmx.io.NDArrayIter(np.arange(120, dtype=np.float32).reshape(40, 3),
                           np.arange(40, dtype=np.float32), batch_size=8,
                           shuffle=True), num_workers=workers)
    try:
        pooled = [b.data[0].asnumpy() for b in _drain(pipe)]
        jax = [b.data[0].asnumpy() for b in _drain(jpipe)]
    finally:
        pipe.close()
        jpipe.close()
    assert len(eager) == len(pooled) == len(jax) == 5
    for a, b, c in zip(eager, pooled, jax):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(b, c)


def test_epoch_boundary_and_reset():
    pipe = AsyncInputPipeline(_ndarray_iter(n=40, batch=8), num_workers=2)
    try:
        assert len(_drain(pipe)) == 5
        for _ in range(3):
            with pytest.raises(StopIteration):
                pipe.next()
        pipe.reset()
        assert len(_drain(pipe)) == 5
    finally:
        pipe.close()


def test_generic_iterator_without_split_protocol():
    pipe = AsyncInputPipeline(ResizeIter(_ndarray_iter(n=40, batch=8),
                                         size=3), num_workers=4)
    try:
        assert len(_drain(pipe)) == 3
    finally:
        pipe.close()


def test_iter_next_protocol_serves_fetched_batch():
    pipe = AsyncInputPipeline(_ndarray_iter(n=16, batch=8), num_workers=2)
    seen = 0
    try:
        while pipe.iter_next():
            assert pipe.getdata() is not None
            assert pipe.getlabel() is not None
            assert pipe.getpad() == 0
            seen += 1
    finally:
        pipe.close()
    assert seen == 2


def test_numpy_leaves_pass_through_placement():
    class NumpySource(_JitterSource):
        def decode_raw(self, seq):
            data = np.full((self.batch_size, 1), seq, np.float32)
            return DataBatch([data], [tmx.nd.array(data[:, 0])], pad=0)

    pipe = AsyncInputPipeline(NumpySource(n=4), num_workers=2,
                              placement=tmx.cpu())
    try:
        batches = _drain(pipe)
    finally:
        pipe.close()
    assert len(batches) == 4
    assert isinstance(batches[0].data[0], np.ndarray)


@pytest.mark.parametrize("where", ["decode", "placement"])
def test_errors_surface_in_consumer(where):
    class Boom(_JitterSource):
        def decode_raw(self, seq):
            if seq == 2:
                raise ValueError("decode exploded")
            return super().decode_raw(seq)

    def bad_place(name, data):
        raise ValueError("placement exploded")

    pipe = AsyncInputPipeline(Boom(n=6), num_workers=2) \
        if where == "decode" else \
        AsyncInputPipeline(_JitterSource(n=6), num_workers=2,
                           placement=bad_place)
    try:
        with pytest.raises(ValueError, match="%s exploded" % where):
            _drain(pipe)
        # the error also stops the producers
        deadline = time.time() + 5
        while any(t.is_alive() for t in pipe._threads) and \
                time.time() < deadline:
            time.sleep(0.02)
        assert not any(t.is_alive() for t in pipe._threads)
    finally:
        pipe.close()


def test_namedtuple_batches_survive_placement():
    Pair = collections.namedtuple("Pair", ["data", "label"])

    class NTSource(_JitterSource):
        def decode_raw(self, seq):
            arr = tmx.nd.array(np.full((self.batch_size, 1), seq,
                                       np.float32))
            return Pair(arr, arr)

    pipe = AsyncInputPipeline(NTSource(n=3), num_workers=2,
                              placement=tmx.cpu())
    try:
        batches = _drain(pipe)
    finally:
        pipe.close()
    assert len(batches) == 3
    assert isinstance(batches[0], Pair)
    assert batches[0].data._data.device.type == "cpu"


# ---------------------------------------------------------------------------
# PrefetchingIter and thread hygiene
# ---------------------------------------------------------------------------

def test_prefetching_depth_honored_after_reset():
    pre = PrefetchingIter(_ndarray_iter(), prefetch_depth=5)
    try:
        assert pre.prefetch_depth == 5
        assert pre._pipeline._ready_q.maxsize == 5
        pre.reset()
        assert pre._pipeline._ready_q.maxsize == 5
        assert len(_drain(pre)) == 5
    finally:
        pre.close()


def test_repeated_reset_and_gc_leak_no_threads():
    baseline = threading.active_count()
    pre = PrefetchingIter(_ndarray_iter(), prefetch_depth=3)
    try:
        for _ in range(5):
            assert len(_drain(pre)) == 5
            pre.reset()
    finally:
        pre.close()
    del pre
    gc.collect()
    assert _settle_threads(baseline) <= baseline


def test_mid_epoch_reset_does_not_hang_or_leak():
    baseline = threading.active_count()
    for _ in range(3):
        pre = PrefetchingIter(_ndarray_iter(n=80, batch=4),
                              prefetch_depth=2)
        try:
            pre.next()                   # queue full, placer mid-put
            t0 = time.time()
            pre.reset()
            assert time.time() - t0 < 4.0
        finally:
            pre.close()
    gc.collect()
    assert _settle_threads(baseline) <= baseline


def test_pipeline_close_leaves_thread_count_stable():
    baseline = threading.active_count()
    pipes = [AsyncInputPipeline(_ndarray_iter(), num_workers=3)
             for _ in range(4)]
    try:
        for p in pipes:
            _drain(p)
    finally:
        for p in pipes:
            p.close()
    del pipes
    gc.collect()
    assert _settle_threads(baseline) <= baseline


# ---------------------------------------------------------------------------
# placement, the h2d ledger, data_wait
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("placement", ["cpu_context", "torch_device",
                                       "callable"])
def test_batches_arrive_on_requested_device(placement):
    import torch
    target = {"cpu_context": tmx.cpu(), "torch_device": torch.device("cpu"),
              "callable": lambda name, arr: "cpu"}[placement]
    pipe = AsyncInputPipeline(_ndarray_iter(), num_workers=2,
                              placement=target)
    try:
        batches = _drain(pipe)
    finally:
        pipe.close()
    assert len(batches) == 5
    for b in batches:
        assert b.data[0]._data.device.type == "cpu"
        assert b.label[0]._data.device.type == "cpu"


def test_h2d_ledger_and_counters_match_jax():
    import jax
    reports = {}
    for name, mx, tel, place in (
            ("j", jmx, jmx.telemetry, jax.devices("cpu")[0]),
            ("t", tmx, telemetry, tmx.cpu())):
        before = mx.profiler.counters()
        tel.reset()
        tel.start(run_id="h2d")
        it = mx.io.NDArrayIter(np.zeros((40, 3), np.float32),
                               np.zeros(40, np.float32), batch_size=8)
        pipe = mx.io.AsyncInputPipeline(it, num_workers=2, placement=place)
        try:
            _drain(pipe)
        finally:
            pipe.close()
        rep = tel.stop()
        tel.reset()
        after = mx.profiler.counters()
        reports[name] = (
            {k: (v["calls"], v["bytes"]) for k, v in rep["comms"].items()},
            after.get("h2d_calls", 0) - before.get("h2d_calls", 0),
            after.get("h2d_bytes", 0) - before.get("h2d_bytes", 0))
    assert reports["t"] == reports["j"]
    assert reports["t"][0] == {"h2d:data": (5, 480),
                               "h2d:softmax_label": (5, 160)}


def test_no_comms_without_transfers():
    telemetry.reset()
    telemetry.start(run_id="quiet")
    rep = telemetry.stop()
    telemetry.reset()
    assert "comms" not in rep


def test_data_wait_only_counts_queue_dry_stalls():
    telemetry.reset()
    telemetry.start(run_id="dry")
    pipe = AsyncInputPipeline(_ndarray_iter(n=32, batch=8), num_workers=2,
                              prefetch_depth=4)
    try:
        deadline = time.time() + 5
        while pipe._ready_q.qsize() < 4 and time.time() < deadline:
            time.sleep(0.01)          # the queue fills while we idle
        telemetry.step_begin()
        for _ in range(4):
            pipe.next()               # all ready: no data_wait span
        rec = telemetry.step_end(samples=8)
    finally:
        telemetry.stop()
        telemetry.reset()
        pipe.close()
    assert (rec.get("phases_ms") or {}).get("data_wait", 0.0) < 5.0, rec


def test_data_wait_counts_a_dry_queue():
    class Slow(_JitterSource):
        def decode_raw(self, seq):
            time.sleep(0.05)
            return super().decode_raw(seq)

    telemetry.reset()
    telemetry.start(run_id="wet")
    pipe = AsyncInputPipeline(Slow(n=2), num_workers=1, prefetch_depth=1)
    try:
        telemetry.step_begin()
        pipe.next()
        rec = telemetry.step_end(samples=4)
    finally:
        telemetry.stop()
        telemetry.reset()
        pipe.close()
    assert rec["phases_ms"]["data_wait"] > 20.0, rec


def test_image_record_pooled_decode_bit_identical(tmp_path):
    rng = np.random.RandomState(0)
    prefix = str(tmp_path / "pp")
    rec = tmx.recordio.MXIndexedRecordIO(prefix + ".idx", prefix + ".rec",
                                         "w")
    for i in range(8):
        img = rng.randint(0, 255, (36, 36, 3), dtype=np.uint8)
        rec.write_idx(i, tmx.recordio.pack_img(
            tmx.recordio.IRHeader(0, float(i % 3), i, 0), img, quality=95))
    rec.close()

    def batches(wrap):
        it = tmx.io.ImageRecordIter(
            path_imgrec=prefix + ".rec", path_imgidx=prefix + ".idx",
            data_shape=(3, 28, 28), batch_size=4, shuffle=True,
            rand_crop=True, rand_mirror=True, seed=7, preprocess_threads=2)
        src = AsyncInputPipeline(it, num_workers=3,
                                 placement=tmx.cpu()) if wrap else it
        try:
            return [(b.data[0].asnumpy(), b.label[0].asnumpy())
                    for b in _drain(src)]
        finally:
            if wrap:
                src.close()
            it.close()

    eager, pooled = batches(False), batches(True)
    assert len(eager) == len(pooled) == 2
    for (ed, el), (pd, pl) in zip(eager, pooled):
        np.testing.assert_array_equal(ed, pd)
        np.testing.assert_array_equal(el, pl)


# ---------------------------------------------------------------------------
# Module.fit through the pipeline
# ---------------------------------------------------------------------------

def _mlp(mx, hidden=8):
    data = mx.sym.var("data")
    fc = mx.sym.FullyConnected(data, num_hidden=hidden, name="fc")
    return mx.sym.SoftmaxOutput(fc, mx.sym.var("softmax_label"),
                                name="softmax")


def test_fit_through_pipeline_trains_and_cleans_up(monkeypatch):
    from mxnet_tpu_torch.io import pipeline
    made = []
    real = pipeline.AsyncInputPipeline

    class Spy(real):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)
    monkeypatch.setattr(pipeline, "AsyncInputPipeline", Spy)
    rng = np.random.RandomState(0)
    x = rng.randn(64, 10).astype(np.float32)
    y = rng.randint(0, 8, (64,)).astype(np.float32)
    it = NDArrayIter(x, y, batch_size=16)
    mod = tmx.mod.Module(_mlp(tmx), context=tmx.cpu())
    mod.fit(it, num_epoch=2, optimizer="sgd",
            optimizer_params={"learning_rate": 0.1})
    assert len(made) == 1
    assert made[0]._placement("data", None).type == "cpu"
    deadline = time.time() + 5
    while _pipe_threads() and time.time() < deadline:
        time.sleep(0.02)
    assert not _pipe_threads()
    it.reset()
    assert sum(1 for _ in it) == 4


def test_fit_matches_eager_fit_exactly(monkeypatch):
    """The same data and initial weights: the pipelined fit follows the
    unpipelined one bit for bit."""
    def run(on):
        monkeypatch.setenv("MXNET_DATA_PIPELINE", "1" if on else "0")
        rng = np.random.RandomState(3)
        x = rng.randn(48, 6).astype(np.float32)
        y = rng.randint(0, 4, (48,)).astype(np.float32)
        mod = tmx.mod.Module(_mlp(tmx, 4), context=tmx.cpu())
        np.random.seed(1)
        mod.fit(NDArrayIter(x, y, batch_size=12, shuffle=True),
                num_epoch=3, optimizer="sgd", initializer=tmx.init.One(),
                optimizer_params={"learning_rate": 0.05})
        return mod.get_params()[0]["fc_weight"].asnumpy()

    np.testing.assert_array_equal(run(True), run(False))


def _jax_init(sym, data_shape, label_shape, seed=0):
    np.random.seed(seed)
    mod = jmx.mod.Module(sym, context=jmx.cpu())
    mod.bind(data_shapes=[("data", data_shape)],
             label_shapes=[("softmax_label", label_shape)])
    mod.init_params(initializer=jmx.init.Xavier())
    args, auxs = mod.get_params()
    return ({k: v.asnumpy() for k, v in args.items()},
            {k: v.asnumpy() for k, v in auxs.items()})


def test_fit_through_pipeline_follows_jax_losses(monkeypatch):
    """Both packages fit through their pipelines (MXNET_DATA_PIPELINE=1)
    from the same initial parameters and shuffles: the per-batch loss
    agrees within TOL."""
    monkeypatch.setenv("MXNET_DATA_PIPELINE", "1")
    rng = np.random.RandomState(0)
    centers = rng.normal(0, 1.5, (6, 16))
    y = rng.randint(0, 6, 192)
    x = (centers[y] + rng.normal(0, 0.5, (192, 16))).astype(np.float32)
    y = y.astype(np.float32)
    init = _jax_init(_mlp(jmx, 6), (32, 16), (32,))
    losses = {}
    for name, mx in (("j", jmx), ("t", tmx)):
        np.random.seed(5)
        train = mx.io.NDArrayIter(x, y, batch_size=32, shuffle=True)
        mod = mx.mod.Module(_mlp(mx, 6), context=mx.cpu())
        rows = []

        def record(param, mod=mod, rows=rows):
            p = mod.get_outputs()[0].asnumpy()
            lab = param.locals["data_batch"].label[0].asnumpy().astype(int)
            rows.append(float(-np.log(p[np.arange(len(lab)), lab]
                                      + 1e-12).mean()))
        mod.fit(train, num_epoch=4, optimizer="sgd",
                optimizer_params={"learning_rate": 0.3, "momentum": 0.9},
                arg_params={k: mx.nd.array(v) for k, v in init[0].items()},
                aux_params={k: mx.nd.array(v) for k, v in init[1].items()},
                batch_end_callback=record)
        losses[name] = np.array(rows)
    assert len(losses["t"]) == len(losses["j"]) == 24
    np.testing.assert_allclose(losses["t"], losses["j"], **TOL)
    assert losses["t"][-1] < losses["t"][0]


def test_fit_adopts_placement_of_a_given_pipeline():
    rng = np.random.RandomState(1)
    x = rng.randn(32, 10).astype(np.float32)
    y = rng.randint(0, 8, (32,)).astype(np.float32)
    pre = PrefetchingIter(NDArrayIter(x, y, batch_size=16))
    try:
        mod = tmx.mod.Module(_mlp(tmx), context=tmx.cpu())
        mod.fit(pre, num_epoch=1, optimizer="sgd",
                optimizer_params={"learning_rate": 0.1})
        place = pre._pipeline._placement
        assert place is not None and place("data", None).type == "cpu"
        assert pre._pipeline._threads     # fit did not close the caller's
    finally:
        pre.close()
