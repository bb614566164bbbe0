"""Port parity: the kvstore (``mxnet_tpu_torch.kvstore``), fault's
retries, the bucketed exchange and the single-device context rule,
against ``mxnet_tpu`` on the CPU.

Every case of ``tests/test_kvstore.py`` runs through both packages on
the same numpy inputs: the JAX package over its 8 CPU devices
(``cpu(i)``), the port on the host, where every ``cpu(i)`` is the one
torch device. Sums of two are held bit for bit, longer sums and
optimizer steps at ROADMAP rule 5's tolerance."""
import logging

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu import fault as jfault
from mxnet_tpu_torch import fault as tfault
from mxnet_tpu_torch.base import MXNetError

TOL = dict(rtol=1e-5, atol=1e-6)
N_DEV = 8
SHAPE = (4, 5)
KEYS = [3, 5, 7]
FAST_RETRY_ENV = {"MXNET_KVSTORE_TIMEOUT": "0.15",
                  "MXNET_KVSTORE_RETRY_BACKOFF": "0.01",
                  "MXNET_KVSTORE_RETRY_MAX_BACKOFF": "0.04",
                  "MXNET_FAULT_HANG_SECONDS": "0.02"}


@pytest.fixture(autouse=True)
def _port_on_cpu(monkeypatch):
    monkeypatch.setenv("MXNET_DEFAULT_CONTEXT", "cpu")
    for k, v in FAST_RETRY_ENV.items():
        monkeypatch.setenv(k, v)
    monkeypatch.delenv("MXNET_FAULT_PLAN", raising=False)
    monkeypatch.delenv("MXNET_GRAD_OVERLAP", raising=False)
    monkeypatch.delenv("MXNET_UPDATE_ON_KVSTORE", raising=False)
    for f in (jfault, tfault):
        f.reset()
    yield
    for f in (jfault, tfault):
        f.reset()


def _rand(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _both(fn):
    """``fn(mx)`` through the port and the JAX package: (port, jax)."""
    return fn(tmx), fn(jmx)


# ---------------------------------------------------------------------------
# tests/test_kvstore.py, case by case
# ---------------------------------------------------------------------------

def test_push_pull_roundtrip():
    def run(mx):
        kv = mx.kv.create("local")
        kv.init(3, mx.nd.ones(SHAPE))
        out = mx.nd.zeros(SHAPE)
        kv.pull(3, out=out)
        return out.asnumpy()
    got, want = _both(run)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.ones(SHAPE))


def test_push_aggregation_across_devices():
    vals = [_rand(i, *SHAPE) for i in range(N_DEV)]

    def run(mx):
        kv = mx.kv.create("device")
        kv.init(3, mx.nd.zeros(SHAPE))
        kv.push(3, [mx.nd.array(v, ctx=mx.cpu(i))
                    for i, v in enumerate(vals)])
        out = mx.nd.zeros(SHAPE)
        kv.pull(3, out=out)
        return out.asnumpy()
    got, want = _both(run)
    # summed in list order, as the JAX package's tree sum does
    expected = vals[0]
    for v in vals[1:]:
        expected = expected + v
    np.testing.assert_array_equal(got, expected)
    np.testing.assert_allclose(got, want, **TOL)


def test_push_of_two_copies_is_bit_equal_to_jax():
    a, b = _rand(1, *SHAPE), _rand(2, *SHAPE)

    def run(mx):
        kv = mx.kv.create("device")
        kv.init(0, mx.nd.zeros(SHAPE))
        kv.push(0, [mx.nd.array(a, ctx=mx.cpu(0)),
                    mx.nd.array(b, ctx=mx.cpu(1))])
        out = mx.nd.zeros(SHAPE)
        kv.pull(0, out=out)
        return out.asnumpy()
    got, want = _both(run)
    np.testing.assert_array_equal(got, want)


def test_push_accumulates_with_updater():
    def run(mx):
        kv = mx.kv.create("local")
        kv.init(99, mx.nd.zeros(SHAPE))

        def updater(key, pushed, stored):
            stored += pushed
        kv.set_updater(updater)
        for _ in range(4):
            kv.push(99, [mx.nd.ones(SHAPE, ctx=mx.cpu(i))
                         for i in range(N_DEV)])
        out = mx.nd.zeros(SHAPE)
        kv.pull(99, out=out)
        return out.asnumpy()
    got, want = _both(run)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.full(SHAPE, 4.0 * N_DEV))


def test_pull_broadcast_preserves_placement_and_writes_in_place():
    def run(mx):
        kv = mx.kv.create("device")
        kv.init(5, mx.nd.ones(SHAPE) * 2)
        outs = [mx.nd.zeros(SHAPE, ctx=mx.cpu(i)) for i in range(N_DEV)]
        ptrs = [getattr(o._data, "data_ptr", lambda: None)()
                for o in outs]
        kv.pull(5, out=outs)
        return [o.asnumpy() for o in outs], outs, ptrs
    (got, touts, ptrs), (want, _, _) = _both(run)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, np.full(SHAPE, 2.0))
    # the port's pull copies into each destination's own tensor
    assert [o._data.data_ptr() for o in touts] == ptrs


def test_pull_into_another_shape_takes_a_copy():
    kv = tmx.kv.create("local")
    kv.init(1, tmx.nd.ones((2, 3)))
    out = tmx.nd.zeros((6,))
    kv.pull(1, out=out)
    assert out.shape == (2, 3)
    out[:] = 5
    again = tmx.nd.zeros((2, 3))
    kv.pull(1, out=again)
    np.testing.assert_array_equal(again.asnumpy(), np.ones((2, 3)))


def test_list_key_push_pull():
    def run(mx):
        kv = mx.kv.create("local")
        kv.init(KEYS, [mx.nd.ones(SHAPE)] * len(KEYS))
        kv.push(KEYS, [[mx.nd.ones(SHAPE, ctx=mx.cpu(i)) * 2
                        for i in range(N_DEV)] for _ in KEYS])
        outs = [mx.nd.zeros(SHAPE) for _ in KEYS]
        kv.pull(KEYS, out=outs)
        return [o.asnumpy() for o in outs]
    got, want = _both(run)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, np.full(SHAPE, 2.0 * N_DEV))


def test_pushpull_matches_jax():
    a, b = _rand(60, *SHAPE), _rand(61, *SHAPE)

    def run(mx):
        kv = mx.kv.create("device")
        kv.init(KEYS, [mx.nd.zeros(SHAPE)] * len(KEYS))
        outs = [mx.nd.zeros(SHAPE) for _ in KEYS]
        kv.pushpull(KEYS, [[mx.nd.array(a * (i + 1), ctx=mx.cpu(0)),
                            mx.nd.array(b, ctx=mx.cpu(1))]
                           for i in range(len(KEYS))], out=outs)
        kv.pushpull(KEYS[0], mx.nd.array(b))          # no out: push only
        last = mx.nd.zeros(SHAPE)
        kv.pull(KEYS[0], out=last)
        return [o.asnumpy() for o in outs] + [last.asnumpy()]
    got, want = _both(run)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got[-1], b)


def _tpu_sync_roundtrip(mx, values):
    kv = mx.kv.create("tpu_sync")
    kv.init(3, mx.nd.zeros(SHAPE))
    for step_vals in values:
        kv.push(3, [mx.nd.array(v, ctx=mx.cpu(i))
                    for i, v in enumerate(step_vals)])
    out = mx.nd.zeros(SHAPE)
    kv.pull(3, out=out)
    return out.asnumpy()


def test_tpu_sync_retry_path_byte_identical():
    """A dist store outside a launched world is one worker (its reduce is
    the identity); a planned push failure is retried to the same bytes."""
    values = [[np.full(SHAPE, i + 1, np.float32) for i in range(N_DEV)]
              for _ in range(2)]
    for mx, fault in ((tmx, tfault), (jmx, jfault)):
        fault.reset()
        baseline = _tpu_sync_roundtrip(mx, values)
        np.testing.assert_array_equal(
            baseline, np.full(SHAPE, sum(range(1, N_DEV + 1)), np.float32))
        np.testing.assert_array_equal(_tpu_sync_roundtrip(mx, values),
                                      baseline)
        fault.set_plan("push:step=1:raise")
        np.testing.assert_array_equal(_tpu_sync_roundtrip(mx, values),
                                      baseline)
        stats = fault.stats()
        assert stats["injected"]["push"] == 1 and stats["retries"] >= 1
        fault.reset()
    kv = tmx.kv.create("dist_sync")
    assert (kv.rank, kv.num_workers) == (0, 1)
    assert kv.stats()["backend"] is None


# ---------------------------------------------------------------------------
# the factory, the hosted optimizer, compression, states
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["local", "device", "nccl", "tpu_sync",
                                  "dist_sync", "dist_device_sync", "dist",
                                  "local_allreduce_cpu", "device_x",
                                  "my_dist_store"])
def test_create_matches_every_type_the_jax_factory_takes(name):
    got, want = tmx.kv.create(name), jmx.kv.create(name)
    assert got.type == want.type == name
    assert got._is_dist == want._is_dist


@pytest.mark.parametrize("name", ["", "nope", "horovod"])
def test_create_rejects_what_the_jax_factory_rejects(name):
    with pytest.raises(MXNetError, match="unknown KVStore type"):
        tmx.kv.create(name)
    with pytest.raises(jmx.MXNetError):
        jmx.kv.create(name)
    with pytest.raises(TypeError):
        tmx.kv.create(3)


@pytest.mark.parametrize("optimizer,params", [
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-3}),
    ("adam", {"learning_rate": 0.01})])
def test_set_optimizer_updates_on_the_store(optimizer, params):
    w0 = _rand(10, *SHAPE)
    grads = [[_rand(20 + 2 * s + d, *SHAPE) for d in range(2)]
             for s in range(3)]

    def run(mx):
        kv = mx.kv.create("device")
        kv.set_optimizer(mx.optimizer.create(optimizer, rescale_grad=0.5,
                                             **params))
        kv.init("w", mx.nd.array(w0))
        out = mx.nd.zeros(SHAPE)
        for step in grads:
            kv.push("w", [mx.nd.array(g, ctx=mx.cpu(d))
                          for d, g in enumerate(step)])
            kv.pull("w", out=out)
        return out.asnumpy()
    got, want = _both(run)
    np.testing.assert_allclose(got, want, **TOL)
    assert not np.allclose(got, w0)


def test_two_bit_compression_residual_is_bit_equal_to_jax():
    pushes = [_rand(30 + i, *SHAPE) * 0.4 for i in range(3)]

    def run(mx):
        kv = mx.kv.create("local")
        kv.set_gradient_compression({"type": "2bit", "threshold": 0.5})
        kv.init(0, mx.nd.zeros(SHAPE))
        outs = []
        for p in pushes:
            kv.push(0, mx.nd.array(p))
            out = mx.nd.zeros(SHAPE)
            kv.pull(0, out=out)
            outs.append(out.asnumpy())
        residual = kv._compression._residual[0]
        return outs, np.asarray(getattr(residual, "numpy", lambda: residual)())
    (got, got_res), (want, want_res) = _both(run)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
        assert set(np.unique(g)) <= {-0.5, 0.0, 0.5}
    np.testing.assert_array_equal(got_res, np.asarray(want_res))
    # the plain formula, carried over the three pushes
    res = np.zeros(SHAPE, np.float32)
    for p, g in zip(pushes, got):
        x = p + res
        q = np.where(x >= 0.5, 0.5, np.where(x <= -0.5, -0.5, 0.0))
        np.testing.assert_array_equal(g, q.astype(np.float32))
        res = (x - q).astype(np.float32)
    np.testing.assert_array_equal(got_res, res)


@pytest.mark.parametrize("params", [{"type": "1bit"}, {"threshold": 1},
                                    {"type": "2bit", "threshold": 0}])
def test_bad_compression_params_raise_as_in_jax(params):
    for mx in (tmx, jmx):
        with pytest.raises(ValueError):
            mx.kv.create("local").set_gradient_compression(params)


def test_optimizer_states_round_trip_across_packages(tmp_path):
    w0 = _rand(40, *SHAPE)
    g = _rand(41, *SHAPE)

    def run(mx, load=None):
        kv = mx.kv.create("local")
        kv.set_optimizer(mx.optimizer.create("sgd", learning_rate=0.1,
                                             momentum=0.9))
        kv.init(0, mx.nd.array(w0))
        if load is not None:
            kv.load_optimizer_states(load)
        kv.push(0, mx.nd.array(g))
        out = mx.nd.zeros(SHAPE)
        kv.pull(0, out=out)
        return kv, out.asnumpy()
    tkv, _ = run(tmx)
    jkv, _ = run(jmx)
    tkv.save_optimizer_states(str(tmp_path / "t.states"))
    jkv.save_optimizer_states(str(tmp_path / "j.states"))
    # each package resumes from either package's file to the same step
    got = [run(tmx, str(tmp_path / f))[1] for f in ("t.states",
                                                   "j.states")]
    want = [run(jmx, str(tmp_path / f))[1] for f in ("t.states",
                                                    "j.states")]
    for a in got + want[1:]:
        np.testing.assert_allclose(a, want[0], **TOL)
    with pytest.raises(AssertionError):
        tmx.kv.create("local").save_optimizer_states(str(tmp_path / "x"))


# ---------------------------------------------------------------------------
# retries: tests/test_fault_tolerance.py:91-128, :385-400
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mx,fault", [(tmx, tfault), (jmx, jfault)])
def test_injected_push_failure_retried_to_success(mx, fault):
    fault.set_plan("push:step=1:raise")
    kv = mx.kv.create("local")
    kv.init(3, mx.nd.zeros(SHAPE))
    kv.push(3, mx.nd.ones(SHAPE) * 4)
    out = mx.nd.zeros(SHAPE)
    kv.pull(3, out=out)
    np.testing.assert_array_equal(out.asnumpy(), np.ones(SHAPE) * 4)
    s = fault.stats()
    assert s["injected"]["push"] == 1
    assert s["retries"] >= 1
    assert s["timeouts"] == 0


@pytest.mark.parametrize("mx,fault", [(tmx, tfault), (jmx, jfault)])
def test_exhausted_retries_raise_collective_timeout(mx, fault):
    fault.set_plan("push:step=1:raise:count=inf")
    kv = mx.kv.create("local")
    kv.init(3, mx.nd.zeros(SHAPE))
    with pytest.raises(mx.CollectiveTimeoutError):
        kv.push(3, mx.nd.ones(SHAPE))
    assert fault.stats()["timeouts"] == 1


@pytest.mark.parametrize("mx,fault", [(tmx, tfault), (jmx, jfault)])
def test_unrecoverable_hang_raises_and_one_hang_recovers(mx, fault):
    """The JAX file's two hang cases on the ``pull`` site (the port has
    no ``engine.wait_for_all``, ROADMAP item 8)."""
    kv = mx.kv.create("local")
    kv.init(3, mx.nd.ones(SHAPE))
    out = mx.nd.zeros(SHAPE)
    fault.set_plan("pull:step=1:hang:count=inf")
    with pytest.raises(mx.CollectiveTimeoutError):
        kv.pull(3, out=out)
    fault.set_plan("pull:step=1:hang")
    kv.pull(3, out=out)
    assert fault.stats()["injected"]["pull"] == 1
    np.testing.assert_array_equal(out.asnumpy(), np.ones(SHAPE))


@pytest.mark.parametrize("fault", [tfault, jfault])
def test_with_retries_preserves_return_value(fault):
    fault.set_plan("init:step=1:raise")
    assert fault.with_retries(lambda: 42, site="init") == 42
    assert fault.stats()["retries"] == 1


def test_with_retries_gives_up_on_errors_it_does_not_retry():
    calls = []

    def boom():
        calls.append(1)
        raise KeyError("no")
    with pytest.raises(KeyError):
        tfault.with_retries(boom)
    assert calls == [1]
    assert issubclass(tmx.CollectiveTimeoutError, MXNetError)


@pytest.mark.parametrize("mx,kvs", [(tmx, tmx.kvstore_module),
                                    (jmx, jmx.kvstore_module)])
def test_dist_async_warns_once(caplog, mx, kvs):
    kvs._DIST_ASYNC_WARNED = False
    with caplog.at_level(logging.WARNING):
        mx.kv.create("dist_async")
        mx.kv.create("dist_async")
    hits = [r for r in caplog.records if "dist_async" in r.getMessage()]
    assert len(hits) == 1
    assert "degrades to synchronous" in hits[0].getMessage()


def test_join_without_a_contract_is_a_no_op_and_heartbeat_raises(
        monkeypatch, tmp_path):
    monkeypatch.delenv("DMLC_WORKER_ID", raising=False)
    tfault.join_process_group()
    from mxnet_tpu_torch.parallel import distributed
    assert not distributed.is_initialized()
    monkeypatch.setenv("DMLC_NUM_WORKER", "2")
    monkeypatch.setenv("DMLC_WORKER_ID", "0")
    monkeypatch.setenv("MXNET_HB_DIR", str(tmp_path))
    with pytest.raises(NotImplementedError, match="item 12, order step 6"):
        tfault.join_process_group()
    assert not distributed.is_initialized()


# ---------------------------------------------------------------------------
# parallel.distributed
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("env,missing", [
    ({"MXNET_TPU_COORDINATOR": "127.0.0.1:1234"},
     "MXNET_TPU_WORLD, MXNET_TPU_RANK"),
    ({"MXNET_TPU_WORLD": "2", "MXNET_TPU_RANK": "0"},
     "MXNET_TPU_COORDINATOR")])
def test_partial_contract_raises_naming_the_missing_variable(
        monkeypatch, env, missing):
    from mxnet_tpu.parallel import distributed as jdist
    from mxnet_tpu_torch.parallel import distributed as tdist
    for k in ("MXNET_TPU_COORDINATOR", "MXNET_TPU_WORLD", "MXNET_TPU_RANK"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    for dist in (tdist, jdist):
        with pytest.raises(MXNetError if dist is tdist else jmx.MXNetError,
                           match="missing"):
            dist.init()
    with pytest.raises(MXNetError, match=missing):
        tdist.init()
    with pytest.raises(MXNetError, match="process_id missing"):
        tdist.init("127.0.0.1:1", 2)
    assert not tdist.is_initialized()


def test_single_process_identity():
    from mxnet_tpu_torch.parallel import distributed
    assert (distributed.rank(), distributed.num_workers()) == (0, 1)
    assert distributed.local_devices() == [torch.device("cpu")] or \
        torch.cuda.is_available()
    assert distributed.global_devices() == distributed.local_devices()
    distributed.barrier()           # one worker: nothing to wait for
    distributed.init()              # no contract: a no-op
    assert not distributed.is_initialized()


@pytest.mark.parametrize("method,world,cuda,want", [
    ("file:///tmp/x", 2, True, "gloo"),
    ("tcp://127.0.0.1:29500", 2, True, "gloo"),
    ("tcp://localhost:29500", 4, True, "gloo"),
    ("tcp://10.0.0.7:29500", 2, True, "cpu:gloo,cuda:nccl"),
    ("tcp://10.0.0.7:29500", 2, False, "gloo"),
    ("tcp://10.0.0.7:29500", 1, True, "gloo")])
def test_backend_rule(monkeypatch, method, world, cuda, want):
    from mxnet_tpu_torch.parallel import distributed
    monkeypatch.setattr(torch.cuda, "is_available", lambda: cuda)
    assert distributed.backend_for(method, world) == want


# ---------------------------------------------------------------------------
# telemetry, the bucketed exchange, sparse values
# ---------------------------------------------------------------------------

def test_push_and_pull_records_of_a_telemetry_run():
    from mxnet_tpu import telemetry as jtel
    from mxnet_tpu_torch import telemetry as ttel

    def run(mx, tel):
        tel.reset()
        tel.start(run_id="kv")
        try:
            kv = mx.kv.create("local")
            kv.init(3, mx.nd.zeros(SHAPE))
            for _ in range(2):
                kv.push(3, mx.nd.ones(SHAPE))
                kv.pull(3, out=mx.nd.zeros(SHAPE))
            kv.pull(3, out=[mx.nd.zeros(SHAPE), mx.nd.zeros(SHAPE)])
        finally:
            summary = tel.stop()
            tel.reset()
        return {k: (v["calls"], v["bytes"])
                for k, v in summary["comms"].items()}
    got, want = run(tmx, ttel), run(jmx, jtel)
    assert got == want
    assert got == {"push:3": (2, 160), "pull:3": (3, 240)}


def test_comm_links_book_cross_process_bytes_under_dcn():
    from mxnet_tpu_torch import telemetry as ttel
    ttel.reset()
    ttel.start(run_id="links")
    try:
        ttel.comm_links("kvstore_push", 0, 400)
        with ttel.comm_span("grad_sync", "bucket00", nbytes=96):
            pass
    finally:
        summary = ttel.stop()
        ttel.reset()
    comms = summary["comms"]
    assert comms["dcn:kvstore_push"]["bytes"] == 400
    assert comms["ici:kvstore_push"]["bytes"] == 0
    assert comms["grad_sync:bucket00"]["bytes"] == 96


def _grad_roster(seed):
    shapes = [(16, 8), (16,), (4, 16), (4,), (3, 3, 2)]
    return [_rand(seed + i, *s) for i, s in enumerate(shapes)]


def test_bucket_plan_matches_jax():
    from mxnet_tpu.parallel import grad_sync as jgs
    from mxnet_tpu_torch.parallel import grad_sync as tgs
    shapes = [g.shape for g in _grad_roster(0)]
    dtypes = ["float32"] * 4 + ["float16"]
    for cap in (64, 300, 1 << 20):
        for axis in (1, 8):
            got = tgs.GradSyncPlan(shapes, dtypes, axis, cap_bytes=cap)
            want = jgs.GradSyncPlan(shapes, dtypes, axis, cap_bytes=cap)
            assert got.signature() == want.signature()
            assert got.layout_key() == want.layout_key()
            assert got.describe() == want.describe()


@pytest.mark.parametrize("kv_type", ["local", "tpu_sync"])
def test_bucketed_sync_equals_the_per_key_loop_bit_for_bit(monkeypatch,
                                                         kv_type):
    from mxnet_tpu_torch.parallel import grad_sync
    roster = _grad_roster(50)
    per_key = [tmx.nd.array(g) for g in roster]
    kv = tmx.kv.create(kv_type)
    for i, g in enumerate(per_key):
        kv.init(i, tmx.nd.zeros(g.shape))
        kv.push(i, [g, g])
        kv.pull(i, [g])
    bucketed = [tmx.nd.array(g) for g in roster]
    ptrs = [g._data.data_ptr() for g in bucketed]
    kv2 = tmx.kv.create(kv_type)
    assert grad_sync.bucketed_kvstore_sync(
        kv2, list(enumerate(bucketed)), cap_bytes=600)
    assert len(kv2._grad_bucket_plan[1].buckets) > 1
    # the sum of one copy is the copy: hold the exchange to the values
    for got, want in zip(bucketed, roster):
        np.testing.assert_array_equal(got.asnumpy(), want)
    assert [g._data.data_ptr() for g in bucketed] == ptrs
    monkeypatch.setenv("MXNET_GRAD_OVERLAP", "1")
    from mxnet_tpu_torch.model import _bucketed_exchange
    doubled = [tmx.nd.array(g) * 2 for g in roster]
    assert _bucketed_exchange(doubled, kv2)
    for got, want in zip(doubled, per_key):
        np.testing.assert_array_equal(got.asnumpy(), want.asnumpy())
    assert not _bucketed_exchange([[doubled[0], doubled[1]]], kv2)
    kv2.set_gradient_compression({"type": "2bit"})
    assert not grad_sync.bucketed_kvstore_sync(kv2, [(0, doubled[0])])


def test_sparse_values_push_and_pull_like_jax():
    """A row_sparse push stored as row_sparse (a list push summed by row
    union), skipped by ``pull``, and ``row_sparse_pull`` of a dense
    stored value deduplicated and sorted into a row_sparse destination;
    a dense destination raises (tests/test_sparse.py:155-187)."""
    d = np.zeros((6, 2), np.float32)
    d[[1, 3]] = 2.0
    w = _rand(9, 6, 2)

    def run(mx):
        sp = mx.nd.sparse
        kv = mx.kv.create("local")
        kv.init(0, mx.nd.zeros((6, 2)))
        kv.push(0, [sp.row_sparse_array(d), sp.row_sparse_array(d * 3)])
        kept = mx.nd.ones((6, 2))
        kv.pull(0, out=kept)
        kv.init(1, mx.nd.array(w))
        out = sp.zeros("row_sparse", (6, 2))
        kv.row_sparse_pull(1, out=out, row_ids=mx.nd.array([5, 0, 5]))
        return kv._data[0], kept.asnumpy(), out
    (stored, kept, out), (jstored, jkept, jout) = _both(run)
    assert stored.stype == jstored.stype == "row_sparse"
    np.testing.assert_array_equal(stored.asnumpy(), jstored.asnumpy())
    np.testing.assert_array_equal(stored.asnumpy(), 4 * d)
    np.testing.assert_array_equal(kept, jkept)
    assert list(out.indices.asnumpy()) == list(jout.indices.asnumpy()) \
        == [0, 5]
    np.testing.assert_array_equal(out.data.asnumpy(), w[[0, 5]])
    kv = tmx.kv.create("local")
    kv.init(0, tmx.nd.zeros((4, 2)))
    with pytest.raises(MXNetError):
        kv.row_sparse_pull(0, out=tmx.nd.zeros((4, 2)),
                           row_ids=tmx.nd.array([1]))


def test_server_role_is_a_logged_no_op(caplog):
    from mxnet_tpu_torch import kvstore_server
    with caplog.at_level(logging.INFO):
        kvstore_server.KVStoreServer(tmx.kv.create("local")).run()
    assert any("no server loop" in r.getMessage() for r in caplog.records)
    assert tmx.kvstore_create("device").type == "device"
    assert tmx.KVStore is tmx.kvstore.KVStore


def test_bandwidth_layer_shapes_match_jax():
    from mxnet_tpu.tools import bandwidth as jband
    from mxnet_tpu_torch.tools import bandwidth as tband
    got = tband._layer_shapes("resnet18_v1", 10, (3, 32, 32))
    want = jband._layer_shapes("resnet18_v1", 10, (3, 32, 32))
    assert got == want
    assert len(got) == 102
    assert sum(int(np.prod(s)) for s in got) == 11191242
