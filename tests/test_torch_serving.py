"""The port's continuous-batching InferenceServer
(``mxnet_tpu_torch.serving``) against the JAX package's
(tests/test_serving.py's cases), each drill run through both servers on
the same Symbol MLP artifact graph, the same numpy inputs and the same
fault plans: bucket-ladder batching bit-exact to the Predictor within a
bucket, the fixed program set (``compile_watch.site_stats("serving")``
counts equal JAX's), backpressure and shedding, planned deadline
timeouts, replicas (``devices=["cpu", "cpu"]`` on the port, one JAX CPU
device twice), and the telemetry/diagnose/metrics wiring. The port's
own: a served callable runs in inference mode (no autograd graph), and
the CUDA-graph path through a stand-in capture — every bucket captured
once by ``warmup()``, none during traffic."""
import json

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu import compile_watch as jcw
from mxnet_tpu import fault as jfault
from mxnet_tpu import profiler as jprofiler
from mxnet_tpu import serving as jserving
from mxnet_tpu import telemetry as jtelemetry
from mxnet_tpu.tools import diagnose as jdiagnose
from mxnet_tpu_torch import (compile_watch, fault, livemetrics, profiler,
                             serving, telemetry)
from mxnet_tpu_torch.cached_op import _Graphs
from mxnet_tpu_torch.serving import (BucketLadder, InferenceServer,
                                     RequestTimeoutError,
                                     ServerOverloadedError)

TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True)
def _clean_state(monkeypatch):
    monkeypatch.setenv("MXNET_DEFAULT_CONTEXT", "cpu")
    for mod in (fault, jfault, telemetry, jtelemetry):
        mod.reset()
    compile_watch.disable()
    jcw.disable()
    yield
    for mod in (fault, jfault, telemetry, jtelemetry):
        mod.reset()
    compile_watch.disable()
    jcw.disable()


PKGS = {"port": (mx, serving, fault, telemetry, compile_watch),
        "jax": (jmx, jserving, jfault, jtelemetry, jcw)}


def _mlp_artifact(m, path, batch_sizes, in_dim=12, classes=5):
    """The JAX test's symbol MLP, exported by package ``m``."""
    d = m.sym.var("data")
    h = m.sym.FullyConnected(d, name="fc1", num_hidden=16)
    h = m.sym.Activation(h, act_type="relu")
    out = m.sym.FullyConnected(h, name="fc2", num_hidden=classes)
    rs = np.random.RandomState(7)
    params = {
        "fc1_weight": m.nd.array(rs.randn(16, in_dim) * 0.1),
        "fc1_bias": m.nd.zeros((16,)),
        "fc2_weight": m.nd.array(rs.randn(classes, 16) * 0.1),
        "fc2_bias": m.nd.zeros((classes,)),
    }
    m.deploy.export_compiled(out, path, params=params,
                             input_shapes={"data": (1, in_dim)},
                             batch_sizes=batch_sizes)
    return m.deploy.load_compiled(path)


def _both_preds(tmp_path, batch_sizes):
    return {k: _mlp_artifact(PKGS[k][0], str(tmp_path / ("%s.mxp" % k)),
                             batch_sizes) for k in PKGS}


def _serve(srv, xs):
    try:
        futs = [srv.submit(x) for x in xs]
        return [np.asarray(f.result(timeout=30)) for f in futs]
    finally:
        srv.stop()


# ---------------------------------------------------------------------------
# ladder
# ---------------------------------------------------------------------------

def test_ladder_geometric_and_bucket_for():
    for Ladder in (BucketLadder, jserving.BucketLadder):
        lad = Ladder.geometric(8)
        assert lad.buckets == [1, 2, 4, 8]
        assert [lad.bucket_for(n) for n in (1, 3, 8, 9)] \
            == [1, 4, 8, None]
        assert Ladder.geometric(6).buckets == [1, 2, 4, 6]
    with pytest.raises(mx.base.MXNetError):
        BucketLadder([0, 2])


# ---------------------------------------------------------------------------
# batching correctness
# ---------------------------------------------------------------------------

def test_batched_bit_identical_to_predictor(tmp_path):
    preds = _both_preds(tmp_path, [4])
    rs = np.random.RandomState(0)
    xs = [rs.randn(12).astype(np.float32) for _ in range(7)]
    got = {}
    for k, pred in preds.items():
        one_by_one = [np.asarray(pred(x[None]))[0] for x in xs]
        srv = PKGS[k][1].InferenceServer(pred, max_queue=32,
                                         batch_window_ms=5.0)
        got[k] = _serve(srv, xs)
        for want, have in zip(one_by_one, got[k]):
            assert (want == have).all()
    for a, b in zip(got["port"], got["jax"]):
        np.testing.assert_allclose(a, b, **TOL)


def test_mixed_buckets_match_predictor_closely(tmp_path):
    preds = _both_preds(tmp_path, [1, 2, 4, 8])
    rs = np.random.RandomState(1)
    xs = [rs.randn(12).astype(np.float32) for _ in range(13)]
    got = {}
    for k, pred in preds.items():
        ref = [np.asarray(pred(x[None]))[0] for x in xs]
        srv = PKGS[k][1].InferenceServer(pred, max_queue=64,
                                         batch_window_ms=5.0)
        got[k] = _serve(srv, xs)
        for want, have in zip(ref, got[k]):
            np.testing.assert_allclose(have, want, **TOL)
        st = srv.stats()
        assert st["completed"] == 13
        assert st["shed"] == 0 and st["timeouts"] == 0
    for a, b in zip(got["port"], got["jax"]):
        np.testing.assert_allclose(a, b, **TOL)


def test_callable_model_in_process():
    import jax.numpy as jnp
    w = np.random.RandomState(2).randn(6, 3).astype(np.float32)
    tw = torch.from_numpy(w)
    jw = jnp.asarray(w)
    models = {"port": lambda x: x @ tw, "jax": lambda x: x @ jw}
    xs = [np.random.RandomState(i).randn(6).astype(np.float32)
          for i in range(5)]
    got = {}
    for k, model in models.items():
        srv = PKGS[k][1].InferenceServer(model, max_batch=4,
                                         max_queue=16,
                                         batch_window_ms=1.0)
        got[k] = _serve(srv, xs)
        for x, y in zip(xs, got[k]):
            np.testing.assert_allclose(y, x @ w, **TOL)
    for a, b in zip(got["port"], got["jax"]):
        np.testing.assert_allclose(a, b, **TOL)


def test_served_callable_runs_in_inference_mode():
    """Grad mode is thread-local: the replica worker serves under
    torch.inference_mode, so a model over a trainable tensor builds no
    autograd graph."""
    w = torch.randn(6, 3, requires_grad=True)
    seen = []

    def model(x):
        y = x @ w
        seen.append((torch.is_inference_mode_enabled(), y.requires_grad,
                     y.grad_fn))
        return y
    srv = InferenceServer(model, max_batch=2, max_queue=8,
                          batch_window_ms=0.0)
    srv.warmup(np.zeros(6, np.float32))
    out = _serve(srv, [np.ones(6, np.float32)])
    assert seen and all(s == (True, False, None) for s in seen)
    np.testing.assert_allclose(out[0], (torch.ones(6) @ w).detach(),
                               **TOL)


# ---------------------------------------------------------------------------
# the fixed-program-set oracle
# ---------------------------------------------------------------------------

def test_program_cache_bounded_by_ladder(tmp_path):
    preds = _both_preds(tmp_path, [1, 2, 4, 8])
    sites = {}
    for k, pred in preds.items():
        _m, srvmod, _f, _t, cw = PKGS[k]
        cw.enable()
        srv = srvmod.InferenceServer(pred, max_queue=256,
                                     batch_window_ms=1.0)
        rs = np.random.RandomState(3)
        try:
            assert srv.warmup() == 4
            warm = cw.site_stats("serving")
            assert warm and len(warm) == 4
            assert all(s["count"] == 1 for s in warm.values()), warm
            for burst in (1, 2, 3, 5, 8, 4, 7, 6):
                futs = [srv.submit(rs.randn(12).astype(np.float32))
                        for _ in range(burst)]
                for f in futs:
                    f.result(timeout=30)
            for _ in range(6):
                burst = int(rs.randint(1, 9))
                futs = [srv.submit(rs.randn(12).astype(np.float32))
                        for _ in range(burst)]
                for f in futs:
                    f.result(timeout=30)
            steady = cw.site_stats("serving")
            assert {s: v["count"] for s, v in steady.items()} \
                == {s: v["count"] for s, v in warm.items()}
            sites[k] = {s: v["count"] for s, v in steady.items()}
        finally:
            srv.stop()
            cw.disable()
    assert sites["port"] == sites["jax"]


def _StandinGraphs():
    """``cached_op._Graphs`` on the CPU through a stand-in capture (the
    body re-runs at each replay): the card's graph path, on the host."""
    return _Graphs("cpu", capture=_standin)


def _standin(body, device, pool):
    out = body()

    def replay():
        for o, r in zip(out, body()):
            o.copy_(r)
    return replay, out, {}


def test_graph_path_captures_every_bucket_in_warmup(tmp_path,
                                                    monkeypatch):
    """The card's path: one graph per bucket, captured by warmup(), none
    during any request mix; replays equal the batches served."""
    import mxnet_tpu_torch.cached_op as co
    monkeypatch.setattr(co, "_Graphs", _StandinGraphs)
    pred = _mlp_artifact(mx, str(tmp_path / "m.mxp"), [1, 2, 4, 8])
    compile_watch.enable()
    srv = InferenceServer(pred, max_queue=256, batch_window_ms=1.0)
    rs = np.random.RandomState(3)
    xs = [rs.randn(12).astype(np.float32) for _ in range(29)]
    try:
        assert srv.warmup() == 4
        warm = compile_watch.site_stats("serving")
        futs = [srv.submit(x) for x in xs]
        got = [f.result(timeout=30) for f in futs]
    finally:
        srv.stop()
    for x, y in zip(xs, got):
        np.testing.assert_allclose(y, pred(x[None])[0], **TOL)
    assert compile_watch.site_stats("serving") == warm
    assert sorted(warm) == ["serving:b%d" % b for b in (1, 2, 4, 8)]
    graphs = [srv._programs[("cpu", b)].graphs.stats() for b in
              (1, 2, 4, 8)]
    assert [g["captures"] for g in graphs] == [1, 1, 1, 1]
    assert sum(g["recaptures"] for g in graphs) == 0
    assert sum(g["replays"] for g in graphs) \
        == 4 + srv.stats()["batches"]


def test_first_batch_of_a_bucket_captures_on_the_worker(tmp_path,
                                                        monkeypatch):
    """Without warmup, the worker thread captures a bucket's program at
    its first batch (under the capture lock): one compile a bucket."""
    import mxnet_tpu_torch.cached_op as co
    monkeypatch.setattr(co, "_Graphs", _StandinGraphs)
    pred = _mlp_artifact(mx, str(tmp_path / "m.mxp"), [2])
    compile_watch.enable()
    srv = InferenceServer(pred, max_queue=16, batch_window_ms=0.0)
    out = _serve(srv, [np.ones(12, np.float32)] * 5)
    assert len(out) == 5
    assert compile_watch.site_stats("serving")["serving:b2"]["count"] == 1


def _attention_artifact(path):
    """FC -> causal ``_contrib_flash_attention`` -> FC (B, 6, 12),
    exported with buckets [1, 2, 4]: its programs hold op
    ``mxnet_tpu_torch::flash_fwd``."""
    d = mx.sym.var("data")
    heads = [mx.sym.reshape(mx.sym.FullyConnected(
        d, num_hidden=16, flatten=False, name=n), shape=(0, 0, 2, 8))
        for n in "qkv"]
    att = mx.sym._contrib_flash_attention(*heads, causal=True)
    out = mx.sym.FullyConnected(mx.sym.reshape(att, shape=(0, 0, 16)),
                                num_hidden=5, flatten=False, name="o")
    rs = np.random.RandomState(4)
    params = {n: mx.nd.array(rs.randn(*sh).astype(np.float32) * 0.4)
              for n, sh in [("q_weight", (16, 12)), ("k_weight", (16, 12)),
                            ("v_weight", (16, 12)), ("q_bias", (16,)),
                            ("k_bias", (16,)), ("v_bias", (16,)),
                            ("o_weight", (5, 16)), ("o_bias", (5,))]}
    mx.deploy.export_compiled(out, path, params=params,
                              input_shapes={"data": (1, 6, 12)},
                              batch_sizes=[1, 2, 4])
    return mx.deploy.load_compiled(path), (6, 12)


def _int8_artifact(path):
    """The MLP exported as a format-3 int8 artifact, buckets [1, 2, 4]."""
    d = mx.sym.var("data")
    h = mx.sym.Activation(mx.sym.FullyConnected(d, name="fc1",
                                                num_hidden=16),
                          act_type="relu")
    out = mx.sym.FullyConnected(h, name="fc2", num_hidden=5)
    rs = np.random.RandomState(7)
    params = {"fc1_weight": mx.nd.array(rs.randn(16, 12) * 0.1),
              "fc1_bias": mx.nd.zeros((16,)),
              "fc2_weight": mx.nd.array(rs.randn(5, 16) * 0.1),
              "fc2_bias": mx.nd.zeros((5,))}
    calib = [mx.nd.array(rs.randn(4, 12).astype(np.float32))
             for _ in range(2)]
    mx.deploy.export_compiled(out, path, params=params,
                              input_shapes={"data": (1, 12)},
                              batch_sizes=[1, 2, 4], quantize=True,
                              calib_data=calib)
    return mx.deploy.load_compiled(path), (12,)


@pytest.mark.parametrize("kind", ["attention", "int8"])
def test_graph_path_serves_attention_and_int8_artifacts(tmp_path,
                                                        monkeypatch, kind):
    """Both new artifact kinds on the card's path: one graph a bucket,
    captured in warmup(), none in traffic; each answer equal to the
    Predictor's program on the batch it was served in (an int8 answer
    depends on its batch-mates: the input is quantized over the whole
    batch), found from the request's ``batch`` and ``row``."""
    import mxnet_tpu_torch.cached_op as co
    monkeypatch.setattr(co, "_Graphs", _StandinGraphs)
    make = _attention_artifact if kind == "attention" else _int8_artifact
    pred, shape = make(str(tmp_path / "m.mxp"))
    assert (pred.meta["format"], pred.meta["custom_ops"][0]) == (
        (2, "mxnet_tpu_torch::flash_fwd") if kind == "attention"
        else (3, "mxnet_tpu_torch::dequantize"))
    compile_watch.enable()
    srv = InferenceServer(pred, max_queue=64, batch_window_ms=1.0)
    rs = np.random.RandomState(5)
    xs = [rs.randn(*shape).astype(np.float32) for _ in range(19)]
    try:
        assert srv.warmup() == 3
        warm = compile_watch.site_stats("serving")
        futs = [srv.submit(x) for x in xs]
        got = [f.result(timeout=30) for f in futs]
        st = srv.stats()
    finally:
        srv.stop()
    assert compile_watch.site_stats("serving") == warm
    graphs = [srv._programs[("cpu", b)].graphs.stats() for b in (1, 2, 4)]
    assert [g["captures"] for g in graphs] == [1, 1, 1]
    assert sum(g["replays"] for g in graphs) == 3 + st["batches"]
    batches = {}
    for i, f in enumerate(futs):
        batches.setdefault(f.batch, []).append((f.row, i))
    assert len(batches) == st["batches"]
    for rows in batches.values():
        rows.sort()
        idx = [i for _row, i in rows]
        assert [r for r, _ in rows] == list(range(len(idx)))
        b = futs[idx[0]].bucket
        batch = np.zeros((b,) + shape, np.float32)
        batch[:len(idx)] = np.stack([xs[i] for i in idx])
        with torch.inference_mode():
            want = pred.program(b)(torch.from_numpy(batch)).numpy()
        for row, i in enumerate(idx):
            np.testing.assert_array_equal(got[i], want[row])


# ---------------------------------------------------------------------------
# backpressure, shedding, deadlines (deterministic via fault plan)
# ---------------------------------------------------------------------------

def test_backpressure_bound_and_shed(tmp_path, monkeypatch):
    monkeypatch.setenv("MXNET_FAULT_HANG_SECONDS", "0.01")
    stats = {}
    for k, pred in _both_preds(tmp_path, [4]).items():
        _m, srvmod, flt, _t, _cw = PKGS[k]
        srv = srvmod.InferenceServer(pred, max_queue=4,
                                     batch_window_ms=0.0)
        flt.set_plan("serve_dispatch:step=1:hang:count=inf")
        try:
            x = np.zeros((12,), np.float32)
            for _ in range(4):
                srv.submit(x)
            for _ in range(3):
                with pytest.raises(srvmod.ServerOverloadedError):
                    srv.submit(x)
            st = srv.stats()
            assert st["queue_peak"] <= 4 and st["queue_depth"] <= 4
            stats[k] = (st["shed"], st["requests"])
        finally:
            flt.set_plan(None)
            srv.stop(drain=False)
    assert stats["port"] == stats["jax"] == (3, 7)


def test_deadline_timeouts_are_deterministic(tmp_path, monkeypatch):
    monkeypatch.setenv("MXNET_FAULT_HANG_SECONDS", "0.05")
    for k, pred in _both_preds(tmp_path, [4]).items():
        _m, srvmod, flt, _t, _cw = PKGS[k]
        srv = srvmod.InferenceServer(pred, max_queue=16,
                                     batch_window_ms=0.0)
        flt.set_plan("serve_dispatch:step=1:hang:count=2")
        try:
            x = np.zeros((12,), np.float32)
            futs = [srv.submit(x, deadline_ms=1) for _ in range(3)]
            for f in futs:
                with pytest.raises(srvmod.RequestTimeoutError):
                    f.result(timeout=30)
            st = srv.stats()
            assert st["timeouts"] == 3 and st["completed"] == 0, k
            assert st["dispatch_faults"] >= 1
            y = srv.predict(x, timeout=30)
            assert np.asarray(y).shape == (5,)
        finally:
            flt.set_plan(None)
            srv.stop()


def test_admit_site_raise_rejects_single_request(tmp_path):
    for k, pred in _both_preds(tmp_path, [2]).items():
        _m, srvmod, flt, _t, _cw = PKGS[k]
        srv = srvmod.InferenceServer(pred, max_queue=8,
                                     batch_window_ms=0.0)
        flt.set_plan("serve_admit:step=2:raise")
        try:
            x = np.zeros((12,), np.float32)
            srv.submit(x).result(timeout=30)
            with pytest.raises(flt.InjectedFault):
                srv.submit(x)
            srv.submit(x).result(timeout=30)
        finally:
            flt.set_plan(None)
            srv.stop()


# ---------------------------------------------------------------------------
# validation
# ---------------------------------------------------------------------------

def test_submit_validates_sample_against_meta(tmp_path):
    msgs = {}
    for k, pred in _both_preds(tmp_path, [2]).items():
        m, srvmod = PKGS[k][:2]
        srv = srvmod.InferenceServer(pred, max_queue=8)
        got = []
        try:
            for args in ((np.zeros((12,), np.float32),
                          np.zeros((12,), np.float32)),
                         (np.zeros((11,), np.float32),),
                         (np.zeros((12,), np.complex64),)):
                with pytest.raises(m.base.MXNetError) as exc:
                    srv.submit(*args)
                got.append(str(exc.value))
            y = srv.predict(np.zeros((12,), np.float64), timeout=30)
            assert np.asarray(y).shape == (5,)
        finally:
            srv.stop()
        msgs[k] = got
    assert msgs["port"] == msgs["jax"]
    assert "1 input" in msgs["port"][0]
    assert "sample shape" in msgs["port"][1]
    assert "cannot safely" in msgs["port"][2]


# ---------------------------------------------------------------------------
# replicas
# ---------------------------------------------------------------------------

def test_replicas_spread_batches_least_outstanding(tmp_path):
    import jax
    devices = {"port": ["cpu", "cpu"],
               "jax": [jax.devices("cpu")[0]] * 2}
    for k, pred in _both_preds(tmp_path, [1, 2]).items():
        srv = PKGS[k][1].InferenceServer(
            pred, max_queue=128, batch_window_ms=0.0, replicas=2,
            devices=devices[k])
        rs = np.random.RandomState(5)
        got = _serve(srv, [rs.randn(12).astype(np.float32)
                           for _ in range(40)])
        assert len(got) == 40 and all(y.shape == (5,) for y in got)
        st = srv.stats()
        assert st["replicas"] == 2
        assert sum(st["replica_batches"]) == st["batches"]
        assert all(b > 0 for b in st["replica_batches"]), (k, st)
    with pytest.raises(mx.base.MXNetError, match="need 2 devices"):
        InferenceServer(pred, replicas=2, devices=["cpu"])
    with pytest.raises(mx.base.MXNetError, match="exceed"):
        InferenceServer(_mlp_artifact(mx, str(tmp_path / "r.mxp"), [1]),
                        replicas=2)


# ---------------------------------------------------------------------------
# telemetry & diagnose
# ---------------------------------------------------------------------------

def test_serving_records_and_diagnose_table(tmp_path, capsys):
    pred = _mlp_artifact(mx, str(tmp_path / "m.mxp"), [1, 4])
    sink = str(tmp_path / "run.jsonl")
    telemetry.start(filename=sink)
    srv = InferenceServer(pred, max_queue=32, batch_window_ms=1.0,
                          record_every=2)
    rs = np.random.RandomState(6)
    _serve(srv, [rs.randn(12).astype(np.float32) for _ in range(9)])
    summary = telemetry.stop()
    assert summary["serving"]["completed"] == 9
    assert summary["serving"]["shed"] == 0
    with open(sink) as f:
        kinds = {json.loads(line).get("type") for line in f}
    assert "serving" in kinds
    from mxnet_tpu_torch.tools import diagnose
    diagnose.main([sink])
    out = capsys.readouterr().out
    assert "----------Serving----------" in out
    assert "9 submitted (completed 9" in out
    assert "latency(ms)" in out and "queue depth" in out
    jdiagnose.main([sink])
    assert capsys.readouterr().out == out


def test_no_server_keeps_sink_byte_identical(tmp_path):
    sink = str(tmp_path / "run.jsonl")
    telemetry.start(filename=sink)
    telemetry.step_begin()
    telemetry.step_end(samples=4)
    summary = telemetry.stop()
    assert "serving" not in summary
    with open(sink) as f:
        kinds = {json.loads(line).get("type") for line in f}
    assert "serving" not in kinds


def test_request_ids_assigned_and_in_profiler_counters(tmp_path,
                                                       monkeypatch):
    monkeypatch.setenv("MXNET_FAULT_HANG_SECONDS", "0.01")
    deltas = {}
    for k, pred in _both_preds(tmp_path, [4]).items():
        _m, srvmod, flt, _t, _cw = PKGS[k]
        prof = profiler if k == "port" else jprofiler
        base = prof.counters()
        srv = srvmod.InferenceServer(pred, max_queue=2,
                                     batch_window_ms=0.0)
        flt.set_plan("serve_dispatch:step=1:hang:count=3")
        try:
            x = np.zeros((12,), np.float32)
            futs = [srv.submit(x, deadline_ms=1) for _ in range(2)]
            assert [f.request_id for f in futs] == ["r000001",
                                                    "r000002"]
            with pytest.raises(srvmod.ServerOverloadedError) as exc:
                srv.submit(x)
            assert "r000003" in str(exc.value)
            for f in futs:
                with pytest.raises(srvmod.RequestTimeoutError) as texc:
                    f.result(timeout=30)
                assert f.request_id in str(texc.value)
            srv.predict(x, timeout=30)
        finally:
            flt.set_plan(None)
            srv.stop()
        ctr = prof.counters()
        deltas[k] = [ctr.get(n, 0) - base.get(n, 0)
                     for n in ("serving_shed", "serving_timeouts")]
        assert ctr.get("serving_dispatches", 0) \
            - base.get("serving_dispatches", 0) >= 1
    assert deltas["port"] == deltas["jax"] == [1, 2]


def test_stop_drain_serves_queued_requests(tmp_path):
    pred = _mlp_artifact(mx, str(tmp_path / "m.mxp"), [8])
    srv = InferenceServer(pred, max_queue=64, batch_window_ms=20.0)
    x = np.zeros((12,), np.float32)
    futs = [srv.submit(x) for _ in range(5)]
    srv.stop(drain=True)
    for f in futs:
        assert np.asarray(f.result(timeout=1)).shape == (5,)
    with pytest.raises(serving.ServerClosedError):
        srv.submit(x)


def test_metrics_page_and_watchdog_read_the_server(tmp_path):
    """The server's ``mxnet_serving_*`` families on /metrics equal its
    stats(), and its records feed the SLO watchdog."""
    pred = _mlp_artifact(mx, str(tmp_path / "m.mxp"), [1, 2])
    wd = livemetrics.enable_watchdog()
    try:
        srv = InferenceServer(pred, max_queue=8, batch_window_ms=0.0,
                              record_every=1, name="metrics-drill")
        _serve(srv, [np.zeros(12, np.float32)] * 3)
        page = livemetrics.render()
        st = srv.stats()
        assert 'mxnet_serving_completed_total{server="metrics-drill"} 3' \
            not in page                 # deregistered at stop
        assert "metrics-drill" in wd._prev_serving
        srv2 = InferenceServer(pred, max_queue=8, name="metrics-drill")
        try:
            page = livemetrics.render()
            assert 'mxnet_serving_queue_bound{server="metrics-drill"} 8' \
                in page
        finally:
            srv2.stop()
        assert st["completed"] == 3
    finally:
        livemetrics.disable_watchdog()


def test_serving_seq_ladder_program_cache_bounded():
    """Variable-length requests over a (batch x seq) ladder: exactly
    |ladder| x |seq_ladder| programs, none more in steady state, the same
    sites as JAX's; over-long requests are refused up front."""
    import jax.numpy as jnp
    w = np.random.RandomState(0).randn(4, 3).astype(np.float32)
    models = {"port": lambda x: x.mean(1) @ torch.from_numpy(w),
              "jax": lambda x: jnp.mean(x, axis=1) @ jnp.asarray(w)}
    got, sites = {}, {}
    for k, model in models.items():
        m, srvmod, _f, _t, cw = PKGS[k]
        cw.enable()
        srv = srvmod.InferenceServer(model, ladder=[1, 2, 4],
                                     seq_ladder=[4, 8], max_queue=64,
                                     batch_window_ms=1.0)
        rs = np.random.RandomState(1)
        try:
            assert srv.warmup(np.zeros((5, 4), np.float32)) == 6
            warm = cw.site_stats("serving")
            assert len(warm) == 6
            assert all(s["count"] == 1 for s in warm.values()), warm
            futs = [srv.submit(
                rs.randn(int(rs.randint(1, 9)), 4).astype(np.float32))
                for _ in range(24)]
            got[k] = [np.asarray(f.result(timeout=30)) for f in futs]
            assert all(o.shape == (3,) for o in got[k])
            assert cw.site_stats("serving") == warm
            with pytest.raises(m.base.MXNetError, match="exceeds"):
                srv.submit(np.zeros((9, 4), np.float32))
            sites[k] = {s: v["count"] for s, v in warm.items()}
        finally:
            srv.stop()
            cw.disable()
    assert sites["port"] == sites["jax"]
    for a, b in zip(got["port"], got["jax"]):
        np.testing.assert_allclose(a, b, **TOL)
