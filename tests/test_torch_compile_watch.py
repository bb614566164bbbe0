"""The port's compile watch (``mxnet_tpu_torch.compile_watch``) against
the JAX package's (tests/test_compile_watch.py's cases where the port
has the site): compile records at the executor / fused-step / CachedOp
sites, recompile causes naming the churning argument, the one-time
storm warning, MFU against hand-counted matmul flops, the JSONL round
trip through both diagnose tools, the Speedometer's MFU column and the
always-cheap off path. Compile counts per site equal JAX's for the same
sequence of calls. On the CPU a port "compile" is the first call of a
new argument signature (on the card, a CUDA graph capture; the graph
holder's path is driven here through a stand-in capture).

JAX tests without a port counterpart:

- ``test_one_time_zeros_specializations_do_not_storm`` — it watches the
  per-op eager jit (``op:_zeros``); the port runs single ops eagerly,
  with no program and so no site.

The MFU tests use an executor's predict program (``executor:fwd:eval``)
where the JAX tests use the eager ``op:dot`` site; the flops of the
matmul are the same hand count.
"""
import json
import logging
import warnings

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu import compile_watch as jcw
from mxnet_tpu import telemetry as jtelemetry
from mxnet_tpu.tools import diagnose as jdiagnose
from mxnet_tpu_torch import compile_watch, profiler, telemetry
from mxnet_tpu_torch.model import BatchEndParam
from mxnet_tpu_torch.tools import diagnose


@pytest.fixture(autouse=True)
def _clean_state(monkeypatch):
    for var in ("MXNET_TELEMETRY", "MXNET_TELEMETRY_FILE",
                "MXNET_COMPILE_WATCH", "MXNET_COMPILE_STORM_K",
                "MXNET_COMPILE_STORM_STEPS", "MXNET_DEVICE_PEAK_FLOPS",
                "MXNET_DEVICE_PEAK_BW", "MXNET_FUSED_STEP"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("MXNET_DEFAULT_CONTEXT", "cpu")
    for cw, tel in ((compile_watch, telemetry), (jcw, jtelemetry)):
        cw.disable()
        tel.reset()
    yield
    for cw, tel in ((compile_watch, telemetry), (jcw, jtelemetry)):
        cw.disable()
        tel.reset()


def _mlp_sym(m):
    data = m.sym.var("data")
    x = m.sym.FullyConnected(data, num_hidden=8, name="fc1")
    x = m.sym.Activation(x, act_type="relu")
    x = m.sym.FullyConnected(x, num_hidden=3, name="fc2")
    return m.sym.SoftmaxOutput(x, m.sym.var("softmax_label"),
                               name="softmax")


def _train_iter(m, n=24, batch=8):
    rng = np.random.RandomState(7)
    X = rng.uniform(size=(n, 6)).astype(np.float32)
    Y = rng.randint(0, 3, (n,)).astype(np.float32)
    return m.io.NDArrayIter(X, Y, batch_size=batch)


def _fit_once(m, sink=None, epochs=1):
    tel = telemetry if m is mx else jtelemetry
    tel.start(filename=sink, meta={"case": "compile_watch_test"})
    mod = m.module.Module(_mlp_sym(m), context=m.cpu())
    mod.fit(_train_iter(m), num_epoch=epochs, optimizer="sgd",
            optimizer_params={"learning_rate": 0.05})
    return tel.stop()


def _bind_fc(m, batch):
    data = m.sym.var("data")
    sym = m.sym.FullyConnected(data, num_hidden=4, name="fc")
    args = {"data": m.nd.array(np.ones((batch, 6), np.float32)),
            "fc_weight": m.nd.array(np.zeros((4, 6), np.float32)),
            "fc_bias": m.nd.array(np.zeros((4,), np.float32))}
    return sym.bind(m.cpu(), args)


def _dot_exec(m, k=16, dtype="float32"):
    """An executor whose predict program is one (8, k) @ (k, 4)
    matmul: 2*8*k*4 flops."""
    a = m.sym.var("a")
    b = m.sym.var("b")
    args = {"a": m.nd.array(np.ones((8, k))).astype(dtype),
            "b": m.nd.array(np.ones((k, 4))).astype(dtype)}
    return m.sym.dot(a, b).bind(m.cpu(), args)


def _both(fn):
    """``fn(m, cw)`` on the port then on the JAX package, each with its
    watch on; returns the two results."""
    out = []
    for m, cw in ((mx, compile_watch), (jmx, jcw)):
        cw.enable()
        out.append(fn(m, cw))
        cw.disable()
    return out


# ---------------------------------------------------------------------------
# off path
# ---------------------------------------------------------------------------

def test_off_is_a_noop(tmp_path):
    sink = str(tmp_path / "off.jsonl")
    ctr_before = profiler.counters().get("fused_step_compile_ms", 0)
    with warnings.catch_warnings(record=True) as wlog:
        warnings.simplefilter("always")
        summary = _fit_once(mx, sink=sink)
    assert not compile_watch.enabled()
    assert compile_watch.stats() is None
    assert compile_watch.site_stats() is None
    assert compile_watch.recent_mfu() is None
    assert "compile" not in summary
    assert "utilization" not in summary
    kinds = {json.loads(line)["type"] for line in open(sink)}
    assert kinds <= {"run_start", "step", "memory", "summary"}
    assert not [w for w in wlog if "compile_watch" in str(w.message)]
    assert profiler.counters().get("fused_step_compile_ms", 0) \
        == ctr_before


def test_env_enables_with_telemetry_run(tmp_path, monkeypatch):
    monkeypatch.setenv("MXNET_COMPILE_WATCH", "1")
    sink = str(tmp_path / "env.jsonl")
    summary = _fit_once(mx, sink=sink)
    assert compile_watch.enabled()
    assert summary["compile"]["count"] > 0
    kinds = {json.loads(line)["type"] for line in open(sink)}
    assert "compile" in kinds and "utilization" in kinds


# ---------------------------------------------------------------------------
# compile-event capture per site
# ---------------------------------------------------------------------------

def test_executor_site_captured():
    def run(m, cw):
        ex = _bind_fc(m, 3)
        ex.forward(is_train=False)
        return cw.stats()["programs"]["executor:fwd:eval"]
    got, want = _both(run)
    assert got["count"] == want["count"] == 1 and got["total_s"] > 0
    assert got["causes"] == want["causes"] == {"first_compile": 1}


def test_fused_step_site_and_counter_bridge(tmp_path):
    compile_watch.enable()
    sink = str(tmp_path / "fused.jsonl")
    summary = _fit_once(mx, sink=sink)
    progs = compile_watch.stats()["programs"]
    assert "fused_step:module" in progs
    assert progs["fused_step:module"]["count"] == 1
    ctr = summary["counters"]
    assert ctr.get("fused_step_cache_misses", 0) >= 1
    assert ctr.get("fused_step_dispatches", 0) >= 1
    assert ctr.get("fused_step_compile_ms", 0) > 0
    assert summary["compile"]["programs"]["fused_step:module"][
        "total_s"] > 0
    # the JAX fit compiles its fused step once too
    jcw.enable()
    _fit_once(jmx)
    assert jcw.stats()["programs"]["fused_step:module"]["count"] == 1


def test_cached_op_site_captured():
    def run(m, cw):
        x = m.sym.var("x")
        op = m.cached_op.CachedOp(2 * x + 1)
        out = op(m.nd.array(np.ones((3,), np.float32)))
        out = out[0] if isinstance(out, (list, tuple)) else out
        np.testing.assert_allclose(out.asnumpy(), [3, 3, 3])
        return {s: p["count"] for s, p in cw.stats()["programs"].items()
                if s.startswith("op:_cachedop")}
    got, want = _both(run)
    assert len(got) == 1 and list(got.values()) == [1]
    assert len(want) == 1 and list(want.values()) == [1]


# ---------------------------------------------------------------------------
# recompile-cause diff + storm
# ---------------------------------------------------------------------------

def test_recompile_diff_names_changed_argument():
    def run(m, cw):
        for batch in (3, 5):
            _bind_fc(m, batch).forward(is_train=False)
        p = cw.stats()["programs"]["executor:fwd:eval"]
        return p["count"], p["causes"].get("changed"), p["churn"]
    got, want = _both(run)
    assert got == want == (2, 1, {"data": 1})


def test_storm_warning_fires_once_and_names_argument(monkeypatch):
    monkeypatch.setenv("MXNET_COMPILE_STORM_K", "3")

    def run(m, cw):
        with warnings.catch_warnings(record=True) as wlog:
            warnings.simplefilter("always")
            for batch in (3, 5, 7, 9, 11):   # forced shape churn
                _bind_fc(m, batch).forward(is_train=False)
        return [str(w.message) for w in wlog
                if "recompile storm" in str(w.message)], cw.stats()
    (got, gst), (want, _) = _both(run)
    assert len(got) == len(want) == 1
    assert "executor:fwd:eval" in got[0] and "'data'" in got[0]
    s = gst["storms"]
    assert len(s) == 1 and s[0]["arg"] == "data"


def test_rebinds_without_arg_churn_do_not_storm():
    def run(m, cw):
        with warnings.catch_warnings(record=True) as wlog:
            warnings.simplefilter("always")
            for _ in range(5):
                _bind_fc(m, 3).forward(is_train=False)
        assert not [w for w in wlog
                    if "recompile storm" in str(w.message)]
        st = cw.stats()
        return st["storms"], st["programs"]["executor:fwd:eval"]["count"]
    got, want = _both(run)
    assert got == want == ([], 5)


def test_distinct_models_at_one_site_do_not_storm(monkeypatch):
    monkeypatch.setenv("MXNET_COMPILE_STORM_K", "3")

    def run(m, cw):
        with warnings.catch_warnings(record=True) as wlog:
            warnings.simplefilter("always")
            for depth in (1, 2, 3, 1, 2, 3):
                x = m.sym.var("data")
                args = {"data": m.nd.array(np.ones((4, 6), np.float32))}
                width = 6
                for d in range(depth):
                    name = "fc%d" % d
                    x = m.sym.FullyConnected(x, num_hidden=4, name=name)
                    args[name + "_weight"] = m.nd.array(
                        np.zeros((4, width), np.float32))
                    args[name + "_bias"] = m.nd.array(
                        np.zeros((4,), np.float32))
                    width = 4
                x.bind(m.cpu(), args).forward(is_train=False)
        assert not [w for w in wlog
                    if "recompile storm" in str(w.message)]
        return cw.stats()["programs"]["executor:fwd:eval"]["causes"]
    got, want = _both(run)
    assert got == want
    assert got.get("rebound", 0) >= 2


def _standin(body, device, pool):
    out = body()

    def replay():
        res = body()
        for o, r in zip(out, res):
            o.copy_(r)
    return replay, out, {}


def test_recapture_names_the_replaced_parameter():
    """A graph holder reads its parameters in place: a parameter
    replaced by a new tensor recaptures, and the cause names it (the
    graph path, through a stand-in capture on the CPU)."""
    from mxnet_tpu_torch.cached_op import _Graphs
    compile_watch.enable()
    ex = _bind_fc(mx, 3)
    ex.graphs = _Graphs("cpu", capture=_standin)
    ex.forward(is_train=False)
    ex.forward(is_train=False)                     # a replay
    ex.arg_dict["fc_weight"]._set_data(torch.ones(4, 6))
    out = ex.forward(is_train=False)[0].asnumpy()
    np.testing.assert_allclose(out, np.full((3, 4), 6.0))
    p = compile_watch.stats()["programs"]["executor:fwd:eval"]
    assert p["count"] == 2
    assert p["causes"] == {"first_compile": 1, "replaced": 1}
    assert p["churn"] == {"fc_weight": 1}
    assert ex.stats()["recaptures"] == 1
    assert compile_watch.stats()["dispatches"] == 3


# ---------------------------------------------------------------------------
# MFU math
# ---------------------------------------------------------------------------

def _one_step(m, run):
    tel = telemetry if m is mx else jtelemetry
    tel.start()
    tel.step_begin()
    run()
    rec = tel.step_end()
    summary = tel.stop()
    recs = tel._last_run.records or []
    return rec, summary, recs


def test_mfu_against_hand_computed_matmul_flops(monkeypatch):
    """A (8,16)@(16,4) matmul is 2*8*16*4 = 1024 flops by torch's flop
    counter, as in XLA's cost model; the utilization record's MFU is
    flops / (step_seconds * dtype_peak * n_devices)."""
    peak = 1e9
    monkeypatch.setenv("MXNET_DEVICE_PEAK_FLOPS", str(peak))
    compile_watch.enable()
    ex = _dot_exec(mx)
    rec, summary, recs = _one_step(
        mx, lambda: ex.forward(is_train=False)[0].asnumpy())
    utils = [r for r in recs if r.get("type") == "utilization"]
    assert len(utils) == 1
    util = utils[0]
    assert util["flops"] == 2 * 8 * 16 * 4
    n_dev = compile_watch.stats()["n_devices"]
    f32_peak = peak * compile_watch.dtype_peak_factor("float32")
    expect = util["flops"] / ((rec["dur_ms"] / 1e3) * f32_peak * n_dev)
    assert util["mfu"] == pytest.approx(expect, rel=1e-3)
    assert summary["utilization"]["mfu"]["samples"] == 1
    assert summary["utilization"]["peak_flops"] == peak
    # JAX's eager dot program counts the same flops
    jcw.enable()
    a = jmx.nd.array(np.ones((8, 16), np.float32))
    b = jmx.nd.array(np.ones((16, 4), np.float32))
    _, _, jrecs = _one_step(jmx, lambda: jmx.nd.dot(a, b).asnumpy())
    assert [r["flops"] for r in jrecs if r.get("type") == "utilization"] \
        == [util["flops"]]


def test_mfu_dtype_aware_peak(monkeypatch):
    monkeypatch.setenv("MXNET_DEVICE_PEAK_FLOPS", "1e9")
    compile_watch.enable()
    for dt in ("bfloat16", "float32", "int8", "weird", "float64"):
        assert compile_watch.dtype_peak_factor(dt) \
            == jcw.dtype_peak_factor(dt)
    for dt in ("float32", "bfloat16"):
        ex = _dot_exec(mx, k=48, dtype=dt)
        rec, _, recs = _one_step(mx, lambda: ex.forward(is_train=False))
        utils = [r for r in recs if r.get("type") == "utilization"]
        compiles = [r for r in recs if r.get("type") == "compile"]
        assert len(utils) == 1
        util = utils[0]
        assert util["flops"] == 2 * 8 * 48 * 4
        assert dt in [c.get("compute_dtype") for c in compiles]
        dur_s = rec["dur_ms"] / 1e3
        if dt == "float32":
            assert util["flops_norm"] == 2 * util["flops"]
            expect = util["flops_norm"] / (dur_s * 1e9)
        else:
            assert "flops_norm" not in util
            expect = util["flops"] / (dur_s * 1e9)
        assert util["mfu"] == pytest.approx(expect, rel=1e-3)


def test_h100_peak_table(monkeypatch):
    """On the H100 the table is NVIDIA's spec sheet: 989 TFLOP/s bf16
    dense, fp32 at 67 TFLOP/s (495 as TF32), 3.35 TB/s."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda *a: "NVIDIA H100 80GB HBM3")
    flops, bw, kind, n = compile_watch.peak_table()
    assert (flops, bw, kind, n) == (989e12, 3.35e12,
                                    "NVIDIA H100 80GB HBM3", 1)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        assert flops * compile_watch.dtype_peak_factor("float32") \
            == pytest.approx(67e12)
        torch.backends.cuda.matmul.allow_tf32 = True
        assert flops * compile_watch.dtype_peak_factor("float32") \
            == pytest.approx(495e12)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    assert compile_watch.dtype_peak_factor("bfloat16") == 1.0
    monkeypatch.setenv("MXNET_DEVICE_PEAK_FLOPS", "5e14")
    monkeypatch.setenv("MXNET_DEVICE_PEAK_BW", "2e12")
    assert compile_watch.peak_table()[:2] == (5e14, 2e12)


def test_step_without_watched_dispatch_emits_no_utilization():
    compile_watch.enable()
    _, _, recs = _one_step(mx, lambda: None)
    assert not [r for r in recs if r.get("type") == "utilization"]


def test_prestep_backlog_never_inflates_first_step(monkeypatch):
    monkeypatch.setenv("MXNET_DEVICE_PEAK_FLOPS", "1e9")
    compile_watch.enable()
    ex = _dot_exec(mx)
    for _ in range(5):                       # pre-run backlog
        ex.forward(is_train=False)
    telemetry.start()
    ex.forward(is_train=False)               # pre-step backlog
    telemetry.step_begin()
    ex.forward(is_train=False)[0].asnumpy()  # the step's real work
    telemetry.step_end()
    summary = telemetry.stop()
    utils = [r for r in telemetry._last_run.records
             if r.get("type") == "utilization"]
    assert len(utils) == 1
    assert utils[0]["dispatches"] == 1
    assert utils[0]["flops"] == 2 * 8 * 16 * 4
    assert summary["utilization"]["mfu"]["samples"] == 1
    assert summary["utilization"]["total_flops"] == 2 * 8 * 16 * 4


def test_hand_kernel_work_counts_into_the_cost():
    """A kernel launch adds its flops and bytes to the program's cost
    (the formulas of PERF.md's bound column); the plain attention's own
    flops come from torch's counter."""
    from mxnet_tpu_torch.parallel import flash_attention as fa
    q = torch.ones(1, 4, 2, 8)
    with fa.counting_work() as work:
        fa._work(lambda: 4.0 * 8 * 2 * fa._pairs(1, 4, 4, True, None,
                                                  "cpu"), q, q, q, q)
    assert work == {"flops": 4.0 * 8 * 2 * 10, "bytes": 4 * q.nbytes}
    _, flops, nbytes = compile_watch.count_cost(
        lambda: fa.flash_attention(q, q, q, causal=True))
    assert flops == 2 * (2 * 1 * 2 * 4 * 4 * 8)     # QK^T and PV
    assert nbytes > 0


# ---------------------------------------------------------------------------
# JSONL round trip through diagnose
# ---------------------------------------------------------------------------

def test_diagnose_renders_compile_and_utilization_tables(tmp_path,
                                                         capsys):
    compile_watch.enable()
    sink = str(tmp_path / "run.jsonl")
    _fit_once(mx, sink=sink)
    text = diagnose.format_telemetry(diagnose.read_telemetry(sink))
    assert "----------Compilation----------" in text
    assert "fused_step:module" in text
    assert "TOTAL" in text
    assert "fused-step cache:" in text
    assert "----------Utilization----------" in text
    assert "MFU p50" in text
    # the JAX tool reads the port's sink the same way
    assert jdiagnose.format_telemetry(jdiagnose.read_telemetry(sink)) \
        == text
    diagnose.main([sink])
    out = capsys.readouterr().out
    assert "----------Compilation----------" in out
    assert "MFU p50" in out


def test_diagnose_off_run_has_no_new_tables(tmp_path):
    sink = str(tmp_path / "plain.jsonl")
    _fit_once(mx, sink=sink)
    text = diagnose.format_telemetry(diagnose.read_telemetry(sink))
    assert "Compilation" not in text
    assert "Utilization" not in text


def _zero_step_sink(path, compiles):
    with open(path, "w") as f:
        f.write(json.dumps({"type": "run_start", "run_id": "r0",
                            "time": 0.0, "meta": {}}) + "\n")
        for i in range(compiles):
            f.write(json.dumps({"type": "compile",
                                "program": "executor:fwd:eval",
                                "n": i + 1, "dur_ms": 12.5,
                                "cause": "first_compile"}) + "\n")


@pytest.mark.parametrize("compiles", [2, 0])
def test_diagnose_zero_step_and_empty_runs(tmp_path, compiles):
    sink = str(tmp_path / "nostep.jsonl")
    _zero_step_sink(sink, compiles)
    text = diagnose.format_telemetry(diagnose.read_telemetry(sink))
    assert text == jdiagnose.format_telemetry(
        jdiagnose.read_telemetry(sink))
    if compiles:
        assert "run recorded 2 compile(s) but no steps" in text
        assert "----------Compilation----------" in text
        assert "executor:fwd:eval" in text
    else:
        assert "no step records" in text
        assert "run recorded" not in text


# ---------------------------------------------------------------------------
# Speedometer MFU column
# ---------------------------------------------------------------------------

def _speedometer_lines(caplog):
    speed = mx.callback.Speedometer(batch_size=8, frequent=2,
                                    auto_reset=False)
    with caplog.at_level(logging.INFO):
        for nbatch in range(1, 5):
            speed(BatchEndParam(epoch=0, nbatch=nbatch,
                                eval_metric=None, locals=None))
    return [r.getMessage() for r in caplog.records
            if "samples/sec" in r.getMessage()]


def test_speedometer_appends_mfu_when_available(caplog, monkeypatch):
    monkeypatch.setenv("MXNET_DEVICE_PEAK_FLOPS", "1e9")
    compile_watch.enable()
    telemetry.start()
    ex = _dot_exec(mx)
    for _ in range(3):
        telemetry.step_begin()
        ex.forward(is_train=False)[0].asnumpy()
        telemetry.step_end(samples=8)
    lines = _speedometer_lines(caplog)
    telemetry.stop()
    assert lines and all("MFU: " in ln for ln in lines)


def test_speedometer_unchanged_when_watch_off(caplog):
    telemetry.start()
    telemetry.step_begin()
    telemetry.step_end(samples=8)
    lines = _speedometer_lines(caplog)
    telemetry.stop()
    assert lines and all("MFU" not in ln for ln in lines)


# ---------------------------------------------------------------------------
# monitor-forced-eager note, keyword calls
# ---------------------------------------------------------------------------

def test_monitor_fallback_noted_once(tmp_path):
    sink = str(tmp_path / "mon.jsonl")
    telemetry.start(filename=sink)
    mod = mx.module.Module(_mlp_sym(mx), context=mx.cpu())
    mod.bind(data_shapes=[("data", (8, 6))],
             label_shapes=[("softmax_label", (8,))])
    mod.init_params()
    mod.init_optimizer(optimizer="sgd")
    mod._exec.set_monitor_callback(lambda *a: None)
    batch = mx.io.DataBatch(
        data=[mx.nd.array(np.ones((8, 6), np.float32))],
        label=[mx.nd.array(np.zeros((8,), np.float32))])
    for _ in range(3):
        mod.forward(batch, is_train=True)
        mod.backward()
        mod.update()
    summary = telemetry.stop()
    assert summary["events"]["fused_step_eager_monitor"] == 1
    text = diagnose.format_telemetry(diagnose.read_telemetry(sink))
    assert "fused_step_eager_monitor" in text


def test_kwarg_calls_bypass_staging():
    compile_watch.enable()
    fn = compile_watch.jit(lambda x, y=1.0: x + y, "test:kwargs")
    out = fn(torch.tensor(1.0), y=torch.tensor(2.0))
    assert float(out) == 3.0
    assert "test:kwargs" not in compile_watch.stats()["programs"]


def _lm_sym_gen(m, V=20, E=8):
    def sym_gen(seq_len):
        data = m.sym.var("data")
        label = m.sym.var("softmax_label")
        emb = m.sym.Embedding(data, input_dim=V, output_dim=E,
                              name="embed")
        pred = m.sym.Reshape(emb, shape=(-1, E))
        pred = m.sym.FullyConnected(pred, num_hidden=V, name="pred")
        label_f = m.sym.Reshape(label, shape=(-1,))
        out = m.sym.SoftmaxOutput(pred, label_f, name="softmax",
                                  use_ignore=True, ignore_label=0,
                                  normalization="valid")
        return out, ("data",), ("softmax_label",)
    return sym_gen


def test_bucketed_fit_compiles_ladder_size_programs(monkeypatch):
    """tests/test_bucketing.py's storm regression on the port: ~40
    distinct lengths through a bucketed ``Module.fit`` compile one
    program a bucket under ``bucketing:<shape>`` (the same sites and
    counts as JAX's), none in a second epoch, and no storm."""
    monkeypatch.setenv("MXNET_DATA_PIPELINE", "0")
    rng = np.random.RandomState(7)
    sents = [list(rng.randint(1, 20, size=L))
             for L in rng.choice(np.arange(3, 43), size=160)]
    ladder = [11, 22, 32, 42]
    got = {}
    for m, cw in ((mx, compile_watch), (jmx, jcw)):
        cw.enable()
        it = m.rnn.BucketSentenceIter(sents, batch_size=8,
                                      buckets=ladder, invalid_label=0)
        mod = m.mod.BucketingModule(_lm_sym_gen(m),
                                    default_bucket_key=it.default_bucket_key)
        kw = dict(eval_metric=m.metric.Perplexity(ignore_label=0),
                  optimizer="sgd",
                  optimizer_params={"learning_rate": 0.05})
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            mod.fit(it, num_epoch=1, **kw)
            warm = cw.site_stats("bucketing")
            mod.fit(it, num_epoch=1, force_rebind=False, force_init=False,
                    **kw)
            assert cw.site_stats("bucketing") == warm
        assert not [w for w in caught
                    if "recompile storm" in str(w.message)]
        got[m.__name__] = {s: v["count"] for s, v in warm.items()}
        cw.disable()
    assert got["mxnet_tpu_torch"] == got["mxnet_tpu"] \
        == {"bucketing:%d" % k: 1 for k in ladder}
