"""Port parity: mxnet_tpu_torch.telemetry (and the event profiler it
layers onto) against mxnet_tpu.telemetry, on the CPU.

The drills of tests/test_telemetry.py over the port: exclusive phases,
tick mode, the ring, the atomic create-then-append sink, the sink-error
degrade, per-worker sink names, the Gluon Trainer's ticks, and the
profiler's gated emission, bounded buffer, table and atomic dump. The
cross-package drill runs a JAX Router over JAX DecodeServers and a port
Router over port DecodeServers on the same numpy weights, prompts and
``pump(now)`` schedule, armed with a telemetry run and a meter, and
requires equal ``decode``, ``prefix_cache``, ``router`` and ``usage``
records once times and FLOPs are left out; both packages' diagnose
tools must print identical tables for either package's sink. The port
writes no ``memory`` record on the CPU (torch has no counterpart of the
JAX host live-buffer fallback), so those comparisons leave ``memory``
records out."""
import gc
import itertools
import json
import os
import threading
import time

import numpy as np
import pytest

import mxnet_tpu_torch as mx
from mxnet_tpu import metering as jmetering
from mxnet_tpu import serving as jserving
from mxnet_tpu import telemetry as jtelemetry
from mxnet_tpu.tools import diagnose as jdiagnose
from mxnet_tpu_torch import fault, metering, profiler, telemetry
from mxnet_tpu_torch.serving import (DecodeServer, Router, ToyDecoderLM,
                                     params_from_numpy)
from mxnet_tpu_torch.tools import diagnose


@pytest.fixture(autouse=True)
def _clean_state(monkeypatch):
    for var in ("MXNET_TELEMETRY", "MXNET_TELEMETRY_FILE",
                "MXNET_TELEMETRY_RING", "MXNET_TELEMETRY_MEM_INTERVAL",
                "MXNET_FAULT_PLAN", "MXNET_PROFILER_MAX_EVENTS"):
        monkeypatch.delenv(var, raising=False)
    telemetry.reset()
    jtelemetry.reset()
    fault.reset()
    metering.stop()
    jmetering.stop()
    yield
    telemetry.reset()
    jtelemetry.reset()
    fault.reset()
    metering.stop()
    jmetering.stop()


def _steps(n, sleep_s=0.0):
    for _ in range(n):
        telemetry.step_begin()
        if sleep_s:
            time.sleep(sleep_s)
        telemetry.step_end(samples=1)


# ---------------------------------------------------------------------------
# the off path, spans and steps
# ---------------------------------------------------------------------------

def test_off_by_default_every_hook_noops():
    assert not telemetry.enabled()
    assert telemetry.maybe_start() is False
    assert telemetry.span("compute") is telemetry._NULL
    assert telemetry.step_end() is None
    telemetry.step_begin()
    telemetry.note("skipped_steps")
    telemetry.sample_memory()
    telemetry.decode_event({"name": "x"})
    telemetry.router_event({"name": "x"})
    telemetry.usage_event({"name": "x"})
    assert telemetry.report() is None
    assert telemetry.flush() is None


def test_span_nesting_outermost_owns_the_time():
    telemetry.start(run_id="nest")
    telemetry.step_begin()
    with telemetry.span("compute"):
        time.sleep(0.02)
        with telemetry.span("compute"):
            time.sleep(0.02)
        with telemetry.span("data_wait"):
            time.sleep(0.01)
    with telemetry.span("optimizer"):
        time.sleep(0.01)
    rec = telemetry.step_end(samples=4)
    phases = rec["phases_ms"]
    assert 40.0 <= phases["compute"] < 70.0, phases
    assert "data_wait" not in phases and phases["optimizer"] >= 8.0
    assert sum(phases.values()) <= rec["dur_ms"]
    rep = telemetry.stop()
    assert rep["steps"] == 1 and rep["samples"] == 4
    assert rep["phases_ms"]["compute"] == pytest.approx(
        phases["compute"], abs=1e-3)
    assert profiler.aggregate_stats()["telemetry.compute"]["count"] >= 1


def test_spans_off_the_accounting_thread_are_ignored():
    telemetry.start(run_id="threads")
    telemetry.step_begin()
    done = threading.Event()

    def worker():
        with telemetry.span("data_wait"):
            time.sleep(0.03)
        done.set()

    t = threading.Thread(target=worker)
    t.start()
    time.sleep(0.005)
    with telemetry.span("data_wait"):
        time.sleep(0.01)
    done.wait()
    t.join()
    rec = telemetry.step_end(samples=1)
    assert 8.0 <= rec["phases_ms"]["data_wait"] < 25.0, rec
    telemetry.stop()


def test_tick_mode_ring_and_percentiles(monkeypatch):
    monkeypatch.setenv("MXNET_TELEMETRY_RING", "8")
    telemetry.start(run_id="tick")
    assert telemetry.step_tick(samples=8) is None      # baseline only
    time.sleep(0.01)
    assert telemetry.step_tick(samples=8)["dur_ms"] >= 8.0
    _steps(19)
    rep = telemetry.stop()
    assert rep["steps"] == 20 and rep["samples"] == 27
    assert rep["step_time_ms"]["count"] == 8
    assert sum(1 for r in telemetry._last_run.records
               if r["type"] == "step") == 20
    assert telemetry.quick_stats()["steps"] == 20
    assert telemetry.recent_rate() > 0
    vals = list(range(1, 101))
    for q in (0, 50, 90, 99, 100):
        assert telemetry.percentile(vals, q) \
            == jtelemetry.percentile(vals, q)
    assert telemetry.percentile([], 50) is None


def test_note_reconciles_goodput_with_fault_stats():
    telemetry.start(run_id="notes")
    telemetry.step_begin()
    telemetry.note("skipped_steps")
    telemetry.note("decode_shed", 3)
    telemetry.step_end(samples=2)
    _steps(1)
    rep = telemetry.stop()
    assert rep["skipped_steps"] == 1 and rep["productive_steps"] == 1
    assert rep["goodput"] == 0.5 and rep["events"] == {"decode_shed": 3}
    assert rep["fault"] == {"skipped_steps": 0, "retries": 0,
                            "timeouts": 0}
    steps = [r for r in telemetry._last_run.records if r["type"] == "step"]
    assert steps[0]["skipped"] == 1 and "skipped" not in steps[1]


# ---------------------------------------------------------------------------
# the sink
# ---------------------------------------------------------------------------

def test_incremental_flush_appends_once(tmp_path):
    sink = str(tmp_path / "inc.jsonl")
    telemetry.start(filename=sink, run_id="inc")
    _steps(3)
    assert telemetry.flush() == sink
    assert telemetry._run.records == []
    assert not os.path.exists("%s.%d.tmp" % (sink, os.getpid()))
    _steps(2)
    telemetry.stop()
    recs = [json.loads(line) for line in open(sink)]
    kinds = [r["type"] for r in recs]
    assert kinds[0] == "run_start" and kinds[-1] == "summary"
    assert [r["seq"] for r in recs if r["type"] == "step"] == [1, 2, 3, 4, 5]
    assert "memory" not in kinds          # no card: no memory record


def test_memory_only_run_bounds_records(monkeypatch):
    monkeypatch.setenv("MXNET_TELEMETRY_MAX_RECORDS", "6")
    telemetry.start(run_id="cap")
    _steps(10)
    rep = telemetry.stop()
    assert rep["steps"] == 10 and rep["records_dropped"] > 0
    assert telemetry._last_run.records[0]["type"] == "run_start"


def test_unwritable_sink_degrades_instead_of_crashing(tmp_path):
    telemetry.start(filename=str(tmp_path / "no_such_dir" / "x.jsonl"))
    _steps(1)
    with pytest.warns(UserWarning, match="sink disabled"):
        assert telemetry.flush() is None
    _steps(1)
    rep = telemetry.stop()
    assert rep["steps"] == 2


def test_multi_worker_sink_gets_per_worker_file(tmp_path, monkeypatch):
    monkeypatch.setenv("DMLC_NUM_WORKER", "2")
    monkeypatch.setenv("DMLC_WORKER_ID", "1")
    sink = str(tmp_path / "run.jsonl")
    telemetry.start(filename=sink)
    assert telemetry._run.filename == str(tmp_path / "run.worker1.jsonl")
    telemetry.stop()
    assert os.path.exists(str(tmp_path / "run.worker1.jsonl"))
    assert not os.path.exists(sink)


def test_start_registers_atexit_stop(tmp_path, monkeypatch):
    import atexit
    sink = str(tmp_path / "atexit.jsonl")
    telemetry._atexit_registered = False
    registered = []
    monkeypatch.setattr(atexit, "register", registered.append)
    telemetry.start(filename=sink)
    assert registered == [telemetry.stop]
    _steps(1)
    registered[0]()
    assert not telemetry.enabled()
    assert [json.loads(line)["type"] for line in open(sink)][-1] \
        == "summary"


# ---------------------------------------------------------------------------
# the Gluon Trainer
# ---------------------------------------------------------------------------

def _train(trainer_call, steps=3):
    with mx.cpu():
        net = mx.gluon.nn.Dense(4, in_units=6)
        net.initialize(mx.init.Xavier())
        trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                                   {"learning_rate": 0.1})
        x = mx.nd.array(np.random.RandomState(0).uniform(
            size=(8, 6)).astype(np.float32))
        for _ in range(steps):
            with mx.autograd.record():
                loss = net(x).sum()
            loss.backward()
            trainer_call(trainer)


def test_gluon_trainer_tick_and_phases():
    telemetry.start(run_id="gluon")
    _train(lambda tr: tr.step(8))
    rep = telemetry.stop()
    assert rep["steps"] == 2 and rep["samples"] == 16
    assert rep["phases_ms"].get("optimizer", 0) > 0
    assert "sync" not in rep["phases_ms"]     # one device: no kvstore


@pytest.mark.parametrize("path", ["step", "update"])
def test_trainer_autostarts_from_the_environment(tmp_path, monkeypatch,
                                                 path):
    sink = str(tmp_path / "auto.jsonl")
    monkeypatch.setenv("MXNET_TELEMETRY_FILE", sink)
    telemetry.reset()
    if path == "step":
        _train(lambda tr: tr.step(8))
    else:
        _train(lambda tr: (tr.allreduce_grads(), tr.update(8)))
    assert telemetry.enabled()
    rep = telemetry.stop()
    assert rep["steps"] == 2
    recs = [json.loads(line) for line in open(sink)]
    assert recs[0]["meta"] == {"source": "gluon.Trainer"}
    assert [r["samples"] for r in recs if r["type"] == "step"] == [8, 8]


# ---------------------------------------------------------------------------
# the profiler the spans layer onto
# ---------------------------------------------------------------------------

def _drain_profiler():
    profiler.set_state("stop")
    with profiler._lock:
        profiler._state["events"] = []


def test_profiler_emission_gated_bounded_and_dumped(tmp_path,
                                                    monkeypatch):
    _drain_profiler()
    profiler.Marker("m").mark()
    with profiler.Task("t"):
        pass
    assert profiler._state["events"] == []        # stopped: nothing
    monkeypatch.setenv("MXNET_PROFILER_MAX_EVENTS", "5")
    profiler.reset_counters()
    fname = str(tmp_path / "trace.json")
    profiler.set_config(filename=fname, profile_all=True)
    profiler.set_state("run")
    try:
        marker = profiler.Marker("spam")
        for _ in range(12):
            marker.mark()
        assert len(profiler._state["events"]) == 5
        assert profiler.counters()["profiler_events_dropped"] == 7
    finally:
        profiler.set_state("stop")
    assert profiler.dump() == fname
    assert not os.path.exists(fname + ".tmp")
    assert len(json.load(open(fname))["traceEvents"]) == 5
    _drain_profiler()
    profiler.reset_counters()


def test_profiler_table_sort_and_thread_safe_counter():
    with profiler._lock:
        profiler._state["aggregate"] = {}
    profiler._aggregate("many_small", 10.0)
    profiler._aggregate("many_small", 20.0)
    profiler._aggregate("one_big", 100.0)
    lines = profiler.dumps(sort_by="avg").splitlines()
    assert "Avg(us)" in lines[0] and lines[1].startswith("one_big")
    assert "15.0" in lines[2]
    with pytest.raises(ValueError):
        profiler.dumps(sort_by="bogus")
    profiler.dumps(reset=True)
    counter = profiler.Counter("race")
    threads = [threading.Thread(
        target=lambda: [counter.increment() for _ in range(500)])
        for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert counter._v == 4000


# ---------------------------------------------------------------------------
# cross-package: the same armed drill on a JAX fleet and a port fleet
# ---------------------------------------------------------------------------

_KW = dict(vocab=32, n_layers=1, n_heads=2, head_dim=8, max_len=128)
_JMODEL = jserving.ToyDecoderLM(**_KW)
_JPARAMS = _JMODEL.init_params(seed=3)
_MODEL = ToyDecoderLM(**_KW)
_PARAMS = params_from_numpy({k: np.asarray(v) for k, v in _JPARAMS.items()},
                            "cpu", model=_MODEL)
_DRILL = itertools.count()

# values that depend on the host's clock, or on the cost source (the
# JAX server bills FLOPs and bytes only under its compile watch), or
# exist only in the port (the CUDA-graph counters), and the ledger path
# each drill chose
_VOLATILE = {"t", "tokens_per_sec", "inter_token_ms", "ttft_ms",
             "failover_resume_ms", "latency_ms", "page_seconds",
             "queue_ms", "flops", "bytes", "graphs", "path"}


def _stable(value):
    if isinstance(value, dict):
        return {k: _stable(v) for k, v in value.items()
                if k not in _VOLATILE}
    if isinstance(value, list):
        return [_stable(v) for v in value]
    return value


def _armed_drill(pkg, tmp_path, tag):
    """A two-replica fleet on one shared prefix pool, two tenants, one
    replica killed mid-stream, armed with a telemetry run (sink) and a
    meter (ledger). Returns the sink path and the streams."""
    serving = jserving if pkg == "jax" else None
    tel = jtelemetry if pkg == "jax" else telemetry
    met = jmetering if pkg == "jax" else metering
    names = ["x%d-rep-%d" % (tag, i) for i in range(2)]
    if pkg == "jax":
        pool = serving.KVCachePool(1, 2, 8, page_size=8, n_pages=96)
        reps = [serving.DecodeServer(
            _JMODEL, _JPARAMS, seq_ladder=[16, 32], max_new_tokens=12,
            window=4, pool=pool, share_group="m0", prefix_cache=True,
            record_every=2, name=n, start=False) for n in names]
        router = serving.Router(reps, name="x%d-front" % tag, start=False,
                                probe_interval_ms=1, strikes=2)
    else:
        from mxnet_tpu_torch.serving import KVCachePool
        pool = KVCachePool(1, 2, 8, page_size=8, n_pages=96, device="cpu")
        reps = [DecodeServer(
            _MODEL, _PARAMS, seq_ladder=[16, 32], max_new_tokens=12,
            window=4, pool=pool, share_group="m0", prefix_cache=True,
            record_every=2, name=n, start=False) for n in names]
        router = Router(reps, name="x%d-front" % tag, start=False,
                        probe_interval_ms=1, strikes=2)
    sink = str(tmp_path / ("%s.jsonl" % pkg))
    tel.start(filename=sink, run_id="xpkg")
    met.start(name="fleet", path=str(tmp_path / ("%s.ledger" % pkg)),
              flush_every=3)
    rs = np.random.RandomState(5)
    base = rs.randint(1, 32, size=8)
    prompts = [np.concatenate([base, rs.randint(1, 32,
                                                 size=rs.randint(1, 6))])
               for _ in range(6)]
    try:
        reqs = [router.submit(p, max_new_tokens=8,
                              tenant="acme" if i % 2 else "zeta")
                for i, p in enumerate(prompts)]
        now = 0.0
        while min(len(q.emitted) for q in reqs) < 2:
            now += 0.01
            router.pump(now)
        next(q._replica for q in reqs
             if not q.done() and q._replica is not None).kill()
        while not all(q.done() for q in reqs):
            now += 0.01
            router.pump(now)
        streams = [[int(t) for t in q.result(timeout=1)] for q in reqs]
    finally:
        router.stop()
    met.stop()
    tel.stop()
    return sink, streams


@pytest.fixture(scope="module")
def drill_sinks(tmp_path_factory):
    gc.collect()
    tag = next(_DRILL)
    tmp = tmp_path_factory.mktemp("xpkg")
    for mod in (telemetry, jtelemetry):
        mod.reset()
    out = {pkg: _armed_drill(pkg, tmp, tag) for pkg in ("jax", "port")}
    metering.stop()
    jmetering.stop()
    return out


_KINDS = ("decode", "prefix_cache", "router", "usage")


def test_serving_records_equal_the_jax_records(drill_sinks):
    (jsink, jstreams), (psink, pstreams) = drill_sinks["jax"], \
        drill_sinks["port"]
    assert pstreams == jstreams

    def records(path, kind):
        return [json.loads(line) for line in open(path)
                if json.loads(line)["type"] == kind]
    for kind in _KINDS:
        want = [_stable(r) for r in records(jsink, kind)]
        got = [_stable(r) for r in records(psink, kind)]
        assert want, kind
        assert got == want, kind
    usage = records(psink, "usage")[-1]
    assert usage["reconcile"]["ok"] and usage["totals"]["flops"] > 0
    assert usage["totals"]["prefix_hit_tokens"] > 0
    router = records(psink, "router")[-1]
    assert router["failovers"] >= 1 and router["failed"] == 0


@pytest.mark.parametrize("which", ["port", "jax"])
@pytest.mark.parametrize("fmt", ["text", "json"])
def test_diagnose_prints_what_the_jax_tool_prints(drill_sinks, capsys,
                                                  which, fmt):
    sink = drill_sinks[which][0]
    argv = [sink] + (["--format", "json"] if fmt == "json" else [])
    jdiagnose.main(argv)
    want = capsys.readouterr().out
    diagnose.main(argv)
    got = capsys.readouterr().out
    assert got == want
    if which == "port" and fmt == "text":
        for table in ("Decode", "Prefix cache", "Router", "Usage",
                      "Alerts"):
            assert "----------%s----------" % table in got
        assert "[OK]" in got and "MISMATCH" not in got
