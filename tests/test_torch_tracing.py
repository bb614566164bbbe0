"""Port parity: mxnet_tpu_torch.tracing against mxnet_tpu.tracing, on the
CPU.

The drills of tests/test_tracing.py and tests/test_fleet_obs.py over
the port: the always-cheap-when-off contract (a shared no-op span, a
sink and wire payloads byte-identical to a run without the tracer), the
bounded ring and track table, the wire context's round trip and its
interop with the JAX tracer in both directions, merge_exports (the
port's merge of two exports equals the JAX merge of the same inputs),
and the serving spans of a routed port fleet nesting causally under
one request id. Routers and replicas are unstarted and driven through
``Router.pump(now)``."""
import json
import os

import numpy as np
import pytest
import torch

from mxnet_tpu import serving as jserving
from mxnet_tpu import tracing as jtracing
from mxnet_tpu_torch import fault, metering, telemetry, tracing
from mxnet_tpu_torch.serving import (DecodeServer, Router, ToyDecoderLM,
                                     params_from_numpy)


@pytest.fixture(autouse=True)
def _clean_state():
    fault.reset()
    telemetry.reset()
    tracing.reset()
    jtracing.reset()
    yield
    fault.reset()
    telemetry.reset()
    tracing.reset()
    jtracing.reset()


_KW = dict(vocab=32, n_layers=1, n_heads=2, head_dim=8, max_len=128)
_JPARAMS = jserving.ToyDecoderLM(**_KW).init_params(seed=3)
_MODEL = ToyDecoderLM(**_KW)
_PARAMS = params_from_numpy({k: np.asarray(v) for k, v in _JPARAMS.items()},
                            "cpu", model=_MODEL)


def _fleet(n=2, **kw):
    reps = [DecodeServer(_MODEL, _PARAMS, seq_ladder=[16, 32],
                         max_new_tokens=12, window=4, page_size=8,
                         pool_pages=64, name="rep-%d" % i, device="cpu",
                         start=False)
            for i in range(n)]
    kw.setdefault("start", False)
    kw.setdefault("probe_interval_ms", 1)
    return Router(reps, name="front", **kw)


def _pump(router, reqs, now=0.0, until=None, limit=800):
    n = 0
    while not (until() if until else all(q.done() for q in reqs)):
        now += 0.01
        router.pump(now)
        n += 1
        assert n < limit, "router made no progress"
    return now


def _events(name=None, cat=None, ph=None):
    return [e for e in tracing.export()["traceEvents"]
            if (name is None or e["name"] == name)
            and (cat is None or e.get("cat") == cat)
            and (ph is None or e["ph"] == ph)]


def _contains(parent, child, tol=2.0):
    return child["ts"] >= parent["ts"] - tol and \
        child["ts"] + child["dur"] <= parent["ts"] + parent["dur"] + tol


# ---------------------------------------------------------------------------
# the off path
# ---------------------------------------------------------------------------

def test_off_by_default_zero_allocation_span():
    assert not tracing.enabled()
    assert tracing.span("a") is tracing.span("b")     # one singleton
    assert tracing.track("x") is None
    assert tracing.context() is None
    assert tracing.stats() is None
    assert tracing.wire_context(request_id="x") is None
    assert tracing.adopt_context({"v": 1, "pid": 1}) is None
    tracing.add("n", "c", 0.0, 1.0)                   # dropped
    tracing.instant("n", "c")
    with pytest.raises(RuntimeError):
        tracing.export()


def _routed_streams(sink):
    telemetry.start(filename=sink, run_id="off")
    r = _fleet(n=2)
    sent = []
    for rep in r._replicas:                  # record each wire payload
        submit = rep.server.submit

        def spy(prompt, _submit=submit, **kw):
            sent.append(kw.get("trace_ctx"))
            return _submit(prompt, **kw)
        rep.server.submit = spy
    reqs = [r.submit(np.arange(1, 6 + i), max_new_tokens=6)
            for i in range(3)]
    try:
        _pump(r, reqs)
    finally:
        r.stop()
    telemetry.stop()
    with open(sink) as f:
        recs = [json.loads(line) for line in f]
    return [[int(t) for t in q.result(timeout=1)] for q in reqs], sent, recs


def test_off_path_sink_and_wire_byte_identical(tmp_path, monkeypatch):
    """Disarmed, every dispatch carries ``trace_ctx=None`` and the sink
    holds only the serving kinds; with ``MXNET_TRACE_WIRE=0`` an armed
    tracer leaves the streams, the wire payloads and the sink's records
    (kinds and fields) exactly as the disarmed run's."""
    streams, sent, recs = _routed_streams(str(tmp_path / "off.jsonl"))
    assert sent and all(ctx is None for ctx in sent)
    kinds = {r["type"] for r in recs}
    assert kinds <= {"run_start", "decode", "router", "summary"}
    assert telemetry._recent is None and telemetry._flight_alert is None
    tracing.enable()
    monkeypatch.setenv("MXNET_TRACE_WIRE", "0")
    streams2, sent2, recs2 = _routed_streams(str(tmp_path / "wire0.jsonl"))
    assert streams2 == streams
    assert sent2 == sent

    def shape(rs):
        return [(r["type"], sorted(r)) for r in rs]
    assert shape(recs2) == shape(recs)


# ---------------------------------------------------------------------------
# ring and track bounds
# ---------------------------------------------------------------------------

def test_ring_bound_drops_oldest(monkeypatch):
    monkeypatch.setenv("MXNET_TRACE_RING", "16")
    tracing.enable()
    for i in range(50):
        tracing.instant("e%d" % i, "t")
    assert tracing.stats() == {"events": 16, "dropped": 34, "tracks": 0}
    names = [e["name"] for e in tracing.export()["traceEvents"]]
    assert names[-1] == "e49"


def test_track_table_bounded_newest_labels_win(monkeypatch):
    monkeypatch.setenv("MXNET_TRACE_TRACKS", "16")
    tracing.enable()
    tids = [tracing.track("req r%06d" % i) for i in range(40)]
    assert len(set(tids)) == 40
    assert tracing.stats()["tracks"] == 16
    metas = [e["args"]["name"] for e in tracing.export()["traceEvents"]
             if e["ph"] == "M"]
    assert metas == ["req r%06d" % i for i in range(24, 40)]
    assert tracing.track("req r000039") == tids[39]


def test_exported_chrome_json_validates(tmp_path):
    tracing.enable()
    r = _fleet(n=1)
    try:
        _pump(r, [r.submit(np.arange(1, 5), max_new_tokens=3)])
    finally:
        r.stop()
    path = str(tmp_path / "trace.json")
    assert tracing.export(path) == path
    with open(path) as f:
        trace = json.load(f)
    assert trace["traceEvents"] and trace["displayTimeUnit"] == "ms"
    for e in trace["traceEvents"]:
        assert "name" in e and "ph" in e and "pid" in e and "tid" in e
        if e["ph"] == "X":
            assert e["dur"] >= 0 and e["ts"] >= 0
        if e["ph"] in ("X", "i"):
            assert "cat" in e
    assert not os.path.exists(path + ".%d.tmp" % os.getpid())


# ---------------------------------------------------------------------------
# the wire context
# ---------------------------------------------------------------------------

def test_wire_context_round_trip_carries_identity_and_samples():
    tracing.enable()
    ctx = tracing.wire_context(request_id="r1", tenant="acme")
    assert ctx["v"] == 1 and ctx["pid"] == os.getpid()
    assert ctx["request_id"] == "r1" and ctx["tenant"] == "acme"
    args = tracing.adopt_context(ctx)
    assert args["request_id"] == "r1" and args["origin_pid"] == ctx["pid"]
    assert "wall_skew_ms" in args
    exp = tracing.export()
    wire = [e for e in exp["traceEvents"]
            if e.get("cat") == "wire" and e["ph"] == "i"]
    assert wire and wire[0]["args"]["request_id"] == "r1"
    assert exp["otherData"]["wire_samples"][0]["origin_pid"] == ctx["pid"]


def test_step_context_rides_the_wire():
    tracing.enable()
    telemetry.start(run_id="steps")
    assert tracing.wire_context()["step"] == 1      # the OPEN step
    telemetry.step_tick()
    telemetry.step_tick()
    assert tracing.wire_context()["step"] == 2
    telemetry.stop()


def test_contexts_interoperate_with_the_jax_tracer():
    """A context either tracer writes, the other adopts with the same
    identity args; a JAX router's context joins a port replica's spans
    under the router's request id."""
    tracing.enable()
    jtracing.enable()
    pctx = tracing.wire_context(request_id="s1", tenant="acme")
    jctx = jtracing.wire_context(request_id="s1", tenant="acme")
    assert sorted(pctx) == sorted(jctx)

    def ident(args):
        return {k: v for k, v in args.items() if k != "wall_skew_ms"}
    assert ident(jtracing.adopt_context(pctx)) \
        == ident(tracing.adopt_context(pctx))
    assert ident(tracing.adopt_context(jctx)) \
        == ident(jtracing.adopt_context(jctx))
    srv = DecodeServer(_MODEL, _PARAMS, seq_ladder=[16], max_new_tokens=3,
                       window=2, page_size=8, pool_pages=16, device="cpu",
                       start=False)
    try:
        req = srv.submit(np.arange(1, 5), trace_ctx=jctx)
        while not req.done():
            srv._tick()
    finally:
        srv.stop()
    spans = [e for e in _events(ph="X", cat="decode")
             if e["args"]["request_id"] == "s1"]
    assert {e["name"] for e in spans} == {"queue", "prefill", "decode"}
    assert all(e["args"]["server_request_id"] == req.request_id
               for e in spans)
    adopted = _events(name="ctx:submit", cat="wire")
    assert adopted[0]["args"]["origin_pid"] == jctx["pid"]


# ---------------------------------------------------------------------------
# merge_exports
# ---------------------------------------------------------------------------

def _fake_export(pid, rank, t0_wall, events, dropped=0):
    return {"traceEvents": [
        {"name": n, "cat": "test", "ph": "X", "pid": pid, "tid": 1,
         "ts": ts, "dur": dur, "args": {}} for n, ts, dur in events],
        "displayTimeUnit": "ms",
        "otherData": {"pid": pid, "trace_t0_wall": t0_wall,
                      "dropped_events": dropped, "rank": rank, "gen": 0}}


def test_merge_hand_skewed_clocks_nest_causally():
    a = _fake_export(100, 0, 1000.0, [("parent", 0.0, 4_000_000.0)])
    b = _fake_export(200, 1, 1002.5, [("child", 100.0, 1000.0)])
    merged = tracing.merge_exports([a, b])
    evs = {e["name"]: e for e in merged["traceEvents"] if e["ph"] == "X"}
    assert evs["parent"]["ts"] == 0.0
    assert evs["child"]["ts"] == pytest.approx(2.5e6 + 100.0)
    assert _contains(evs["parent"], evs["child"], tol=0.0)
    shifts = {p["rank"]: p["shift_us"]
              for p in merged["otherData"]["processes"]}
    assert shifts == {0: 0.0, 1: pytest.approx(2.5e6)}


def test_merge_pid_collision_remapped_and_file_round_trip(tmp_path):
    a = _fake_export(77, 0, 5.0, [("a", 0.0, 10.0)], dropped=2)
    b = _fake_export(77, 1, 6.0, [("b", 0.0, 10.0)], dropped=3)
    pa = tmp_path / "a.json"
    pa.write_text(json.dumps(a))
    out = tmp_path / "merged.json"
    assert tracing.merge_exports([str(pa), b], path=str(out)) == str(out)
    merged = json.loads(out.read_text())
    assert len({e["pid"] for e in merged["traceEvents"]
                if e["ph"] == "X"}) == 2
    assert merged["otherData"]["dropped_events"] == 5
    with pytest.raises(ValueError, match="trace_t0_wall"):
        tracing.merge_exports([{"traceEvents": [], "otherData": {}}])
    with pytest.raises(ValueError, match="no inputs"):
        tracing.merge_exports([])


def _real_exports(tmp_path):
    """One export from the port's tracer over a routed session, one
    from the JAX tracer over the same session on a JAX fleet."""
    tracing.enable()
    r = _fleet(n=1)
    try:
        _pump(r, [r.submit(np.arange(1, 6), max_new_tokens=4,
                           tenant="acme")])
    finally:
        r.stop()
    jtracing.enable()
    jr = jserving.Router(
        [jserving.DecodeServer(jserving.ToyDecoderLM(**_KW), _JPARAMS,
                               seq_ladder=[16, 32], max_new_tokens=12,
                               window=4, page_size=8, pool_pages=64,
                               name="rep-0", start=False)],
        name="front", start=False, probe_interval_ms=1)
    try:
        _pump(jr, [jr.submit(np.arange(1, 6), max_new_tokens=4,
                             tenant="acme")])
    finally:
        jr.stop()
    pp, pj = str(tmp_path / "port.json"), str(tmp_path / "jax.json")
    tracing.export(pp)
    jtracing.export(pj)
    return [pp, pj]


@pytest.mark.parametrize("inputs", ["skewed", "routed"])
def test_merge_equals_the_jax_merge(tmp_path, inputs):
    if inputs == "skewed":
        srcs = [_fake_export(7, 0, 10.0, [("p", 0.0, 50.0)], dropped=1),
                _fake_export(7, 1, 10.25, [("c", 3.0, 4.0)]),
                _fake_export(9, 2, 9.5, [("q", 1.0, 2.0)])]
    else:
        srcs = _real_exports(tmp_path)
    assert tracing.merge_exports(srcs) == jtracing.merge_exports(srcs)


# ---------------------------------------------------------------------------
# serving spans across the router and its replicas
# ---------------------------------------------------------------------------

def test_routed_session_spans_nest_causally():
    """Router-side and replica-side spans of each session join under its
    request id on one named track, in causal order: router queue, then
    the replica's queue, prefill and decode, the decode span covering
    the rest of the stream."""
    tracing.enable()
    r = _fleet(n=2)
    try:
        reqs = [r.submit(np.arange(1, 6 + i), max_new_tokens=6,
                         tenant="acme" if i % 2 else "zeta")
                for i in range(4)]
        _pump(r, reqs)
    finally:
        r.stop()
    by_req = {}
    for e in _events(ph="X"):
        rid = (e.get("args") or {}).get("request_id")
        if rid is not None:
            by_req.setdefault(rid, []).append(e)
    for q in reqs:
        evs = {(e["cat"], e["name"]): e for e in by_req[q.request_id]}
        assert set(evs) == {("router", "queue"), ("decode", "queue"),
                            ("decode", "prefill"), ("decode", "decode")}
        rq, dq = evs["router", "queue"], evs["decode", "queue"]
        pf, dc = evs["decode", "prefill"], evs["decode", "decode"]
        assert rq["ts"] <= dq["ts"] <= pf["ts"] <= dc["ts"]
        assert pf["ts"] + pf["dur"] <= dc["ts"] + 2.0
        assert dc["args"]["tokens"] == 6 and dc["args"]["outcome"] == "ok"
        assert pf["args"]["rung"] == 16
        assert len({e["tid"] for e in by_req[q.request_id]}) == 1
    insts = {e["name"] for e in _events(ph="i", cat="router")}
    assert "router:dispatch" in insts


def test_trainer_step_trace_nests_the_optimizer_phase():
    import mxnet_tpu_torch as mx
    tracing.enable()
    telemetry.start(run_id="gluon")
    with mx.cpu():
        net = mx.gluon.nn.Dense(3, in_units=4)
        net.initialize(mx.init.Xavier())
        trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                                   {"learning_rate": 0.1})
        x = mx.nd.array(np.ones((2, 4), np.float32))
        for _ in range(3):
            with mx.autograd.record():
                loss = net(x).sum()
            loss.backward()
            trainer.step(2)
    telemetry.stop()
    steps = _events(name="step", ph="X")
    assert [e["args"]["seq"] for e in steps] == [1, 2]   # tick mode
    opt = sorted(_events(name="optimizer", cat="phase"),
                 key=lambda e: e["ts"])
    assert len(opt) == 3
    for ph, st in zip(opt[1:], steps):
        assert ph["args"]["step"] == st["args"]["seq"]
        assert _contains(st, ph) and ph["tid"] == st["tid"]
    assert not metering.enabled()
    assert torch.is_grad_enabled()
