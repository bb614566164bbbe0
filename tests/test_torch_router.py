"""Port parity: mxnet_tpu_torch.serving.router / .fleet (the fleet Router
over port DecodeServers) against the JAX package's, on the CPU.

The drills of tests/test_router.py, over port replicas: WFQ +
token-bucket multi-tenant dispatch, session affinity, graceful drain,
and transparent failover on replica loss — a streaming session whose
replica dies resumes by re-prefill replay TOKEN-IDENTICAL to an
uninterrupted run. Routers and replicas are unstarted and driven
through ``Router.pump(now)``, so every schedule, sweep and failover is
deterministic. The oracle is greedy generation by one full-sequence
prefill at each length, on the port's model with the JAX model's
weights; the cross-package tests run a JAX Router over JAX
DecodeServers and a port Router over port DecodeServers on the same
numpy weights and prompts and require the same streams and counters.
The autoscaler drills and the router's telemetry record (sink, diagnose
Router table, /metrics gauges) run as tests/test_router.py runs them."""
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from mxnet_tpu import compile_watch
from mxnet_tpu import fault as jfault
from mxnet_tpu import serving as jserving
from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch import fault
from mxnet_tpu_torch import livemetrics
from mxnet_tpu_torch import telemetry
from mxnet_tpu_torch.parallel.multihost import StrikeTracker
from mxnet_tpu_torch.serving import (DecodeServer, FleetMonitor,
                                     KVCachePool, Replica, Router,
                                     ServerClosedError,
                                     ServerOverloadedError, ToyDecoderLM,
                                     params_from_numpy)


@pytest.fixture(autouse=True)
def _clean_state():
    fault.reset()
    jfault.reset()
    compile_watch.disable()
    yield
    fault.reset()
    jfault.reset()
    compile_watch.disable()


_KW = dict(vocab=32, n_layers=1, n_heads=2, head_dim=8, max_len=128)
_JMODEL = jserving.ToyDecoderLM(**_KW)
_JPARAMS = _JMODEL.init_params(seed=3)
_MODEL = ToyDecoderLM(**_KW)
_PARAMS = params_from_numpy({k: np.asarray(v) for k, v in _JPARAMS.items()},
                            "cpu", model=_MODEL)


def _replica(name, ladder=(16, 32), max_new=12, window=4):
    return DecodeServer(_MODEL, _PARAMS, seq_ladder=list(ladder),
                        max_new_tokens=max_new, window=window,
                        page_size=8, pool_pages=64, name=name,
                        device="cpu", start=False)


def _router(n=2, **kw):
    kw.setdefault("start", False)
    kw.setdefault("probe_interval_ms", 1)
    return Router([_replica("rep-%d" % i) for i in range(n)], **kw)


def _reference(prompt, n):
    """Greedy generation by one FULL-sequence forward at each length —
    the oracle a failed-over stream must still reproduce."""
    toks = [int(t) for t in prompt]
    with torch.no_grad():
        for _ in range(n):
            logits, _, _ = _MODEL.prefill(_PARAMS, torch.tensor([toks]))
            toks.append(int(torch.argmax(logits[0, len(toks) - 1])))
    return toks[len(prompt):]


def _run(router, *reqs, limit=600, dt=0.01):
    """Pump an unstarted router (synthetic clock) until the given
    sessions complete."""
    now = 0.0
    n = 0
    while not all(r.done() for r in reqs):
        now += dt
        router.pump(now)
        n += 1
        assert n < limit, "router made no progress"
    return n


# ---------------------------------------------------------------------------
# StrikeTracker
# ---------------------------------------------------------------------------

def test_strike_tracker_two_strikes_abstain_departed():
    tr = StrikeTracker(strikes=2)
    assert not tr.observe("a", healthy=False)      # strike 1
    assert tr.observe("a", healthy=False)          # strike 2: confirmed
    tr.clear("a")
    assert not tr.observe("a", healthy=False)
    tr.abstain()                                   # starved judge
    assert not tr.observe("a", healthy=False)      # back to strike 1
    assert not tr.observe("a", healthy=True)       # healthy resets
    tr.departed("b")
    assert not tr.observe("b", healthy=False)      # clean exit exempt
    assert tr.is_departed("b")


# ---------------------------------------------------------------------------
# dispatch: least-outstanding, affinity, inflight bound
# ---------------------------------------------------------------------------

def test_router_single_replica_matches_direct_serving():
    r = _router(n=1)
    try:
        prompt = np.arange(1, 6)
        req = r.submit(prompt, max_new_tokens=8)
        _run(r, req)
        assert [int(t) for t in req.result(timeout=1)] \
            == _reference(prompt, 8)
        assert req.state == "done" and req.failovers == 0
    finally:
        r.stop()


def test_router_least_outstanding_spreads_and_affinity_holds():
    r = _router(n=2)
    try:
        a = r.submit(np.arange(1, 5), max_new_tokens=8)
        b = r.submit(np.arange(1, 7), max_new_tokens=8)
        r.pump(0.01)
        assert a._replica is not None and b._replica is not None
        assert a._replica is not b._replica
        bound = (a._replica, b._replica)
        for i in range(100):
            r.pump(0.02 + i * 0.01)
            if a.done() and b.done():
                break
            assert (a._replica or bound[0]) is bound[0]
            assert (b._replica or bound[1]) is bound[1]
        st = r.stats()
        assert st["completed"] == 2 and st["failed"] == 0
        assert [p["dispatched"] for p in st["replicas"]] == [1, 1]
    finally:
        r.stop()


def test_router_max_inflight_queues_excess():
    r = _router(n=1, max_inflight=2)
    try:
        reqs = [r.submit(np.arange(1, 4), max_new_tokens=4)
                for _ in range(3)]
        r.pump(0.01)
        assert sum(q._replica is not None for q in reqs) == 2
        assert r.stats()["queued"] == 1        # third waits its turn
        _run(r, *reqs)
        assert all(q.state == "done" for q in reqs)
    finally:
        r.stop()


# ---------------------------------------------------------------------------
# the acceptance drill: replicas die mid-stream, zero failed streams,
# token-identical resumption
# ---------------------------------------------------------------------------

def test_replica_kill_mid_stream_zero_failed_streams_token_identical():
    r = _router(n=4, strikes=2)
    rs = np.random.RandomState(7)
    try:
        prompts = [rs.randint(1, 32, size=rs.randint(3, 9))
                   for _ in range(6)]
        refs = [_reference(p, 10) for p in prompts]
        reqs = [r.submit(p, max_new_tokens=10,
                         tenant="acme" if i % 2 else "zeta")
                for i, p in enumerate(prompts)]
        now = 0.0
        while min(len(q.emitted) for q in reqs) < 2:  # all mid-stream
            now += 0.01
            r.pump(now)
        victim = reqs[0]._replica
        n_bound = sum(q._replica is victim for q in reqs)
        assert n_bound >= 1
        victim.kill()                      # futures never resolve
        while not all(q.done() for q in reqs):
            now += 0.01
            r.pump(now)
        got = [[int(t) for t in q.result(timeout=1)] for q in reqs]
        assert got == refs                 # token-identical, all six
        st = r.stats()
        assert st["failed"] == 0           # ZERO failed streams
        assert st["completed"] == 6
        assert st["replicas_lost"] == 1
        assert st["failovers"] == n_bound
        assert st["replay_tokens"] >= n_bound
        assert st["failover_resume_ms"]["p99"] > 0
        assert sum(q.failovers for q in reqs) == n_bound
    finally:
        r.stop()


def test_planned_replica_lost_fault_confirms_loss_deterministically():
    r = _router(n=2, strikes=1)
    try:
        prompt = np.arange(1, 7)
        ref = _reference(prompt, 8)
        req = r.submit(prompt, max_new_tokens=8)
        now = 0.0
        while len(req.emitted) < 3:
            now += 0.01
            r.pump(now)
        bound = req._replica.name
        step = 1 if bound == "rep-0" else 2
        fault.set_plan("replica_lost:step=%d:raise" % step)
        _run(r, req, dt=0.01)
        assert fault.stats()["injected"]["replica_lost"] == 1
        assert [int(t) for t in req.result(timeout=1)] == ref
        st = r.stats()
        assert st["replicas_lost"] == 1 and st["failovers"] == 1
        assert r.replica(bound).state == "lost"
    finally:
        fault.set_plan(None)
        r.stop()


def test_non_replayable_session_fails_typed_on_loss():
    reps = [_replica("a", ladder=(16,), max_new=12),
            _replica("b", ladder=(16,), max_new=12)]
    r = Router(reps, start=False, probe_interval_ms=1, strikes=1)
    try:
        req = r.submit(np.arange(1, 11), max_new_tokens=12)  # 10+12-1>16
        now = 0.0
        while len(req.emitted) < 7:        # 10 + 7 > 16: pinned now
            now += 0.01
            r.pump(now)
        r.replica(req._replica.name).kill()
        while not req.done():
            now += 0.01
            r.pump(now)
        assert req.state == "failed"
        with pytest.raises(ServerClosedError,
                           match="no surviving replica"):
            req.result(timeout=1)
        st = r.stats()
        assert st["failed"] == 1 and st["failovers"] == 0
    finally:
        r.stop()


def test_serve_route_fault_counted_session_survives():
    r = _router(n=1)
    try:
        fault.set_plan("serve_route:step=1:raise")
        req = r.submit(np.arange(1, 4), max_new_tokens=4)
        r.pump(0.01)
        assert req._replica is None
        assert r.stats()["route_faults"] == 1
        _run(r, req)
        assert req.state == "done"
        assert fault.stats()["injected"]["serve_route"] == 1
    finally:
        fault.set_plan(None)
        r.stop()


# ---------------------------------------------------------------------------
# graceful drain
# ---------------------------------------------------------------------------

def test_graceful_drain_finishes_streams_then_retires_replica():
    r = _router(n=2)
    try:
        req = r.submit(np.arange(1, 6), max_new_tokens=8)
        now = 0.0
        while len(req.emitted) < 2:
            now += 0.01
            r.pump(now)
        name = req._replica.name
        rep = r.drain(name, wait=False)
        assert rep.state == "draining"
        other = r.submit(np.arange(1, 4), max_new_tokens=4)
        _run(r, req, other)
        assert other._replica is None or other._replica.name != name
        assert req.state == "done" and req.failovers == 0
        assert [int(t) for t in req.result(timeout=1)] \
            == _reference(np.arange(1, 6), 8)
        while rep.state == "draining":
            now += 0.01
            r.pump(now)
        assert rep.state == "drained" and rep.server._closed
        st = r.stats()
        assert st["replicas_lost"] == 0 and st["drains"] == 1
        assert st["failed"] == 0
    finally:
        r.stop()


def test_drain_timeout_fails_over_stragglers():
    r = _router(n=2)
    try:
        req = r.submit(np.arange(1, 6), max_new_tokens=10)
        now = 0.0
        while len(req.emitted) < 2:
            now += 0.01
            r.pump(now)
        name = req._replica.name
        r.drain(name, wait=False, timeout_ms=1)
        time.sleep(0.01)                   # blow the real-time budget
        _run(r, req)
        assert req.state == "done" and req.failovers == 1
        assert [int(t) for t in req.result(timeout=1)] \
            == _reference(np.arange(1, 6), 10)
        st = r.stats()
        assert st["drain_timeouts"] == 1 and st["failovers"] == 1
        assert st["failed"] == 0
    finally:
        r.stop()


# ---------------------------------------------------------------------------
# per-tenant fairness: WFQ weights + token-bucket quotas
# ---------------------------------------------------------------------------

def test_wfq_flooding_tenant_cannot_starve_light_one():
    r = _router(n=1, max_inflight=1,
                tenants={"light": {"weight": 2.0},
                         "flood": {"weight": 1.0}})
    try:
        order = []
        flood = [r.submit(np.arange(1, 5), max_new_tokens=4,
                          tenant="flood") for _ in range(8)]
        light = [r.submit(np.arange(1, 5), max_new_tokens=4,
                          tenant="light") for _ in range(2)]
        every = [("f%d" % i, q) for i, q in enumerate(flood)] \
            + [("l%d" % i, q) for i, q in enumerate(light)]
        now, n = 0.0, 0
        while not all(q.done() for _, q in every):
            now += 0.01
            r.pump(now)
            for tag, q in every:
                if q.done() and tag not in order:
                    order.append(tag)
            n += 1
            assert n < 2000
        assert set(order[:3]) >= {"l0", "l1"}, order
        st = r.stats()
        assert st["completed"] == 10 and st["failed"] == 0
        lat = st["tenants"]["light"]["latency_ms"]["p99"]
        flat = st["tenants"]["flood"]["latency_ms"]["p99"]
        assert lat <= flat
    finally:
        r.stop()


def test_token_bucket_throttles_tenant_rate():
    r = _router(n=1, tenants={"t": {"rate": 10.0, "burst": 8.0}})
    try:
        a = r.submit(np.arange(1, 5), max_new_tokens=4, tenant="t")
        b = r.submit(np.arange(1, 5), max_new_tokens=4, tenant="t")
        now = 10.0
        r.pump(now)
        assert a._replica is not None      # burst covered the first
        assert b._replica is None          # bucket empty for the next
        for _ in range(20):                # refill too slow at +10ms
            now += 0.01
            r.pump(now)
        assert b._replica is None and not b.done()
        now += 0.8                         # 0.8s * 10/s = 8 tokens
        r.pump(now)
        assert b._replica is not None      # refilled: dispatched
        _run(r, a, b)
        assert a.state == "done" and b.state == "done"
        assert r.stats()["tenants"]["t"]["throttled"] > 0
        assert r.stats()["throttles"] > 0
    finally:
        r.stop()


def test_tenant_queue_bound_sheds_lowest_priority(monkeypatch):
    monkeypatch.setenv("MXNET_ROUTER_TENANT_QUEUE", "2")
    r = _router(n=1, max_inflight=1)
    try:
        r.submit(np.arange(1, 4), max_new_tokens=4)   # occupies replica
        r.pump(0.01)
        low = [r.submit(np.arange(1, 4), max_new_tokens=4, priority=0)
               for _ in range(2)]
        high = r.submit(np.arange(1, 4), max_new_tokens=4, priority=2)
        assert low[1].done()
        with pytest.raises(ServerOverloadedError,
                           match=r"priority 0.*priority-2"):
            low[1].result(timeout=1)
        with pytest.raises(ServerOverloadedError, match="tenant queue"):
            r.submit(np.arange(1, 4), max_new_tokens=4, priority=0)
        st = r.stats()
        assert st["shed"] == 2
        _run(r, low[0], high)
    finally:
        r.stop()


def test_cancel_queued_session_reaped_before_dispatch():
    r = _router(n=1, max_inflight=1)
    try:
        busy = r.submit(np.arange(1, 4), max_new_tokens=4)
        r.pump(0.01)
        queued = r.submit(np.arange(1, 4), max_new_tokens=4)
        queued.cancel()
        r.pump(0.02)
        assert queued.done() and queued.state == "cancelled"
        assert list(queued.tokens(timeout=1)) == []   # clean end
        _run(r, busy)
        assert r.stats()["cancelled"] == 1
    finally:
        r.stop()


# ---------------------------------------------------------------------------
# admission errors and stop
# ---------------------------------------------------------------------------

def test_router_admission_validation():
    r = _router(n=1)
    try:
        with pytest.raises(MXNetError, match="non-empty 1-D"):
            r.submit(np.zeros((2, 2), np.int32))
        with pytest.raises(MXNetError, match="ladder top"):
            r.submit(np.arange(1, 40))
        with pytest.raises(MXNetError, match="max_new_tokens"):
            r.submit(np.arange(1, 4), max_new_tokens=0)
        with pytest.raises(MXNetError, match="MXNET_SERVING_PRIORITIES"):
            r.submit(np.arange(1, 4), priority=99)
    finally:
        r.stop()
    with pytest.raises(ServerClosedError, match="stopped"):
        r.submit(np.arange(1, 4))


def test_router_stop_drains_and_types_out_leftovers():
    r = _router(n=1)
    done = r.submit(np.arange(1, 4), max_new_tokens=4)
    r.stop(drain=True)                     # finishes queued work first
    assert done.state == "done" and len(done.result(timeout=1)) == 4
    r2 = _router(n=1)
    doomed = r2.submit(np.arange(1, 4), max_new_tokens=4)
    r2.stop(drain=False)
    with pytest.raises(ServerClosedError, match=doomed.request_id):
        doomed.result(timeout=1)


# ---------------------------------------------------------------------------
# autoscaler hook
# ---------------------------------------------------------------------------

class _FakeWatchdog:
    def __init__(self):
        self.counts = {}

    def alerts(self):
        return dict(self.counts)


def test_autoscaler_scale_up_on_watchdog_pressure(monkeypatch):
    wd = _FakeWatchdog()
    monkeypatch.setattr(livemetrics, "_watchdog", wd)
    calls = []
    r = _router(n=1, supervisor=lambda action, router, info:
                calls.append((action, info)))
    try:
        r.pump(0.01)
        assert calls == []                 # no pressure, no signal
        wd.counts["serving_queue_full"] = 2
        r.pump(0.02)
        r.pump(0.03)                       # same pressure: no re-fire
        assert [c[0] for c in calls] == ["scale_up"]
        assert calls[0][1]["alerts"]["serving_queue_full"] == 2
        wd.counts["serving_shed_rate"] = 1
        r.pump(0.04)                       # NEW pressure re-fires
        assert [c[0] for c in calls] == ["scale_up", "scale_up"]
        assert r.stats()["scale_up_signals"] == 2
    finally:
        r.stop()


def test_autoscaler_scale_down_after_idle_rounds(monkeypatch):
    monkeypatch.setenv("MXNET_ROUTER_AUTOSCALE_IDLE_ROUNDS", "3")
    calls = []
    r = _router(n=2, supervisor=lambda action, router, info:
                calls.append((action, info)))
    try:
        for i in range(6):
            r.pump(0.01 * (i + 1))
        assert [c[0] for c in calls] == ["scale_down"]   # fires ONCE
        assert calls[0][1]["replicas_up"] == 2
        assert r.stats()["scale_down_signals"] == 1
        # a broken callback is survived (warned, not raised)
        r2 = _router(n=2, supervisor=lambda *a: 1 / 0)
        with pytest.warns(UserWarning, match="supervisor callback"):
            for i in range(4):
                r2.pump(0.01 * (i + 1))
        r2.stop()
    finally:
        r.stop()


def test_router_telemetry_records_diagnose_table_and_metrics(tmp_path):
    sink = str(tmp_path / "run.jsonl")
    telemetry.start(filename=sink, run_id="router-test")
    try:
        r = Router([_replica("rt-%d" % i) for i in range(2)], name="fleet",
                   start=False, probe_interval_ms=1, strikes=1)
        req = r.submit(np.arange(1, 5), max_new_tokens=6)
        now = 0.0
        while len(req.emitted) < 2:
            now += 0.01
            r.pump(now)
        r.replica(req._replica.name).kill()
        _run(r, req)
        page = livemetrics.render()
        assert 'mxnet_router_failovers_total{router="fleet"} 1' in page
        assert 'mxnet_router_replicas_up{router="fleet"} 1' in page
        assert 'mxnet_router_replica_outstanding_tokens{' in page
        r.stop()                           # final record
    finally:
        telemetry.stop()
    recs = [json.loads(line) for line in open(sink) if line.strip()]
    last = [x for x in recs if x.get("type") == "router"][-1]
    assert last["name"] == "fleet"
    assert last["completed"] == 1 and last["failovers"] == 1
    assert last["replicas_lost"] == 1
    assert last["failover_resume_ms"]["p99"] > 0
    summary = [x for x in recs if x.get("type") == "summary"][-1]
    assert summary["router"]["fleet"]["failovers"] == 1
    out = subprocess.run(
        [sys.executable, "-m", "mxnet_tpu_torch.tools.diagnose", sink],
        capture_output=True, text=True,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert out.returncode == 0, out.stderr
    assert "----------Router----------" in out.stdout
    assert "re-homed" in out.stdout and "resume" in out.stdout


# ---------------------------------------------------------------------------
# fleet plumbing
# ---------------------------------------------------------------------------

def test_default_replica_name_reads_worker_contract(monkeypatch):
    from mxnet_tpu_torch.serving.fleet import default_replica_name
    from mxnet_tpu_torch.tools.launch import worker_contract
    for k in ("DMLC_ROLE", "DMLC_WORKER_ID", "DMLC_NUM_WORKER"):
        monkeypatch.delenv(k, raising=False)
    assert worker_contract() is None
    assert default_replica_name(3) == "replica-3"
    monkeypatch.setenv("DMLC_ROLE", "worker")
    monkeypatch.setenv("DMLC_WORKER_ID", "2")
    monkeypatch.setenv("DMLC_NUM_WORKER", "4")
    monkeypatch.setenv("DMLC_PS_ROOT_PORT", "9500")
    c = worker_contract()
    assert c["rank"] == 2 and c["world"] == 4 and c["port"] == 9500
    assert default_replica_name(0) == "replica-2"


def test_fleet_monitor_starved_judge_abstains_on_slow_only():
    class _Slow:
        _closed = False
        _started = True

        class _thread:
            @staticmethod
            def is_alive():
                return True

        @staticmethod
        def stats():
            raise RuntimeError("wedged")

    mon = FleetMonitor(strikes=1, interval_ms=10)
    slow = Replica(_Slow(), name="slow")
    dead = Replica(_Slow(), name="dead")
    dead.killed = True
    assert mon.check([slow], now=1.0) == [slow]    # not starved: judged
    mon2 = FleetMonitor(strikes=1, interval_ms=10)
    mon2.check([], now=1.0)
    lost = mon2.check([slow, dead], now=2.0)       # 1s gap >> 20ms
    assert lost == [dead]                  # "down" is never suppressed


def test_failover_replay_hits_dead_replicas_shared_prefix_pages():
    pool = KVCachePool(1, 2, 8, page_size=8, n_pages=64, device="cpu")
    reps = [DecodeServer(_MODEL, _PARAMS, seq_ladder=[16, 32],
                         max_new_tokens=12, window=4, pool=pool,
                         share_group="m0", prefix_cache=True,
                         name="rep-%d" % i, start=False)
            for i in range(2)]
    r = Router(reps, start=False, probe_interval_ms=1, strikes=2)
    try:
        prompt = np.arange(10, 22)         # 12 tokens: 1 full page
        ref = _reference(prompt, 10)
        req = r.submit(prompt, max_new_tokens=10)
        now = 0.0
        while len(req.emitted) < 3:
            now += 0.01
            r.pump(now)
        req._replica.kill()
        _run(r, req)
        assert [int(t) for t in req.result(timeout=1)] == ref
        st = r.stats()
        assert st["failovers"] == 1 and st["failed"] == 0
        assert st["replay_cached_tokens"] >= 8
        assert st["replay_tokens"] > st["replay_cached_tokens"]
        hits = sum(s.stats()["prefix"]["hits"] for s in reps)
        assert hits >= 1
    finally:
        r.stop()


# ---------------------------------------------------------------------------
# cross-package: a JAX Router over JAX DecodeServers and a port Router
# over port DecodeServers, same weights, same prompts
# ---------------------------------------------------------------------------

def _jax_router(n, **kw):
    reps = [jserving.DecodeServer(_JMODEL, _JPARAMS, seq_ladder=[16, 32],
                                  max_new_tokens=12, window=4, page_size=8,
                                  pool_pages=64, name="rep-%d" % i,
                                  start=False) for i in range(n)]
    return jserving.Router(reps, start=False, probe_interval_ms=1, **kw)


def _drill(router, kill_after):
    """Six sessions over two tenants; with ``kill_after`` the replica of
    session 0 is killed once every session has streamed that many
    tokens. Returns the streams and the router's counters."""
    rs = np.random.RandomState(11)
    prompts = [rs.randint(1, 32, size=rs.randint(3, 15))
               for _ in range(6)]
    reqs = [router.submit(p, max_new_tokens=10,
                          tenant="acme" if i % 2 else "zeta")
            for i, p in enumerate(prompts)]
    now = 0.0
    if kill_after:
        while min(len(q.emitted) for q in reqs) < kill_after:
            now += 0.01
            router.pump(now)
        reqs[0]._replica.kill()
    while not all(q.done() for q in reqs):
        now += 0.01
        router.pump(now)
    st = router.stats()
    keys = ("completed", "failed", "failovers", "replicas_lost",
            "replay_tokens", "dispatched")
    return ([[int(t) for t in q.result(timeout=1)] for q in reqs],
            {k: st[k] for k in keys})


@pytest.mark.parametrize("kill_after", [0, 3], ids=["steady", "kill"])
def test_router_streams_token_identical_to_jax(kill_after):
    jr, tr = _jax_router(3, strikes=2), _router(n=3, strikes=2)
    try:
        want = _drill(jr, kill_after)
        got = _drill(tr, kill_after)
        assert got == want
        assert got[1]["failed"] == 0 and got[1]["completed"] == 6
        assert (got[1]["replicas_lost"] == 1) == bool(kill_after)
    finally:
        jr.stop()
        tr.stop()
