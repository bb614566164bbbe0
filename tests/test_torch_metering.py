"""Port parity: mxnet_tpu_torch.metering against mxnet_tpu.metering, on
the CPU, and the decode server's program costs.

The drills of tests/test_metering.py over port replicas: the failover
ledger reconciling (dual-entry books, replay tokens billed exactly
once, prefix credits equal to the pool's hit counters, diagnose's Usage
line ``[OK]``), the raw-ledger diagnose, the off path, the
unattributed bucket, the ledger's cadence and bounded tail, training
accounting, and the usage record, /metrics families and flight-recorder
block. The JAX server bills each program's ``cost_analysis`` FLOPs;
the port bills an analytic count of each program
(``DecodeServer.program_costs``), held here to
``torch.utils.flop_counter.FlopCounterMode`` over the eager plain body
of each program, and billed FLOPs and bytes are held to the program
counts times the dispatches counted by the graph holder (driven on the
CPU through a stand-in capture)."""
import json

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import mxnet_tpu_torch as mx
from mxnet_tpu import serving as jserving
from mxnet_tpu.tools import diagnose as jdiagnose
from mxnet_tpu_torch import (fault, flightrec, livemetrics, metering,
                             telemetry)
from mxnet_tpu_torch.serving import (DecodeServer, KVCachePool, Router,
                                     ToyDecoderLM, params_from_numpy)
from mxnet_tpu_torch.serving import decode as tdecode
from mxnet_tpu_torch.tools import diagnose


@pytest.fixture(autouse=True)
def _clean_state():
    fault.reset()
    telemetry.reset()
    metering.stop()
    yield
    metering.stop()
    fault.reset()
    telemetry.reset()


_KW = dict(vocab=32, n_layers=1, n_heads=2, head_dim=8, max_len=128)
_JPARAMS = jserving.ToyDecoderLM(**_KW).init_params(seed=3)
_MODEL = ToyDecoderLM(**_KW)
_PARAMS = params_from_numpy({k: np.asarray(v) for k, v in _JPARAMS.items()},
                            "cpu", model=_MODEL)


def _replica(name, **kw):
    kw.setdefault("seq_ladder", [16, 32])
    kw.setdefault("max_new_tokens", 12)
    kw.setdefault("window", 4)
    if "pool" not in kw:
        kw.setdefault("page_size", 8)
        kw.setdefault("pool_pages", 64)
        kw.setdefault("device", "cpu")
    kw.setdefault("start", False)
    return DecodeServer(_MODEL, _PARAMS, name=name, **kw)


def _router(n=2, **kw):
    kw.setdefault("start", False)
    kw.setdefault("probe_interval_ms", 1)
    return Router([_replica("rep-%d" % i) for i in range(n)], **kw)


def _run(router, *reqs, limit=2000, dt=0.01, now=0.0):
    n = 0
    while not all(r.done() for r in reqs):
        now += dt
        router.pump(now)
        n += 1
        assert n < limit, "router made no progress"
    return now


# ---------------------------------------------------------------------------
# the headline drill
# ---------------------------------------------------------------------------

def test_replica_kill_failover_ledger_reconciles_ok(tmp_path, capsys):
    """Two tenants on three replicas over ONE shared prefix pool, one
    replica killed mid-stream: the books balance, replay tokens equal
    the router's own counter (billed once), prefix credits equal the
    pools' hit counters, every tenant pays FLOPs and page-seconds, and
    both packages' diagnose tools render the same Usage table with
    ``[OK]``."""
    sink = str(tmp_path / "run.jsonl")
    ledger = str(tmp_path / "ledger.jsonl")
    telemetry.start(filename=sink)
    metering.start(name="fleet", path=ledger, flush_every=4)
    pool = KVCachePool(1, 2, 8, page_size=8, n_pages=96, device="cpu")
    servers = [_replica("rep-%d" % i, pool=pool, share_group="m0",
                        prefix_cache=True) for i in range(3)]
    r = Router(servers, start=False, probe_interval_ms=1, strikes=2)
    rs = np.random.RandomState(0)
    try:
        base = rs.randint(1, 32, size=8)
        prompts = [np.concatenate([base, rs.randint(1, 32,
                                                     size=rs.randint(1, 6))])
                   for _ in range(8)]
        reqs = [r.submit(p, max_new_tokens=8,
                         tenant="acme" if i % 2 else "zeta")
                for i, p in enumerate(prompts)]
        now = 0.0
        while min(len(q.emitted) for q in reqs) < 2:
            now += 0.01
            r.pump(now)
        victim = next(q._replica for q in reqs
                      if not q.done() and q._replica is not None)
        victim.kill()
        _run(r, *reqs, now=now)
        st = r.stats()
        assert st["failed"] == 0 and st["completed"] == 8
        assert st["replicas_lost"] == 1 and st["failovers"] >= 1
        snap = metering.snapshot()
        assert snap["reconcile"]["ok"], snap["reconcile"]
        assert snap["admitted"] == st["requests"] == 8
        assert snap["closed"] == 8 and snap["open"] == 0
        assert snap["outcomes"] == {"completed": 8}
        assert snap["totals"]["replay_tokens"] == st["replay_tokens"]
        assert snap["totals"]["failovers"] == st["failovers"]
        assert snap["totals"]["replay_cached_tokens"] \
            == st["replay_cached_tokens"]
        hit_tokens = sum(s.stats()["prefix"]["hit_tokens"]
                         for s in servers)
        assert hit_tokens > 0
        assert snap["totals"]["prefix_hit_tokens"] == hit_tokens
        assert snap["totals"]["flops"] > 0
        assert snap["totals"]["page_seconds"] > 0
        for t in snap["tenants"].values():
            assert t["flops"] > 0 and t["page_seconds"] > 0
        assert metering.UNATTRIBUTED not in snap["tenants"]
    finally:
        r.stop()
    metering.stop()
    telemetry.stop()
    lines = [json.loads(line) for line in open(ledger)]
    assert len(lines) == 8
    assert all(line["type"] == "usage_record" for line in lines)
    assert sum(line["replay_tokens"] for line in lines) \
        == st["replay_tokens"]
    replayed = [line for line in lines if line["failovers"]]
    assert replayed and all(line["replica"] != victim.name
                            for line in replayed)
    jdiagnose.main([sink])
    want = capsys.readouterr().out
    diagnose.main([sink])
    out = capsys.readouterr().out
    assert out == want
    assert "----------Usage----------" in out
    assert "[OK]" in out and "[MISMATCH]" not in out
    j = diagnose.telemetry_json(diagnose.read_telemetry(sink))
    assert j["usage"]["fleet"]["reconciled"] is True


def test_diagnose_reads_raw_ledger_directly(tmp_path, capsys):
    ledger = str(tmp_path / "ledger.jsonl")
    metering.start(name="fleet", path=ledger, flush_every=1)
    r = _router(n=1)
    try:
        _run(r, r.submit(np.arange(1, 6), max_new_tokens=4, tenant="acme"))
    finally:
        r.stop()
    metering.stop()
    diagnose.main([ledger])
    out = capsys.readouterr().out
    assert "synthesized from raw ledger lines" in out
    assert "tenant acme" in out
    jdiagnose.main([ledger])
    assert capsys.readouterr().out == out


def test_prefix_hit_credit_equals_pool_hit_counters():
    metering.start(name="fleet")
    srv = _replica("rep-0", prefix_cache=True, seq_ladder=[32],
                   max_new_tokens=4)
    r = Router([srv], start=False, probe_interval_ms=1)
    base = np.arange(1, 13)
    try:
        now = _run(r, r.submit(base, max_new_tokens=4, tenant="acme"))
        _run(r, r.submit(np.concatenate([base, [13, 14]]),
                         max_new_tokens=4, tenant="acme"), now=now)
        st = srv.stats()["prefix"]
        assert st["hits"] == 1 and st["hit_tokens"] > 0
        snap = metering.snapshot()
        acct = snap["tenants"]["acme"]
        assert acct["prefix_hit_tokens"] == st["hit_tokens"]
        assert acct["prefix_bytes_saved"] == st["bytes_saved"]
        assert snap["reconcile"]["ok"]
    finally:
        r.stop()


# ---------------------------------------------------------------------------
# the off path, ledger mechanics, training accounting
# ---------------------------------------------------------------------------

def test_meter_off_every_hook_is_a_noop():
    assert not metering.enabled()
    metering.request_admitted("t", "r1", 5, 8, 0)
    metering.request_dispatched("r1", "k1", "rep-0")
    metering.request_requeued("r1")
    metering.request_resumed("r1", 3)
    metering.request_closed("r1", "completed", generated_tokens=2)
    metering.request_pages([("k1", 2)], 1.0)
    metering.request_flops("k1", 1e6)
    metering.request_prefix("k1", 4, 64)
    metering.tenant_throttled("t")
    metering.training_step()
    assert metering.snapshot() is None and metering.emit() is None


def test_unknown_inner_id_bills_unattributed_not_crash():
    metering.start(name="m")
    metering.request_flops("stray", 100.0, 10.0)
    metering.request_pages([("stray", 2)], 1.0)
    metering.request_pages([("stray", 2)], 2.0)
    snap = metering.snapshot()
    acct = snap["tenants"][metering.UNATTRIBUTED]
    assert acct["flops"] == 100.0
    assert acct["page_seconds"] == pytest.approx(2.0)
    assert snap["reconcile"]["ok"]


def test_ledger_flush_every_and_bounded_tail(tmp_path):
    ledger = str(tmp_path / "l.jsonl")
    m = metering.start(name="m", path=ledger, flush_every=3, max_records=4)
    for i in range(7):
        metering.request_admitted("t", "r%d" % i, 4, 2, 0)
        metering.request_closed("r%d" % i, "completed", generated_tokens=2)
    with open(ledger) as f:
        assert len(f.read().splitlines()) == 6
    assert len(m.records()) == 4
    snap = metering.stop()
    with open(ledger) as f:
        assert len(f.read().splitlines()) == 7
    assert snap["ledger"]["written"] == 7 and snap["reconcile"]["ok"]


def test_training_accounting_reconciles_wasted_steps(monkeypatch):
    metering.start(name="train")
    for _ in range(10):
        metering.training_step()
    tr = metering.snapshot()["training"]
    assert tr["steps"] == 10 and tr["devices"] == 1
    assert tr["wasted_steps"] == 0 and tr["goodput"] == 1.0
    assert tr["total_flops"] is None
    real = fault.stats
    monkeypatch.setattr(fault, "stats",
                        lambda: dict(real(), skipped_steps=2))
    tr = metering.snapshot()["training"]
    assert tr["wasted_steps"] == 2 and tr["goodput"] == pytest.approx(0.8)
    assert tr["effective_device_seconds"] == pytest.approx(
        tr["device_seconds"] / 0.8, abs=2e-6)


def test_trainer_drives_training_meter():
    metering.start(name="train")
    with mx.cpu():
        net = mx.gluon.nn.Dense(4, in_units=6)
        net.initialize(mx.init.Xavier())
        trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                                   {"learning_rate": 0.05})
        x = mx.nd.array(np.ones((4, 6), np.float32))
        for _ in range(3):
            with mx.autograd.record():
                loss = net(x).sum()
            loss.backward()
            trainer.step(4)
    assert metering.snapshot()["training"]["steps"] == 3


def test_usage_flows_to_telemetry_metrics_and_flightrec(tmp_path):
    telemetry.start(filename=str(tmp_path / "run.jsonl"))
    metering.start(name="fleet")
    metering.request_admitted("acme", "r1", 5, 8, 0)
    metering.request_closed("r1", "completed", generated_tokens=8)
    metering.emit()
    rep = telemetry.report()
    assert rep["usage"]["fleet"]["admitted"] == 1
    page = livemetrics.render()
    assert 'mxnet_usage_admitted_total{meter="fleet"} 1' in page
    assert 'mxnet_usage_reconciled{meter="fleet"} 1' in page
    assert ('mxnet_usage_tenant_generated_tokens_total'
            '{meter="fleet",tenant="acme"} 8') in page
    flightrec.enable(str(tmp_path / "fr"))
    try:
        bundle = flightrec.read_bundle(flightrec.crash_dump("test"))
        assert bundle["metering"]["admitted"] == 1
        assert bundle["metering"]["reconcile"]["ok"]
    finally:
        flightrec.disable()
    telemetry.stop()


# ---------------------------------------------------------------------------
# program costs: the analytic count against FlopCounterMode, and billing
# ---------------------------------------------------------------------------

def _counted_flops(fn):
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


@pytest.mark.parametrize("kv_dtype", ["float32", "int8"])
def test_program_costs_equal_flop_counter_on_the_plain_bodies(kv_dtype):
    """Each program's analytic FLOPs equal FlopCounterMode's count of the
    eager plain body (every matmul: projections, FFN, attention's
    Q K^T and P V at the static shapes, LM head)."""
    model = ToyDecoderLM(vocab=40, n_layers=2, n_heads=2, head_dim=8,
                         d_ff=24, max_len=128, impl="plain")
    params = model.init_params(seed=1, device="cpu")
    pool = KVCachePool(2, 2, 8, page_size=8, n_pages=32, dtype=kv_dtype,
                       device="cpu")
    srv = DecodeServer(model, params, seq_ladder=[16, 32],
                       max_new_tokens=8, window=3, pool=pool, start=False)
    try:
        costs = srv.program_costs()
        ver = srv._params
        assert _counted_flops(lambda: srv._decode_step(
            ver.tree, *srv._step_args())) == costs["step"][0]
        for rung in (16, 32):
            assert _counted_flops(lambda: srv._prefill_step(
                ver.tree, *srv._prefill_args(rung))) \
                == costs["prefill"][rung][0]
        assert set(costs["prefill"]) == {16, 32}
        # the step moves more than its weights: every gathered K/V row
        step_bytes = costs["step"][1]
        assert step_bytes > 3 * 8 * srv._pool.token_bytes
    finally:
        srv.stop()


def _standin(body, device, pool):
    """A CUDA capture's contract on the CPU: one call now, each replay
    re-runs the body into the kept output."""
    out = body()

    def replay():
        res = body()
        if out is not None:
            out.copy_(res)
    return replay, out, {}


def test_billed_flops_and_bytes_equal_costs_times_dispatches():
    """FLOPs and bytes billed equal each program's count times its
    dispatches (graph replays per rung and of the step), tenant by
    tenant summing to the totals."""
    metering.start(name="fleet")
    servers = [_replica("rep-%d" % i) for i in range(2)]
    for s in servers:
        s._programs = tdecode._Programs(torch.device("cpu"),
                                        capture=_standin)
    r = Router(servers, start=False, probe_interval_ms=1)
    rs = np.random.RandomState(9)
    try:
        reqs = [r.submit(rs.randint(1, 32, size=n), max_new_tokens=5,
                         tenant="acme" if n % 2 else "zeta")
                for n in (4, 9, 17, 21, 30)]
        _run(r, *reqs)
    finally:
        r.stop()
    want_f = want_b = 0.0
    for s in servers:
        g, costs = s.stats()["graphs"], s.program_costs()
        assert g["replays"]["step"] == s.stats()["decode_steps"]
        want_f += g["replays"]["step"] * costs["step"][0]
        want_b += g["replays"]["step"] * costs["step"][1]
        for rung, n in g["prefill_replays"].items():
            want_f += n * costs["prefill"][rung][0]
            want_b += n * costs["prefill"][rung][1]
    assert set().union(*(s.stats()["graphs"]["prefill_replays"]
                         for s in servers)) == {16, 32}
    snap = metering.snapshot()
    assert snap["totals"]["flops"] == pytest.approx(want_f, rel=1e-9)
    assert snap["totals"]["bytes"] == pytest.approx(want_b, rel=1e-9)
    assert sum(t["flops"] for t in snap["tenants"].values()) \
        == pytest.approx(want_f, rel=1e-9)
    assert snap["reconcile"]["ok"]
