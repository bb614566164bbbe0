"""Port parity: mxnet_tpu_torch.flightrec against mxnet_tpu.flightrec, on
the CPU.

The acceptance drill of tests/test_fleet_obs.py over port replicas: a
routed two-replica fleet, armed with a telemetry sink, the tracer and
the flight recorder, loses one replica mid-stream and must leave
EXACTLY one bundle carrying the triggering ``replica_lost`` alert,
router- and replica-side spans joined causally under each session's
request id, and a fleet diagnose report whose counters reconcile. The
recorder's own drills follow: alert storms, rotation, the never-fatal
dump, the shadow ring, hook removal, and a bundle's program-set
counters (the port's counterpart of the JAX bundle's compile sites),
read from a server whose graph holder is driven through a stand-in
capture. Both packages' diagnose tools must print the same fleet and
bundle reports for the same files."""
import json
import os

import numpy as np
import pytest
import torch

from mxnet_tpu import serving as jserving
from mxnet_tpu.tools import diagnose as jdiagnose
from mxnet_tpu_torch import (fault, flightrec, livemetrics, telemetry,
                             tracing)
from mxnet_tpu_torch.serving import (DecodeServer, Router, ToyDecoderLM,
                                     params_from_numpy)
from mxnet_tpu_torch.serving import decode as tdecode
from mxnet_tpu_torch.tools import diagnose


@pytest.fixture(autouse=True)
def _clean_state():
    fault.reset()
    telemetry.reset()
    tracing.reset()
    flightrec.disable()
    yield
    fault.reset()
    telemetry.reset()
    tracing.reset()
    flightrec.disable()


_KW = dict(vocab=32, n_layers=1, n_heads=2, head_dim=8, max_len=128)
_JPARAMS = jserving.ToyDecoderLM(**_KW).init_params(seed=3)
_MODEL = ToyDecoderLM(**_KW)
_PARAMS = params_from_numpy({k: np.asarray(v) for k, v in _JPARAMS.items()},
                            "cpu", model=_MODEL)


def _fleet(name, n=2):
    reps = [DecodeServer(_MODEL, _PARAMS, seq_ladder=[16, 32],
                         max_new_tokens=12, window=4, page_size=8,
                         pool_pages=64, record_every=1,
                         name="%s-rep-%d" % (name, i), device="cpu",
                         start=False)
            for i in range(n)]
    return Router(reps, name=name, start=False, probe_interval_ms=1)


def test_replica_lost_drill_one_bundle_joined_spans_reconciled(
        tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("MXNET_FLIGHTREC_DIR", str(tmp_path))
    sink = str(tmp_path / "telem.jsonl")
    tracing.enable()
    telemetry.start(sink, run_id="drill")
    assert flightrec.enabled()          # armed by telemetry.start
    r = _fleet("front")
    reqs = [r.submit(np.arange(1, 6), max_new_tokens=8,
                     tenant="acme" if i % 2 else "zeta")
            for i in range(4)]
    now = 0.0
    while min(len(q.emitted) for q in reqs) < 2:
        now += 0.01
        r.pump(now)
    victim = reqs[0]._replica
    bound = [q for q in reqs if q._replica is victim]
    victim.kill()
    n = 0
    while not all(q.done() for q in reqs):
        now += 0.01
        r.pump(now)
        n += 1
        assert n < 600, "router made no progress"
    st = r.stats()
    assert st["failed"] == 0 and st["completed"] == 4
    assert st["replicas_lost"] == 1 and st["failovers"] == len(bound) >= 1
    # the lost replica left the scrape
    assert victim.server not in set(livemetrics._decode_servers)

    bundles = flightrec.list_bundles(str(tmp_path))
    assert len(bundles) == 1 == st["replicas_lost"]
    b = flightrec.read_bundle(bundles[0])
    assert b["reason"] == "alert"
    assert b["alert"]["kind"] == "replica_lost"
    assert b["alert"]["replica"] == victim.name
    assert b["alert"]["sessions"] == len(bound)
    assert b["records"] and b["router"]["front"]["replicas_lost"] == 1
    assert {p["name"] for p in b["topology"]["front"]} \
        == {"front-rep-0", "front-rep-1"}
    assert b["trace"]["traceEvents"]
    assert b["versions"] == {"torch": torch.__version__,
                             "cuda": torch.version.cuda}
    assert b["envs"]["MXNET_FLIGHTREC_DIR"] == str(tmp_path)

    exp = tracing.export()
    spans = {}
    for e in exp["traceEvents"]:
        if e["ph"] == "X" and e.get("cat") in ("router", "decode"):
            spans.setdefault(e["args"]["request_id"], []).append(e)
    for q in reqs:
        evs = spans[q.request_id]
        first = {}
        for e in evs:
            key = (e["cat"], e["name"])
            first[key] = min(first.get(key, e["ts"]), e["ts"])
        assert first["router", "queue"] <= first["decode", "queue"] \
            <= first["decode", "prefill"]
    fo = [e for e in exp["traceEvents"]
          if e["ph"] == "i" and e["name"] == "router:failover"]
    assert {e["args"]["request_id"] for e in fo} \
        == {q.request_id for q in bound}
    r.stop()
    telemetry.stop()

    paths = sorted([sink] + flightrec.list_bundles(str(tmp_path)))
    fleet = diagnose.read_fleet(paths)
    sv = diagnose.fleet_json(fleet)["serving"]
    assert sv["reconciled"], sv
    assert sv["dispatched"] == sv["admitted"] + sv["replica_shed"]
    assert sv["replicas_lost"] == 1 == sv["replica_lost_alerts"]
    text = diagnose.format_fleet(fleet)
    assert "[OK]" in text and "MISMATCH" not in text
    assert "1 replica_lost bundle(s) vs 1 replica_lost alert(s)" in text
    for argv in ([str(tmp_path)], [str(tmp_path), "--format", "json"],
                 [bundles[0]]):
        jdiagnose.main(argv)
        want = capsys.readouterr().out
        diagnose.main(argv)
        assert capsys.readouterr().out == want


def test_alert_storm_yields_one_bundle_crash_bypasses(tmp_path,
                                                      monkeypatch):
    monkeypatch.setenv("MXNET_FLIGHTREC_INTERVAL_MS", "60000")
    flightrec.enable(str(tmp_path))
    for i in range(5):
        telemetry.alert_event({"kind": "slo_breach", "message": "m%d" % i})
    st = flightrec.stats()
    assert st["dumps"] == 1 and st["suppressed"] == 4
    path = flightrec.crash_dump("host_dying", detail="test")
    assert path and os.path.isfile(path)
    b = flightrec.read_bundle(path)
    assert b["reason"] == "crash:host_dying" and b["detail"] == "test"
    assert flightrec.stats()["dumps"] == 2


def test_rotation_bounds_bundle_count(tmp_path, monkeypatch):
    monkeypatch.setenv("MXNET_FLIGHTREC_MAX_BUNDLES", "2")
    flightrec.enable(str(tmp_path))
    paths = [flightrec.crash_dump("r%d" % i) for i in range(4)]
    assert all(paths)
    left = flightrec.list_bundles(str(tmp_path))
    assert len(left) <= 2 and paths[-1] in left


def test_dump_failure_counted_never_fatal(tmp_path):
    flightrec.enable(str(tmp_path))
    fault.set_plan("flightrec:step=1:raise")
    telemetry.alert_event({"kind": "k", "message": "m"})
    st = flightrec.stats()
    assert st["failed"] == 1 and st["dumps"] == 0
    assert fault.stats()["injected"]["flightrec"] == 1
    assert flightrec.list_bundles(str(tmp_path)) == []
    fault.set_plan(None)
    assert flightrec.crash_dump("after") is not None


def test_shadow_ring_survives_sink_flush(tmp_path, monkeypatch):
    monkeypatch.setenv("MXNET_FLIGHTREC_RECORDS", "8")
    flightrec.enable(str(tmp_path))
    telemetry.start(str(tmp_path / "t.jsonl"), run_id="ring")
    for i in range(20):
        telemetry.external_record({"type": "probe", "i": i})
    telemetry.flush()
    b = flightrec.read_bundle(flightrec.crash_dump("probe"))
    recs = [r for r in b["records"] if r.get("type") == "probe"]
    assert len(recs) == 8 and recs[-1]["i"] == 19
    telemetry.stop()


def test_disable_uninstalls_hooks(tmp_path):
    assert telemetry._recent is None and telemetry._flight_alert is None
    assert flightrec.dump("alert") is None          # off: nothing
    flightrec.enable(str(tmp_path))
    assert telemetry._recent is not None
    assert telemetry._flight_alert is not None
    assert flightrec.disable()["dir"] == str(tmp_path)
    assert telemetry._recent is None and telemetry._flight_alert is None
    with pytest.raises(ValueError, match="MXNET_FLIGHTREC_DIR"):
        flightrec.enable()


def _standin(body, device, pool):
    out = body()

    def replay():
        res = body()
        if out is not None:
            out.copy_(res)
    return replay, out, {}


def test_bundle_carries_each_servers_program_set_counters(tmp_path):
    """The bundle's ``compile_sites`` hold each live server's captures,
    replays and recaptures per site (the JAX bundle's
    ``compile_watch.site_stats()``); a server running eagerly on the CPU
    has none."""
    graphed = DecodeServer(_MODEL, _PARAMS, seq_ladder=[16, 32],
                           max_new_tokens=4, window=2, page_size=8,
                           pool_pages=32, name="fr-graphed", device="cpu",
                           start=False)
    graphed._programs = tdecode._Programs(torch.device("cpu"),
                                          capture=_standin)
    eager = DecodeServer(_MODEL, _PARAMS, seq_ladder=[16],
                         max_new_tokens=4, window=2, page_size=8,
                         pool_pages=32, name="fr-eager", device="cpu",
                         start=False)
    try:
        graphed.warmup()
        req = graphed.submit(np.arange(1, 6), max_new_tokens=3)
        while not req.done():
            graphed._tick()
        flightrec.enable(str(tmp_path))
        sites = flightrec.read_bundle(
            flightrec.crash_dump("probe"))["compile_sites"]
        g = sites["fr-graphed"]
        assert g["sites"]["prefill"] == {"captures": 2, "replays": 1}
        assert g["sites"]["step"] == {"captures": 1, "replays": 2}
        assert g["recaptures"] == 0 and g["after_warmup"] == 0
        assert sites["fr-eager"] is None
    finally:
        graphed.stop()
        eager.stop()


def test_bundle_one_liner_matches_the_jax_tool(tmp_path, capsys):
    flightrec.enable(str(tmp_path))
    telemetry.start(run_id="b")
    path = flightrec.dump("alert",
                          alert={"kind": "slo_breach", "message": "x"})
    telemetry.stop()
    b = flightrec.read_bundle(path)
    line = diagnose.format_bundle_line(path, b)
    assert os.path.basename(path) in line and "slo_breach" in line
    assert line == jdiagnose.format_bundle_line(path, b)
    diagnose.main([path])
    text = capsys.readouterr().out
    assert "----------Flight-recorder bundle----------" in text
    jdiagnose.main([path])
    assert capsys.readouterr().out == text
    assert json.loads(open(path).read())["type"] == "flightrec"
