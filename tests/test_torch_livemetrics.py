"""Port parity: mxnet_tpu_torch.livemetrics against mxnet_tpu.livemetrics,
on the CPU.

The drills of tests/test_livemetrics.py over the port: the /metrics
scrape parses and agrees with ``telemetry.report()`` and with each port
DecodeServer's and Router's ``stats()``, the 404 path, and the SLO
watchdog (step-time drift under slow steps, silence on a clean run,
shed rate, queue at its bound, replica skew, hysteresis). A scrape runs
from another thread while started servers and a started router serve,
as it does on the card beside their CUDA graphs. The cross-package
check runs the same routed drill on a JAX fleet and a port fleet and
requires the same set of series names, an InferenceServer's
``mxnet_serving_*`` families with them."""
import gc
import re
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from mxnet_tpu import livemetrics as jlivemetrics
from mxnet_tpu import serving as jserving
from mxnet_tpu import telemetry as jtelemetry
from mxnet_tpu_torch import fault, livemetrics, metering, telemetry
from mxnet_tpu_torch.serving import (DecodeServer, Router, ToyDecoderLM,
                                     params_from_numpy)


@pytest.fixture(autouse=True)
def _clean_state():
    fault.reset()
    telemetry.reset()
    livemetrics.disable_watchdog()
    yield
    fault.reset()
    telemetry.reset()
    metering.stop()
    livemetrics.disable_watchdog()
    livemetrics.stop_server()


_LINE = re.compile(
    r"^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^}]*\})? [-+0-9.eEinfa]+$")


def _scrape(port):
    return urllib.request.urlopen(
        "http://127.0.0.1:%d/metrics" % port, timeout=10).read() \
        .decode("utf-8")


def _parse(text):
    out = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        assert _LINE.match(line), line
        key, value = line.rsplit(" ", 1)
        out[key] = float(value)
    return out


_KW = dict(vocab=32, n_layers=1, n_heads=2, head_dim=8, max_len=128)
_JMODEL = jserving.ToyDecoderLM(**_KW)
_JPARAMS = _JMODEL.init_params(seed=3)
_MODEL = ToyDecoderLM(**_KW)
_PARAMS = params_from_numpy({k: np.asarray(v) for k, v in _JPARAMS.items()},
                            "cpu", model=_MODEL)


def _fleet(prefix, n=2, start=False, **kw):
    reps = [DecodeServer(_MODEL, _PARAMS, seq_ladder=[16, 32],
                         max_new_tokens=12, window=4, page_size=8,
                         pool_pages=64, name="%s-rep-%d" % (prefix, i),
                         device="cpu", prefix_cache=True, start=start)
            for i in range(n)]
    return Router(reps, name=prefix, start=start, probe_interval_ms=1,
                  **kw)


def _pump(router, reqs, now=0.0, limit=800):
    n = 0
    while not all(q.done() for q in reqs):
        now += 0.01
        router.pump(now)
        n += 1
        assert n < limit, "router made no progress"
    return now


# ---------------------------------------------------------------------------
# /metrics
# ---------------------------------------------------------------------------

def test_metrics_scrape_parses_and_agrees_with_report():
    telemetry.start(run_id="scrape")
    for _ in range(5):
        telemetry.step_begin()
        with telemetry.span("compute"):
            pass
        telemetry.step_end(samples=8)
    port = livemetrics.serve(0)
    assert livemetrics.server_port() == port
    vals = _parse(_scrape(port))
    rep = telemetry.report()
    assert vals["mxnet_steps_total"] == rep["steps"] == 5
    assert vals["mxnet_samples_total"] == rep["samples"] == 40
    assert vals["mxnet_telemetry_run_active"] == 1
    assert vals['mxnet_step_time_ms{quantile="p50"}'] == \
        pytest.approx(rep["step_time_ms"]["p50"])
    assert vals['mxnet_phase_ms_total{phase="compute"}'] == \
        pytest.approx(rep["phases_ms"]["compute"])
    ident = [k for k in vals if k.startswith("mxnet_identity_info")]
    assert len(ident) == 1
    assert 'torch="%s"' % torch.__version__ in ident[0]
    assert 'run="scrape"' in ident[0] and "jax" not in ident[0]
    telemetry.stop()
    vals = _parse(_scrape(port))
    assert vals["mxnet_telemetry_run_active"] == 0
    assert vals["mxnet_steps_total"] == 5


def test_metrics_endpoint_404_off_path():
    port = livemetrics.serve(0)
    with pytest.raises(urllib.error.HTTPError):
        urllib.request.urlopen("http://127.0.0.1:%d/nope" % port,
                               timeout=10)
    livemetrics.stop_server()
    assert livemetrics.server_port() is None


def test_decode_and_router_series_equal_stats():
    """After a routed drill with a replica kill, every decode and router
    counter on the page equals the servers' and the router's stats()."""
    metering.start(name="fleet")
    r = _fleet("lm1")
    try:
        reqs = [r.submit(np.arange(1, 6 + i), max_new_tokens=6,
                         tenant="acme" if i % 2 else "zeta")
                for i in range(4)]
        now = 0.0
        while min(len(q.emitted) for q in reqs) < 2:
            now += 0.01
            r.pump(now)
        reqs[0]._replica.kill()
        _pump(r, reqs, now=now)
        vals = _parse(livemetrics.render())
        st = r.stats()
        lab = '{router="lm1"}'
        for key in ("requests", "dispatched", "completed", "failed",
                    "failovers", "replay_tokens", "replicas_lost",
                    "scale_up_signals", "scale_down_signals"):
            assert vals["mxnet_router_%s_total%s" % (key, lab)] == st[key]
        assert vals["mxnet_router_replicas_up" + lab] == st["replicas_up"]
        for rep in r._replicas:
            s = rep.server.stats()
            slab = '{server="%s"}' % s["name"]
            if rep.state == "lost":
                # a lost replica is deregistered from the scrape
                assert "mxnet_decode_requests_total" + slab not in vals
                continue
            for key in ("requests", "completed", "prefill_steps",
                        "decode_steps", "tokens_out", "preempted"):
                assert vals["mxnet_decode_%s_total%s" % (key, slab)] \
                    == s[key]
            assert vals["mxnet_prefix_hit_tokens_total" + slab] \
                == s["prefix"]["hit_tokens"]
            assert vals["mxnet_decode_kv_pages_used" + slab] \
                == s["kv"]["used"]
        assert vals['mxnet_usage_closed_total{meter="fleet"}'] == 4
    finally:
        r.stop()


def test_scrape_from_another_thread_while_serving():
    """Started servers and a started router serve while a client thread
    scrapes every few milliseconds: every page parses, and the last one
    equals the final stats()."""
    port = livemetrics.serve(0)
    r = _fleet("lm2", start=True)
    pages, stop = [], threading.Event()

    def scraper():
        while not stop.is_set():
            pages.append(_scrape(port))
            stop.wait(0.005)

    t = threading.Thread(target=scraper)
    t.start()
    try:
        reqs = [r.submit(np.arange(1, 6 + i), max_new_tokens=8)
                for i in range(6)]
        for q in reqs:
            q.result(timeout=60)
    finally:
        stop.set()
        t.join()
    try:
        assert len(pages) >= 2
        for page in pages:
            _parse(page)
        vals = _parse(_scrape(port))
        for rep in r._replicas:
            s = rep.server.stats()
            assert vals['mxnet_decode_tokens_out_total{server="%s"}'
                        % s["name"]] == s["tokens_out"]
        assert vals['mxnet_router_completed_total{router="lm2"}'] == 6
    finally:
        r.stop()


def _names(page, label):
    """The series names of a page, counting a server's or router's series
    only when it is this drill's (``label``): servers other tests left
    alive in the process stay out of the comparison."""
    names = set()
    for line in page.splitlines():
        if not line or line.startswith("#"):
            continue
        if re.search(r'(server|router)="', line) and label not in line:
            continue
        names.add(re.split(r"[{ ]", line, 1)[0])
    return names


def test_series_names_equal_the_jax_page():
    gc.collect()
    jlivemetrics.disable_watchdog()       # no alert family on either page
    telemetry.start(run_id="names")
    jtelemetry.start(run_id="names")
    metering.start(name="fleet")
    from mxnet_tpu import metering as jmetering
    jmetering.start(name="fleet")
    jreps = [jserving.DecodeServer(_JMODEL, _JPARAMS, seq_ladder=[16, 32],
                                   max_new_tokens=12, window=4,
                                   page_size=8, pool_pages=64,
                                   prefix_cache=True, name="lm3-rep-%d" % i,
                                   start=False) for i in range(2)]
    jr = jserving.Router(jreps, name="lm3", start=False,
                         probe_interval_ms=1)
    r = _fleet("lm3")
    # an InferenceServer each, for the mxnet_serving_* families
    from mxnet_tpu_torch.serving import InferenceServer
    jinf = jserving.InferenceServer(lambda x: x, max_batch=2,
                                    name="lm3-inf", start=False)
    inf = InferenceServer(lambda x: x, max_batch=2, name="lm3-inf",
                          devices=["cpu"], start=False)
    try:
        for router in (jr, r):
            reqs = [router.submit(np.arange(1, 6 + i), max_new_tokens=6,
                                  tenant="acme" if i % 2 else "zeta")
                    for i in range(4)]
            _pump(router, reqs)
        # the process-wide counters' family shows once any counter
        # exists, whatever ran before in this process: give both one
        from mxnet_tpu import profiler as jprofiler
        from mxnet_tpu_torch import profiler
        for prof in (profiler, jprofiler):
            prof.increment_counter("series_names_probe")
        got = _names(livemetrics.render(), "lm3")
        want = _names(jlivemetrics.render(), "lm3")
        assert got == want
        assert "mxnet_serving_queue_bound" in got
    finally:
        jinf.stop()
        inf.stop()
        jr.stop()
        r.stop()
        jmetering.stop()
        jtelemetry.stop()
        telemetry.stop()


# ---------------------------------------------------------------------------
# the SLO watchdog
# ---------------------------------------------------------------------------

def _drive_steps(durations):
    import time
    for d in durations:
        telemetry.step_begin()
        time.sleep(d)
        telemetry.step_end(samples=1)


def test_watchdog_step_drift_fires_on_slow_steps(tmp_path, monkeypatch,
                                                 capsys):
    monkeypatch.setenv("MXNET_WATCHDOG_BASELINE", "10")
    monkeypatch.setenv("MXNET_WATCHDOG_WINDOW", "5")
    monkeypatch.setenv("MXNET_WATCHDOG_SUSTAIN", "3")
    sink = str(tmp_path / "run.jsonl")
    wd = livemetrics.enable_watchdog()
    telemetry.start(filename=sink)
    with pytest.warns(UserWarning, match="step_time_drift"):
        _drive_steps([0.002] * 10 + [0.032] * 20)
    summary = telemetry.stop()
    assert wd.alerts() == {"step_time_drift": 1}
    assert len(summary["alerts"]) == 1
    assert summary["alerts"][0]["ratio"] > 1.5
    page = livemetrics.render()
    assert 'mxnet_watchdog_alerts_total{kind="step_time_drift"} 1' in page
    from mxnet_tpu_torch.tools import diagnose
    diagnose.main([sink])
    out = capsys.readouterr().out
    assert "step_time_drift" in out and "1 alert(s) fired" in out


def test_watchdog_silent_on_clean_run(tmp_path, monkeypatch):
    monkeypatch.setenv("MXNET_WATCHDOG_BASELINE", "10")
    monkeypatch.setenv("MXNET_WATCHDOG_WINDOW", "5")
    monkeypatch.setenv("MXNET_WATCHDOG_SUSTAIN", "3")
    wd = livemetrics.enable_watchdog()
    telemetry.start(filename=str(tmp_path / "run.jsonl"))
    _drive_steps([0.002] * 30)
    summary = telemetry.stop()
    assert wd.alerts() == {} and "alerts" not in summary


def test_watchdog_is_armed_by_the_environment(monkeypatch):
    monkeypatch.setenv("MXNET_WATCHDOG", "1")
    telemetry.start(run_id="env")
    assert livemetrics.watchdog_enabled()
    assert telemetry._watch_step is not None
    telemetry.stop()
    livemetrics.disable_watchdog()
    assert telemetry._watch_step is None


def test_watchdog_shed_rate_and_queue_full(monkeypatch):
    monkeypatch.setenv("MXNET_WATCHDOG_MIN_REQUESTS", "5")
    telemetry.start()
    wd = livemetrics.enable_watchdog()
    wd.on_serving({"name": "s", "requests": 10, "shed": 0,
                   "queue_depth": 0, "max_queue": 2})    # seeds only
    with pytest.warns(UserWarning):
        wd.on_serving({"name": "s", "requests": 22, "shed": 8,
                       "queue_depth": 2, "max_queue": 2})
    telemetry.stop()
    fired = wd.alerts()
    assert fired == {"serving_shed_rate": 1, "serving_queue_full": 1}


def test_watchdog_replica_skew_straggler():
    telemetry.start()
    wd = livemetrics.enable_watchdog()
    with pytest.warns(UserWarning, match="replica_skew"):
        wd.on_serving({"requests": 50, "shed": 0, "queue_depth": 0,
                       "max_queue": 64, "replica_batches": [10, 10, 10],
                       "replica_service_ms": [5.0, 5.5, 40.0]})
    summary = telemetry.stop()
    assert wd.alerts() == {"replica_skew": 1}
    assert summary["alerts"][0]["replica"] == 2


def test_watchdog_hysteresis_rearms_on_clear():
    import warnings
    telemetry.start()
    wd = livemetrics.enable_watchdog()
    snap = {"requests": 50, "shed": 0, "queue_depth": 60,
            "max_queue": 64, "replica_batches": [],
            "replica_service_ms": []}
    with pytest.warns(UserWarning, match="serving_queue_full"):
        wd.on_serving(dict(snap))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        wd.on_serving(dict(snap, requests=60))
        wd.on_serving(dict(snap, requests=70, queue_depth=0))
        wd.on_serving(dict(snap, requests=80, queue_depth=64))
    summary = telemetry.stop()
    assert wd.alerts()["serving_queue_full"] == 2
    assert len(summary["alerts"]) == 2
