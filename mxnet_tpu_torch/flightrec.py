"""Flight recorder: rate-limited post-mortem bundles for fleet
incidents (counterpart of ``mxnet_tpu/flightrec.py``) — the "what was
true at the moment it fired" the live observability stack (tracing
ring, /metrics, SLO watchdog) cannot answer after the fact.

It hooks the alert edge (``telemetry.alert_event`` →
``_flight_alert``: a Router's confirmed replica loss, an SLO-watchdog
breach) and the crash path (:func:`crash_dump`), and writes ONE atomic
JSON bundle per trigger under ``MXNET_FLIGHTREC_DIR``: the triggering
alert, the last K telemetry records (a shadow ring — the run's own
records leave memory at every sink flush), the trace-ring tail,
``envs.snapshot()``, each live decode server's program-set counters
(``compile_sites``: ``compile_watch.site_stats()`` while the watch is
on; else the decode servers' captures, replays and recaptures per site
from ``stats()["graphs"]``), the latest decode/router snapshots,
the meter's books, and the fleet topology.

- **Always cheap when off** — arming installs two module-global hooks
  in telemetry (``_recent``, ``_flight_alert``); disarmed, every hook
  is one ``None`` check and no sink byte changes.
- **Bounded** — at most ``MXNET_FLIGHTREC_MAX_BUNDLES`` bundles and
  ``MXNET_FLIGHTREC_MAX_BYTES`` on disk (oldest deleted first), one
  dump per ``MXNET_FLIGHTREC_INTERVAL_MS`` (an alert storm suppresses,
  never stacks; crash dumps bypass the interval), trace tail capped at
  :data:`_TRACE_TAIL_EVENTS` events.
- **Never fatal** — a dump visits the ``flightrec`` fault site and
  swallows every exception as a counted failure (``stats()["failed"]``):
  the recorder must not take down the process it is post-morteming.

``python -m mxnet_tpu_torch.tools.diagnose <dir>`` renders each bundle
as a one-line summary next to the fleet report.
"""
from __future__ import annotations

import json
import logging
import os
import threading
import time
from collections import deque

from . import envs

__all__ = ["enabled", "enable", "disable", "maybe_enable", "stats",
           "on_alert", "crash_dump", "dump", "BUNDLE_PREFIX",
           "read_bundle", "list_bundles"]

BUNDLE_PREFIX = "flightrec-"
_TRACE_TAIL_EVENTS = 5000       # trace-ring tail kept per bundle

_rec = None            # the armed _Recorder; module-global None check
_lock = threading.Lock()
_log = logging.getLogger(__name__)


class _Recorder:
    def __init__(self, dirname):
        self.dir = dirname
        self.max_bundles = max(
            1, envs.get_int("MXNET_FLIGHTREC_MAX_BUNDLES"))
        self.max_bytes = max(
            1 << 16, envs.get_int("MXNET_FLIGHTREC_MAX_BYTES"))
        self.interval_s = max(
            0, envs.get_int("MXNET_FLIGHTREC_INTERVAL_MS")) / 1e3
        self.recent = deque(maxlen=max(
            1, envs.get_int("MXNET_FLIGHTREC_RECORDS")))
        self.seq = 0
        self.dumps = 0
        self.suppressed = 0
        self.failed = 0
        # first trigger always dumps: the rate limit bounds storms,
        # not the first sighting
        self.last_dump = None


def enabled():
    """True while the recorder is armed."""
    return _rec is not None


def enable(dirname=None):
    """Arm the recorder (idempotent): bundles land under ``dirname``
    (or ``MXNET_FLIGHTREC_DIR``), the telemetry shadow ring and the
    alert-edge hook are installed. Returns the bundle directory."""
    global _rec
    from . import telemetry
    with _lock:
        if _rec is not None:
            return _rec.dir
        dirname = dirname or envs.get_path("MXNET_FLIGHTREC_DIR")
        if not dirname:
            raise ValueError("flightrec.enable: no directory — pass "
                             "dirname= or set MXNET_FLIGHTREC_DIR")
        os.makedirs(dirname, exist_ok=True)
        _rec = _Recorder(dirname)
        telemetry._recent = _rec.recent
        telemetry._flight_alert = on_alert
        return _rec.dir


def disable():
    """Disarm: uninstall the telemetry hooks. Returns final
    :func:`stats` (or None when never armed)."""
    global _rec
    from . import telemetry
    with _lock:
        rec, _rec = _rec, None
        if rec is None:
            return None
        telemetry._recent = None
        telemetry._flight_alert = None
        return {"dir": rec.dir, "dumps": rec.dumps,
                "suppressed": rec.suppressed, "failed": rec.failed}


def maybe_enable():
    """Arm when ``MXNET_FLIGHTREC_DIR`` is set — called from
    ``telemetry.start`` so the recorder rides a run the way tracing
    does. Returns True when armed after the call."""
    if _rec is not None:
        return True
    if envs.get_path("MXNET_FLIGHTREC_DIR"):
        enable()
        return True
    return False


def stats():
    """{"dir", "dumps", "suppressed", "failed"}; None when off."""
    rec = _rec
    if rec is None:
        return None
    return {"dir": rec.dir, "dumps": rec.dumps,
            "suppressed": rec.suppressed, "failed": rec.failed}


# ---------------------------------------------------------------------------
# triggers
# ---------------------------------------------------------------------------

def on_alert(alert):
    """The SLO-watchdog alert edge (installed as
    ``telemetry._flight_alert``): one bundle per alert, rate-limited."""
    dump("alert", alert=alert)


def crash_dump(reason, detail=None):
    """The crash path (multihost heartbeat excepthook / host-loss
    monitor): bypasses the rate limit — a dying process gets its last
    word regardless of how recently an alert dumped."""
    extra = {"detail": detail} if detail else None
    return dump("crash:%s" % reason, extra=extra, force=True)


def dump(reason, alert=None, extra=None, force=False):
    """Write one bundle. Returns the bundle path, or None when the
    recorder is off, the rate limit suppressed the dump, or the dump
    failed (counted, logged, never raised)."""
    rec = _rec
    if rec is None:
        return None
    with _lock:
        if rec is not _rec:
            return None
        now = time.monotonic()
        if (not force and rec.last_dump is not None
                and now - rec.last_dump < rec.interval_s):
            rec.suppressed += 1
            return None
        rec.last_dump = now
        rec.seq += 1
        seq = rec.seq
    try:
        return _write_bundle(rec, seq, reason, alert, extra)
    except Exception as exc:               # noqa: BLE001 — see module
        # doc: the recorder must never take down the host process;
        # InjectedFault from the drill site lands here too
        rec.failed += 1
        _log.warning("flightrec: dump failed (%s: %s)",
                     type(exc).__name__, str(exc)[:200])
        return None


# ---------------------------------------------------------------------------
# bundle assembly
# ---------------------------------------------------------------------------

def _identity():
    from . import tracing
    ident = tracing.process_identity()
    world = os.environ.get("DMLC_NUM_WORKER", "")
    if not world:
        world = envs.get_int("MXNET_TPU_WORLD") or 1
    try:
        ident["world"] = int(world)
    except (TypeError, ValueError):
        ident["world"] = 1
    ident["pid"] = os.getpid()
    return ident


def _versions():
    import torch
    return {"torch": torch.__version__, "cuda": torch.version.cuda}


def _program_sites():
    """``compile_watch.site_stats()`` while the compile watch is on (the
    JAX bundle's ``compile_sites``); otherwise each live decode server's
    fixed-program-set counters, keyed by its /metrics label: ``{site:
    {"captures", "replays"}}`` plus the server's ``recaptures`` (None for
    a server running eagerly on the CPU)."""
    from . import compile_watch, livemetrics
    sites = compile_watch.site_stats()
    if sites is not None:
        return sites
    out = {}
    for srv in list(livemetrics._decode_servers):
        g = srv.stats()["graphs"]
        label = getattr(srv, "_metrics_label", None) or "default"
        out[label] = None if g is None else {
            "sites": {site: {"captures": g["captures"][site],
                             "replays": g["replays"][site]}
                      for site in g["captures"]},
            "recaptures": g["recaptures"],
            "after_warmup": g["after_warmup"]}
    return out


def _write_bundle(rec, seq, reason, alert, extra):
    from . import fault, metering, telemetry, tracing
    fault.inject("flightrec")        # the deterministic dumper drill
    run = telemetry._run or telemetry._last_run
    bundle = {
        "type": "flightrec",
        "version": 1,
        "reason": reason,
        "time": time.time(),
        "identity": _identity(),
        "versions": _versions(),
        "alert": dict(alert) if alert else None,
        "records": list(rec.recent),
        "envs": envs.snapshot(),
        "compile_sites": _program_sites(),
        "fault": fault.stats(),
        "trace_stats": tracing.stats(),
        # who-was-being-billed at the crash edge: the meter's
        # cumulative per-tenant books (None when metering is off —
        # the key stays so bundle readers need no probing)
        "metering": metering.snapshot(),
    }
    if extra:
        bundle.update(extra)
    if run is not None:
        # advisory reads — trace metadata, not accounting; the latest
        # cumulative snapshots double as the fleet topology (replica
        # roster with states rides every router snapshot)
        bundle["run"] = {"run_id": run.run_id, "steps": run.steps,
                         "alerts_dropped": run.alerts_dropped}
        bundle["alerts"] = list(run.alerts or [])
        bundle["decode"] = run.decode
        bundle["router"] = run.router
        routers = run.router or {}
        bundle["topology"] = {
            name: [dict(r) for r in (snap.get("replicas") or [])]
            for name, snap in routers.items()}
    if tracing.enabled():
        trace = tracing.export()
        evs = trace["traceEvents"]
        if len(evs) > _TRACE_TAIL_EVENTS:
            # keep metadata rows + the newest tail: the ring is
            # newest-wins and so is the bundle
            metas = [e for e in evs if e.get("ph") == "M"]
            tail = [e for e in evs if e.get("ph") != "M"]
            trace["traceEvents"] = metas + tail[-_TRACE_TAIL_EVENTS:]
            trace["otherData"]["bundle_truncated_events"] = \
                len(tail) - _TRACE_TAIL_EVENTS
        bundle["trace"] = trace
    payload = json.dumps(bundle)
    _rotate(rec, len(payload))
    stamp = time.strftime("%Y%m%dT%H%M%S",
                          time.gmtime(bundle["time"]))
    path = os.path.join(rec.dir, "%s%s-%d-%03d.json"
                        % (BUNDLE_PREFIX, stamp, os.getpid(), seq))
    tmp = "%s.%d.tmp" % (path, os.getpid())
    with open(tmp, "w") as f:
        f.write(payload)
    os.replace(tmp, path)
    rec.dumps += 1
    return path


def _rotate(rec, incoming_bytes):
    """Delete oldest bundles until the new one fits the count and
    byte budgets. Oldest = lexicographically first (the UTC-stamped
    names sort by time)."""
    try:
        names = sorted(n for n in os.listdir(rec.dir)
                       if n.startswith(BUNDLE_PREFIX)
                       and n.endswith(".json"))
    except OSError:
        return
    sizes = {}
    for n in names:
        try:
            sizes[n] = os.path.getsize(os.path.join(rec.dir, n))
        except OSError:
            sizes[n] = 0
    total = sum(sizes.values())
    while names and (len(names) >= rec.max_bundles
                     or total + incoming_bytes > rec.max_bytes):
        victim = names.pop(0)
        total -= sizes.get(victim, 0)
        try:
            os.unlink(os.path.join(rec.dir, victim))
        except OSError:
            pass


# ---------------------------------------------------------------------------
# readers (diagnose / tests)
# ---------------------------------------------------------------------------

def list_bundles(dirname):
    """Bundle paths under ``dirname``, oldest first."""
    try:
        names = sorted(n for n in os.listdir(dirname)
                       if n.startswith(BUNDLE_PREFIX)
                       and n.endswith(".json"))
    except OSError:
        return []
    return [os.path.join(dirname, n) for n in names]


def read_bundle(path):
    """Load one bundle dict (raises on unreadable/torn files — the
    diagnose caller counts those as warnings)."""
    with open(path) as f:
        return json.load(f)
