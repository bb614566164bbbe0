"""Live operational metrics: a stdlib-only Prometheus ``/metrics``
HTTP endpoint plus an SLO watchdog (counterpart of
``mxnet_tpu/livemetrics.py``) — the scrape-and-alert half of the
observability stack.

- **/metrics endpoint** — :func:`serve` starts a daemon-thread HTTP
  server (``http.server``) answering ``GET /metrics`` with Prometheus
  text exposition (format 0.0.4) rendered on demand from
  ``telemetry.report()``, ``profiler.counters()``, every live
  ``serving.InferenceServer``, ``serving.DecodeServer`` and
  ``serving.Router`` (registered by
  weakref; a stopped one drops out) and the process meter. Rendering
  reads host state only — each server's ``stats()`` — and never
  touches a device, so a scrape is safe while a server captures or
  replays its CUDA graphs. Binds ``127.0.0.1`` by default (metrics can
  leak workload shape; ``MXNET_METRICS_HOST`` opts out).
  ``MXNET_METRICS_PORT`` (picked up at ``telemetry.start`` and server
  construction) starts it from the environment; port 0 asks the OS for
  an ephemeral port (tests).

- **SLO watchdog** — :class:`Watchdog` observes the step records and
  the InferenceServer's cumulative serving snapshots flowing through
  telemetry (the ``_watch_step``/``_watch_serving`` hooks, one ``None``
  check each when off), and raises structured ``alert``
  telemetry records plus a one-time warning per alert kind on:
  sustained step-time p50 drift against a rolling baseline, serving
  shed-rate breach, queue depth pinned at the bound, and per-replica
  service-time skew. The Router's autoscaler reads its per-kind counts.

The series names and labels are the JAX package's; the identity gauge
labels the process with ``torch`` and ``cuda`` versions in place of
``jax`` and ``jaxlib``.

Both pieces are off by default and cost nothing when off: without
:func:`serve` no thread, socket, or render ever exists.
"""
from __future__ import annotations

import bisect
import itertools
import threading
import warnings
import weakref
from collections import deque

from . import envs

__all__ = ["serve", "stop_server", "server_port", "render",
           "register_server", "deregister_server",
           "register_decode_server", "deregister_decode_server",
           "register_router", "deregister_router", "Watchdog",
           "enable_watchdog", "disable_watchdog", "watchdog_enabled",
           "maybe_start", "LATENCY_BUCKETS_MS"]

# histogram bucket upper bounds (ms) for the recent-window serving
# latency histogram — roughly log-spaced over sub-ms..seconds
LATENCY_BUCKETS_MS = (1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0,
                      500.0, 1000.0, 2500.0, 5000.0)

_servers = weakref.WeakSet()      # live InferenceServers
_decode_servers = weakref.WeakSet()   # live DecodeServers
_routers = weakref.WeakSet()      # live serving Routers
_http = None                      # (HTTPServer, thread)
_http_lock = threading.Lock()
_watchdog = None


_label_seq = itertools.count(2)
_register_lock = threading.Lock()


def _assign_label_locked(server, pool):
    label = getattr(server, "name", None) or "default"
    taken = {getattr(s, "_metrics_label", None) for s in pool}
    if label in taken:
        label = "%s-%d" % (label, next(_label_seq))
    server._metrics_label = label


def register_server(server):
    """Track one live ``serving.InferenceServer`` for the scrape
    (weakref — a collected server drops out). Called from the server
    constructor. Each server gets a UNIQUE ``server=`` label: a second
    unnamed (or same-named) server is suffixed ``-2``, ``-3``, ... —
    duplicate label sets would make Prometheus reject the scrape."""
    with _register_lock:
        _assign_label_locked(server, _servers)
        _servers.add(server)


def deregister_server(server):
    """Drop a server from the scrape (called by
    ``InferenceServer.stop``); its label becomes reusable."""
    with _register_lock:
        _servers.discard(server)


def register_decode_server(server):
    """Track one live ``serving.DecodeServer`` for the scrape (weakref
    — a collected server drops out) with its ``mxnet_decode_*`` metric
    families. Each server gets a UNIQUE ``server=`` label: a second
    unnamed (or same-named) server is suffixed ``-2``, ``-3``, ... —
    duplicate label sets would make Prometheus reject the whole scrape.
    The check-and-assign runs under a lock so concurrently constructed
    servers cannot both claim one label."""
    with _register_lock:
        _assign_label_locked(server, _decode_servers)
        _decode_servers.add(server)


def deregister_decode_server(server):
    """Drop a decode server from the scrape (called by
    ``DecodeServer.stop``)."""
    with _register_lock:
        _decode_servers.discard(server)


def register_router(router):
    """Track one live ``serving.Router`` for the scrape — the
    ``mxnet_router_*`` families (label uniqueness enforced within the
    router set, same rules as :func:`register_decode_server`)."""
    with _register_lock:
        _assign_label_locked(router, _routers)
        _routers.add(router)


def deregister_router(router):
    """Drop a router from the scrape (called by ``Router.stop``)."""
    with _register_lock:
        _routers.discard(router)


def maybe_start(fresh_run=False):
    """Environment entry point (called from ``telemetry.start`` with
    ``fresh_run=True`` and from each DecodeServer and Router): start
    the endpoint when ``MXNET_METRICS_PORT`` is set, the watchdog
    when ``MXNET_WATCHDOG=1``. A fresh telemetry run re-arms a FRESH
    watchdog — the previous run's rolling step-time baseline belongs
    to a different workload and would fire spurious drift alerts on
    the new one."""
    port = envs.get_int("MXNET_METRICS_PORT", None)
    if port is not None and _http is None:
        try:
            serve(int(port))
        except (OSError, ValueError) as exc:
            warnings.warn("livemetrics: cannot start /metrics on port "
                          "%s (%s) — endpoint disabled" % (port, exc))
    if envs.get_bool("MXNET_WATCHDOG") \
            and (_watchdog is None or fresh_run):
        enable_watchdog()


# ---------------------------------------------------------------------------
# Prometheus text rendering
# ---------------------------------------------------------------------------

def _esc(value):
    """Prometheus label-value escape."""
    return str(value).replace("\\", r"\\").replace('"', r'\"') \
        .replace("\n", r"\n")


class _Page:
    """Accumulates one exposition page; emits # HELP/# TYPE once per
    metric family."""

    def __init__(self):
        self.lines = []
        self._seen = set()

    def add(self, name, value, labels=None, kind="gauge", help_=""):
        if value is None:
            return
        if name not in self._seen:
            self._seen.add(name)
            if help_:
                self.lines.append("# HELP %s %s" % (name, help_))
            self.lines.append("# TYPE %s %s" % (name, kind))
        if labels:
            lab = ",".join('%s="%s"' % (k, _esc(v))
                           for k, v in sorted(labels.items()))
            self.lines.append("%s{%s} %s" % (name, lab, _fmt(value)))
        else:
            self.lines.append("%s %s" % (name, _fmt(value)))

    def histogram(self, name, le_counts, sum_value, count,
                  labels=None, help_=""):
        """One histogram family per the exposition contract: TYPE is
        declared ONCE on the base name; the ``_bucket``/``_sum``/
        ``_count`` samples carry no TYPE lines of their own."""
        if name not in self._seen:
            self._seen.add(name)
            if help_:
                self.lines.append("# HELP %s %s" % (name, help_))
            self.lines.append("# TYPE %s histogram" % name)

        def line(suffix, value, extra=None):
            lab = dict(labels or {})
            if extra:
                lab.update(extra)
            if lab:
                body = ",".join('%s="%s"' % (k, _esc(v))
                                for k, v in sorted(lab.items()))
                self.lines.append("%s%s{%s} %s"
                                  % (name, suffix, body, _fmt(value)))
            else:
                self.lines.append("%s%s %s" % (name, suffix,
                                               _fmt(value)))

        for le, c in le_counts:
            line("_bucket", c, {"le": le})
        line("_bucket", count, {"le": "+Inf"})
        line("_sum", sum_value)
        line("_count", count)

    def text(self):
        return "\n".join(self.lines) + "\n"


def _fmt(v):
    if isinstance(v, bool):
        return "1" if v else "0"
    if isinstance(v, float):
        return repr(v)
    return str(v)


def _render_training(page):
    """Training-run families from ``telemetry.report()`` — the same
    aggregates the JSONL summary carries, live."""
    from . import telemetry
    rep = telemetry.report()
    page.add("mxnet_telemetry_run_active",
             1 if telemetry.enabled() else 0,
             help_="1 while a telemetry run is active")
    if rep is None:
        return
    page.add("mxnet_steps_total", rep["steps"], kind="counter",
             help_="training steps recorded by the telemetry run")
    page.add("mxnet_samples_total", rep["samples"], kind="counter")
    page.add("mxnet_skipped_steps_total", rep["skipped_steps"],
             kind="counter",
             help_="steps skipped by the non-finite fault guard")
    page.add("mxnet_goodput_ratio", rep.get("goodput"))
    page.add("mxnet_samples_per_sec", rep.get("samples_per_sec"))
    st = rep.get("step_time_ms") or {}
    for q in ("p50", "p90", "p99"):
        page.add("mxnet_step_time_ms", st.get(q),
                 labels={"quantile": q},
                 help_="step wall time over the telemetry ring")
    for phase, ms in (rep.get("phases_ms") or {}).items():
        page.add("mxnet_phase_ms_total", ms, labels={"phase": phase},
                 kind="counter",
                 help_="accounted wall time per step phase")
    # alert counts come from the watchdog's own monotonic per-kind
    # tallies, NOT the run summary's bounded alert window — a window
    # that trims old entries would make this "counter" decrease
    # mid-run, which rate()/increase() read as a bogus reset
    wd = _watchdog
    if wd is not None:
        for kind, n in sorted(wd.alerts().items()):
            page.add("mxnet_watchdog_alerts_total", n,
                     labels={"kind": kind}, kind="counter",
                     help_="SLO watchdog alerts by kind")


def _render_counters(page):
    from . import profiler
    for name, value in sorted(profiler.counters().items()):
        page.add("mxnet_profiler_counter", value,
                 labels={"name": name}, kind="counter",
                 help_="process-global profiler counters (decode "
                       "shed/timeout/preempt, router, watchdog, ...)")


def _render_decode(page):
    for srv in list(_decode_servers):
        try:
            st = srv.stats()
        except Exception:
            continue                       # mid-shutdown server
        lab = {"server": getattr(srv, "_metrics_label", None)
               or "default"}
        for key, help_ in (("requests", "generations submitted"),
                           ("completed", ""), ("cancelled", ""),
                           ("timeouts", ""), ("shed", ""),
                           ("preempted", "evicted under KV-pool "
                                         "pressure"),
                           ("errors", ""),
                           ("prefill_steps", ""),
                           ("decode_steps", ""),
                           ("tokens_out", "tokens generated")):
            page.add("mxnet_decode_%s_total" % key, st.get(key),
                     labels=lab, kind="counter", help_=help_)
        page.add("mxnet_decode_queue_depth", st.get("queue_depth"),
                 labels=lab)
        page.add("mxnet_decode_active", st.get("active"), labels=lab,
                 help_="requests holding decode slots now")
        page.add("mxnet_decode_window", st.get("window"), labels=lab,
                 help_="decode-step batch width (MXNET_DECODE_WINDOW)")
        page.add("mxnet_decode_tokens_per_sec",
                 st.get("tokens_per_sec"), labels=lab)
        page.add("mxnet_decode_prefill_fraction",
                 st.get("prefill_fraction"), labels=lab,
                 help_="prefill share of scheduler steps (the "
                       "continuous-batching mix)")
        for q in ("p50", "p99"):
            page.add("mxnet_decode_inter_token_ms",
                     (st.get("inter_token_ms") or {}).get(q),
                     labels=dict(lab, quantile=q),
                     help_="inter-token latency over the recent ring")
            page.add("mxnet_decode_ttft_ms",
                     (st.get("ttft_ms") or {}).get(q),
                     labels=dict(lab, quantile=q),
                     help_="time to first token (submit -> prefill "
                           "emit)")
        kv = st.get("kv") or {}
        page.add("mxnet_decode_kv_pages", kv.get("pages"), labels=lab,
                 help_="usable pages of the paged KV pool")
        page.add("mxnet_decode_kv_pages_used", kv.get("used"),
                 labels=lab)
        page.add("mxnet_decode_kv_pages_peak", kv.get("peak_used"),
                 labels=lab)
        page.add("mxnet_decode_kv_evicted_total", kv.get("evicted"),
                 labels=lab, kind="counter",
                 help_="pages reclaimed (the kv_evict path)")
        page.add("mxnet_decode_weight_swaps_total", st.get("swaps"),
                 labels=lab, kind="counter")
        page.add("mxnet_decode_weight_version",
                 st.get("weight_version"), labels=lab,
                 help_="parameter generation serving new requests")
        px = st.get("prefix") or {}
        if px.get("enabled"):
            page.add("mxnet_prefix_hits_total", px.get("hits"),
                     labels=lab, kind="counter",
                     help_="prompts admitted onto shared prefix pages")
            page.add("mxnet_prefix_misses_total", px.get("misses"),
                     labels=lab, kind="counter")
            page.add("mxnet_prefix_hit_rate", px.get("hit_rate"),
                     labels=lab)
            page.add("mxnet_prefix_hit_tokens_total",
                     px.get("hit_tokens"), labels=lab, kind="counter",
                     help_="prompt tokens served from the index "
                           "instead of prefill")
            page.add("mxnet_prefix_bytes_saved_total",
                     px.get("bytes_saved"), labels=lab,
                     kind="counter",
                     help_="K/V bytes not recomputed thanks to "
                           "sharing")
            page.add("mxnet_prefix_cow_splits_total",
                     px.get("cow_splits"), labels=lab, kind="counter",
                     help_="copy-on-write page splits")
            page.add("mxnet_prefix_cow_degraded_total",
                     px.get("cow_degraded"), labels=lab,
                     kind="counter",
                     help_="kv_cow faults degraded to private "
                           "re-prefill")
            pool = px.get("pool") or {}
            page.add("mxnet_prefix_entries", pool.get("entries"),
                     labels=lab, help_="pages held by the index")
            page.add("mxnet_prefix_shared_pages",
                     pool.get("shared_pages"), labels=lab,
                     help_="pages with more than one holder now")
            page.add("mxnet_prefix_evicted_total", pool.get("evicted"),
                     labels=lab, kind="counter",
                     help_="cold index entries reclaimed under "
                           "pressure")
        for owner, o in sorted((kv.get("owners") or {}).items()):
            olab = dict(lab, model=owner)
            page.add("mxnet_prefix_pool_pages_used", o.get("used"),
                     labels=olab,
                     help_="shared-pool pages held per model")
            if o.get("quota"):
                page.add("mxnet_prefix_pool_quota", o.get("quota"),
                         labels=olab)


def _render_router(page):
    for router in list(_routers):
        try:
            st = router.stats()
        except Exception:
            continue                       # mid-shutdown router
        lab = {"router": getattr(router, "_metrics_label", None)
               or "default"}
        for key, help_ in (("requests", "sessions admitted"),
                           ("dispatched", ""), ("completed", ""),
                           ("failed", ""), ("cancelled", ""),
                           ("shed", ""), ("timeouts", ""),
                           ("throttles", "dispatch rounds a tenant "
                                         "sat out its token bucket"),
                           ("failovers", "streaming sessions re-homed "
                                         "after a replica loss"),
                           ("replay_tokens", "tokens re-prefilled by "
                                             "failover replay"),
                           ("replicas_lost", ""), ("drains", ""),
                           ("drain_timeouts", ""),
                           ("route_faults", ""),
                           ("scale_up_signals", ""),
                           ("scale_down_signals", "")):
            page.add("mxnet_router_%s_total" % key, st.get(key),
                     labels=lab, kind="counter", help_=help_)
        page.add("mxnet_router_replicas_up", st.get("replicas_up"),
                 labels=lab, help_="replicas taking new sessions")
        page.add("mxnet_router_queued", st.get("queued"), labels=lab,
                 help_="sessions waiting in tenant queues")
        page.add("mxnet_router_sessions", st.get("sessions"),
                 labels=lab, help_="streaming sessions bound to "
                                   "replicas now")
        for rep in st.get("replicas") or ():
            rlab = dict(lab, replica=rep.get("name") or "?")
            page.add("mxnet_router_replica_outstanding_tokens",
                     rep.get("outstanding"), labels=rlab,
                     help_="tokens owed by sessions bound to the "
                           "replica (the dispatch signal)")
            page.add("mxnet_router_replica_sessions",
                     rep.get("sessions"), labels=rlab)
        for name, t in (st.get("tenants") or {}).items():
            tlab = dict(lab, tenant=name)
            page.add("mxnet_router_tenant_queued", t.get("queued"),
                     labels=tlab)
            page.add("mxnet_router_tenant_throttled_total",
                     t.get("throttled"), labels=tlab, kind="counter")
            page.add("mxnet_router_tenant_shed_total", t.get("shed"),
                     labels=tlab, kind="counter")
            for q in ("p50", "p99"):
                page.add("mxnet_router_tenant_latency_ms",
                         (t.get("latency_ms") or {}).get(q),
                         labels=dict(tlab, quantile=q),
                         help_="session completion latency (submit "
                               "-> done)")
        for q in ("p50", "p99"):
            page.add("mxnet_router_failover_resume_ms",
                     (st.get("failover_resume_ms") or {}).get(q),
                     labels=dict(lab, quantile=q),
                     help_="replica-loss detection to first resumed "
                           "token")


def _render_usage(page):
    """Per-tenant cost attribution from the process meter
    (``metering``): attributed tokens/FLOPs/page*seconds,
    prefix-cache credits, outcome counts, and the dual-entry
    reconciliation verdict — one gauge the alerting layer can page on
    when the books stop balancing."""
    from . import metering
    st = metering.snapshot()
    if st is None:
        return
    lab = {"meter": st.get("name") or "default"}
    for key, help_ in (("admitted", "usage records opened"),
                       ("dispatched", ""), ("closed", ""),
                       ("throttle_events", "")):
        page.add("mxnet_usage_%s_total" % key, st.get(key),
                 labels=lab, kind="counter", help_=help_)
    page.add("mxnet_usage_open", st.get("open"), labels=lab,
             help_="requests admitted but not yet closed")
    rec = st.get("reconcile") or {}
    page.add("mxnet_usage_reconciled", 1 if rec.get("ok") else 0,
             labels=lab, help_="1 while sum-over-tenants equals the "
                               "meter totals for every conserved "
                               "quantity")
    for name, t in sorted((st.get("tenants") or {}).items()):
        tlab = dict(lab, tenant=name)
        for key, help_ in (
                ("prompt_tokens", "prompt tokens attributed"),
                ("generated_tokens", "generated tokens attributed"),
                ("replay_tokens", "failover re-prefill tokens billed "
                                  "(exactly once, to the surviving "
                                  "replica)"),
                ("replay_cached_tokens", ""),
                ("prefix_hit_tokens", "tokens credited back by "
                                      "prefix-cache sharing"),
                ("prefix_bytes_saved", ""),
                ("throttle_events", "")):
            page.add("mxnet_usage_tenant_%s_total" % key, t.get(key),
                     labels=tlab, kind="counter", help_=help_)
        page.add("mxnet_usage_tenant_flops_total", t.get("flops"),
                 labels=tlab, kind="counter",
                 help_="attributed FLOPs (batch-share of each "
                       "dispatched program's analytic cost)")
        page.add("mxnet_usage_tenant_page_seconds_total",
                 t.get("page_seconds"), labels=tlab, kind="counter",
                 help_="KV page*seconds integrated at decode step "
                       "boundaries")
        for outcome, n in sorted((t.get("outcomes") or {}).items()):
            page.add("mxnet_usage_tenant_outcomes_total", n,
                     labels=dict(tlab, outcome=outcome),
                     kind="counter")


def _render_identity(page):
    """The fleet-join info gauge: constant 1 whose labels say WHO this
    process is — run id, rank, restart generation, torch/CUDA versions
    (the JAX package labels jax/jaxlib there) — so any series scraped
    from this endpoint joins to its fleet coordinates with one
    ``group_left`` instead of per-series labels."""
    from . import telemetry, tracing
    import torch
    ident = tracing.process_identity()
    rep = telemetry.report()
    page.add("mxnet_identity_info", 1,
             labels={"run": (rep or {}).get("run_id") or "",
                     "rank": ident["rank"],
                     "generation": ident["gen"],
                     "torch": torch.__version__,
                     "cuda": torch.version.cuda or ""},
             help_="constant 1; the labels identify this process "
                   "(run id, rank, restart generation, torch/CUDA "
                   "versions)")


def _render_serving(page):
    for srv in list(_servers):
        try:
            st = srv.stats()
            lats = srv.latency_snapshot()
        except Exception:
            continue                       # mid-shutdown server
        lab = {"server": getattr(srv, "_metrics_label", None)
               or "default"}
        page.add("mxnet_serving_requests_total", st["requests"],
                 labels=lab, kind="counter",
                 help_="requests submitted (admission attempts)")
        page.add("mxnet_serving_completed_total", st["completed"],
                 labels=lab, kind="counter")
        page.add("mxnet_serving_shed_total", st["shed"], labels=lab,
                 kind="counter",
                 help_="requests shed at the bounded admission queue")
        page.add("mxnet_serving_timeouts_total", st["timeouts"],
                 labels=lab, kind="counter")
        page.add("mxnet_serving_errors_total", st["errors"],
                 labels=lab, kind="counter")
        page.add("mxnet_serving_batches_total", st["batches"],
                 labels=lab, kind="counter")
        page.add("mxnet_serving_queue_depth", st["queue_depth"],
                 labels=lab,
                 help_="admission queue depth now (bound: max_queue)")
        page.add("mxnet_serving_queue_peak", st["queue_peak"],
                 labels=lab)
        page.add("mxnet_serving_queue_bound", st["max_queue"],
                 labels=lab)
        page.add("mxnet_serving_occupancy_ratio", st.get("occupancy"),
                 labels=lab,
                 help_="mean filled share of dispatched bucket slots")
        page.add("mxnet_serving_rps", st.get("rps"), labels=lab)
        lat = st.get("latency_ms") or {}
        for q in ("p50", "p90", "p99"):
            page.add("mxnet_serving_latency_ms", lat.get(q),
                     labels=dict(lab, quantile=q),
                     help_="request latency over the recent ring")
        for i, n in enumerate(st.get("replica_batches") or []):
            page.add("mxnet_serving_replica_batches_total", n,
                     labels=dict(lab, replica=str(i)), kind="counter")
        for i, ms in enumerate(st.get("replica_service_ms") or []):
            page.add("mxnet_serving_replica_service_ms", ms,
                     labels=dict(lab, replica=str(i)),
                     help_="mean batch service time per replica "
                           "(straggler signal)")
        # recent-window latency histogram (the ring, not all-time):
        # cumulative le buckets per the Prometheus histogram contract
        ms_vals = [v * 1e3 for v in lats]
        bins = [0] * (len(LATENCY_BUCKETS_MS) + 1)
        for v in ms_vals:
            bins[bisect.bisect_left(LATENCY_BUCKETS_MS, v)] += 1
        le_counts, cum = [], 0
        for le, c in zip(LATENCY_BUCKETS_MS, bins):
            cum += c
            le_counts.append(("%g" % le, cum))
        page.histogram(
            "mxnet_serving_latency_recent_ms", le_counts,
            round(sum(ms_vals), 3), len(ms_vals), labels=lab,
            help_="request latency histogram over the recent "
                  "latency ring")


def render():
    """The whole ``/metrics`` page as Prometheus text exposition."""
    page = _Page()
    page.add("mxnet_up", 1, help_="the mxnet_tpu process is alive")
    _render_identity(page)
    _render_training(page)
    _render_counters(page)
    _render_serving(page)
    _render_decode(page)
    _render_router(page)
    _render_usage(page)
    return page.text()


# ---------------------------------------------------------------------------
# the HTTP endpoint
# ---------------------------------------------------------------------------

def serve(port=None, host=None):
    """Start the ``/metrics`` endpoint on a daemon thread (idempotent
    — a second call returns the live port). ``port`` defaults to
    ``MXNET_METRICS_PORT``; 0 picks an ephemeral port. ``host``
    defaults to ``MXNET_METRICS_HOST`` or ``127.0.0.1`` — localhost
    by default on purpose. Returns the bound port."""
    global _http
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
    with _http_lock:
        if _http is not None:
            return _http[0].server_address[1]
        if port is None:
            port = envs.get_int("MXNET_METRICS_PORT")
        if host is None:
            host = envs.get_str("MXNET_METRICS_HOST") or "127.0.0.1"

        class _Handler(BaseHTTPRequestHandler):
            def do_GET(self):
                if self.path.split("?", 1)[0] not in ("/metrics", "/"):
                    self.send_error(404)
                    return
                try:
                    body = render().encode("utf-8")
                except Exception as exc:      # noqa: BLE001 — a render
                    # bug must surface as a 500, never kill the server
                    self.send_error(500, explain=str(exc)[:200])
                    return
                self.send_response(200)
                self.send_header(
                    "Content-Type",
                    "text/plain; version=0.0.4; charset=utf-8")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):       # scrapes are not news
                pass

        httpd = ThreadingHTTPServer((host, int(port)), _Handler)
        httpd.daemon_threads = True
        thread = threading.Thread(target=httpd.serve_forever,
                                  name="mxnet-metrics", daemon=True)
        thread.start()
        _http = (httpd, thread)
        return httpd.server_address[1]


def server_port():
    """The live endpoint's port, or None when not serving."""
    with _http_lock:
        return _http[0].server_address[1] if _http else None


def stop_server():
    """Shut the endpoint down (tests; production just lets the daemon
    thread die with the process)."""
    global _http
    with _http_lock:
        pair, _http = _http, None
    if pair is not None:
        pair[0].shutdown()
        pair[0].server_close()
        pair[1].join(timeout=5)


# ---------------------------------------------------------------------------
# the SLO watchdog
# ---------------------------------------------------------------------------

class Watchdog:
    """Rolling-baseline SLO detector. Observes step records (installed
    as telemetry's ``_watch_step`` hook) and cumulative serving
    snapshots (:meth:`on_serving`, installed as telemetry's
    ``_watch_serving`` hook: the InferenceServer's records feed it) and
    emits one structured ``alert``
    telemetry record + one warning per alert kind:

    - ``step_time_drift`` — recent-window step-time p50 above
      ``MXNET_WATCHDOG_DRIFT`` (default 1.5) x the rolling baseline
      p50 for ``MXNET_WATCHDOG_SUSTAIN`` (default 10) consecutive
      steps. The baseline (``MXNET_WATCHDOG_BASELINE`` steps, default
      50) only absorbs samples while no breach is building, so a
      regression cannot slowly become the new normal.
    - ``serving_shed_rate`` — sheds/submits over the snapshot delta
      above ``MXNET_WATCHDOG_SHED_RATE`` (default 0.3) once at least
      ``MXNET_WATCHDOG_MIN_REQUESTS`` (default 20) new requests
      arrived.
    - ``serving_queue_full`` — admission queue depth at or above 90%
      of its bound (``MXNET_WATCHDOG_QUEUE_FRAC``).
    - ``replica_skew`` — slowest replica's mean batch service time
      above ``MXNET_WATCHDOG_SKEW`` (default 2.0) x the replica
      median, each replica having served ≥3 batches — the straggler
      primitive.

    Serving baselines are kept per server (snapshots carry the server
    name), and the serving conditions alert on the healthy→breached
    edge with hysteresis: a breach that persists across snapshots
    emits ONE alert record, re-arming only when it clears. The
    telemetry alert list is additionally bounded at the sink.
    """

    def __init__(self):
        self.drift = max(1.01, envs.get_float("MXNET_WATCHDOG_DRIFT"))
        self.window = max(2, envs.get_int("MXNET_WATCHDOG_WINDOW"))
        self.baseline_n = max(
            2, envs.get_int("MXNET_WATCHDOG_BASELINE"))
        self.sustain = max(1, envs.get_int("MXNET_WATCHDOG_SUSTAIN"))
        self.shed_rate = envs.get_float("MXNET_WATCHDOG_SHED_RATE")
        self.min_requests = max(
            1, envs.get_int("MXNET_WATCHDOG_MIN_REQUESTS"))
        self.queue_frac = envs.get_float("MXNET_WATCHDOG_QUEUE_FRAC")
        self.skew = max(1.01, envs.get_float("MXNET_WATCHDOG_SKEW"))
        self._baseline = deque(maxlen=self.baseline_n)
        self._recent = deque(maxlen=self.window)
        self._breach = 0
        self._prev_serving = {}   # per-server previous snapshot
        self._fired = {}          # kind -> count (warn once per kind)
        # serving conditions re-arm instead of re-firing: a breach
        # alerts once on entry, then stays silent until it CLEARS —
        # keys are (kind, server)
        self._active = set()
        # RLock: on_serving holds it across its read-modify-write of
        # the previous snapshot (every replica worker thread can emit
        # a serving record concurrently) and _fire re-enters it
        self._lock = threading.RLock()

    # -- alert plumbing ----------------------------------------------------
    def _fire(self, kind, message, **fields):
        with self._lock:
            first = kind not in self._fired
            self._fired[kind] = self._fired.get(kind, 0) + 1
        from . import profiler, telemetry
        rec = {"kind": kind, "message": message}
        rec.update(fields)
        telemetry.alert_event(rec)
        profiler.increment_counter("watchdog_alerts")
        if first:
            warnings.warn("watchdog: %s — %s" % (kind, message))

    def alerts(self):
        with self._lock:
            return dict(self._fired)

    # -- step SLO ----------------------------------------------------------
    def on_step(self, rec):
        dur = rec.get("dur_ms")
        if dur is None:
            return
        from .telemetry import percentile
        with self._lock:
            self._on_step_locked(dur, percentile)

    def _on_step_locked(self, dur, percentile):
        if len(self._baseline) < self.baseline_n:
            self._baseline.append(dur)
            return
        self._recent.append(dur)
        if len(self._recent) < self.window:
            return
        base_p50 = percentile(self._baseline, 50)
        recent_p50 = percentile(self._recent, 50)
        if base_p50 and recent_p50 > self.drift * base_p50:
            self._breach += 1
            if self._breach == self.sustain:
                self._fire(
                    "step_time_drift",
                    "step-time p50 %.3f ms vs rolling baseline %.3f "
                    "ms (x%.2f > x%.2f) sustained %d steps"
                    % (recent_p50, base_p50, recent_p50 / base_p50,
                       self.drift, self.sustain),
                    recent_p50_ms=round(recent_p50, 3),
                    baseline_p50_ms=round(base_p50, 3),
                    ratio=round(recent_p50 / base_p50, 3))
        else:
            # healthy sample: the rolling baseline may absorb it
            self._breach = 0
            self._baseline.append(dur)

    # -- serving SLOs ------------------------------------------------------
    def on_serving(self, st):
        with self._lock:
            self._on_serving_locked(st)

    def _edge(self, kind, server, in_breach):
        """Entry-edge detector with hysteresis: True only when the
        (kind, server) condition goes healthy→breached; a breach that
        persists across snapshots alerts once, then re-arms when it
        clears — a days-long breach must not emit thousands of
        identical alert records."""
        key = (kind, server)
        if in_breach:
            if key in self._active:
                return False
            self._active.add(key)
            return True
        self._active.discard(key)
        return False

    def _on_serving_locked(self, st):
        server = st.get("name") or "default"
        prev = self._prev_serving.get(server)
        d_req = None
        if prev is not None:
            d_req = st.get("requests", 0) - prev.get("requests", 0)
            d_shed = st.get("shed", 0) - prev.get("shed", 0)
            if d_req < 0:
                # cumulative counters never decrease within one
                # server lifetime, so a regression is either a
                # RESTARTED server reusing this label (counters back
                # near zero — re-seed, or the dead generation's
                # baseline blinds the check until the new one
                # out-counts it) or a slightly-stale OUT-OF-ORDER
                # snapshot from a racing replica worker (counters
                # just below the baseline — drop it; the newer
                # snapshot was already evaluated and the baseline
                # must not rewind)
                if st.get("requests", 0) * 2 < prev.get("requests",
                                                        0):
                    prev = d_req = None
                else:
                    return
        if prev is None:
            # first snapshot for this server (generation): the
            # cumulative counters span its whole pre-watchdog history
            # — seed the baseline without evaluating the rate, or a
            # long-recovered burst of sheds would fire a spurious
            # alert on arm
            self._prev_serving.pop(server, None)
            self._prev_serving[server] = {
                "requests": st.get("requests", 0),
                "shed": st.get("shed", 0)}
            # bound the per-server table in server-churning processes
            # (fresh labels accumulate); prune the evicted server's
            # hysteresis keys with it
            while len(self._prev_serving) > 128:
                old = next(iter(self._prev_serving))
                del self._prev_serving[old]
                self._active = {k for k in self._active
                                if k[1] != old}
        if d_req is not None and d_req >= self.min_requests:
            # baselines are PER SERVER (snapshots carry the server
            # name): one server's counters must never dilute
            # another's deltas. The baseline only advances when the
            # check actually RUNS — small per-snapshot deltas
            # accumulate until they clear min_requests instead of
            # being absorbed unevaluated — and counters only move
            # forward, so an out-of-order older snapshot (two replica
            # workers emitting concurrently) cannot rewind it.
            self._prev_serving[server] = {
                "requests": max(st.get("requests", 0),
                                prev.get("requests", 0)),
                "shed": max(st.get("shed", 0), prev.get("shed", 0))}
            breach = d_shed > 0 and d_shed / float(d_req) > \
                self.shed_rate
            if self._edge("serving_shed_rate", server, breach):
                self._fire(
                    "serving_shed_rate",
                    "server %s shed %d of %d requests (%.0f%% > "
                    "%.0f%%) since the previous snapshot — sustained "
                    "overload, raise capacity or shed earlier "
                    "upstream" % (server, d_shed, d_req,
                                  100.0 * d_shed / d_req,
                                  100.0 * self.shed_rate),
                    server=server, shed=d_shed, requests=d_req,
                    rate=round(d_shed / float(d_req), 4))
        bound = st.get("max_queue") or 0
        depth = st.get("queue_depth", 0)
        if bound and self._edge("serving_queue_full", server,
                                depth >= self.queue_frac * bound):
            self._fire(
                "serving_queue_full",
                "server %s admission queue depth %d at %.0f%% of "
                "bound %d — latency is queue-bound; sheds are "
                "imminent" % (server, depth, 100.0 * depth / bound,
                              bound),
                server=server, queue_depth=depth, max_queue=bound)
        service = st.get("replica_service_ms") or []
        batches = st.get("replica_batches") or []
        valid = [(i, ms) for i, ms in enumerate(service)
                 if ms is not None and i < len(batches)
                 and batches[i] >= 3]
        if len(valid) >= 2:
            from .telemetry import percentile
            med = percentile([ms for _, ms in valid], 50)
            worst_i, worst = max(valid, key=lambda kv: kv[1])
            breach = bool(med) and worst > self.skew * med
            if self._edge("replica_skew", server, breach):
                self._fire(
                    "replica_skew",
                    "server %s replica %d mean batch service %.3f ms "
                    "vs replica median %.3f ms (x%.2f > x%.2f) — "
                    "straggling device/host"
                    % (server, worst_i, worst, med, worst / med,
                       self.skew),
                    server=server, replica=worst_i,
                    service_ms=round(worst, 3),
                    median_ms=round(med, 3),
                    ratio=round(worst / med, 3))


def enable_watchdog():
    """Install a fresh watchdog as telemetry's step hook (re-arming any
    previously fired alerts). Returns it."""
    global _watchdog
    from . import telemetry
    wd = Watchdog()
    _watchdog = wd
    telemetry._watch_step = wd.on_step
    telemetry._watch_serving = wd.on_serving
    return wd


def disable_watchdog():
    global _watchdog
    from . import telemetry
    telemetry._watch_step = None
    telemetry._watch_serving = None
    _watchdog = None


def watchdog_enabled():
    return _watchdog is not None
