"""Fleet serving router: one front door over N decode replicas that
keeps streaming through replica loss (counterpart of
``mxnet_tpu/serving/router.py``, with the same names and behaviour; the
replicas are the port's DecodeServers, each replaying its own CUDA
graphs on the card).

Everything below a single server is already fault-hardened —
:class:`~mxnet_tpu_torch.serving.DecodeServer` has priorities, preemption,
and hot swap — but one replica dying would still kill every stream it
owns. :class:`Router` is the scale-out tier above it (the capability
the retired distributed-KVStore serving shim pointed at): it admits
sessions into per-tenant queues, dispatches them across replicas, and
transparently re-homes the streams of a dead replica so the client
iterator sees a latency blip, never an error.

- **Least-outstanding-tokens dispatch** — a new session goes to the
  ``up`` replica owing the fewest tokens (budgeted minus streamed over
  its bound sessions), bounded by ``MXNET_ROUTER_MAX_INFLIGHT``
  sessions per replica; excess demand waits in the tenant queues where
  fairness (not arrival order) decides what runs next.
- **Session affinity** — a streaming session's KV pages live on ONE
  replica; the router binds the session there and relays its tokens
  until it completes or the replica dies. There is no mid-stream
  migration of healthy sessions: pages are replica-local state.
- **Per-tenant fairness** — each tenant has a token bucket (rate/
  burst, counted in prompt + budgeted generation tokens) and a
  weighted-fair-queueing weight, layered on the existing priority
  classes: WFQ picks WHICH tenant's head dispatches next (a flooding
  tenant cannot starve a light one), the bucket caps a tenant's
  sustained token rate, and priorities keep their meaning inside each
  replica (overload sheds the lowest class first) and inside each
  tenant queue (the router's own bounded queue sheds the newest
  lowest-priority member).
- **Failover by re-prefill replay** — replica health is confirmed by
  :class:`~mxnet_tpu_torch.serving.fleet.FleetMonitor` (the training
  heartbeat's two-strike / self-starvation / clean-departure guards
  over an in-band probe). On a confirmed loss, every affected session
  is re-submitted elsewhere: the router replays prompt + every
  already-emitted token as ONE re-prefill, and greedy decode makes
  the resumed stream token-identical from the failure point (the same
  full-sequence-forward oracle ``tests/test_decode.py`` proves). The
  client's ``tokens()`` iterator never learns; failover sessions
  resume ahead of new admissions and are never re-charged to the
  tenant bucket.
- **Graceful drain** — :meth:`Router.drain` stops admitting to a
  replica, lets its streams finish, then stops the server (pages come
  back through the counted ``kv_evict`` path) and retires it as a
  CLEAN departure the monitor never misreads as a loss. Sessions
  still streaming past ``MXNET_ROUTER_DRAIN_TIMEOUT_MS`` fail over to
  the remaining replicas instead of blocking the drain.
- **Autoscaler hook** — with a ``supervisor`` callback, the router
  watches the livemetrics SLO watchdog's pressure alerts
  (queue-at-bound, shed rate, replica skew) and calls
  ``supervisor("scale_up", router, info)`` on new ones; a fleet idle
  for ``MXNET_ROUTER_AUTOSCALE_IDLE_ROUNDS`` sweeps gets ONE
  ``"scale_down"`` suggestion. The callback starts/drains replicas
  (``add_replica``/``drain``); the router never spawns processes
  itself.
- **Faults** — ``serve_route`` fires once per dispatch (a planned
  raise is counted and survived; a hang stalls dispatch so queued
  sessions age deterministically); ``replica_lost`` fires per replica
  per health sweep (a planned raise IS the loss confirmation).
- **Observability** — cumulative ``router`` telemetry records
  (failovers, replayed re-prefill tokens, per-replica outstanding
  tokens, per-tenant throttles/latency, drains, detection-to-resume
  latency), the diagnose Router table, and ``mxnet_router_*``
  /metrics gauges; trace spans and instants on each session's track,
  joined to the replica's spans by the wire context each dispatch
  carries; the meter's per-request hooks; a confirmed replica loss is
  an ``alert`` record, which the flight recorder dumps on.

Fallback matrix: a single-replica router is today's single-server
behavior plus the relay (same tokens, same typed errors); with no
router at all, nothing here is imported and every existing serving
path is byte-identical.

``start=False`` leaves the pump unstarted so tests drive
:meth:`Router.pump` deterministically — one pump is one health sweep
(when due), one WFQ dispatch pass, one scheduler step for any
unstarted replica, and one relay pass.
"""
from __future__ import annotations

import itertools
import queue as _queue_mod
import threading
import time
import warnings
from collections import deque

import numpy as _np

from .. import envs, fault, metering, telemetry, tracing
from ..base import MXNetError
from . import fleet
from .decode import req_deadline
from .server import (RequestTimeoutError, ServerClosedError,
                     ServerOverloadedError, validate_priority,
                     shed_lowest_locked)

__all__ = ["Router", "RouterRequest"]

_DONE = object()


class RouterRequest:
    """One fleet-routed streaming session: the client-facing future.
    Mirrors :class:`~mxnet_tpu_torch.serving.DecodeRequest` (``tokens()``
    iterator, ``result()``, ``cancel()``), but its tokens come from
    the router's relay — which replica generates them can change
    across a failover without the consumer noticing. ``emitted`` is
    the authoritative ledger of what the client was shown; failover
    replays exactly ``prompt + emitted``."""

    __slots__ = ("prompt", "tenant", "max_new", "priority", "deadline",
                 "eos_id", "request_id", "t_submit", "state",
                 "failovers", "_emitted", "_out", "_event", "_error",
                 "_cancelled", "_replica", "_inner", "_inner_fwd",
                 "_failover", "_t_lost", "_resume_pending", "_t_trace")

    def __init__(self, prompt, tenant, max_new, priority, deadline,
                 eos_id, request_id):
        self.prompt = prompt
        self.tenant = tenant
        self.max_new = max_new
        self.priority = priority
        self.deadline = deadline
        self.eos_id = eos_id
        self.request_id = request_id
        self.t_submit = time.monotonic()
        self.state = "queued"    # queued|active|failover|done|failed
                                 # |cancelled
        self.failovers = 0
        self._emitted = []
        self._out = _queue_mod.Queue(maxsize=max_new + 2)
        self._event = threading.Event()
        self._error = None
        self._cancelled = False
        self._replica = None     # fleet.Replica while bound
        self._inner = None       # the replica's DecodeRequest
        self._inner_fwd = 0      # inner.generated tokens forwarded
        self._failover = False   # queued for re-dispatch after a loss
        self._t_lost = None      # loss-detection time (resume clock)
        self._resume_pending = False
        self._t_trace = None     # trace-clock submit stamp (None when
                                 # tracing is off — the queue span)

    @property
    def emitted(self):
        """Tokens already shown to the client (the replay ledger)."""
        return list(self._emitted)

    def done(self):
        return self._event.is_set()

    def cancel(self):
        """Drop this session: a queued one is reaped before dispatch,
        a streaming one is cancelled on its replica and its pages come
        back through the counted reclaim. Completes WITHOUT an error
        (the stream just ends; ``state == "cancelled"``)."""
        self._cancelled = True
        inner = self._inner
        if inner is not None:
            inner.cancel()

    def result(self, timeout=None):
        """Block for the full generation; returns the emitted tokens
        as int32 (the partial list for a cancelled session). Raises
        the session's error."""
        if not self._event.wait(timeout):
            raise RequestTimeoutError(
                "session %s did not complete within %ss"
                % (self.request_id, timeout))
        if self._error is not None:
            raise self._error
        return _np.asarray(self._emitted, _np.int32)

    def tokens(self, timeout=None):
        """Iterate tokens as the relay forwards them (``timeout``
        bounds the wait per token). A failover shows up as a latency
        blip between tokens, never as an error or a duplicate."""
        while True:
            item = self._out.get(timeout=timeout)
            if item is _DONE:
                if self._error is not None:
                    raise self._error
                return
            yield item

    # -- router side -------------------------------------------------------
    def _push(self, token):
        try:
            self._out.put_nowait(int(token))
        except _queue_mod.Full:       # unreachable by construction
            pass

    def _complete(self, error=None, state=None):
        """First caller wins; the ``_DONE`` sentinel always lands (the
        same never-hang contract as DecodeRequest._complete)."""
        if self._event.is_set():
            return
        self._error = error
        self.state = state if state is not None \
            else ("failed" if error is not None else "done")
        while True:
            try:
                self._out.put_nowait(_DONE)
                break
            except _queue_mod.Full:
                try:
                    self._out.get_nowait()
                except _queue_mod.Empty:
                    pass
        self._event.set()


class _Tenant:
    """One tenant's router-side state: the FIFO of queued sessions,
    the token bucket (rate/burst in tokens), and the WFQ virtual
    finish time that decides whose head dispatches next."""

    __slots__ = ("name", "weight", "rate", "burst", "bucket",
                 "_last_refill", "finish", "queue", "submitted",
                 "completed", "failed", "shed", "throttled", "lat")

    def __init__(self, name, weight, rate, burst):
        if weight <= 0:
            raise MXNetError(
                "router tenant %r: WFQ weight must be > 0, got %s"
                % (name, weight))
        self.name = name
        self.weight = float(weight)
        self.rate = float(rate)
        if burst and burst > 0:
            self.burst = float(burst)
        else:
            self.burst = 2.0 * self.rate if self.rate > 0 \
                else float("inf")
        self.bucket = self.burst          # starts full
        self._last_refill = None
        self.finish = 0.0                 # WFQ virtual finish time
        self.queue = deque()
        self.submitted = 0
        self.completed = 0
        self.failed = 0
        self.shed = 0
        self.throttled = 0
        self.lat = deque(maxlen=512)      # completion latency, ms

    def refill(self, now):
        if self.rate <= 0:
            return
        if self._last_refill is None:
            self._last_refill = now
            return
        dt = now - self._last_refill
        if dt > 0:
            self.bucket = min(self.burst, self.bucket + self.rate * dt)
            self._last_refill = now


def _cost(req):
    """A session's token cost for quota/WFQ purposes: prompt plus the
    full generation budget (charged at dispatch, so a throttled
    tenant's backlog drains at its refill rate)."""
    return len(req.prompt) + req.max_new


class Router:
    """The fleet front door (module docstring has the architecture).
    ``replicas`` are live DecodeServers (or ``fleet.Replica``
    wrappers); ``tenants`` maps tenant name to ``{"weight", "rate",
    "burst"}`` overrides of the ``MXNET_ROUTER_TENANT_*`` defaults;
    ``supervisor`` arms the autoscaler hook (``supervisor(action,
    router, info)`` with action ``"scale_up"``/``"scale_down"``).
    ``start=False`` leaves the pump unstarted for deterministic
    tests."""

    def __init__(self, replicas=(), *, name=None, tenants=None,
                 probe_interval_ms=None, strikes=None,
                 max_inflight=None, drain_timeout_ms=None,
                 record_every=None, supervisor=None, start=True):
        self.name = name
        self._lock = threading.RLock()
        self._replicas = []
        self._rep_seq = itertools.count(0)
        self._monitor = fleet.FleetMonitor(strikes=strikes,
                                           interval_ms=probe_interval_ms)
        self._max_inflight = max(1, int(max_inflight)
                                 if max_inflight is not None
                                 else envs.get_int(
                                     "MXNET_ROUTER_MAX_INFLIGHT"))
        self._tenant_bound = max(1, envs.get_int(
            "MXNET_ROUTER_TENANT_QUEUE"))
        self._drain_timeout = max(
            int(drain_timeout_ms) if drain_timeout_ms is not None
            else envs.get_int("MXNET_ROUTER_DRAIN_TIMEOUT_MS"), 1) / 1e3
        self._record_every = max(1, int(record_every) if record_every
                                 else envs.get_int(
                                     "MXNET_ROUTER_RECORD_EVERY"))
        self._levels = max(1, envs.get_int("MXNET_SERVING_PRIORITIES"))
        self._tenant_cfg = {k: dict(v) for k, v
                            in (tenants or {}).items()}
        self._tenants = {}
        self._sessions = []       # dispatched (bound) sessions
        self._vtime = 0.0         # WFQ system virtual time
        self._rid = itertools.count(1)
        self._stats = {"requests": 0, "dispatched": 0, "completed": 0,
                       "failed": 0, "cancelled": 0, "shed": 0,
                       "timeouts": 0, "failovers": 0,
                       "replay_tokens": 0, "replay_cached_tokens": 0,
                       "replicas_lost": 0,
                       "drains": 0, "drain_timeouts": 0,
                       "route_faults": 0, "scale_up_signals": 0,
                       "scale_down_signals": 0}
        self._supervisor = supervisor
        self._alerts_seen = 0
        self._idle_rounds = 0
        self._idle_fired = False
        self._idle_limit = max(1, envs.get_int(
            "MXNET_ROUTER_AUTOSCALE_IDLE_ROUNDS"))
        self._resume_ms = deque(maxlen=512)   # detect -> resume, ms
        self._rounds_since_record = 0
        self._stopping = False
        self._closed = False
        self._started = False
        self._thread = None
        self._wake = threading.Event()
        for rep in replicas:
            self.add_replica(rep)
        from .. import livemetrics
        livemetrics.register_router(self)
        livemetrics.maybe_start()
        if start:
            self.start()

    # -- membership --------------------------------------------------------
    def add_replica(self, server, name=None):
        """Join one replica (a DecodeServer or a prepared
        ``fleet.Replica``) into the rotation. Returns the Replica."""
        if isinstance(server, fleet.Replica):
            rep = server
        else:
            rep = fleet.Replica(server, name=name,
                                index=next(self._rep_seq))
        with self._lock:
            if any(r.name == rep.name for r in self._replicas):
                raise MXNetError(
                    "router: duplicate replica name %r" % rep.name)
            self._replicas.append(rep)
        self._monitor.forget(rep.name)
        self._wake.set()
        return rep

    def replica(self, name):
        with self._lock:
            for rep in self._replicas:
                if rep.name == name:
                    return rep
        raise MXNetError("router: no replica named %r" % name)

    def replicas_up(self):
        with self._lock:
            return [r for r in self._replicas if r.state == "up"]

    # -- lifecycle ---------------------------------------------------------
    def start(self):
        if self._started:
            return self
        if self._closed:
            raise ServerClosedError("Router already stopped")
        self._started = True
        self._thread = threading.Thread(
            target=self._loop, name="mxnet-router", daemon=True)
        self._thread.start()
        return self

    def _loop(self):
        idle = min(self._monitor.interval, 0.005)
        while True:
            with self._lock:
                if self._stopping:
                    break
            if not self.pump():
                self._wake.wait(idle)
                self._wake.clear()

    def stop(self, drain=True):
        """Stop the router. ``drain=True`` finishes every queued and
        streaming session first (bounded by the drain timeout), then
        stops each replica through its own draining stop — pages come
        back through the counted reclaim. ``drain=False`` (or the
        timeout) fails the leftovers with the typed ServerClosedError.
        Either way no consumer is left hanging."""
        if self._closed:
            return
        with self._lock:
            self._stopping = True
        self._wake.set()
        if self._started and self._thread is not None:
            self._thread.join(timeout=max(self._drain_timeout, 5.0))
        if drain:
            deadline = time.monotonic() + self._drain_timeout
            while time.monotonic() < deadline:
                with self._lock:
                    busy = bool(self._sessions) or any(
                        t.queue for t in self._tenants.values())
                if not busy:
                    break
                if not self.pump():
                    time.sleep(0.001)
        with self._lock:
            leftovers = list(self._sessions)
            for t in self._tenants.values():
                leftovers.extend(t.queue)
                t.queue.clear()
        for req in leftovers:
            self._retire(req, ServerClosedError(
                "router stopped; session %s dropped" % req.request_id))
        with self._lock:
            reps = list(self._replicas)
        for rep in reps:
            if rep.state == "lost" or rep.server._closed:
                continue
            rep.server.stop(drain=drain)
            rep.state = "drained"
        self._closed = True
        self._emit_record()
        # the final usage snapshot rides the same stop edge, so a
        # metered run's sink always ends with books that cover every
        # session this router retired
        metering.emit()
        from .. import livemetrics
        livemetrics.deregister_router(self)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False

    # -- admission ---------------------------------------------------------
    def submit(self, prompt, *, tenant="default", max_new_tokens=None,
               priority=0, deadline_ms=None, eos_id=None):
        """Admit one streaming session for ``tenant``. Returns a
        :class:`RouterRequest`. The session waits in its tenant's
        queue until WFQ + the tenant's token bucket let it dispatch to
        the least-loaded replica; ``priority`` keeps its server-side
        meaning and additionally orders shedding inside the tenant's
        bounded router queue."""
        if self._closed or self._stopping:
            raise ServerClosedError("router is stopped")
        prompt = _np.asarray(prompt)
        if prompt.ndim != 1 or prompt.size < 1:
            raise MXNetError(
                "Router.submit: prompt must be a non-empty 1-D token "
                "array, got shape %s" % (prompt.shape,))
        prompt = prompt.astype(_np.int32)
        ups = self.replicas_up()
        if not ups:
            raise ServerClosedError("router has no live replicas")
        top = max(r.replay_limit for r in ups)
        if len(prompt) > top:
            raise MXNetError(
                "Router.submit: prompt length %d exceeds the fleet's "
                "largest ladder top %d" % (len(prompt), top))
        budget = max(r.max_new for r in ups)
        max_new = int(max_new_tokens) if max_new_tokens is not None \
            else min(r.max_new for r in ups)
        if not 1 <= max_new <= budget:
            raise MXNetError(
                "Router.submit: max_new_tokens must be in 1..%d (the "
                "fleet budget), got %d" % (budget, max_new))
        priority = validate_priority(priority, self._levels)
        rid = "r%06d" % next(self._rid)
        req = RouterRequest(prompt, str(tenant), max_new, priority,
                            req_deadline(float(deadline_ms) / 1e3
                                         if deadline_ms is not None
                                         else None),
                            eos_id, rid)
        if tracing.enabled():
            req._t_trace = tracing.now()     # the queue span's start
        victim = None
        shed = False
        with self._lock:
            t = self._tenant_state(req.tenant)
            self._stats["requests"] += 1
            t.submitted += 1
            if len(t.queue) >= self._tenant_bound:
                victim = shed_lowest_locked(t.queue, priority)
                self._stats["shed"] += 1
                t.shed += 1
                if victim is None:
                    shed = True
            if not shed:
                t.queue.append(req)
        # every submission opens a usage record — including the ones
        # shed right back — so metering's admitted count reconciles
        # with _stats["requests"] and every outcome lands in exactly
        # one tenant account
        metering.request_admitted(req.tenant, rid, len(prompt),
                                  max_new, priority)
        if victim is not None:
            tracing.instant(
                "router:shed", "router",
                args={"request_id": victim.request_id,
                      "tenant": victim.tenant,
                      "priority": victim.priority,
                      "displaced_by": rid})
            metering.request_closed(victim.request_id, "shed")
            victim._complete(ServerOverloadedError(
                "router: session %s (priority %d, tenant %s) shed for "
                "a priority-%d arrival — tenant queue full (bound %d)"
                % (victim.request_id, victim.priority, victim.tenant,
                   priority, self._tenant_bound)))
        if shed:
            tracing.instant(
                "router:shed", "router",
                args={"request_id": rid, "tenant": req.tenant,
                      "priority": priority})
            metering.request_closed(rid, "shed")
            raise ServerOverloadedError(
                "router: session %s (priority %d, tenant %s) shed — "
                "tenant queue full (bound %d) and no lower-priority "
                "session to displace" % (rid, priority, req.tenant,
                                         self._tenant_bound))
        self._wake.set()
        return req

    def _tenant_state(self, name):
        t = self._tenants.get(name)
        if t is None:
            cfg = self._tenant_cfg.get(name) or {}
            t = _Tenant(
                name,
                weight=cfg.get("weight", envs.get_float(
                    "MXNET_ROUTER_TENANT_WEIGHT")),
                rate=cfg.get("rate", envs.get_float(
                    "MXNET_ROUTER_TENANT_RATE")),
                burst=cfg.get("burst", envs.get_float(
                    "MXNET_ROUTER_TENANT_BURST")))
            self._tenants[name] = t
        return t

    # -- the pump ----------------------------------------------------------
    def pump(self, now=None):
        """One router pass: health sweep (when due), WFQ dispatch,
        one scheduler step for any unstarted replica, stream relay,
        drain bookkeeping, autoscaler tick. The started router's loop
        calls this continuously; ``start=False`` tests call it
        directly (passing ``now`` makes health-sweep timing
        deterministic). Returns True when anything progressed."""
        if self._closed:
            return False
        now = time.monotonic() if now is None else now
        if self._monitor.due(now):
            self._health_round(now)
        did = self._dispatch_round(now)
        did = self._step_unstarted() or did
        did = self._relay_round() or did
        self._drain_round(time.monotonic())
        self._autoscale_round()
        if did:
            self._rounds_since_record += 1
            if self._rounds_since_record >= self._record_every:
                self._rounds_since_record = 0
                self._emit_record()
        return did

    def _step_unstarted(self):
        """Drive unstarted replicas one scheduler pass each, so a
        fully manual fleet (tests) progresses on pump() alone."""
        with self._lock:
            reps = [r for r in self._replicas
                    if r.state in ("up", "draining")
                    and not r.server._started and not r.server._closed]
        did = False
        for rep in reps:
            if rep.server._has_work():
                did = rep.server._tick() or did
        return did

    # -- health & failover -------------------------------------------------
    def _health_round(self, now):
        with self._lock:
            reps = list(self._replicas)
        for rep in self._monitor.check(reps, now):
            self._on_replica_lost(rep)

    def _on_replica_lost(self, rep):
        detect = time.monotonic()
        with self._lock:
            if rep.state == "lost":
                return
            rep.state = "lost"
            self._stats["replicas_lost"] += 1
            affected = [r for r in self._sessions
                        if r._replica is rep]
        warnings.warn(
            "router: replica %s confirmed lost — re-homing %d "
            "streaming session(s) by re-prefill replay"
            % (rep.name, len(affected)))
        telemetry.note("router_replica_lost")
        tracing.instant("router:replica_lost", "router",
                        args={"replica": rep.name,
                              "sessions": len(affected)})
        # a replica loss is alert-grade: the record joins the watchdog
        # alert stream, and the flight recorder (when armed) dumps one
        # bundle on this edge — failover count == bundle count is the
        # fleet-diagnose reconciliation invariant. A fresh stats
        # snapshot goes out FIRST so the bundle captures the router
        # state at the alert, not a stale periodic record.
        self._emit_record()
        telemetry.alert_event({
            "kind": "replica_lost",
            "message": "replica %s confirmed lost; re-homing %d "
                       "session(s)" % (rep.name, len(affected)),
            "router": self.name, "replica": rep.name,
            "sessions": len(affected)})
        for req in affected:
            self._failover_session(req, detect)

    def _failover_session(self, req, detect):
        """Re-home one session whose replica died (or whose drain
        timed out): harvest the tokens the old replica generated that
        the relay had not yet forwarded (greedy decode makes them
        valid however the replica died), then requeue the session at
        the FRONT of its tenant queue flagged for replay — dispatch
        re-prefills prompt + emitted and the stream continues
        token-identically."""
        inner, rep = req._inner, req._replica
        with self._lock:
            if req in self._sessions:
                self._sessions.remove(req)
            if rep is not None:
                rep.sessions -= 1
                rep.outstanding -= req.max_new - len(req._emitted)
            req._replica = None
            req._inner = None
        if inner is not None:
            gen = inner.generated
            while req._inner_fwd < len(gen) \
                    and len(req._emitted) < req.max_new:
                tok = int(gen[req._inner_fwd])
                req._inner_fwd += 1
                self._forward(req, tok)
        req._inner_fwd = 0
        if len(req._emitted) >= req.max_new or (
                req.eos_id is not None and req._emitted
                and req._emitted[-1] == req.eos_id):
            self._retire(req, None)       # it had actually finished
            return
        if req._cancelled:
            self._retire(req, None, cancelled=True)
            return
        need = len(req.prompt) + len(req._emitted)
        remaining = req.max_new - len(req._emitted)
        with self._lock:
            feasible = any(
                r.state == "up" and not r.killed
                and need <= r.replay_limit and remaining <= r.max_new
                for r in self._replicas)
        if not feasible:
            self._retire(req, ServerClosedError(
                "session %s: its replica was lost and no surviving "
                "replica can replay a %d-token re-prefill — stream "
                "failed after %d token(s)"
                % (req.request_id, need, len(req._emitted))))
            return
        with self._lock:
            req.state = "failover"
            req._failover = True
            req.failovers += 1
            req._t_lost = detect
            req._resume_pending = True
            self._tenant_state(req.tenant).queue.appendleft(req)
            self._stats["failovers"] += 1
        # restamp the queue clock: the session's SECOND wait counts
        # toward its queue_ms, and the failover marks its record
        metering.request_requeued(req.request_id)
        if tracing.enabled():
            req._t_trace = tracing.now()    # the replay queue span
            tracing.instant(
                "router:failover", "router",
                tid=tracing.track("req %s" % req.request_id),
                args={"request_id": req.request_id,
                      "tenant": req.tenant,
                      "replica": rep.name if rep is not None else None,
                      "emitted": len(req._emitted)})

    # -- dispatch ----------------------------------------------------------
    def _reap_queued_locked(self, now):
        reaped = []
        for t in self._tenants.values():
            for req in [r for r in t.queue
                        if r._cancelled or (r.deadline is not None
                                            and now > r.deadline)]:
                t.queue.remove(req)
                reaped.append(req)
        return reaped

    def _pick_tenant_locked(self, now, blocked, throttled):
        """The WFQ choice: among tenants with a dispatchable head,
        pick the one whose head would FINISH first in virtual time
        (start = max(own finish, system vtime); finish = start +
        cost/weight). Failover heads bypass both the bucket and the
        ordering — a lost session resumes before any new admission."""
        best = None
        best_fin = None
        for t in self._tenants.values():
            if t.name in blocked or not t.queue:
                continue
            head = t.queue[0]
            if head._failover:
                return t, head
            t.refill(now)
            cost = _cost(head)
            if t.rate > 0 and t.bucket < cost:
                throttled.add(t.name)
                continue
            fin = max(t.finish, self._vtime) + cost / t.weight
            if best is None or fin < best_fin:
                best, best_fin = t, fin
        return (best, best.queue[0]) if best is not None else None

    def _pick_replica_locked(self, req):
        need = len(req.prompt) + len(req._emitted)
        remaining = req.max_new - len(req._emitted)
        best = None
        for rep in self._replicas:
            if rep.state != "up" or rep.killed or rep.server._closed:
                continue
            if rep.sessions >= self._max_inflight:
                continue
            if need > rep.replay_limit or remaining > rep.max_new:
                continue
            if best is None or rep.outstanding < best.outstanding:
                best = rep
        return best

    def _dispatch_round(self, now):
        with self._lock:
            reaped = self._reap_queued_locked(now)
        for req in reaped:
            if req._cancelled:
                self._retire(req, None, cancelled=True)
            else:
                self._retire(req, RequestTimeoutError(
                    "session %s deadline passed while queued at the "
                    "router (%d/%d tokens emitted)"
                    % (req.request_id, len(req._emitted), req.max_new)))
        did = bool(reaped)
        blocked = set()
        throttled = set()
        while True:
            with self._lock:
                pick = self._pick_tenant_locked(now, blocked, throttled)
                if pick is None:
                    break
                t, req = pick
                rep = self._pick_replica_locked(req)
                if rep is None:
                    blocked.add(t.name)
                    continue
            try:
                fault.inject("serve_route")
            except fault.InjectedFault:
                # counted and survived: the session stays queued and
                # routes on the next pass (a hang already stalled us)
                with self._lock:
                    self._stats["route_faults"] += 1
                break
            if self._dispatch_one(t, req, rep, now):
                did = True
        with self._lock:
            for name in throttled:
                self._tenants[name].throttled += 1
        for name in throttled:
            metering.tenant_throttled(name)
        if throttled and tracing.enabled():
            for name in throttled:
                tracing.instant("router:throttle", "router",
                                args={"tenant": name,
                                      "request_id":
                                          self._throttled_head(name)})
        return did

    def _throttled_head(self, tenant):
        """The request_id waiting at a throttled tenant's head (the
        session the bucket is holding back), for the throttle trace
        instant. Advisory read."""
        t = self._tenants.get(tenant)
        return t.queue[0].request_id if t is not None and t.queue \
            else None

    def _dispatch_one(self, t, req, rep, now):
        """Bind one queued session to one replica (possibly a replay
        re-prefill). Returns True when the session left the queue."""
        replay = req._failover
        prompt = req.prompt if not req._emitted else _np.concatenate(
            [req.prompt, _np.asarray(req._emitted, _np.int32)])
        remaining = req.max_new - len(req._emitted)
        deadline_ms = None
        if req.deadline is not None:
            left = (req.deadline - time.monotonic()) * 1e3
            if left <= 0:
                with self._lock:
                    if t.queue and t.queue[0] is req:
                        t.queue.popleft()
                self._retire(req, RequestTimeoutError(
                    "session %s deadline passed before dispatch"
                    % req.request_id))
                return True
            deadline_ms = left
        # the wire context rides the dispatch so the replica's
        # prefill/decode spans join this session's router spans under
        # one request_id (None when tracing is off — one None check
        # on the replica side)
        ctx = tracing.wire_context(request_id=req.request_id,
                                   tenant=req.tenant)
        try:
            inner = rep.server.submit(
                prompt, max_new_tokens=remaining,
                priority=req.priority, deadline_ms=deadline_ms,
                eos_id=req.eos_id, trace_ctx=ctx)
        except ServerOverloadedError as exc:
            # the replica shed it at ITS bounded queue — a real
            # overload verdict; propagate the typed error
            with self._lock:
                if t.queue and t.queue[0] is req:
                    t.queue.popleft()
            self._retire(req, exc)
            return True
        except ServerClosedError:
            # died between probe and submit: leave the session queued
            # (in-band detection — the health sweep confirms it)
            rep.killed = True
            return False
        with self._lock:
            if not t.queue or t.queue[0] is not req:
                # reaped under us (cancel raced the dispatch): the
                # inner submission is surplus — cancel it right back
                inner.cancel()
                return False
            t.queue.popleft()
            req._inner = inner
            req._inner_fwd = 0
            req._replica = rep
            req._failover = False
            req.state = "active"
            self._sessions.append(req)
            rep.sessions += 1
            rep.dispatched += 1
            rep.outstanding += remaining
            self._stats["dispatched"] += 1
            if replay:
                self._stats["replay_tokens"] += int(len(prompt))
            else:
                # charge the bucket and advance WFQ virtual time only
                # for FIRST dispatches — a failover is not new demand
                cost = _cost(req)
                if t.rate > 0:
                    t.bucket -= cost
                start = max(t.finish, self._vtime)
                t.finish = start + cost / t.weight
                self._vtime = start
        # a replay dispatch bills its re-prefilled tokens exactly once,
        # to the record now bound to the SURVIVING replica; a first
        # dispatch bills none (mirrors the replay_tokens counter above)
        metering.request_dispatched(
            req.request_id,
            metering.inner_key(rep.server, inner.request_id),
            rep.name, replay=bool(replay),
            replay_tokens=int(len(prompt)) if replay else 0)
        if req._t_trace is not None:
            # close the router-side queue span and mark the dispatch
            # edge on the session's own track; a failover requeue
            # restamps _t_trace so its SECOND queue wait records too
            t_now = tracing.now()
            rtid = tracing.track("req %s" % req.request_id)
            tracing.add("queue", "router", req._t_trace,
                        t_now - req._t_trace, tid=rtid,
                        args={"request_id": req.request_id,
                              "tenant": req.tenant})
            tracing.instant("router:dispatch", "router", tid=rtid,
                            args={"request_id": req.request_id,
                                  "tenant": req.tenant,
                                  "replica": rep.name,
                                  "replay": bool(replay)})
            req._t_trace = None
        return True

    # -- relay -------------------------------------------------------------
    def _forward(self, req, tok):
        req._emitted.append(tok)
        req._push(tok)
        with self._lock:
            if req._replica is not None:
                req._replica.outstanding -= 1
            if req._resume_pending:
                req._resume_pending = False
                if req._t_lost is not None:
                    self._resume_ms.append(
                        (time.monotonic() - req._t_lost) * 1e3)
                # with a shared-pool prefix cache, the replay's
                # re-prefill on the new replica hit the dead one's
                # still-indexed pages — these tokens were NOT recomputed
                cached = int(
                    getattr(req._inner, "prefix_cached", 0) or 0)
                self._stats["replay_cached_tokens"] += cached
                metering.request_resumed(req.request_id, cached)

    def _relay_round(self):
        with self._lock:
            sessions = list(self._sessions)
        did = False
        for req in sessions:
            inner = req._inner
            if inner is None:
                continue
            if req._cancelled and not inner._cancelled:
                inner.cancel()
            gen = inner.generated
            limit = len(gen)
            while req._inner_fwd < limit \
                    and len(req._emitted) < req.max_new:
                tok = int(gen[req._inner_fwd])
                req._inner_fwd += 1
                self._forward(req, tok)
                did = True
            if not inner.done():
                continue
            did = True
            gen = inner.generated
            while req._inner_fwd < len(gen) \
                    and len(req._emitted) < req.max_new:
                tok = int(gen[req._inner_fwd])
                req._inner_fwd += 1
                self._forward(req, tok)
            err = inner._error
            if err is None:
                self._retire(req, None,
                             cancelled=inner.state == "cancelled")
            elif isinstance(err, ServerClosedError) \
                    and not self._stopping and req._replica is not None \
                    and req._replica.state in ("up", "draining"):
                # the server was stopped OUT FROM UNDER the router
                # (not a confirmed loss, not our drain): same replay
                # path — the client still never sees an error
                self._failover_session(req, time.monotonic())
            else:
                if isinstance(err, RequestTimeoutError):
                    with self._lock:
                        self._stats["timeouts"] += 1
                self._retire(req, err)
        return did

    def _retire(self, req, error, cancelled=False):
        with self._lock:
            if req in self._sessions:
                self._sessions.remove(req)
            rep = req._replica
            if rep is not None:
                rep.sessions -= 1
                rep.outstanding -= req.max_new - len(req._emitted)
                req._replica = None
            req._inner = None
            t = self._tenant_state(req.tenant)
            if cancelled:
                self._stats["cancelled"] += 1
            elif error is None:
                self._stats["completed"] += 1
                t.completed += 1
                t.lat.append((time.monotonic() - req.t_submit) * 1e3)
            else:
                self._stats["failed"] += 1
                t.failed += 1
        # every session's terminal edge runs through here (and the two
        # shed branches in submit) — one close, one outcome, one
        # tenant account. The fine-grained outcome groups back onto
        # the router counters: completed/cancelled map 1:1, "shed"
        # only ever comes from submit, and timeout/preempted/failed
        # together equal _stats["failed"].
        if cancelled:
            outcome = "cancelled"
        elif error is None:
            outcome = "completed"
        elif isinstance(error, RequestTimeoutError):
            outcome = "timeout"
        elif isinstance(error, ServerOverloadedError):
            outcome = "preempted"
        else:
            outcome = "failed"
        metering.request_closed(req.request_id, outcome,
                                generated_tokens=len(req._emitted))
        req._complete(error, state="cancelled" if cancelled else None)

    # -- drain -------------------------------------------------------------
    def drain(self, name, wait=True, timeout_ms=None):
        """Gracefully retire one replica: stop admitting to it, let
        its bound streams finish (the pump keeps relaying), then stop
        the server (a draining stop — pages come back through the
        counted reclaim) and mark the departure CLEAN so the monitor
        never misreads it as a loss. Sessions still streaming past
        the timeout fail over to the remaining replicas. ``wait``
        blocks until drained (driving the pump itself when the router
        is unstarted)."""
        rep = self.replica(name)
        with self._lock:
            if rep.state != "up":
                return rep
            rep.state = "draining"
            rep.drain_deadline = time.monotonic() + max(
                int(timeout_ms) if timeout_ms is not None
                else envs.get_int("MXNET_ROUTER_DRAIN_TIMEOUT_MS"),
                1) / 1e3
            self._stats["drains"] += 1
        telemetry.note("router_drains")
        tracing.instant("router:drain", "router",
                        args={"replica": rep.name})
        self._wake.set()
        if wait:
            limit = rep.drain_deadline + max(self._drain_timeout, 1.0)
            while rep.state == "draining" and time.monotonic() < limit:
                if self._started:
                    time.sleep(0.002)
                else:
                    self.pump()
        return rep

    def _drain_round(self, now):
        with self._lock:
            draining = [r for r in self._replicas
                        if r.state == "draining"]
        for rep in draining:
            with self._lock:
                bound = [r for r in self._sessions
                         if r._replica is rep]
            if not bound:
                rep.server.stop(drain=True)
                with self._lock:
                    rep.state = "drained"
                self._monitor.tracker.departed(rep.name)
                tracing.instant("router:drained", "router",
                                args={"replica": rep.name})
                continue
            if rep.drain_deadline is not None \
                    and now > rep.drain_deadline:
                with self._lock:
                    self._stats["drain_timeouts"] += 1
                tracing.instant("router:drain_timeout", "router",
                                args={"replica": rep.name,
                                      "sessions": len(bound)})
                for req in bound:
                    inner = req._inner
                    if inner is not None:
                        inner.cancel()
                    self._failover_session(req, now)

    # -- autoscaler hook ---------------------------------------------------
    def _autoscale_round(self):
        if self._supervisor is None:
            return
        from .. import livemetrics
        wd = livemetrics._watchdog
        counts = wd.alerts() if wd is not None else {}
        pressure = sum(counts.get(k, 0)
                       for k in ("serving_queue_full",
                                 "serving_shed_rate", "replica_skew"))
        if pressure > self._alerts_seen:
            self._alerts_seen = pressure
            with self._lock:
                self._stats["scale_up_signals"] += 1
            self._call_supervisor("scale_up", {"alerts": dict(counts)})
        with self._lock:
            idle = not self._sessions and all(
                not t.queue for t in self._tenants.values())
            ups = sum(1 for r in self._replicas if r.state == "up")
        if idle and ups > 1:
            self._idle_rounds += 1
            if self._idle_rounds >= self._idle_limit \
                    and not self._idle_fired:
                self._idle_fired = True
                with self._lock:
                    self._stats["scale_down_signals"] += 1
                self._call_supervisor("scale_down",
                                      {"replicas_up": ups})
        else:
            self._idle_rounds = 0
            self._idle_fired = False

    def _call_supervisor(self, action, info):
        try:
            self._supervisor(action, self, info)
        except Exception as exc:    # noqa: BLE001 — a broken callback
            # must not take the pump down with it
            warnings.warn("router: supervisor callback failed on %r "
                          "(%s: %s)" % (action, type(exc).__name__,
                                        exc))

    # -- stats & telemetry -------------------------------------------------
    def stats(self):
        """Cumulative router snapshot: dispatch/completion counters,
        failovers and replayed re-prefill tokens, detection-to-resume
        latency, per-replica outstanding tokens, per-tenant quota and
        latency state — the ``router`` telemetry record, the diagnose
        Router table, and the /metrics gauges all render this."""
        with self._lock:
            s = dict(self._stats)
            reps = [{"name": r.name, "state": r.state,
                     "outstanding": r.outstanding,
                     "sessions": r.sessions,
                     "dispatched": r.dispatched}
                    for r in self._replicas]
            tenants = {}
            for t in self._tenants.values():
                d = {"weight": t.weight, "rate": t.rate,
                     "queued": len(t.queue), "submitted": t.submitted,
                     "completed": t.completed, "failed": t.failed,
                     "shed": t.shed, "throttled": t.throttled}
                if t.lat:
                    lat = list(t.lat)
                    d["latency_ms"] = {
                        "p50": round(telemetry.percentile(lat, 50), 3),
                        "p99": round(telemetry.percentile(lat, 99), 3),
                        "max": round(max(lat), 3)}
                tenants[t.name] = d
            queued = sum(len(t.queue) for t in self._tenants.values())
            active = len(self._sessions)
            resume = list(self._resume_ms)
            throttles = sum(t.throttled for t in self._tenants.values())
        out = {"name": getattr(self, "_metrics_label", None)
               or self.name or "router",
               "kind": "router",
               "replicas": reps,
               "replicas_up": sum(1 for r in reps
                                  if r["state"] == "up"),
               "queued": queued,
               "sessions": active,
               "tenants": tenants,
               "throttles": throttles,
               "health_sweeps": self._monitor.sweeps}
        out.update(s)
        if resume:
            out["failover_resume_ms"] = {
                "p50": round(telemetry.percentile(resume, 50), 3),
                "p99": round(telemetry.percentile(resume, 99), 3),
                "max": round(max(resume), 3)}
        return out

    def _emit_record(self):
        telemetry.router_event(self.stats())
