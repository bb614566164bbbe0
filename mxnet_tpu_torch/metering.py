"""Usage metering & cost attribution — the per-tenant resource ledger
(counterpart of ``mxnet_tpu/metering.py``).

Telemetry, tracing and the flight recorder say how the system is
doing; this module says **who consumed what**. A :class:`Meter`
follows every routed request across the serving stack — Router admit
-> tenant queue -> DecodeServer prefill/decode -> KVCachePool pages ->
prefix-cache hits — and closes one immutable usage record per request:

    tenant, request_id, prompt/generated tokens, queue ms, attributed
    FLOPs and bytes (each dispatched program's analytic cost — the
    decode server's ``program_cost`` — times this request's share of
    it), KV page*seconds integrated at decode step boundaries,
    prefix-cache tokens/bytes *credited*, failover replay tokens
    (attributed exactly once, to the surviving replica's record),
    terminal outcome.

Records fold into per-tenant cumulative accounts and append to a
durable JSONL ledger (``MXNET_METER_FILE``): atomic pid-unique
tmp + ``os.replace`` on creation, whole-line appends after, write
errors disable the sink with one warning — the same contract as the
telemetry sink.

The headline property is **conservation** — the meter keeps
dual-entry books. Every quantity is debited to exactly one tenant
account at the same locked instant it is credited to the global
totals, so

    sum over tenants == totals           (for every quantity)
    admitted == closed + open            (no request vanishes)

and the totals in turn reconcile against the Router's own cumulative
counters (``requests``/``dispatched``/``shed``/``completed``/
``replay_tokens``/``replay_cached_tokens``) which are incremented by
*independent* code paths — a missed or double-fired hook shows up as
a ``[MISMATCH]`` in ``tools/diagnose.py``'s Usage table, not as a
silently wrong bill. Failover replay tokens are billed at each
**replay dispatch** (never at first dispatch) to the record whose
``replica`` field then names the surviving replica.

Off-path cost: every hook is one module-global ``is None`` check —
a process that never calls :func:`start` pays one attribute load per
hook site and allocates nothing.

Training side: :func:`training_step` (the Gluon Trainer calls it at
each step) gives run-level cost accounting — device-seconds and
restart-wasted steps reconciled with ``fault.stats()``. Training FLOPs
come from the JAX package's compile watch, which the port has not yet
(``total_flops`` is None, as it is there with the watch off).

The ledger is an accounting document, not an access-controlled one:
lines are immutable once written but the file trusts the filesystem.
Rotate it like a log (the meter never truncates, only
creates-or-appends).
"""

import json
import os
import threading
import time
from collections import deque

from . import envs
from .log import get_logger

logger = get_logger("mxnet_tpu_torch.metering")

__all__ = ["Meter", "start", "stop", "active", "enabled", "snapshot",
           "emit", "request_admitted", "request_dispatched",
           "request_requeued", "request_resumed", "request_closed",
           "request_pages", "request_flops", "request_prefix",
           "tenant_throttled", "training_step"]

# the single module-global hook — None is the whole off-path
_meter = None

# the tenant bucket for decode-side activity the router never linked
# (a request submitted straight to a DecodeServer, not through a
# Router): it still must land in SOME account or the dual-entry books
# would not balance
UNATTRIBUTED = "(unattributed)"

_NUM_FIELDS = ("prompt_tokens", "generated_tokens", "replay_tokens",
               "replay_cached_tokens", "flops", "bytes",
               "page_seconds", "prefix_hit_tokens",
               "prefix_bytes_saved", "queue_ms", "failovers")

_OUTCOMES = ("completed", "cancelled", "shed", "throttled", "timeout",
             "preempted", "failed")


def _zero_account():
    acct = {k: 0 for k in _NUM_FIELDS}
    acct["flops"] = 0.0
    acct["bytes"] = 0.0
    acct["page_seconds"] = 0.0
    acct["queue_ms"] = 0.0
    acct["outcomes"] = {}
    acct["throttle_events"] = 0
    acct["closed"] = 0
    return acct


class Meter:
    """The per-tenant resource ledger. One instance per process is the
    expected shape (installed via :func:`start`); the class is
    separable for tests. All mutation happens under ``_lock``; the
    ledger file is serialized by ``_flush_lock`` taken BEFORE ``_lock``
    (the telemetry sink's lock order)."""

    def __init__(self, name="default", path=None, flush_every=None,
                 max_records=None):
        self.name = name or "default"
        self._path = path if path is not None \
            else (envs.get_path("MXNET_METER_FILE") or None)
        self._flush_every = max(1, int(
            flush_every if flush_every is not None
            else envs.get_int("MXNET_METER_FLUSH_EVERY")))
        cap = int(max_records if max_records is not None
                  else envs.get_int("MXNET_METER_MAX_RECORDS"))
        self._lock = threading.Lock()
        self._flush_lock = threading.Lock()   # sink writers, BEFORE _lock
        self._t0 = time.time()
        self._open = {}            # outer request_id -> open record
        self._inner = {}           # inner request_id -> outer request_id
        self._pstamp = {}          # inner request_id -> last page tick
        self._accounts = {}        # tenant -> cumulative account
        self._records = deque(maxlen=max(1, cap))   # closed, bounded
        self._pending = []         # closed but not yet in the ledger
        self._sink_created = False
        self._sink_broken = False
        self._written = 0
        self._write_errors = 0
        self._closed_since_emit = 0
        self._totals = _zero_account()
        self._totals.update(admitted=0, dispatched=0, closed=0)
        self._train = None
        from . import fault
        self._fault_base = dict(fault.stats())

    # -- request lifecycle (router-driven) -----------------------------

    def admit(self, tenant, request_id, prompt_tokens, max_new,
              priority):
        now = time.monotonic()
        with self._lock:
            tenant = str(tenant)
            self._account_locked(tenant)
            if request_id in self._open:
                return
            self._open[request_id] = {
                "tenant": tenant, "request_id": request_id,
                "prompt_tokens": int(prompt_tokens),
                "max_new": int(max_new), "priority": int(priority),
                "generated_tokens": 0, "replay_tokens": 0,
                "replay_cached_tokens": 0, "flops": 0.0,
                "bytes": 0.0, "page_seconds": 0.0,
                "prefix_hit_tokens": 0, "prefix_bytes_saved": 0,
                "queue_ms": 0.0, "failovers": 0, "replica": None,
                "outcome": "open", "latency_ms": None,
                "_t_queued": now, "_t_admit": now, "_inner_ids": [],
            }
            self._totals["admitted"] += 1
            self._totals["prompt_tokens"] += int(prompt_tokens)

    def dispatch(self, request_id, inner_id, replica, replay,
                 replay_tokens):
        now = time.monotonic()
        with self._lock:
            rec = self._open.get(request_id)
            if rec is None:
                return
            if inner_id is not None:
                self._inner[inner_id] = request_id
                rec["_inner_ids"].append(inner_id)
            rec["replica"] = replica
            rec["queue_ms"] += (now - rec["_t_queued"]) * 1e3
            self._totals["dispatched"] += 1
            if replay:
                # the replay re-prefill is billed HERE, exactly once
                # per failover dispatch, to the record whose replica
                # field now names the survivor — never at first
                # dispatch, so an unfailed stream carries zero
                rec["replay_tokens"] += int(replay_tokens)
                self._totals["replay_tokens"] += int(replay_tokens)

    def requeued(self, request_id):
        now = time.monotonic()
        with self._lock:
            rec = self._open.get(request_id)
            if rec is None:
                return
            rec["failovers"] += 1
            rec["_t_queued"] = now     # its SECOND queue wait counts
            self._totals["failovers"] += 1

    def resumed(self, request_id, cached_tokens):
        with self._lock:
            rec = self._open.get(request_id)
            if rec is None:
                return
            rec["replay_cached_tokens"] += int(cached_tokens)
            self._totals["replay_cached_tokens"] += int(cached_tokens)

    def throttled(self, tenant):
        with self._lock:
            acct = self._account_locked(str(tenant))
            acct["throttle_events"] += 1
            self._totals["throttle_events"] += 1

    def close(self, request_id, outcome, generated_tokens=None,
              latency_ms=None):
        now = time.monotonic()
        with self._lock:
            rec = self._open.pop(request_id, None)
            if rec is None:
                return
            for iid in rec.pop("_inner_ids"):
                self._inner.pop(iid, None)
                self._pstamp.pop(iid, None)
            rec.pop("_t_queued", None)
            t_admit = rec.pop("_t_admit")
            if generated_tokens is not None:
                rec["generated_tokens"] = int(generated_tokens)
            rec["outcome"] = outcome if outcome in _OUTCOMES \
                else "failed"
            rec["latency_ms"] = round(
                latency_ms if latency_ms is not None
                else (now - t_admit) * 1e3, 3)
            rec["queue_ms"] = round(rec["queue_ms"], 3)
            rec["page_seconds"] = round(rec["page_seconds"], 9)
            rec["t"] = round(time.time() - self._t0, 6)
            acct = self._account_locked(rec["tenant"])
            for k in _NUM_FIELDS:
                acct[k] += rec[k]
            acct["outcomes"][rec["outcome"]] = \
                acct["outcomes"].get(rec["outcome"], 0) + 1
            acct["closed"] += 1
            self._totals["closed"] += 1
            self._totals["generated_tokens"] += rec["generated_tokens"]
            self._totals["queue_ms"] += rec["queue_ms"]
            self._totals["outcomes"][rec["outcome"]] = \
                self._totals["outcomes"].get(rec["outcome"], 0) + 1
            ledger_line = dict(rec)
            ledger_line["type"] = "usage_record"
            self._records.append(ledger_line)
            self._pending.append(ledger_line)
            self._closed_since_emit += 1
            flush = self._path is not None and not self._sink_broken \
                and len(self._pending) >= self._flush_every
            emit_now = self._closed_since_emit >= self._flush_every
            if emit_now:
                self._closed_since_emit = 0
        if flush:
            self.flush()
        if emit_now:
            self.emit()

    # -- decode-side attribution (inner request ids) -------------------

    def pages(self, entries, now):
        """Integrate KV page holdings at a decode step boundary:
        ``entries`` is ``[(inner_request_id, n_pages)]`` for every
        active request. Dual entry: each request's page*seconds and
        the pool total accrue in the same locked pass, from the same
        timestamps — the conservation line can only break if
        attribution (not integration) is wrong."""
        with self._lock:
            for iid, npages in entries:
                last = self._pstamp.get(iid)
                self._pstamp[iid] = now
                if last is None:
                    continue
                ps = npages * (now - last)
                if ps <= 0:
                    continue
                rec = self._resolve_locked(iid)
                rec["page_seconds"] += ps
                self._totals["page_seconds"] += ps

    def flops(self, inner_id, flops, nbytes=0.0):
        with self._lock:
            rec = self._resolve_locked(inner_id)
            rec["flops"] += float(flops)
            rec["bytes"] += float(nbytes)
            self._totals["flops"] += float(flops)
            self._totals["bytes"] += float(nbytes)

    def prefix(self, inner_id, tokens, nbytes):
        with self._lock:
            rec = self._resolve_locked(inner_id)
            rec["prefix_hit_tokens"] += int(tokens)
            rec["prefix_bytes_saved"] += int(nbytes)
            self._totals["prefix_hit_tokens"] += int(tokens)
            self._totals["prefix_bytes_saved"] += int(nbytes)

    def _resolve_locked(self, inner_id):
        """The open record an inner request id belongs to, or the
        unattributed account (shaped like a record for the numeric
        fields) when the router never linked it."""
        outer = self._inner.get(inner_id)
        if outer is not None:
            rec = self._open.get(outer)
            if rec is not None:
                return rec
        return self._account_locked(UNATTRIBUTED)

    def _account_locked(self, tenant):
        acct = self._accounts.get(tenant)
        if acct is None:
            acct = self._accounts[tenant] = _zero_account()
        return acct

    # -- training-side accounting --------------------------------------

    def training_step(self, n=1):
        now = time.monotonic()
        with self._lock:
            tr = self._train
            if tr is None:
                tr = self._train = {"steps": 0, "t_first": now,
                                    "t_last": now}
            tr["steps"] += int(n)
            tr["t_last"] = now

    def _training_snapshot_locked(self):
        tr = self._train
        if tr is None:
            return None
        steps = tr["steps"]
        elapsed = max(tr["t_last"] - tr["t_first"], 0.0)
        devices = 1          # the Trainer steps on one device
        out = {"steps": steps, "elapsed_s": round(elapsed, 6),
               "devices": devices,
               "device_seconds": round(elapsed * devices, 6),
               "total_flops": None, "flops_per_step": None}
        from . import fault
        wasted = int(fault.stats().get("skipped_steps", 0)
                     - self._fault_base.get("skipped_steps", 0))
        out["wasted_steps"] = wasted
        goodput = (steps - wasted) / steps if steps else None
        out["goodput"] = round(goodput, 6) \
            if goodput is not None else None
        # the restart tax, priced: device-seconds inflated by the
        # share of steps that bought nothing
        out["effective_device_seconds"] = round(
            out["device_seconds"] / goodput, 6) \
            if goodput else out["device_seconds"]
        return out

    # -- books ---------------------------------------------------------

    def _reconcile_locked(self, tenants):
        """The dual-entry balance: sum over tenant accounts (open
        partials folded in by the caller) must equal the totals for
        every conserved quantity, and no request may have vanished."""
        checks = {}
        tol = 1e-6
        for k in ("prompt_tokens", "generated_tokens", "replay_tokens",
                  "replay_cached_tokens", "prefix_hit_tokens",
                  "page_seconds", "flops"):
            lhs = sum(t[k] for t in tenants.values())
            rhs = self._totals[k]
            checks[k] = {"tenants": round(lhs, 6),
                         "totals": round(rhs, 6),
                         "ok": abs(lhs - rhs) <= tol}
        closed = sum(t["closed"] for t in tenants.values())
        checks["requests"] = {
            "tenants": closed + len(self._open),
            "totals": self._totals["admitted"],
            "ok": closed + len(self._open)
            == self._totals["admitted"]}
        return {"ok": all(c["ok"] for c in checks.values()),
                "checks": checks}

    def snapshot(self):
        """One JSON-ready cumulative snapshot: per-tenant accounts
        (open requests' partial attributions folded in), global
        totals, outcome counts, ledger state, training costs, and the
        dual-entry reconciliation verdict. This is the ``usage``
        telemetry record, the diagnose Usage table, the
        ``mxnet_usage_*`` /metrics families, and the flight-recorder
        ``metering`` block."""
        with self._lock:
            tenants = {}
            for name, acct in self._accounts.items():
                t = {k: acct[k] for k in _NUM_FIELDS}
                t["outcomes"] = dict(acct["outcomes"])
                t["throttle_events"] = acct["throttle_events"]
                t["closed"] = acct["closed"]
                t["open"] = 0
                tenants[name] = t
            for rec in self._open.values():
                t = tenants.get(rec["tenant"])
                if t is None:
                    t = tenants[rec["tenant"]] = _zero_account()
                    t["open"] = 0
                for k in _NUM_FIELDS:
                    t[k] += rec[k]
                t["open"] += 1
            for t in tenants.values():
                t["page_seconds"] = round(t["page_seconds"], 6)
                t["flops"] = round(t["flops"], 3)
                t["bytes"] = round(t["bytes"], 3)
                t["queue_ms"] = round(t["queue_ms"], 3)
            out = {
                "name": self.name,
                "admitted": self._totals["admitted"],
                "dispatched": self._totals["dispatched"],
                "closed": self._totals["closed"],
                "open": len(self._open),
                "outcomes": dict(self._totals["outcomes"]),
                "totals": {
                    k: (round(self._totals[k], 6)
                        if isinstance(self._totals[k], float)
                        else self._totals[k])
                    for k in _NUM_FIELDS},
                "throttle_events": self._totals["throttle_events"],
                "tenants": tenants,
                "ledger": {"path": self._path,
                           "written": self._written,
                           "errors": self._write_errors,
                           "records": len(self._records)},
                "reconcile": self._reconcile_locked(tenants),
            }
            train = self._training_snapshot_locked()
            if train is not None:
                out["training"] = train
        return out

    def records(self):
        """The bounded in-memory tail of closed usage records."""
        with self._lock:
            return [dict(r) for r in self._records]

    # -- ledger sink -----------------------------------------------------

    def flush(self):
        """Append pending closed records to the JSONL ledger — atomic
        pid-unique tmp + ``os.replace`` on creation (a reader never
        sees a half-written file), whole-line appends after (a killed
        writer strands at most one truncated trailing line). An
        OSError disables the sink with one warning; accounting
        continues in memory."""
        if self._path is None:
            return None
        with self._flush_lock:
            with self._lock:
                if self._sink_broken or not self._pending:
                    return self._path if self._sink_created else None
                batch = self._pending
                self._pending = []
                created = self._sink_created
            data = "".join(json.dumps(r, sort_keys=True) + "\n"
                           for r in batch)
            try:
                if not created:
                    tmp = "%s.tmp.%d" % (self._path, os.getpid())
                    with open(tmp, "w") as f:
                        f.write(data)
                        f.flush()
                        os.fsync(f.fileno())
                    os.replace(tmp, self._path)
                else:
                    with open(self._path, "a") as f:
                        f.write(data)
                with self._lock:
                    self._sink_created = True
                    self._written += len(batch)
            except OSError as exc:
                with self._lock:
                    self._sink_broken = True
                    self._write_errors += 1
                logger.warning(
                    "metering: ledger write to %s failed (%s) — sink "
                    "disabled, accounting continues in memory",
                    self._path, exc)
        return self._path

    def emit(self):
        """Publish the cumulative snapshot as one ``usage`` telemetry
        record (no-op without an active telemetry run)."""
        from . import telemetry
        telemetry.usage_event(self.snapshot())


# ---------------------------------------------------------------------------
# module API
# ---------------------------------------------------------------------------

def start(name="default", path=None, flush_every=None,
          max_records=None):
    """Install the process meter and return it. Idempotent for the
    same name — restarting replaces the meter (the old one's ledger is
    flushed first)."""
    global _meter
    old = _meter
    if old is not None:
        old.flush()
    m = Meter(name=name, path=path, flush_every=flush_every,
              max_records=max_records)
    _meter = m
    return m


def stop():
    """Flush the ledger, publish a final ``usage`` record, uninstall
    the meter, and return its last snapshot (None when off)."""
    global _meter
    m = _meter
    if m is None:
        return None
    m.flush()
    m.emit()
    _meter = None
    return m.snapshot()


def active():
    return _meter


def enabled():
    return _meter is not None


def snapshot():
    m = _meter
    if m is None:
        return None
    return m.snapshot()


def emit():
    m = _meter
    if m is None:
        return
    m.emit()


def inner_key(server, request_id):
    """Metering key for a replica-local request id. DecodeServer ids
    (``d%06d``) restart at 1 per server, so two replicas collide on
    the bare id — qualify by server identity. The router composes the
    same key at dispatch that the server composes at attribution."""
    return "%d:%s" % (id(server), request_id)


# -- hooks: each is ONE None check when metering is off -----------------

def request_admitted(tenant, request_id, prompt_tokens, max_new,
                     priority):
    m = _meter
    if m is None:
        return
    m.admit(tenant, request_id, prompt_tokens, max_new, priority)


def request_dispatched(request_id, inner_id, replica, replay=False,
                       replay_tokens=0):
    m = _meter
    if m is None:
        return
    m.dispatch(request_id, inner_id, replica, replay, replay_tokens)


def request_requeued(request_id):
    m = _meter
    if m is None:
        return
    m.requeued(request_id)


def request_resumed(request_id, cached_tokens):
    m = _meter
    if m is None:
        return
    m.resumed(request_id, cached_tokens)


def request_closed(request_id, outcome, generated_tokens=None,
                   latency_ms=None):
    m = _meter
    if m is None:
        return
    m.close(request_id, outcome, generated_tokens=generated_tokens,
            latency_ms=latency_ms)


def request_pages(entries, now):
    m = _meter
    if m is None:
        return
    m.pages(entries, now)


def request_flops(inner_id, flops, nbytes=0.0):
    m = _meter
    if m is None:
        return
    m.flops(inner_id, flops, nbytes)


def request_prefix(inner_id, tokens, nbytes):
    m = _meter
    if m is None:
        return
    m.prefix(inner_id, tokens, nbytes)


def tenant_throttled(tenant):
    m = _meter
    if m is None:
        return
    m.throttled(tenant)


def training_step(n=1):
    m = _meter
    if m is None:
        return
    m.training_step(n)
