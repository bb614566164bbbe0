"""Deterministic fault injection (counterpart of ``mxnet_tpu/fault.py``),
limited to the pieces and sites the decode serving path calls.

``MXNET_FAULT_PLAN`` holds a ``;``- or ``,``-separated list of
``site:step=N:action[:count=K]`` entries, e.g.
``serve_decode:step=1:hang:count=inf;kv_evict:step=1:raise``. A site's
step counter counts *visits*; an entry fires on visits
``step .. step+count-1`` (``count=inf`` fires forever). With the plan
unset every injection point is a no-op.

Sites of this slice:

- ``serve_admit`` — once per ``DecodeServer.submit``;
- ``serve_decode`` — once per decode step; a planned hang stalls token
  production so a streaming request ages past its deadline;
- ``kv_evict`` — once per KV page reclaim; a planned raise is counted
  and the page is reclaimed anyway;
- ``kv_share`` — once per would-be prefix-cache hit; a raise forces a
  miss (a full private prefill);
- ``kv_cow`` — once per copy-on-write page split; a raise degrades the
  request to a private re-prefill;
- ``serve_route`` — once per router dispatch; a raise is counted and
  survived (the session stays queued and routes on the next pass), a
  hang stalls dispatch so queued sessions age;
- ``replica_lost`` — once per replica per router health sweep; a
  planned raise confirms the loss of the replica under probe on that
  visit;
- ``flightrec`` — once per flight-recorder dump; a raise is counted as
  a failed dump, never fatal (the dumper drill).

The JAX module's retry, gradient-guard and resume branches, which also
count into an active telemetry run (``telemetry.note``), arrive with
the modules that take them (kvstore, the fused step, checkpoint).

Actions: ``raise`` → :class:`InjectedFault`; ``hang`` → sleep
``MXNET_FAULT_HANG_SECONDS`` then :class:`InjectedHang`; ``stall`` →
the same sleep and no exception. State is process-global; :func:`reset`
re-reads the environment.
"""
from __future__ import annotations

import threading
import time

from . import envs
from .base import MXNetError

__all__ = ["FaultPlan", "InjectedFault", "InjectedHang", "plan",
           "set_plan", "reset", "inject", "stats", "reset_stats"]

_ACTIONS = ("raise", "hang", "stall")
_SITES = ("serve_admit", "serve_decode", "serve_route", "kv_evict",
          "kv_share", "kv_cow", "replica_lost", "flightrec")


class InjectedFault(MXNetError):
    """A fault raised by a MXNET_FAULT_PLAN entry (action ``raise``)."""


class InjectedHang(InjectedFault):
    """A planned hang: the injection point blocked for
    MXNET_FAULT_HANG_SECONDS and then surfaced as a timed-out op."""


class _PlanEntry:
    __slots__ = ("site", "step", "action", "count")

    def __init__(self, site, step, action, count):
        self.site, self.step = site, step
        self.action, self.count = action, count

    def fires(self, visit):
        return self.step <= visit < self.step + self.count

    def __repr__(self):
        spec = "%s:step=%d:%s" % (self.site, self.step, self.action)
        if self.count != 1:
            spec += ":count=%s" % ("inf" if self.count == float("inf")
                                   else int(self.count))
        return spec


def _parse_entry(text):
    parts = [p.strip() for p in text.split(":") if p.strip()]
    if len(parts) < 2:
        raise MXNetError(
            "fault plan entry %r: want site:step=N:action[:count=K]"
            % (text,))
    site, step, count, action = parts[0], 1, 1, None
    for tok in parts[1:]:
        if tok.startswith("step="):
            step = int(tok[len("step="):])
        elif tok.startswith("count="):
            val = tok[len("count="):]
            count = float("inf") if val in ("inf", "-1") else int(val)
        elif tok in _ACTIONS:
            action = tok
        else:
            raise MXNetError(
                "fault plan entry %r: unknown token %r (actions: %s)"
                % (text, tok, "|".join(_ACTIONS)))
    if action is None:
        raise MXNetError("fault plan entry %r: no action given" % (text,))
    if step < 1:
        raise MXNetError("fault plan entry %r: step is 1-based" % (text,))
    if site not in _SITES:
        raise MXNetError(
            "fault plan entry %r: unknown site %r (sites: %s)"
            % (text, site, "|".join(_SITES)))
    return _PlanEntry(site, step, action, count)


class FaultPlan:
    """A parsed MXNET_FAULT_PLAN: entries plus per-site visit counters."""

    def __init__(self, entries):
        self.entries = list(entries)
        self._visits = {}

    @classmethod
    def parse(cls, spec):
        return cls([_parse_entry(e)
                    for e in spec.replace(";", ",").split(",")
                    if e.strip()])

    def visit(self, site):
        """Count one visit to ``site``; return the entry that fires on
        this visit, or None."""
        n = self._visits.get(site, 0) + 1
        self._visits[site] = n
        for entry in self.entries:
            if entry.site == site and entry.fires(n):
                return entry
        return None

    def __repr__(self):
        return "FaultPlan(%s)" % ";".join(repr(e) for e in self.entries)


_lock = threading.Lock()
_plan = None
_plan_loaded = False
_stats = {"injected": {}}


def plan():
    """The active FaultPlan, parsed once from MXNET_FAULT_PLAN (None
    when unset/empty)."""
    global _plan, _plan_loaded
    if not _plan_loaded:
        with _lock:
            if not _plan_loaded:
                spec = envs.get_raw("MXNET_FAULT_PLAN") or ""
                _plan = FaultPlan.parse(spec) if spec.strip() else None
                if _plan is not None and not _plan.entries:
                    _plan = None
                _plan_loaded = True
    return _plan


def set_plan(spec):
    """Install a plan programmatically (a spec string, a FaultPlan, or
    None); resets the visit counters and the stats."""
    global _plan, _plan_loaded
    with _lock:
        if spec is None or isinstance(spec, FaultPlan):
            _plan = spec
        else:
            _plan = FaultPlan.parse(spec)
            if not _plan.entries:
                _plan = None
        _plan_loaded = True
    reset_stats()


def reset():
    """Forget the cached plan and re-read the environment on next use.
    Tests that monkeypatch MXNET_* vars call this."""
    global _plan, _plan_loaded
    with _lock:
        _plan, _plan_loaded = None, False
    reset_stats()


def reset_stats():
    global _stats
    with _lock:
        _stats = {"injected": {}}


def stats():
    """Per-site counts of the faults that fired (``injected``)."""
    with _lock:
        return {"injected": dict(_stats["injected"])}


def inject(site):
    """One injection point. Counts a visit to ``site``; when a plan
    entry fires: ``raise`` → InjectedFault, ``hang`` → bounded sleep
    then InjectedHang, ``stall`` → the same sleep and no exception.
    No-op without an active plan."""
    p = plan()
    if p is None:
        return
    with _lock:
        entry = p.visit(site)
        if entry is not None:
            _stats["injected"][site] = _stats["injected"].get(site, 0) + 1
    if entry is None:
        return
    if entry.action == "raise":
        raise InjectedFault("planned fault at site %r (%r)" % (site, entry))
    hang = envs.get_float("MXNET_FAULT_HANG_SECONDS")
    time.sleep(hang)
    if entry.action == "hang":
        raise InjectedHang("planned hang at site %r (%r): blocked %.3fs"
                           % (site, entry, hang))
