"""Fleet membership and replica health for the serving router
(counterpart of ``mxnet_tpu/serving/fleet.py``).

The router (``serving.router``) fronts N in-process decode replicas;
this module owns the roster: :class:`Replica` wraps one live
:class:`~mxnet_tpu_torch.serving.DecodeServer` with the router's view of its
state, load, and liveness, and :class:`FleetMonitor` confirms replica
loss with the SAME false-positive armor the multi-host training
heartbeat uses (``parallel.multihost.StrikeTracker`` — two-strike
confirmation, self-starvation abstention, clean-departure exemption)
plus an in-band probe instead of a beat file: an in-process replica's
scheduler thread either answers or it does not, and the probe can tell
a *definitively dead* replica (scheduler thread gone, server closed
outside a drain, a simulated kill) from a merely *unresponsive* one —
only the latter verdict is starvation-suppressible, because only it
can be an artifact of the judge's own lost time slices.

Loss confirmation visits the ``replica_lost`` fault site once per
replica per sweep, so ``MXNET_FAULT_PLAN=replica_lost:step=N:raise``
deterministically confirms the loss of the replica under probe on
visit N — the failover/replay path is testable without killing
anything or racing a timing window.

Replica naming defaults ride the launcher worker contract
(``tools.launch.worker_contract`` — DMLC_NUM_WORKER/DMLC_WORKER_ID):
a launched serving worker names its replica ``replica-<rank>`` so
router telemetry, /metrics labels, and the supervisor's restart log
all speak the same id.
"""
from __future__ import annotations

import time

from .. import envs, fault
from ..parallel.multihost import StrikeTracker

__all__ = ["Replica", "FleetMonitor", "default_replica_name"]


def default_replica_name(index=None):
    """The launcher-contract replica name: ``replica-<DMLC_WORKER_ID>``
    under a launched worker set (``tools.launch``), else
    ``replica-<index>`` (or ``replica-0``). One naming scheme across
    the router, /metrics labels, and the supervisor's event log."""
    from ..tools.launch import worker_contract
    contract = worker_contract()
    if contract is not None:
        return "replica-%d" % contract["rank"]
    return "replica-%d" % (index or 0)


class Replica:
    """One fleet member: a live DecodeServer plus the router's view of
    it. ``state`` walks ``up -> draining -> drained`` (graceful exit)
    or ``up -> lost`` (confirmed loss); only ``up`` replicas take new
    sessions. ``outstanding`` is the router-maintained
    least-outstanding-tokens dispatch signal: tokens still owed by the
    sessions bound here (budgeted minus streamed)."""

    def __init__(self, server, name=None, index=0):
        self.server = server
        self.name = (name or getattr(server, "name", None)
                     or "replica-%d" % index)
        self.state = "up"        # up | draining | drained | lost
        self.killed = False      # simulated abrupt loss (tests/bench)
        self.outstanding = 0     # tokens owed by bound sessions
        self.sessions = 0        # bound streaming sessions
        self.dispatched = 0      # sessions ever routed here
        self.drain_deadline = None

    # -- capacity ----------------------------------------------------------
    @property
    def replay_limit(self):
        """Longest prompt this replica can prefill — the bound on
        failover replay (prompt + already-emitted tokens re-enter as
        one prefill)."""
        return self.server._seq_ladder.max_batch

    @property
    def max_new(self):
        return self.server._max_new

    # -- health ------------------------------------------------------------
    def probe(self):
        """One in-band health probe: ``"up"`` (healthy), ``"slow"``
        (unresponsive — starvation-suppressible), or ``"down"``
        (definitively dead: simulated kill, scheduler thread gone, or
        the server closed outside a clean drain)."""
        if self.killed:
            return "down"
        srv = self.server
        if srv._closed:
            return "up" if self.state == "drained" else "down"
        if srv._started:
            t = srv._thread
            if t is None or not t.is_alive():
                return "down"
        try:
            srv.stats()
        except Exception:
            return "slow"
        return "up"

    def kill(self):
        """Simulate abrupt replica loss (chaos tests, the bench's
        mid-run kill): the scheduler exits WITHOUT completing or
        failing in-flight work — futures never resolve, KV pages are
        abandoned with the "process". Nothing announces the death; the
        fleet monitor must detect it and the router must replay the
        orphaned sessions elsewhere."""
        self.killed = True
        srv = self.server
        with srv._cond:
            srv._stopping = True
            srv._drain = False
            srv._queue.clear()
            del srv._active[:]
            srv._cond.notify_all()
        if srv._started and srv._thread is not None:
            srv._thread.join(timeout=5.0)
        srv._closed = True
        from .. import livemetrics
        livemetrics.deregister_decode_server(srv)


class FleetMonitor:
    """Replica-loss confirmation over in-band probes, judging by the
    training heartbeat's rules (:class:`StrikeTracker`): ``strikes``
    consecutive failed probes confirm a loss; a monitor that was
    itself starved between sweeps abstains from judging *unresponsive*
    replicas that sweep (a ``"down"`` verdict — dead thread, closed
    server — is definitive and never suppressed); a replica that
    drained cleanly is exempt. :meth:`check` visits the
    ``replica_lost`` fault site once per replica per sweep — a planned
    raise there confirms the loss deterministically."""

    def __init__(self, strikes=None, interval_ms=None):
        self.strikes = max(1, int(strikes) if strikes is not None
                           else envs.get_int("MXNET_ROUTER_STRIKES"))
        ms = (int(interval_ms) if interval_ms is not None
              else envs.get_int("MXNET_ROUTER_PROBE_MS"))
        self.interval = max(ms, 1) / 1e3
        self.tracker = StrikeTracker(self.strikes)
        self._last_sweep = None
        self.sweeps = 0

    def due(self, now):
        return self._last_sweep is None \
            or now - self._last_sweep >= self.interval

    def check(self, replicas, now=None):
        """One health sweep; returns the replicas whose loss this
        sweep CONFIRMS (their state is not changed here — ownership of
        the up->lost transition stays with the router's failover)."""
        now = time.monotonic() if now is None else now
        starved = self._last_sweep is not None and \
            now - self._last_sweep > max(2.0 * self.interval, 0.25)
        self._last_sweep = now
        self.sweeps += 1
        lost = []
        for rep in replicas:
            if rep.state == "lost":
                continue
            if rep.state == "drained":
                # clean departure: a drained replica's dead scheduler
                # must never read as a lost one
                self.tracker.departed(rep.name)
                continue
            try:
                fault.inject("replica_lost")
                verdict = rep.probe()
            except fault.InjectedFault:
                # the planned confirmation: this probe IS the loss
                verdict = "down"
                rep.killed = True
            if verdict == "slow" and starved:
                # a starved judge cannot tell a dead peer from its
                # own lost time slices — judge nobody this sweep
                self.tracker.abstain()
                continue
            if self.tracker.observe(rep.name, healthy=verdict == "up"):
                lost.append(rep)
        return lost

    def forget(self, name):
        """Drop a replica from judgment (it left the roster)."""
        self.tracker.clear(name)
