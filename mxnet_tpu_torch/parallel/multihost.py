"""Peer-loss judgment (counterpart of the ``StrikeTracker`` part of
``mxnet_tpu/parallel/multihost.py``). The serving fleet's replica health
(``serving.fleet``) judges by it. The process group is
``parallel.distributed``'s; the heartbeat, the cross-host exchange and
the restart machinery of multi-host training wait for ROADMAP queue A
item 12, order step 6."""
from __future__ import annotations

__all__ = ["StrikeTracker"]


class StrikeTracker:
    """The false-positive armor of peer-loss detection, shared by every
    liveness monitor (the JAX training heartbeat, the serving fleet's
    replica health):

    - **Strikes** — a peer counts as lost only after ``strikes``
      CONSECUTIVE unhealthy sweeps (:meth:`observe` returns True on
      the confirming one); a single throttle window spanning one
      sweep cannot fire a false loss.
    - **Self-starvation abstention** — :meth:`abstain` clears every
      count: a starved judge cannot tell a dead peer from its own lost
      time slices, so it judges nobody that sweep.
    - **Clean departure** — a peer that announced normal completion
      (:meth:`departed`) is never judged again.

    ``counts`` is the live per-peer strike dict."""

    def __init__(self, strikes=2):
        self.strikes = max(1, int(strikes))
        self.counts = {}
        self._departed = set()

    def departed(self, peer):
        """Mark a clean departure: ``peer`` is exempt from judgment."""
        self._departed.add(peer)
        self.counts.pop(peer, None)

    def is_departed(self, peer):
        return peer in self._departed

    def clear(self, peer):
        """Forget ``peer`` entirely (it left the roster)."""
        self.counts.pop(peer, None)
        self._departed.discard(peer)

    def abstain(self):
        """This sweep judges nobody (the monitor itself was starved)."""
        self.counts.clear()

    def observe(self, peer, healthy):
        """Record one sweep's verdict for ``peer``. Returns True
        exactly when this observation CONFIRMS the loss (the strike
        count crosses the threshold); a healthy observation resets
        the count."""
        if healthy or peer in self._departed:
            self.counts.pop(peer, None)
            return False
        n = self.counts.get(peer, 0) + 1
        self.counts[peer] = n
        return n >= self.strikes
