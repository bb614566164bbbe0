"""Multi-host runtime: heartbeat failure detection, the bounded
control-plane exchange and step boundaries (counterpart of
``mxnet_tpu/parallel/multihost.py``).

One process a rank, joined into a ``torch.distributed`` group by the
launcher contract (``tools/launch.py``'s DMLC_* env or the
``MXNET_TPU_*`` triple; ``parallel.distributed``). This module adds what
the bare process group does not give a training job:

- **Failure detection** (:class:`Heartbeat`): a daemon writer thread a
  process touches ``$MXNET_HB_DIR/hb-<rank>`` every
  ``MXNET_HB_INTERVAL_MS``; a daemon monitor thread watches the peers it
  is responsible for (rank 0 watches everyone, the other ranks watch
  rank 0) and, when a peer's file goes stale past
  ``MXNET_HB_TIMEOUT_MS``, records a :class:`HostLostError` and exits
  the process with :data:`HOST_LOST_EXIT`. A *wedged-but-alive* host
  (stuck in a collective, spinning in native code) is detected by its
  silence, and this process dies loudly for the supervisor instead of
  waiting in a gloo collective until the group's timeout. The writer
  tick visits the ``proc_hb`` fault site, so ``MXNET_FAULT_PLAN`` wedges
  (``stall``/``hang``) or kills (``raise``) the beat deterministically.

- **Bounded exchange** (:func:`barrier`, :func:`exchange_bytes`,
  :func:`exchange_arrays`, :func:`cross_host_sum`): rank-keyed values
  through the process group's c10d ``Store`` (the ``TCPStore`` or
  ``FileStore`` :func:`~mxnet_tpu_torch.parallel.distributed.join`
  built the group over). Every wait is bounded: a peer that never posts
  surfaces as :class:`HostLostError` naming it, unless its heartbeat
  proves it alive (slow is not dead; only the heartbeat decides death).
  :func:`cross_host_sum` left-folds the rows in rank-major order, the
  grouping of the JAX package's flat-mesh sum. This is the control
  plane (barriers, manifests, epochs); gradients ride the group's own
  collectives.

- **Step boundaries** (:func:`step_boundary`): one call a training step
  visits the ``proc_exit`` fault site (the deterministic "host dies at
  step N" of the supervised-launcher tests) and raises
  :class:`HostLostError` on the training thread when the monitor has
  detected a peer loss while this process is between collectives.
"""
from __future__ import annotations

import datetime
import io as _io
import logging
import os
import threading
import time

import numpy as _np

from .. import envs
from ..base import MXNetError

__all__ = ["HostLostError", "HOST_LOST_EXIT", "supports_global_spmd",
           "coordination_client", "barrier", "exchange_bytes",
           "exchange_arrays", "cross_host_sum", "Heartbeat",
           "StrikeTracker",
           "maybe_start_heartbeat", "stop_heartbeat", "heartbeat",
           "host_lost", "step_boundary"]

HOST_LOST_EXIT = 43     # the exit code a heartbeat-detected loss uses


class HostLostError(MXNetError):
    """A peer process (host) is gone or wedged: its heartbeat went stale
    past MXNET_HB_TIMEOUT_MS, or a bounded exchange heard nothing from it
    and its heartbeat is not fresh. Raised on the training thread at the
    next step_boundary(); the monitor thread also exits the process with
    HOST_LOST_EXIT, so a job stuck inside a collective still dies loudly
    for the supervisor."""


def supports_global_spmd():
    """True when the group's collectives run on the device (NCCL), so a
    barrier is a device sync; False under gloo (ranks that share a card,
    or the CPU), where the control plane rides the store. A world of one
    is True, as in the JAX package (where the name means "XLA runs one
    program across every process")."""
    from . import distributed
    if distributed.num_workers() <= 1:
        return True
    return "nccl" in (distributed.backend() or "")


def coordination_client():
    """The process group's c10d ``Store`` (the one ``distributed.join``
    built and handed to ``init_process_group``), or None outside a group
    joined that way. It lives exactly as long as the group."""
    from . import distributed
    return distributed.store()


def _timeout_ms():
    return max(int(envs.get_int("MXNET_HB_TIMEOUT_MS")), 1)


def _world():
    from . import distributed
    return distributed.num_workers(), distributed.rank()


_barrier_lock = threading.Lock()
_barrier_uses = {}


def barrier(name, timeout_ms=None, one_shot=False):
    """Block until every rank reached ``name``, through the store (the
    control plane: under gloo no collective is involved). Each use of a
    REUSABLE ``name`` gets a per-use suffix; every rank calls barriers in
    the same program order (SPMD discipline), so the suffixes agree.
    ``one_shot=True`` skips the suffix table for names that are unique
    already (the per-exchange done-barriers). Raises MXNetError naming
    the barrier once ``timeout_ms`` passed: a peer that died surfaces
    here instead of hanging until the group's timeout. In a group joined
    without a store handle this is the group's ``barrier()``."""
    n, _ = _world()
    if n <= 1:
        return
    store = coordination_client()
    if store is None:
        import torch.distributed as dist
        dist.barrier()
        return
    if timeout_ms is None:
        # progress-scale, not liveness-scale: a peer legitimately slow at
        # a barrier (a large shard write before the checkpoint barrier, a
        # first step) must not be judged lost by a heartbeat-sized window
        timeout_ms = max(10 * _timeout_ms(), 60000)
    timeout_ms = int(timeout_ms)
    if one_shot:
        bid = str(name)
    else:
        with _barrier_lock:
            use = _barrier_uses[name] = _barrier_uses.get(name, 0) + 1
        bid = "%s#%d" % (name, use)
    key = "mxbar/" + bid
    try:
        if store.add(key + "/in", 1) >= n:
            store.set(key + "/go", b"1")
        store.wait([key + "/go"], datetime.timedelta(milliseconds=timeout_ms))
    except Exception as exc:
        raise MXNetError(
            "multihost barrier %r did not complete within %dms — a peer "
            "process is gone or wedged (%s: %s)"
            % (bid, timeout_ms, type(exc).__name__, str(exc)[:200])) \
            from exc


# ---------------------------------------------------------------------------
# the store exchange (the control plane)
# ---------------------------------------------------------------------------

_xchg_lock = threading.Lock()
_xchg_seq = [0]

# wire-context framing: when tracing is armed a sender prepends MAGIC +
# 4-byte big-endian length + context JSON to its payload; a receiver
# ALWAYS strips the frame when the magic is present. With tracing off
# nothing is prepended.
_WIRE_MAGIC = b"\x00MXWC1\x00"


def _wire_wrap(tag, payload):
    from .. import tracing
    ctx = tracing.wire_context(tag=tag)
    if ctx is None:
        return bytes(payload)
    import json as _json
    blob = _json.dumps(ctx).encode()
    return _WIRE_MAGIC + len(blob).to_bytes(4, "big") + blob + bytes(payload)


def _wire_unwrap(blob):
    """Strip (and adopt) a peer's wire-context frame; a malformed frame
    falls back to the raw bytes."""
    if not blob.startswith(_WIRE_MAGIC):
        return blob
    try:
        off = len(_WIRE_MAGIC)
        n = int.from_bytes(blob[off:off + 4], "big")
        import json as _json
        ctx = _json.loads(blob[off + 4:off + 4 + n].decode())
        payload = blob[off + 4 + n:]
    except (ValueError, UnicodeDecodeError):
        return blob
    from .. import tracing
    tracing.adopt_context(ctx, name="ctx:exchange", cat="wire")
    return payload


def _next_tag(tag):
    """Unique-per-use exchange tag: every rank calls exchanges in the
    same program order, so a process-local counter agrees."""
    with _xchg_lock:
        _xchg_seq[0] += 1
        return "mxhx/%s/%d" % (tag, _xchg_seq[0])


def _peer_alive(r):
    """Liveness against progress: a peer that is SLOW (a long first step,
    a big shard write) is not lost while its heartbeat proves it alive;
    only the heartbeat decides death. Without a heartbeat contract the
    timeout itself is the verdict."""
    hb_dir = envs.get_path("MXNET_HB_DIR")
    if not hb_dir:
        return False
    path = os.path.join(hb_dir, "hb-%d" % r)
    if os.path.exists(path + ".done"):
        return False       # departed cleanly without contributing
    try:
        age = time.time() - os.stat(path).st_mtime
    except OSError:
        return False
    return age <= _timeout_ms() / 1e3


def exchange_bytes(tag, payload, timeout_ms=None):
    """All-gather one bytes payload a rank through the store: returns
    ``[bytes_rank0, .., bytes_rankN-1]`` on every rank. SPMD: every rank
    calls with the same ``tag`` sequence. A rank that posts nothing
    within ``timeout_ms`` (default ten heartbeat timeouts) and whose
    heartbeat is not fresh raises :class:`HostLostError` naming every
    rank still silent."""
    n, me = _world()
    if n <= 1:
        return [bytes(payload)]
    store = coordination_client()
    if store is None:
        raise MXNetError(
            "multihost.exchange_bytes: no store — the process group was "
            "not joined through parallel.distributed (distributed.init / "
            "the launcher contract)")
    timeout_ms = int(timeout_ms if timeout_ms is not None
                     else 10 * _timeout_ms())
    key = _next_tag(tag)
    store.set("%s/%d" % (key, me), _wire_wrap(key, payload))
    wait = datetime.timedelta(milliseconds=timeout_ms)
    out = []
    for r in range(n):
        if r == me:
            out.append(bytes(payload))
            continue
        pkey = "%s/%d" % (key, r)
        while True:
            try:
                store.wait([pkey], wait)
                val = bytes(store.get(pkey))
                break
            except Exception as exc:
                if _peer_alive(r):
                    continue   # provably alive, just slow: keep waiting
                silent = [q for q in range(r, n) if q != me
                          and not store.check(["%s/%d" % (key, q)])]
                raise HostLostError(
                    "multihost exchange %r: rank(s) %s produced nothing "
                    "within %dms and their heartbeat is not fresh — host "
                    "lost or wedged (%s)"
                    % (key, ", ".join(map(str, silent or [r])), timeout_ms,
                       type(exc).__name__)) from exc
        out.append(_wire_unwrap(val))
    # nobody reads these keys again (every rank holds the values): the
    # done-barrier makes the delete safe, and bounds the store's size
    barrier(key + "/done", timeout_ms=timeout_ms, one_shot=True)
    try:
        store.delete_key("%s/%d" % (key, me))
    except Exception:                              # noqa: BLE001
        pass        # best-effort: the store dies with the group
    return out


def exchange_arrays(tag, arrays, timeout_ms=None):
    """All-gather a list of numpy arrays a rank: ``ranks[r] = [arrays..]``
    for every rank, in rank order, same length and dtypes as
    contributed."""
    buf = _io.BytesIO()
    _np.savez(buf, *[_np.asarray(a) for a in arrays])
    blobs = exchange_bytes(tag, buf.getvalue(), timeout_ms=timeout_ms)
    out = []
    for blob in blobs:
        with _np.load(_io.BytesIO(blob), allow_pickle=False) as z:
            out.append([z["arr_%d" % i] for i in range(len(z.files))])
    return out


def cross_host_sum(tag, stacks, timeout_ms=None):
    """``stacks`` is this rank's list of per-leaf arrays whose leading
    axis is the local device axis (one row a local device, unreduced).
    Every rank's stacks are exchanged and each leaf is summed by a left
    fold over rows in global order: rank-major, local rows in order (the
    JAX package's flat-mesh grouping). Returns the summed leaves. With
    one rank this is the same fold, locally."""
    n, _ = _world()
    all_stacks = [stacks] if n <= 1 else \
        exchange_arrays(tag, stacks, timeout_ms=timeout_ms)
    out = []
    for leaf in range(len(stacks)):
        acc = None
        for rank_stack in all_stacks:
            rows = _np.asarray(rank_stack[leaf])
            for d in range(rows.shape[0]):
                acc = rows[d].copy() if acc is None else acc + rows[d]
        out.append(acc)
    return out


# ---------------------------------------------------------------------------
# heartbeat: per-process liveness over the launcher's MXNET_HB_DIR
# ---------------------------------------------------------------------------

_hb_lock = threading.Lock()
_heartbeat = None
_host_lost = [None]     # message set by the monitor before it exits
_dying = [False]        # this process is exiting because of a fault


def host_lost():
    """The HostLostError message the monitor recorded, or None."""
    return _host_lost[0]


def mark_dying():
    """Flag this process as exiting ABNORMALLY: the atexit heartbeat stop
    then writes no clean-departure marker, so peers detect the loss at
    heartbeat speed."""
    _dying[0] = True


class StrikeTracker:
    """The false-positive armor of peer-loss detection, shared by every
    liveness monitor (the training heartbeat here, the serving fleet's
    replica health in ``serving.fleet``):

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


class Heartbeat:
    """File-based liveness for one process of a launched job.

    The *writer* daemon touches ``hb-<rank>`` every
    ``MXNET_HB_INTERVAL_MS`` (visiting the ``proc_hb`` fault site: a
    planned ``stall``/``hang`` stops the beat exactly like a wedged host,
    a ``raise`` kills the writer outright). The *monitor* daemon stats
    the peers this rank is responsible for (rank 0 watches every worker,
    the other ranks watch rank 0) and on a peer older than
    ``MXNET_HB_TIMEOUT_MS`` logs the :class:`HostLostError`, notes it for
    :func:`step_boundary`, and hard-exits with :data:`HOST_LOST_EXIT`
    (``os._exit``: the training thread may be wedged inside a collective
    that never returns).

    A peer's file must EXIST before it is monitored (a slow-starting
    worker is not a dead one): monitoring of rank r arms on the first
    sighting of its file, or after ``grace_factor`` timeouts pass with
    the file still absent."""

    def __init__(self, rank, world, hb_dir=None, exit_on_loss=True,
                 grace_factor=5):
        self.rank = int(rank)
        self.world = int(world)
        self.dir = hb_dir or envs.get_path("MXNET_HB_DIR")
        if not self.dir:
            raise MXNetError("Heartbeat needs MXNET_HB_DIR (the launcher "
                             "contract) or hb_dir=")
        self.exit_on_loss = exit_on_loss
        self.grace_factor = int(grace_factor)
        self._stop = threading.Event()
        self._writer = None
        self._monitor = None
        self._seen = {}          # rank -> first time its file existed
        self._tracker = StrikeTracker(strikes=2)
        self._strikes = self._tracker.counts   # the live strike dict
        self._last_touch = time.time()
        self._started = time.time()   # beats older than this are a
                                      # PREVIOUS run's leftovers
        self.ticks = 0

    # -- paths ------------------------------------------------------------
    def _path(self, rank):
        return os.path.join(self.dir, "hb-%d" % rank)

    def _peers(self):
        if self.rank == 0:
            return [r for r in range(1, self.world)]
        return [0]

    # -- lifecycle --------------------------------------------------------
    def start(self):
        os.makedirs(self.dir, exist_ok=True)
        try:
            # a previous generation's clean-departure marker must not
            # blind peers to THIS incarnation of the rank
            os.unlink(self._path(self.rank) + ".done")
        except OSError:
            pass
        self._touch()           # exist immediately: peers arm on sight
        self._writer = threading.Thread(
            target=self._writer_loop, daemon=True, name="mxhb-write")
        self._writer.start()
        if self.world > 1:
            self._monitor = threading.Thread(
                target=self._monitor_loop, daemon=True,
                name="mxhb-monitor")
            self._monitor.start()
        return self

    def stop(self):
        self._stop.set()

    # -- writer -----------------------------------------------------------
    def _touch(self):
        path = self._path(self.rank)
        with open(path + ".tmp", "w") as f:
            f.write("%d %.6f\n" % (self.ticks, time.time()))
        os.replace(path + ".tmp", path)
        self._last_touch = time.time()

    def _writer_loop(self):
        from .. import fault
        interval = max(envs.get_int("MXNET_HB_INTERVAL_MS"), 1) / 1e3
        while not self._stop.wait(interval):
            try:
                # the injectable wedge: stall sleeps through beats (a
                # wedged-but-alive host), raise/hang kill the writer;
                # either way the FILE goes stale and peers detect it
                fault.inject("proc_hb")
            except fault.InjectedFault:
                logging.getLogger(__name__).warning(
                    "heartbeat: planned fault killed the writer (rank %d) "
                    "— this host now looks lost to peers", self.rank)
                return
            self.ticks += 1
            try:
                self._touch()
            except OSError as exc:
                logging.getLogger(__name__).warning(
                    "heartbeat: touch failed (%s); retrying", exc)

    # -- monitor ----------------------------------------------------------
    def _check_peers(self, now):
        """One staleness sweep; returns the HostLostError message for the
        first lost peer, or None. A peer that left a clean-departure
        marker (``hb-<rank>.done``: normal job completion) is no longer
        monitored.

        Self-starvation guard: when OUR OWN writer has not beaten
        recently (CPU throttling, a swap storm: whole-machine stalls hit
        every process at once), this sweep judges nobody. Peers also need
        two CONSECUTIVE stale sweeps (strikes) before they count as
        lost."""
        timeout = _timeout_ms() / 1e3
        if now - self._last_touch > 0.5 * timeout:
            self._tracker.abstain()
            return None
        for r in self._peers():
            path = self._path(r)
            if os.path.exists(path + ".done"):
                # departure is re-judged each sweep from the marker file
                # (a restarted incarnation unlinks it), so the tracker
                # only forgets the strikes
                self._tracker.clear(r)
                continue
            stale = None
            try:
                mtime = os.stat(path).st_mtime
                if mtime < self._started:
                    # a PREVIOUS run's leftover beat in a reused
                    # MXNET_HB_DIR: this generation's peer has not
                    # started yet, so the never-seen grace applies
                    raise OSError("stale previous-generation beat")
                age = now - mtime
                self._seen.setdefault(r, now)
                if age > timeout:
                    stale = ("rank %d heartbeat stale for %.3fs (timeout "
                             "%.3fs) — host lost or wedged"
                             % (r, age, timeout))
            except OSError:
                if self._seen.get(r) is not None:
                    # was beating, file gone: the worker (or its dir) was
                    # torn down under us
                    stale = "rank %d heartbeat file disappeared — host " \
                            "lost" % r
                else:
                    # never seen: allow a slow start, then treat a worker
                    # that never appeared as lost
                    self._seen.setdefault("miss-%d" % r, now)
                    first_miss = self._seen["miss-%d" % r]
                    if now - first_miss > self.grace_factor * timeout:
                        stale = ("rank %d heartbeat never appeared within "
                                 "%.1fs" % (r, now - first_miss))
            if self._tracker.observe(r, healthy=stale is None):
                return stale
        return None

    def _monitor_loop(self):
        interval = max(envs.get_int("MXNET_HB_INTERVAL_MS"), 1) / 1e3
        while not self._stop.wait(interval):
            msg = self._check_peers(time.time())
            if msg is None:
                continue
            _host_lost[0] = msg
            logging.getLogger(__name__).error(
                "HostLostError: %s — exiting %d for the supervisor",
                msg, HOST_LOST_EXIT)
            from .. import flightrec, telemetry
            telemetry.note("host_lost")
            # last words before os._exit: the surviving rank's view of
            # the loss (never raises; one None check when disarmed)
            flightrec.crash_dump("host_lost", detail=msg)
            if self.exit_on_loss:
                # the training thread may be wedged inside a collective
                # that never returns: flush what we can and die loudly so
                # the supervisor restarts the world
                try:
                    telemetry.stop()
                except Exception:                  # noqa: BLE001
                    pass
                os._exit(HOST_LOST_EXIT)
            return


def heartbeat():
    """The process's active Heartbeat (or None)."""
    return _heartbeat


def maybe_start_heartbeat(rank=None, world=None):
    """Start the singleton heartbeat when the launcher contract asks for
    one: ``MXNET_HB_DIR`` set and a multi-worker world (the DMLC_* or
    MXNET_TPU_* contract; ``rank``/``world`` given by a join with
    explicit arguments). Idempotent; returns the Heartbeat or None."""
    global _heartbeat
    hb_dir = envs.get_path("MXNET_HB_DIR")
    if not hb_dir:
        return None
    if rank is None or world is None:
        if "DMLC_WORKER_ID" in os.environ:
            rank = int(os.environ["DMLC_WORKER_ID"])
            world = int(os.environ.get("DMLC_NUM_WORKER", 1) or 1)
        else:
            rank = envs.get_int("MXNET_TPU_RANK") or 0
            world = envs.get_int("MXNET_TPU_WORLD") or 1
    if int(world) <= 1:
        return None
    with _hb_lock:
        if _heartbeat is None:
            _heartbeat = Heartbeat(rank, world, hb_dir=hb_dir).start()
            # stop beating the moment this process starts dying: a
            # worker whose main thread raised can linger in interpreter
            # shutdown while daemon threads keep running; without this
            # its fresh heartbeat makes a dead host look alive
            import atexit
            atexit.register(stop_heartbeat)
            # an UNCAUGHT exception is an abnormal exit: flag it so the
            # atexit stop skips the clean-departure marker and peers
            # detect this host at heartbeat speed
            import sys as _sys
            prev_hook = _sys.excepthook

            def _hb_excepthook(tp, val, tb):
                mark_dying()
                stop_heartbeat(clean=False)
                prev_hook(tp, val, tb)

            _sys.excepthook = _hb_excepthook
    return _heartbeat


def stop_heartbeat(clean=None):
    """Stop the singleton heartbeat. ``clean`` (default: "not dying")
    writes the ``hb-<rank>.done`` departure marker so peers stop
    monitoring this rank; a fatal exit skips the marker so peers detect
    the loss at heartbeat speed."""
    global _heartbeat
    with _hb_lock:
        hb, _heartbeat = _heartbeat, None
    if hb is not None:
        hb.stop()
        if clean is None:
            clean = not _dying[0]
        if not clean:
            # the dying rank's own last words (excepthook, fatal step
            # boundary), bundled before the interpreter unwinds
            from .. import flightrec
            flightrec.crash_dump("host_dying")
        if clean:
            try:
                path = hb._path(hb.rank) + ".done"
                with open(path + ".tmp", "w") as f:
                    f.write("done\n")
                os.replace(path + ".tmp", path)
            except OSError:
                pass
    _host_lost[0] = None


def step_boundary():
    """Once a training step on the training thread: the ``proc_exit``
    fault site (a planned ``raise`` here IS the "worker dies at step N"
    of the supervised-launcher tests) plus the host-loss check, so a
    detected peer loss surfaces as a typed :class:`HostLostError` at a
    step boundary even before the monitor hard-exits."""
    from .. import fault
    try:
        fault.inject("proc_exit")
    except BaseException:
        # dying loudly: stop advertising liveness (NO clean marker) so
        # peers detect the loss at heartbeat speed
        mark_dying()
        stop_heartbeat(clean=False)
        raise
    msg = _host_lost[0]
    if msg is not None:
        mark_dying()
        stop_heartbeat(clean=False)
        raise HostLostError(msg)
