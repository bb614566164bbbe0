"""Deterministic fault injection and the non-finite gradient guard
(counterpart of ``mxnet_tpu/fault.py``).

**Fault injection.** ``MXNET_FAULT_PLAN`` holds a ``;``- or
``,``-separated list of ``site:step=N:action[:count=K]`` entries, e.g.
``serve_decode:step=1:hang:count=inf;grad:step=5:nan``. A site's step
counter counts *visits*; an entry fires on visits ``step ..
step+count-1`` (``count=inf`` fires forever). With the plan unset every
injection point is a no-op.

Sites of the port:

- ``grad`` — once per parameter per optimizer step (the ``Updater``, or
  :func:`grad_poison` inside the fused step); ``nan``/``inf`` corrupt a
  copy of the gradient;
- ``ckpt_write`` / ``ckpt_fsync`` — before each checkpoint file write
  and before its fsync (``checkpoint.atomic_write_file``), so a planned
  fault aborts or stalls a save at an exact file boundary;
- ``serve_admit`` — once per ``DecodeServer.submit`` and per
  admitted ``InferenceServer.submit``;
- ``serve_dispatch`` — once per ``InferenceServer`` batcher pass; a
  planned hang stalls dispatch so queued requests age past their
  deadlines, a raise fails that pass and is counted;
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
  a failed dump, never fatal (the dumper drill);
- ``push`` / ``pull`` — once per attempt of a kvstore push's reduce and
  of a pull (``kvstore.py``), so a planned raise exercises the retry;
- ``init`` — once per attempt of the process-group join;
- ``proc_join`` — once per join, before its retried attempts;
- ``proc_hb`` — once per heartbeat-writer tick
  (``parallel/multihost.py``): ``stall``/``hang`` wedge the beat so the
  PEERS detect a stale file, ``raise`` kills the beat outright;
- ``proc_exit`` — once per training step on the training thread
  (``multihost.step_boundary``): ``proc_exit:step=N:raise`` is the
  deterministic "host dies at exactly step N" the supervised launcher's
  restart-the-world path is tested against.

Actions: ``raise`` → :class:`InjectedFault`; ``hang`` → sleep
``MXNET_FAULT_HANG_SECONDS`` then :class:`InjectedHang`; ``stall`` →
the same sleep and no exception; ``nan``/``inf`` (the ``grad`` site
only) → a poisoned copy of the value.

**Non-finite gradient guard.** Policies ``skip_step`` (drop the update,
count it in :func:`stats`) and ``scale_backoff`` (also halve a dynamic
loss scale, regrow it after ``MXNET_LOSS_SCALE_WINDOW`` clean steps),
selected with ``MXNET_NONFINITE_GUARD``; a plan with a ``grad`` site
turns ``skip_step`` on. :func:`filter_gradient` is the eager updater's
guard; the fused step skips inside its graph and reports the step
through :func:`fused_step_guard`. Each branch that advances
``skipped_steps`` also notes it into an active telemetry run, and each
loss-scale change writes a ``loss_scale`` record.

**Retries.** :func:`with_retries` runs a synchronization op with
exponential backoff and jitter under the ``MXNET_KVSTORE_TIMEOUT``
deadline and raises :class:`CollectiveTimeoutError` once it passes;
:func:`guard` is the kvstore's gate for single-process stores (retries
only while a plan is active). :func:`join_process_group` joins the
``torch.distributed`` process group the launcher's ``DMLC_*`` contract
describes (``tools/launch.py``). State is process-global;
:func:`reset` re-reads the environment.
"""
from __future__ import annotations

import logging
import os
import random
import threading
import time

from . import envs
from .base import MXNetError

__all__ = ["FaultPlan", "InjectedFault", "InjectedHang",
           "CollectiveTimeoutError", "with_retries", "guard",
           "join_process_group", "plan",
           "set_plan", "reset", "active", "is_enabled", "inject",
           "stats", "reset_stats", "guard_policy", "loss_scale",
           "filter_gradient", "grad_poison", "fused_step_guard",
           "note_resume"]

_ACTIONS = ("raise", "hang", "stall", "nan", "inf")
_SITES = ("push", "pull", "init", "grad", "ckpt_write", "ckpt_fsync",
          "serve_admit", "serve_dispatch", "serve_decode",
          "serve_route", "kv_evict",
          "kv_share", "kv_cow", "replica_lost", "proc_hb", "proc_join",
          "proc_exit", "flightrec")
# corruption needs a value to corrupt: only the grad site carries one
_VALUE_SITES = ("grad",)
_GUARD_POLICIES = ("skip_step", "scale_backoff")
_LOSS_SCALE_MAX = 2.0 ** 24


class InjectedFault(MXNetError):
    """A fault raised by a MXNET_FAULT_PLAN entry (action ``raise``)."""


class InjectedHang(InjectedFault):
    """A planned hang: the injection point blocked for
    MXNET_FAULT_HANG_SECONDS and then surfaced as a timed-out op."""


class CollectiveTimeoutError(MXNetError):
    """A synchronization op (kvstore push/pull, barrier, process-group
    init) did not complete within MXNET_KVSTORE_TIMEOUT despite
    retries."""


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
    if action in ("nan", "inf") and site not in _VALUE_SITES:
        raise MXNetError(
            "fault plan entry %r: action %r needs one of the value-"
            "carrying sites (%s)" % (text, action, "|".join(_VALUE_SITES)))
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

    def has_site(self, site):
        return any(e.site == site for e in self.entries)

    def __repr__(self):
        return "FaultPlan(%s)" % ";".join(repr(e) for e in self.entries)


# ---------------------------------------------------------------------------
# process-global state
# ---------------------------------------------------------------------------

_lock = threading.Lock()
_plan = None
_plan_loaded = False
_guard = None
_guard_loaded = False
_loss_scale_val = None
_good_steps = 0
# the updater runs once per parameter index per optimizer step; the
# guard counts per STEP, and a repeating index marks the next step
_seen_indices = set()
_step_clean = True


def _fresh_stats():
    return {"skipped_steps": 0, "retries": 0, "timeouts": 0,
            "injected": {}, "resumed_from_epoch": None,
            "clean_resumes": 0, "rollback_resumes": 0,
            "rollback_epochs": 0}


_stats = _fresh_stats()


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


def _reset_guard_state_locked():
    global _guard, _guard_loaded, _loss_scale_val, _good_steps
    global _seen_indices, _step_clean
    _guard, _guard_loaded = None, False
    _loss_scale_val, _good_steps = None, 0
    _seen_indices, _step_clean = set(), True


def set_plan(spec):
    """Install a plan programmatically (a spec string, a FaultPlan, or
    None); resets the visit counters, the stats, the guard's resolution
    and its runtime state (loss scale, step tracking)."""
    global _plan, _plan_loaded
    with _lock:
        if spec is None or isinstance(spec, FaultPlan):
            _plan = spec
        else:
            _plan = FaultPlan.parse(spec)
            if not _plan.entries:
                _plan = None
        _plan_loaded = True
        _reset_guard_state_locked()
    reset_stats()


def reset():
    """Forget the cached plan, guard and scale state and re-read the
    environment on next use. Tests that monkeypatch MXNET_* vars call
    this."""
    global _plan, _plan_loaded, _retry_cfg
    with _lock:
        _plan, _plan_loaded = None, False
        _retry_cfg = None
        _reset_guard_state_locked()
    reset_stats()


def reset_stats():
    global _stats
    with _lock:
        _stats = _fresh_stats()


def active():
    """True when a fault plan is installed."""
    return plan() is not None


def guard_policy():
    """The resolved non-finite-guard policy: MXNET_NONFINITE_GUARD when
    set (``off`` disables), else ``skip_step`` when the active plan has
    a ``grad`` site, else None."""
    global _guard, _guard_loaded
    if not _guard_loaded:
        env = envs.get_str("MXNET_NONFINITE_GUARD")
        if env and env != "off":
            if env not in _GUARD_POLICIES:
                raise MXNetError("MXNET_NONFINITE_GUARD=%r (want %s|off)"
                                 % (env, "|".join(_GUARD_POLICIES)))
            resolved = env
        elif env == "off":
            resolved = None
        else:
            p = plan()
            resolved = "skip_step" if p is not None and p.has_site("grad") \
                else None
        with _lock:
            _guard, _guard_loaded = resolved, True
    return _guard


def is_enabled():
    """Cheap hot-path check: a plan or a guard policy is on."""
    return active() or guard_policy() is not None


# ---------------------------------------------------------------------------
# injection
# ---------------------------------------------------------------------------

def _hang_seconds():
    return envs.get_float("MXNET_FAULT_HANG_SECONDS")


def _corrupt(value, kind):
    """A poisoned COPY of ``value`` (an NDArray, a sparse NDArray, whose
    values are poisoned, or a tensor): the caller's buffer is never
    touched."""
    bad = float("nan") if kind == "nan" else float("inf")
    if getattr(value, "_sp_data", None) is not None:
        out = value.copy()
        out._sp_data = _corrupt(out._sp_data, kind)
        return out
    data = getattr(value, "_data", None)
    if data is not None:
        from .ndarray import NDArray
        return NDArray(data.detach().clone().fill_(bad))
    return value.detach().clone().fill_(bad)


def _visit_site(site):
    """Count one visit to ``site``; return the corruption entry firing
    on this visit or None. ``raise``/``hang``/``stall`` act here."""
    p = plan()
    if p is None:
        return None
    with _lock:
        entry = p.visit(site)
        if entry is not None:
            _stats["injected"][site] = _stats["injected"].get(site, 0) + 1
    if entry is None:
        return None
    if entry.action == "raise":
        raise InjectedFault("planned fault at site %r (%r)" % (site, entry))
    if entry.action in ("hang", "stall"):
        hang = _hang_seconds()
        time.sleep(hang)
        if entry.action == "hang":
            raise InjectedHang("planned hang at site %r (%r): blocked %.3fs"
                               % (site, entry, hang))
        return None
    return entry


def inject(site, value=None):
    """One injection point. Counts a visit to ``site``; when a plan
    entry fires: ``raise`` → InjectedFault, ``hang`` → bounded sleep
    then InjectedHang, ``stall`` → the same sleep and no exception,
    ``nan``/``inf`` → a corrupted copy of ``value``. Returns ``value``
    (possibly corrupted); a no-op without an active plan."""
    entry = _visit_site(site)
    if entry is not None and value is not None:
        return _corrupt(value, entry.action)
    return value


def grad_poison():
    """The fused step's ``grad`` site: counts ONE visit (once per
    parameter per step, the eager updater's visit order) and returns
    the poison the graph splices over that parameter's gradient: 0.0
    when nothing fires, nan/inf when a corruption entry does."""
    entry = _visit_site("grad")
    if entry is None:
        return 0.0
    return float("nan") if entry.action == "nan" else float("inf")


# ---------------------------------------------------------------------------
# non-finite gradient guard
# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# retries
# ---------------------------------------------------------------------------

_retry_cfg = None
_jitter_rng = random.Random(0)


def _retry_config():
    """(timeout, backoff, max_backoff) from the environment, parsed
    once: with_retries sits on the per-key dist push path. reset()
    re-reads."""
    global _retry_cfg
    if _retry_cfg is None:
        _retry_cfg = (
            envs.get_float("MXNET_KVSTORE_TIMEOUT"),
            envs.get_float("MXNET_KVSTORE_RETRY_BACKOFF"),
            envs.get_float("MXNET_KVSTORE_RETRY_MAX_BACKOFF"))
    return _retry_cfg


def with_retries(fn, timeout=None, backoff=None, max_backoff=None,
                 retry_on=None, site=None):
    """Run ``fn()`` with exponential backoff and jitter under a wall-clock
    deadline; raise :class:`CollectiveTimeoutError` (chaining the last
    error) once the deadline passes.

    The deadline is enforced BETWEEN attempts: a planned ``hang`` is
    bounded (it sleeps MXNET_FAULT_HANG_SECONDS, then raises), but an op
    wedged inside the runtime is bounded only by its own timeout (the
    process group's, for a collective).

    - ``timeout``: seconds; default MXNET_KVSTORE_TIMEOUT (60).
    - ``backoff``: first retry delay; default
      MXNET_KVSTORE_RETRY_BACKOFF (0.05), doubling per attempt up to
      ``max_backoff`` (MXNET_KVSTORE_RETRY_MAX_BACKOFF, 2.0).
    - ``retry_on``: exception classes worth retrying; default injected
      faults and transient transport errors (ConnectionError,
      TimeoutError, OSError).
    - ``site``: an injection site visited before each attempt, so
      planned faults exercise the retry path itself.
    """
    env_timeout, env_backoff, env_max_backoff = _retry_config()
    if timeout is None:
        timeout = env_timeout
    if backoff is None:
        backoff = env_backoff
    if max_backoff is None:
        max_backoff = env_max_backoff
    if retry_on is None:
        retry_on = (InjectedFault, ConnectionError, TimeoutError, OSError)
    deadline = time.monotonic() + timeout
    attempt = 0
    while True:
        try:
            if site is not None:
                inject(site)
            return fn()
        except CollectiveTimeoutError:
            raise
        except retry_on as exc:
            now = time.monotonic()
            if now >= deadline:
                with _lock:
                    _stats["timeouts"] += 1
                from . import telemetry
                telemetry.note("timeouts")
                raise CollectiveTimeoutError(
                    "%s did not complete within %.3fs (%d attempt(s); "
                    "last error %s: %s)"
                    % (site or getattr(fn, "__name__", "op"), timeout,
                       attempt + 1, type(exc).__name__, exc)) from exc
            # jitter BEFORE the deadline clamp, so the sleep never
            # overshoots the promised wall-clock bound
            delay = min(backoff * (2.0 ** attempt), max_backoff)
            delay *= 1.0 + 0.1 * _jitter_rng.random()
            delay = min(delay, max(deadline - now, 0.0))
            with _lock:
                _stats["retries"] += 1
            from . import telemetry
            telemetry.note("retries")
            time.sleep(delay)
            attempt += 1


def guard(fn, site):
    """The fast-path gate for sync points: ``with_retries`` while a
    fault plan is active, a plain call otherwise."""
    if active():
        return with_retries(fn, site=site)
    return fn()


def join_process_group():
    """Join the ``torch.distributed`` process group the launcher's
    ``DMLC_*`` contract describes (``tools/launch.py``):
    ``tcp://DMLC_PS_ROOT_URI:DMLC_PS_ROOT_PORT``, world size
    ``DMLC_NUM_WORKER``, rank ``DMLC_WORKER_ID``, the group's timeout
    ``MXNET_KVSTORE_TIMEOUT``; the backend by
    ``parallel.distributed.backend_for``. Transient coordinator races
    are retried under the kvstore deadline (site ``init``). A no-op
    without a contract or inside a group already. The join starts the
    launcher contract's heartbeat (``MXNET_HB_DIR``, set by
    ``tools/launch.py --supervise``; ``parallel.multihost``)."""
    n = int(os.environ.get("DMLC_NUM_WORKER", "1") or 1)
    if n <= 1 or "DMLC_WORKER_ID" not in os.environ:
        return
    from .parallel import distributed
    if distributed.is_initialized():
        return
    uri = os.environ.get("DMLC_PS_ROOT_URI", "127.0.0.1")
    port = os.environ.get("DMLC_PS_ROOT_PORT", "9091")
    inject("proc_join")
    with_retries(
        lambda: distributed.join("tcp://%s:%s" % (uri, port), n,
                                 int(os.environ["DMLC_WORKER_ID"])),
        retry_on=(ConnectionError, OSError, InjectedFault), site="init")


def _all_finite(grad):
    import torch
    grad = getattr(grad, "_sp_data", grad)
    data = getattr(grad, "_data", grad)
    return bool(torch.isfinite(data).all())


def loss_scale():
    """The current dynamic loss scale under ``scale_backoff``; 1.0 when
    that policy is off. The training loop multiplies the loss by it
    before backward; ``gluon.Trainer.step`` divides it back out."""
    global _loss_scale_val
    if guard_policy() != "scale_backoff":
        return 1.0
    if _loss_scale_val is None:
        _loss_scale_val = envs.get_float("MXNET_LOSS_SCALE")
    return _loss_scale_val


def _emit_scale_record(prev, cur, cause):
    """One ``loss_scale`` telemetry record per scale change: the
    trajectory ``tools.diagnose`` renders."""
    from . import telemetry
    telemetry.external_record({"type": "loss_scale", "prev": prev,
                               "scale": cur, "cause": cause})


def _backoff_scale():
    global _loss_scale_val, _good_steps
    prev = loss_scale()
    _loss_scale_val = max(prev * 0.5, 1.0)
    _good_steps = 0
    if _loss_scale_val != prev:
        _emit_scale_record(prev, _loss_scale_val, "backoff")
    return prev, _loss_scale_val


def _close_step():
    """End-of-step accounting: a clean step advances the regrow window
    (scale_backoff); a bad step already halved."""
    global _loss_scale_val, _good_steps
    if guard_policy() != "scale_backoff" or not _step_clean:
        return
    _good_steps += 1
    if _good_steps >= envs.get_int("MXNET_LOSS_SCALE_WINDOW"):
        prev = loss_scale()
        _loss_scale_val = min(prev * 2.0, _LOSS_SCALE_MAX)
        _good_steps = 0
        if _loss_scale_val != prev:
            _emit_scale_record(prev, _loss_scale_val, "regrow")


def _note_step_boundary(index):
    global _seen_indices, _step_clean
    if index in _seen_indices:
        _close_step()
        _seen_indices = set()
        _step_clean = True
    _seen_indices.add(index)


def _count_skip(policy, where):
    with _lock:
        _stats["skipped_steps"] += 1
    from . import telemetry
    telemetry.note("skipped_steps")
    if policy == "scale_backoff":
        prev, cur = _backoff_scale()
        logging.warning("fault: non-finite gradient %s — update dropped, "
                        "loss scale %g -> %g", where, prev, cur)
    else:
        logging.warning("fault: non-finite gradient %s — update dropped "
                        "(policy=skip_step)", where)


def filter_gradient(index, grad):
    """The eager updater's guard: apply a planned ``grad`` fault, then
    test finiteness under the active policy. Returns ``(grad, skip)``;
    ``skip=True`` drops this parameter's update. ``skipped_steps`` and
    the scale_backoff halving advance once per optimizer step, however
    many of its gradients overflowed."""
    global _step_clean
    grad = inject("grad", value=grad)
    policy = guard_policy()
    if policy is None:
        return grad, False
    _note_step_boundary(index)
    if _all_finite(grad):
        return grad, False
    first_bad = _step_clean
    _step_clean = False
    if first_bad:
        _count_skip(policy, "for index %s" % (index,))
    return grad, True


def fused_step_guard(all_finite):
    """The fused step's guard accounting: the skip itself happened
    inside the graph (a ``torch.where`` kept the old weight and state
    of every non-finite gradient); this is :func:`filter_gradient`'s
    host bookkeeping, one count and one halving per bad step, a regrow
    window tick per clean one. No-op without a guard policy."""
    global _step_clean
    policy = guard_policy()
    if policy is None:
        return
    if all_finite:
        _step_clean = True
        _close_step()
        return
    _step_clean = False
    _count_skip(policy, "inside the fused step")


def note_resume(epoch, skipped_epochs=0):
    """Record a checkpoint resume. ``skipped_epochs`` counts newer
    epochs the scan rejected (torn or corrupt) before settling on
    ``epoch``: a rollback resume loses their steps."""
    skipped_epochs = int(skipped_epochs)
    with _lock:
        _stats["resumed_from_epoch"] = epoch
        if skipped_epochs > 0:
            _stats["rollback_resumes"] += 1
            _stats["rollback_epochs"] += skipped_epochs
        else:
            _stats["clean_resumes"] += 1
    if skipped_epochs > 0:
        from . import telemetry
        telemetry.note("resume_rollback_epochs", skipped_epochs)
        telemetry.note("resume_next_epoch", int(epoch) + 1)


def stats():
    """Resilience counters: skipped_steps, retries, timeouts, per-site
    injected counts, the resume record, the loss scale and the guard
    policy."""
    with _lock:
        out = dict(_stats)
        out["injected"] = dict(_stats["injected"])
    out["loss_scale"] = loss_scale()
    out["guard_policy"] = guard_policy()
    return out
