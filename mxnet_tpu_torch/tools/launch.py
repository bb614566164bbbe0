"""Multi-process job launcher (counterpart of
``mxnet_tpu/tools/launch.py``; reference tools/launch.py:33).

``python -m mxnet_tpu_torch.tools.launch -n 2 python train.py`` spawns
N worker processes on this host with the reference's DMLC_* environment
contract (DMLC_NUM_WORKER / DMLC_WORKER_ID / DMLC_PS_ROOT_URI /
DMLC_PS_ROOT_PORT). Workers need no launcher-specific code: importing
``mxnet_tpu_torch``, or creating a dist kvstore, joins the
``torch.distributed`` process group the contract describes
(``fault.join_process_group``); the all-reduce replaces the reference's
server pool, so ``-s/--num-servers`` is accepted and ignored.

**Failure semantics (non-supervised):** the first worker to exit
nonzero tears the survivors down (SIGTERM, a ``MXNET_LAUNCH_GRACE``
window, then SIGKILL) and the launcher exits with THAT worker's code: no
orphans, no masked exit status.

**Supervised mode (``--supervise``):** restart-the-world supervision.
The launcher arms the heartbeat contract (``MXNET_HB_DIR``: every worker
runs a writer and a peer monitor, ``parallel.multihost``), watches both
process exits and heartbeat staleness (a world whose every beat went
silent is torn down too), and on a failure kills the surviving workers,
scans ``--resume-prefix`` for the newest VALID manifest epoch, and
relaunches the whole job, on a fresh store port and a clean heartbeat
slate, with ``MXNET_LAUNCH_RESTART`` (the generation) and
``MXNET_LAUNCH_RESUME_EPOCH`` set, so workers resume instead of
starting over. The backoff doubles from ``MXNET_LAUNCH_BACKOFF`` a
consecutive restart, the budget is ``MXNET_LAUNCH_MAX_RESTARTS``
(``--max-restarts``), and ``MXNET_LAUNCH_ALLOW_SHRINK=1`` relaunches
N-1 workers (the manifests are elastic). ``--events-file`` appends one
JSON line a supervisor event (``launch``, ``worker_failed``,
``teardown``, ``restart``, ``success``, ``give_up``): the source of the
detection-to-relaunch time. A worker that exits with
``multihost.HOST_LOST_EXIT`` (43) saw a peer's heartbeat go stale.

Only the ``local`` launcher exists; ``ssh``/``mpi``/``sge``/``yarn``
raise, as in the JAX package.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import signal
import socket
import subprocess
import sys
import tempfile
import time

__all__ = ["launch_local", "supervise", "worker_contract", "main"]


def worker_contract():
    """This process's launcher worker contract, or ``None`` outside a
    launched worker set: ``{"rank", "world", "uri", "port"}`` read
    from the DMLC_* environment the launcher sets. Serving workers use
    it to name their router replica ``replica-<rank>``."""
    if os.environ.get("DMLC_ROLE") != "worker":
        return None
    try:
        return {"rank": int(os.environ["DMLC_WORKER_ID"]),
                "world": int(os.environ["DMLC_NUM_WORKER"]),
                "uri": os.environ.get("DMLC_PS_ROOT_URI", "127.0.0.1"),
                "port": int(os.environ.get("DMLC_PS_ROOT_PORT", 0))}
    except (KeyError, ValueError):
        return None


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _grace_seconds():
    from .. import envs
    return max(float(envs.get_float("MXNET_LAUNCH_GRACE")), 0.0)


def _spawn_workers(num_workers, command, extra_env=(), port=None,
                   extra=None):
    """Spawn the DMLC_* worker set; returns (procs, port)."""
    port = port or _free_port()
    procs = []
    for i in range(num_workers):
        env = dict(os.environ)
        env.update({
            "DMLC_ROLE": "worker",
            "DMLC_NUM_WORKER": str(num_workers),
            "DMLC_WORKER_ID": str(i),
            "DMLC_PS_ROOT_URI": "127.0.0.1",
            "DMLC_PS_ROOT_PORT": str(port),
        })
        # one trace export a rank (rank 0 keeps the configured name), so
        # tracing.merge_exports can align the set afterwards
        trace_file = env.get("MXNET_TRACE_FILE", "")
        if trace_file and num_workers > 1 and i != 0:
            base, ext = os.path.splitext(trace_file)
            env["MXNET_TRACE_FILE"] = "%s.worker%d%s" % (base, i, ext)
        if extra:
            env.update(extra)
        for kv in extra_env:
            k, _, v = kv.partition(":")
            env[k] = v
        procs.append(subprocess.Popen(command, env=env))
    return procs, port


def _exit_code(code):
    """A Popen returncode as a shell exit code: a signal death (negative)
    maps to 128 + signum; ``None`` maps to 1."""
    if code is None:
        return 1
    code = int(code)
    if code < 0:
        return 128 + (-code) if -code < 128 else 1
    return code


def _teardown(procs, grace=None):
    """SIGTERM every live worker, wait out the grace window, SIGKILL the
    stragglers."""
    live = [p for p in procs if p.poll() is None]
    for p in live:
        try:
            p.send_signal(signal.SIGTERM)
        except OSError:
            pass
    deadline = time.monotonic() + (_grace_seconds() if grace is None
                                   else grace)
    for p in live:
        while p.poll() is None and time.monotonic() < deadline:
            time.sleep(0.05)
        if p.poll() is None:
            try:
                p.kill()
            except OSError:
                pass
            p.wait()


def _wait_first_failure(procs, poll_s=0.1, hb_dir=None,
                        hb_timeout_s=None):
    """Poll until every worker exited cleanly, or one failed. Returns
    ``(failed_rank, exit_code)``, ``(None, 0)`` on full success. With
    ``hb_dir`` given, a WHOLE-WORLD heartbeat silence past
    ``hb_timeout_s`` also counts as a failure (rank -1, code None): the
    in-job monitors usually exit a wedged world themselves, but a world
    wedged before its monitors armed, or with every monitor stuck, needs
    the supervisor's outside view."""
    while True:
        running = False
        for rank, p in enumerate(procs):
            code = p.poll()
            if code is None:
                running = True
            elif code != 0:
                return rank, code
        if not running:
            return None, 0
        if hb_dir is not None and hb_timeout_s:
            freshest = None
            for rank in range(len(procs)):
                try:
                    age = time.time() - os.stat(
                        os.path.join(hb_dir, "hb-%d" % rank)).st_mtime
                except OSError:
                    continue
                freshest = age if freshest is None else min(freshest, age)
            if freshest is not None and freshest > hb_timeout_s:
                # no worker exited, the WORLD went silent: code None maps
                # to exit 1, never aliasing a real signal death
                return -1, None
        time.sleep(poll_s)


def launch_local(num_workers, command, extra_env=(), port=None,
                 extra=None):
    """Spawn ``command`` num_workers times with the DMLC_* contract and
    wait. The FIRST nonzero exit tears the other workers down and its
    code is returned as the job's; a clean run returns 0."""
    procs, _ = _spawn_workers(num_workers, command, extra_env=extra_env,
                              port=port, extra=extra)
    try:
        rank, code = _wait_first_failure(procs)
    except KeyboardInterrupt:
        _teardown(procs)
        raise
    if rank is not None:
        print("launch: worker %d exited with %d — tearing down the "
              "remaining workers" % (rank, code), file=sys.stderr)
        _teardown(procs)
        return _exit_code(code)
    return 0


class _Events:
    """Append-only JSONL event log of the supervisor (the tests and
    ``chip_smoke.py`` read the detection and restart timings from it)."""

    def __init__(self, path):
        self.path = path
        self.t0 = time.monotonic()

    def emit(self, kind, **fields):
        rec = {"t": round(time.monotonic() - self.t0, 4), "kind": kind}
        rec.update(fields)
        if self.path:
            with open(self.path, "a") as f:
                f.write(json.dumps(rec) + "\n")
        print("launch-supervisor: %s %s" % (kind, json.dumps(fields)),
              file=sys.stderr)


def _scan_resume_epoch(prefix):
    """The newest VALID manifest epoch under ``prefix`` (the restart's
    resume point), or None: torn epochs are skipped, not trusted."""
    if not prefix:
        return None
    from ..checkpoint import latest_manifest_epoch
    return latest_manifest_epoch(prefix)


def supervise(num_workers, command, extra_env=(), resume_prefix=None,
              events_file=None, max_restarts=None, hb_dir=None):
    """Run the job under restart-the-world supervision; returns the
    final exit code (0: a launch attempt finished clean)."""
    from .. import envs
    if max_restarts is None:
        max_restarts = envs.get_int("MXNET_LAUNCH_MAX_RESTARTS")
    backoff = max(float(envs.get_float("MXNET_LAUNCH_BACKOFF")), 0.0)
    allow_shrink = bool(envs.get_bool("MXNET_LAUNCH_ALLOW_SHRINK"))
    hb_timeout_s = max(envs.get_int("MXNET_HB_TIMEOUT_MS"), 1) / 1e3
    hb_dir = hb_dir or envs.get_path("MXNET_HB_DIR")
    owned = None
    if not hb_dir:
        hb_dir = owned = tempfile.mkdtemp(prefix="mxhb-")
    events = _Events(events_file)
    try:
        n = int(num_workers)
        restarts = 0
        while True:
            resume_epoch = _scan_resume_epoch(resume_prefix)
            extra = {"MXNET_HB_DIR": hb_dir,
                     "MXNET_LAUNCH_RESTART": str(restarts),
                     "MXNET_LAUNCH_RESUME_EPOCH":
                         "" if resume_epoch is None else str(resume_epoch)}
            # a fresh attempt starts with a clean heartbeat slate: beat
            # files and departure markers of the previous generation
            # must not confuse the new world's monitors
            try:
                for f in os.listdir(hb_dir):
                    if f.startswith("hb-"):
                        os.unlink(os.path.join(hb_dir, f))
            except OSError:
                pass
            events.emit("launch", attempt=restarts, workers=n,
                        resume_epoch=resume_epoch)
            t_launch = time.monotonic()
            # port=None: each attempt rendezvouses on a fresh store port
            procs, _ = _spawn_workers(n, command, extra_env=extra_env,
                                      extra=extra)
            try:
                rank, code = _wait_first_failure(
                    procs, hb_dir=hb_dir, hb_timeout_s=10 * hb_timeout_s)
            except KeyboardInterrupt:
                _teardown(procs)
                raise
            if rank is None:
                events.emit("success", attempt=restarts,
                            wall_s=round(time.monotonic() - t_launch, 3))
                return 0
            t_detect = time.monotonic()
            events.emit("worker_failed", attempt=restarts, rank=rank,
                        code=code, detect_s=round(t_detect - t_launch, 3))
            _teardown(procs)
            events.emit("teardown", attempt=restarts,
                        teardown_s=round(time.monotonic() - t_detect, 3))
            if restarts >= max_restarts:
                events.emit("give_up", attempt=restarts, code=code)
                return _exit_code(code) or 1
            delay = backoff * (2.0 ** restarts)
            restarts += 1
            if allow_shrink and n > 1:
                # degraded relaunch: no replacement host is coming; the
                # elastic manifests make the smaller world a resume
                n -= 1
            events.emit("restart", attempt=restarts, workers=n,
                        backoff_s=round(delay, 3))
            time.sleep(delay)
    finally:
        if owned:
            shutil.rmtree(owned, ignore_errors=True)


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Launch a distributed mxnet_tpu_torch job (local "
                    "multi-process; ref tools/launch.py)")
    parser.add_argument("-n", "--num-workers", required=True, type=int)
    parser.add_argument("-s", "--num-servers", type=int, default=None,
                        help="accepted for CLI parity; the all-reduce "
                             "has no server role")
    parser.add_argument("--launcher", default="local",
                        choices=["local", "ssh", "mpi", "sge", "yarn"])
    parser.add_argument("-H", "--hostfile", default=None)
    parser.add_argument("--env", action="append", default=[],
                        help="KEY:VALUE set in every worker")
    parser.add_argument("--sync-dst-dir", default=None)
    parser.add_argument("--supervise", action="store_true",
                        help="restart-the-world supervision: detect a "
                             "dead/wedged worker, tear the job down, "
                             "relaunch resuming from the last good "
                             "manifest epoch")
    parser.add_argument("--resume-prefix", default=None,
                        help="checkpoint prefix the supervisor scans for "
                             "the newest valid manifest epoch on each "
                             "restart")
    parser.add_argument("--events-file", default=None,
                        help="append supervisor events as JSON lines "
                             "(detection/teardown/restart timings)")
    parser.add_argument("--max-restarts", type=int, default=None,
                        help="restart budget (default "
                             "MXNET_LAUNCH_MAX_RESTARTS)")
    parser.add_argument("command", nargs=argparse.REMAINDER)
    args = parser.parse_args(argv)
    if not args.command:
        parser.error("no command given")
    if args.launcher != "local":
        raise NotImplementedError(
            "launcher %r: only the local launcher exists (as in the JAX "
            "package); use --launcher local for single-host "
            "multi-process" % args.launcher)
    if args.supervise:
        return supervise(args.num_workers, args.command,
                         extra_env=args.env,
                         resume_prefix=args.resume_prefix,
                         events_file=args.events_file,
                         max_restarts=args.max_restarts)
    return launch_local(args.num_workers, args.command,
                        extra_env=args.env)


if __name__ == "__main__":
    sys.exit(main())
