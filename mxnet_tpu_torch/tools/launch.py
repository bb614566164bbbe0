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

**Failure semantics:** the first worker to exit nonzero tears the
survivors down (SIGTERM, a ``MXNET_LAUNCH_GRACE`` window, then SIGKILL)
and the launcher exits with THAT worker's code: no orphans, no masked
exit status.

Only the ``local`` launcher exists; ``ssh``/``mpi``/``sge``/``yarn``
raise, as in the JAX package. ``--supervise`` (restart-the-world
supervision over the heartbeat contract) raises until
``parallel/multihost.py``'s heartbeat is ported (ROADMAP queue A item
12, order step 6).
"""
from __future__ import annotations

import argparse
import os
import signal
import socket
import subprocess
import sys
import time

__all__ = ["launch_local", "worker_contract", "main"]


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


def _wait_first_failure(procs, poll_s=0.1):
    """Poll until every worker exited cleanly, or one failed. Returns
    ``(failed_rank, exit_code)``, ``(None, 0)`` on full success."""
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
                        help="restart-the-world supervision (not ported)")
    parser.add_argument("--resume-prefix", default=None)
    parser.add_argument("--events-file", default=None)
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
        raise NotImplementedError(
            "--supervise needs the heartbeat of parallel/multihost.py, "
            "not ported yet (ROADMAP queue A item 12, order step 6)")
    return launch_local(args.num_workers, args.command,
                        extra_env=args.env)


if __name__ == "__main__":
    sys.exit(main())
