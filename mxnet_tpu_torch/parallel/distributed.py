"""Multi-process group management on ``torch.distributed`` (counterpart
of ``mxnet_tpu/parallel/distributed.py``).

Rank and world size come from the process group. :func:`join` builds
the group's c10d store itself (a ``TCPStore`` for ``tcp://``, a
``FileStore`` for ``file://``), hands it to ``init_process_group`` and
keeps the handle (:func:`store`): ``parallel.multihost``'s bounded
barrier and exchange ride it, and a join under ``MXNET_HB_DIR`` starts
the launcher contract's heartbeat. :func:`barrier` is the store's
bounded barrier under gloo and the group's device barrier under NCCL.
Launch contract, in precedence order:

- ``MXNET_TPU_COORDINATOR`` / ``MXNET_TPU_WORLD`` / ``MXNET_TPU_RANK``,
  the explicit triple :func:`init` reads. Setting only PART of it raises
  ``MXNetError`` naming the missing variable: a mistyped contract must
  not silently train single-process. The coordinator is ``host:port``
  (a TCP rendezvous) or a ``torch.distributed`` init URL
  (``tcp://...``, ``file://...``);
- the launcher's ``DMLC_*`` contract (``tools/launch.py``), joined by
  ``fault.join_process_group`` at package import and at dist-kvstore
  creation.

**The backend rule** (:func:`backend_for`), the same on every rank
because it reads only what every rank is given: ``gloo`` for CPU
tensors and for ranks that share a CUDA device; NCCL only where each
rank has a card of its own. Ranks whose rendezvous is on this host (a
loopback address or a file store) run on this host's cards, and every
rank's ``gpu(i)`` names the same card: they take ``gloo``, which stages
CUDA tensors through the host (NCCL refuses two ranks on one device).
Ranks that meet at another host's address take ``cpu:gloo,cuda:nccl``:
one rank a host, each on its own card. A failed join is retryable:
nothing latches until ``init_process_group`` succeeded.
"""
from __future__ import annotations

import datetime
from urllib.parse import urlparse

import torch

from .. import envs
from ..base import MXNetError

__all__ = ["init", "join", "backend_for", "backend", "store", "rank",
           "num_workers", "barrier", "is_initialized", "finalize",
           "local_devices", "global_devices"]

_CONTRACT = ("MXNET_TPU_COORDINATOR", "MXNET_TPU_WORLD", "MXNET_TPU_RANK")
_LOOPBACK = ("localhost", "::1", "0.0.0.0")
_backend = [None]
_store = [None]


def _contract_from_env():
    """The validated MXNET_TPU_* triple, or None when none of it is set;
    a PARTIAL triple raises naming exactly the missing variable(s)."""
    coordinator = envs.get_str("MXNET_TPU_COORDINATOR")
    world = envs.get_int("MXNET_TPU_WORLD")
    rank_ = envs.get_int("MXNET_TPU_RANK")
    present = {"MXNET_TPU_COORDINATOR": bool(coordinator),
               "MXNET_TPU_WORLD": world is not None,
               "MXNET_TPU_RANK": rank_ is not None}
    if not any(present.values()):
        return None
    missing = [k for k in _CONTRACT if not present[k]]
    if missing:
        raise MXNetError(
            "partial multi-process launch contract: %s set but %s "
            "missing — set the whole MXNET_TPU_COORDINATOR/"
            "MXNET_TPU_WORLD/MXNET_TPU_RANK triple (or none of it) "
            "so the job cannot silently train single-process"
            % (", ".join(k for k in _CONTRACT if present[k]),
               ", ".join(missing)))
    return coordinator, int(world), int(rank_)


def _init_method(coordinator):
    return coordinator if "://" in coordinator else "tcp://" + coordinator


def _on_this_host(init_method):
    """Whether a rendezvous at ``init_method`` keeps every rank on this
    host: a file store, or a loopback address."""
    scheme, _, rest = init_method.partition("://")
    if scheme == "file":
        return True
    host = rest.split("/", 1)[0].rsplit(":", 1)[0].strip("[]")
    return host in _LOOPBACK or host.startswith("127.")


def backend_for(init_method, world_size):
    """The process group's backend, by the stated rule: ``"gloo"`` where
    there is no CUDA device or more than one rank runs on this host
    (they share its cards); ``"cpu:gloo,cuda:nccl"`` where ranks on
    other hosts each drive their own card."""
    if not torch.cuda.is_available() or int(world_size) <= 1 \
            or _on_this_host(init_method):
        return "gloo"
    return "cpu:gloo,cuda:nccl"


def _make_store(init_method, world_size, rank_, timeout):
    """The c10d store of a rendezvous at ``init_method``: a ``FileStore``
    for ``file://PATH``, a ``TCPStore`` (served by rank 0) for
    ``tcp://HOST:PORT``, as ``init_process_group`` would build them."""
    import torch.distributed as dist
    url = urlparse(init_method)
    if url.scheme == "file":
        return dist.FileStore(url.path, int(world_size))
    if url.scheme != "tcp" or url.port is None:
        raise MXNetError("distributed.join: want tcp://HOST:PORT or "
                         "file://PATH, got %r" % init_method)
    return dist.TCPStore(url.hostname, url.port, int(world_size),
                         int(rank_) == 0, timeout=timeout)


def join(init_method, world_size, rank_):
    """``torch.distributed.init_process_group`` over the store of
    ``init_method`` (kept: :func:`store`), with the rule's backend and
    ``MXNET_KVSTORE_TIMEOUT`` as the group's timeout (one attempt;
    callers retry); then the heartbeat when ``MXNET_HB_DIR`` asks for
    one."""
    import torch.distributed as dist
    name = backend_for(init_method, world_size)
    timeout = datetime.timedelta(
        seconds=envs.get_float("MXNET_KVSTORE_TIMEOUT"))
    store_ = _make_store(init_method, world_size, rank_, timeout)
    dist.init_process_group(backend=name, store=store_,
                            world_size=int(world_size), rank=int(rank_),
                            timeout=timeout)
    _backend[0] = name
    _store[0] = store_
    from . import multihost
    multihost.maybe_start_heartbeat(int(rank_), int(world_size))


def init(coordinator=None, num_processes=None, process_id=None):
    """Join the process group (the DMLC_PS_ROOT_URI role).

    Explicit arguments win; otherwise the MXNET_TPU_* triple is read and
    validated. Visits the ``proc_join`` fault site and starts the
    launcher contract's heartbeat (``MXNET_HB_DIR``). Without a contract
    anywhere this is a no-op (a single-process run)."""
    if is_initialized():
        return
    if coordinator is None and num_processes is None \
            and process_id is None:
        contract = _contract_from_env()
        if contract is not None:
            coordinator, num_processes, process_id = contract
    else:
        missing = [name for name, val in
                   (("coordinator", coordinator),
                    ("num_processes", num_processes),
                    ("process_id", process_id)) if val is None]
        if coordinator is None:
            raise MXNetError(
                "distributed.init: explicit arguments need at least "
                "coordinator= (got %s missing)" % ", ".join(missing))
        if missing:
            raise MXNetError(
                "distributed.init(coordinator=%r): %s missing — pass "
                "the full (coordinator, num_processes, process_id) "
                "triple" % (coordinator, ", ".join(missing)))
    if not coordinator:
        return
    from .. import fault
    fault.inject("proc_join")
    join(_init_method(coordinator), num_processes, process_id)


def is_initialized():
    import torch.distributed as dist
    return dist.is_available() and dist.is_initialized()


def backend():
    """The backend string of the joined group (None outside one)."""
    return _backend[0] if is_initialized() else None


def store():
    """The c10d store :func:`join` built the group over (None outside a
    group joined that way)."""
    return _store[0] if is_initialized() else None


def rank():
    import torch.distributed as dist
    return dist.get_rank() if is_initialized() else 0


def num_workers():
    import torch.distributed as dist
    return dist.get_world_size() if is_initialized() else 1


def local_devices():
    """This process's devices: every visible CUDA device, id-ascending,
    else the host."""
    if torch.cuda.is_available():
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


def global_devices():
    """Every rank's :func:`local_devices`, rank-major (rank 0's first).
    A torch device does not name its process: entry ``r * k + j`` is rank
    ``r``'s device ``j`` where every rank sees ``k``."""
    if num_workers() <= 1:
        return local_devices()
    import torch.distributed as dist
    gathered = [None] * num_workers()
    dist.all_gather_object(gathered, [str(d) for d in local_devices()])
    return [torch.device(d) for names in gathered for d in names]


def barrier(name="mxnet_tpu_barrier"):
    """Global barrier (a no-op on one worker). NCCL groups sync the
    devices; gloo groups ride the store's bounded barrier
    (``multihost.barrier``), so a peer that died surfaces as an error
    naming ``name`` instead of a wait until the group's timeout."""
    if num_workers() > 1:
        from . import multihost
        if multihost.supports_global_spmd():
            import torch.distributed as dist
            dist.barrier()
        else:
            multihost.barrier(name)


def finalize():
    from . import multihost
    multihost.stop_heartbeat()
    if is_initialized():
        import torch.distributed as dist
        dist.destroy_process_group()
    _backend[0] = None
    _store[0] = None
