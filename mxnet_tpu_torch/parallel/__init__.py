"""Parallelism and distribution (counterpart of ``mxnet_tpu/parallel``).

Mesh-first, over the ranks of the process group: pick axes (``dp``,
``fsdp``, ``sp``; :mod:`~mxnet_tpu_torch.parallel.mesh`), place arrays
by partition specs and rules (:mod:`~mxnet_tpu_torch.parallel.
sharding_rules`), and run the collectives over an axis's group
(:mod:`~mxnet_tpu_torch.parallel.collectives`): data-parallel, ZeRO-1
and FSDP training (:mod:`~mxnet_tpu_torch.parallel.data_parallel`,
:mod:`~mxnet_tpu_torch.parallel.grad_sync`), ring and Ulysses attention
(:mod:`~mxnet_tpu_torch.parallel.ring_attention`) over the flash-
attention kernels (:mod:`~mxnet_tpu_torch.parallel.flash_attention`; the
name stays the module here, where the JAX package exports its function),
the process group itself (:mod:`~mxnet_tpu_torch.parallel.
distributed`).

The pipeline (``pp``) and expert (``ep``) axes and the multi-host
heartbeat wait for ROADMAP queue A item 12, order step 6: their names
raise ``NotImplementedError``.
"""
from .mesh import (create_mesh, auto_mesh, make_mesh, mesh_axes,
                   local_mesh, PartitionSpec, NamedSharding, ShardedTensor,
                   replicated, shard_batch, use_mesh, current_mesh,
                   set_current_mesh)
from .collectives import (all_reduce, all_gather, reduce_scatter, broadcast,
                          ppermute, barrier, psum_eager, all_to_all,
                          bucket_reduce_scatter, bucket_all_gather)
from . import grad_sync
from .grad_sync import GradSyncPlan, ShardedOptState
from . import sharding_rules
from .sharding_rules import (SpecLayout, ShardingRules, ParamShardPlan,
                             parameter_spec_from_name, param_shard_enabled)
from .ring_attention import ring_attention, ulysses_attention, \
    local_attention
from .data_parallel import (make_data_parallel_step, shard_params,
                            DistributedTrainer, apply_param_sharding)
from . import flash_attention   # the module, as the port's callers use it
from . import distributed
from . import multihost

_NEXT = "ROADMAP queue A item 12, order step 6"


def _unported(name, what):
    def stub(*args, **kwargs):
        raise NotImplementedError(
            "parallel.%s (%s) is not ported yet (%s)" % (name, what, _NEXT))
    stub.__name__ = name
    stub.__doc__ = "Not ported yet: %s (%s)." % (what, _NEXT)
    return stub


pipeline_apply = _unported("pipeline_apply", "the pp axis, pipeline.py")
stack_stage_params = _unported("stack_stage_params",
                                "the pp axis, pipeline.py")
moe_ffn = _unported("moe_ffn", "the ep axis, moe.py")
topk_route = _unported("topk_route", "the ep axis, moe.py")
load_balance_loss = _unported("load_balance_loss", "the ep axis, moe.py")


class HostLostError(RuntimeError):
    """Not ported yet: the multi-host heartbeat's peer-loss error
    (``multihost.py``); constructing one raises."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "parallel.HostLostError (the multi-host heartbeat, "
            "multihost.py) is not ported yet (%s)" % _NEXT)
