"""Parallelism and distribution (counterpart of ``mxnet_tpu/parallel``).

Mesh-first, over the ranks of the process group: pick axes (``dp``,
``fsdp``, ``sp``, ``tp``, ``pp``, ``ep``; :mod:`~mxnet_tpu_torch.
parallel.mesh`), place arrays by partition specs and rules
(:mod:`~mxnet_tpu_torch.parallel.sharding_rules`), and run the
collectives over an axis's group, eager or under autograd
(:mod:`~mxnet_tpu_torch.parallel.collectives`): data-parallel, ZeRO-1,
FSDP, sequence-parallel and tensor-parallel training (:mod:`~mxnet_tpu_
torch.parallel.data_parallel`, :mod:`~mxnet_tpu_torch.parallel.
grad_sync`), ring and Ulysses attention (:mod:`~mxnet_tpu_torch.
parallel.ring_attention`) over the flash-attention kernels
(:mod:`~mxnet_tpu_torch.parallel.flash_attention`; the name stays the
module here, where the JAX package exports its function), the GPipe
schedule over ``pp`` (:mod:`~mxnet_tpu_torch.parallel.pipeline`),
top-k routed experts over ``ep`` (:mod:`~mxnet_tpu_torch.parallel.
moe`), the process group itself (:mod:`~mxnet_tpu_torch.parallel.
distributed`) and its fault tolerance: the heartbeat, the bounded
exchange and the step boundaries (:mod:`~mxnet_tpu_torch.parallel.
multihost`; :class:`HostLostError`).
"""
from .mesh import (create_mesh, auto_mesh, make_mesh, mesh_axes,
                   local_mesh, PartitionSpec, NamedSharding, ShardedTensor,
                   replicated, shard_batch, use_mesh, current_mesh,
                   set_current_mesh, DeviceMesh, MeshTensor)
from .collectives import (all_reduce, all_gather, reduce_scatter, broadcast,
                          ppermute, barrier, psum_eager, all_to_all,
                          bucket_reduce_scatter, bucket_all_gather,
                          copy_to_axis, reduce_from_axis, psum,
                          gather_from_axis, ppermute_grad, all_to_all_grad)
from . import grad_sync
from .grad_sync import GradSyncPlan, ShardedOptState
from . import sharding_rules
from .sharding_rules import (SpecLayout, ShardingRules, ParamShardPlan,
                             parameter_spec_from_name, param_shard_enabled)
from .ring_attention import ring_attention, ulysses_attention, \
    local_attention
from .data_parallel import (make_data_parallel_step, shard_params,
                            DistributedTrainer, apply_param_sharding)
from .pipeline import pipeline_apply, stack_stage_params
from .moe import moe_ffn, topk_route, load_balance_loss
from . import flash_attention   # the module, as the port's callers use it
from . import distributed
from . import multihost
from .multihost import HostLostError
