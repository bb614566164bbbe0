"""Data-parallel and FSDP training over a rank mesh (counterpart of
``mxnet_tpu/parallel/data_parallel.py``).

The JAX package compiles ONE program over its mesh: the batch sharded
over ``dp``, the gradient sum inserted by the partitioner. Here every
rank runs the same step on its own rows (each rank takes its ``dp`` rows
of the global batch it is given, unless the batch was placed already:
``io.make_sharded_pipeline``, ``NamedSharding.place``) and the ranks
meet in the gradient exchange. The contract is the JAX package's
multi-process form (``_build_multihost``/``_mh_step``): each rank's loss
is its rows' SUM divided by the GLOBAL row count, so the ranks'
gradients add up to the gradient of the global mean.

- :func:`make_data_parallel_step` — ``(params, batch) -> (loss,
  new_params)`` for a user ``loss_fn`` that returns the MEAN over the
  rows it sees: its gradient is weighted by rows / global rows and the
  ranks' contributions are summed. ``grad_overlap`` switches the
  exchange to buckets (reduce-scatter, update on the slice, all-gather);
  ``param_shard`` keeps :class:`~.mesh.ShardedTensor` parameters
  sharded at rest (gathered at step entry).
- :class:`DistributedTrainer` — a Gluon net and loss traced into one
  symbol graph (``cached_op.build_graph_callable``), trained by
  ``fit_batch``. Both of its modes run ``grad_sync``'s bucketed update
  (a monolithic plan with replicated state without overlap, size-capped
  buckets with ZeRO-1 state ``1/N`` a rank with it), which makes them
  bit-identical. With ``param_shard`` (FSDP) each rank keeps at rest
  its slice of every bucket's flat parameter vector (the layout the
  update produces, a torch FSDP flat parameter), all-gathered once at
  step entry; the gradients are reduce-scattered by the same exchange,
  so FSDP on and off are bit-identical too. The rules
  (``sharding_rules``) lay out the FSDP parameters' checkpoint pieces.
  Under the trainer's mesh, BatchNorm's statistics are the global
  batch's. A mesh whose ``sp`` axis is larger than 1 is refused.
- Checkpoints go through ``checkpoint.py``'s manifest, every rank
  writing its pieces: elastic across mesh sizes, and across the
  packages (a JAX 8-device save loads on 2 ranks, and back).
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict

import numpy as _np
import torch

from ..base import MXNetError
from .mesh import NamedSharding, PartitionSpec as P, ShardedTensor

__all__ = ["make_data_parallel_step", "shard_params", "DistributedTrainer",
           "sharded_input_pipeline", "apply_param_sharding"]


def sharded_input_pipeline(source, mesh, prefetch_depth=2, num_workers=None):
    """An async input pipeline (``io/pipeline.py``) whose batches arrive
    as this rank's ``dp`` rows (whole for arrays that do not split):
    the placement the data-parallel step consumes as it is."""
    from ..io.pipeline import make_sharded_pipeline
    return make_sharded_pipeline(source, mesh, prefetch_depth=prefetch_depth,
                                 num_workers=num_workers)


def _tensor(value):
    from ..ndarray import NDArray
    if isinstance(value, NDArray):
        return value._data
    if isinstance(value, torch.Tensor):
        return value
    return torch.as_tensor(_np.asarray(value))


def _whole(value):
    """The global value of a parameter or array on every rank."""
    if isinstance(value, ShardedTensor):
        return value.local if value.is_fully_replicated else value.full()
    return _tensor(value)


def _local_rows(value, mesh, axis="dp"):
    """This rank's ``axis`` rows of a batch array (as it is when placed
    already)."""
    if isinstance(value, ShardedTensor):
        return value.local
    if getattr(value, "_dp_local", False):
        return _tensor(value)
    return NamedSharding(mesh, P(axis)).shard(_tensor(value))


def _refuse_sp(mesh, who):
    """The sequence is not sharded over ``sp`` here, nor the gradient
    summed over it: a mesh with ``sp`` > 1 would feed every sp rank the
    whole sequence as its slice."""
    if "sp" in mesh.axis_names and mesh.axis_size("sp") > 1:
        raise NotImplementedError(
            "%s over a mesh whose 'sp' axis is larger than 1 waits for "
            "ROADMAP queue A item 12, order step 6" % who)


def _resolver(mesh, rules):
    from .sharding_rules import ShardingRules
    if isinstance(rules, ShardingRules):
        return rules
    # a legacy substring table: pure overrides with a replicated default
    table = dict(rules or {})
    table.setdefault("", P())
    return ShardingRules(mesh, overrides=table)


def shard_params(params: Dict[str, Any], mesh, rules=None, pad=False):
    """Place a ``{name: array}`` dict on the mesh: ``{name:
    ShardedTensor}``, each holding this rank's piece. ``rules`` is a
    :class:`~.sharding_rules.ShardingRules` or a legacy substring → spec
    table (default: everything replicated). A sharded dim that does not
    divide its axis is never dropped silently: with ``pad=True`` the
    value is zero-padded and stored sharded (noted
    ``param_shard_padded:<name>``), otherwise it stays replicated (noted
    ``param_shard_fallback:<name>``)."""
    from .. import telemetry
    resolver = _resolver(mesh, rules)
    out = {}
    for name, arr in params.items():
        val = _whole(arr)
        plan = resolver.plan(name, tuple(val.shape))
        if plan.padded and not pad:
            telemetry.note("param_shard_fallback:%s" % name)
            out[name] = ShardedTensor(val, val.shape, NamedSharding(mesh,
                                                                    P()))
            continue
        if plan.padded:
            resolver.note_padded(name)
            val = plan.pad(val)
        out[name] = plan.sharding(mesh).place(val)
    return out


def apply_param_sharding(params, mesh, rules=None):
    """The rules layer's ``{name: ParamShardPlan}`` table for a Gluon
    ``ParameterDict`` (or ``{name: Parameter}``). A Gluon Parameter keeps
    its whole logical value in the port (its sharded storage is
    :class:`DistributedTrainer`'s, ``param_shard=True``), and a parameter
    whose sharded dim does not divide its axis is listed replicated, as
    the JAX package places it."""
    from .sharding_rules import ParamShardPlan, ShardingRules
    if not isinstance(rules, ShardingRules):
        rules = ShardingRules(mesh, overrides=rules)
    plans = {}
    for name, p in params.items():
        pl = rules.plan(name, p.data().shape)
        if pl.padded:
            from .. import telemetry
            telemetry.note("param_shard_fallback:%s" % name)
            pl = ParamShardPlan(name, P(), pl.shape, pl.shape)
        plans[name] = pl
    return plans


def make_data_parallel_step(loss_fn: Callable, mesh, optimizer_update=None,
                            donate=True, grad_overlap=None, bucket_mb=None,
                            param_shard=None, param_rules=None):
    """``(step, batch_sharding)`` with ``step(params, batch) -> (loss,
    new_params)``.

    ``loss_fn(params, batch)`` (torch) returns the MEAN loss over the
    rows it is given: each rank calls it on its ``dp`` rows, weights its
    gradient by rows / global rows and the ranks' weighted gradients
    are summed (in rank order), so the step follows the global batch's
    mean; the returned loss is the global mean. ``optimizer_update(p, g)
    -> new_p`` is elementwise (default SGD, lr 0.01). ``params`` values
    are tensors, NDArrays or :class:`~.mesh.ShardedTensor`; the new
    parameters come back in the same form. ``batch`` values are the
    global batch (each rank takes its rows) or arrays placed by
    ``batch_sharding``.

    ``grad_overlap`` (None: ``MXNET_GRAD_OVERLAP``) exchanges the
    gradients in ``bucket_mb`` buckets; without it one bucket holds
    them all. Both update each rank's slice and gather it, so the two
    agree bit for bit. ``param_shard`` (None: ``MXNET_PARAM_SHARD``)
    with parameters placed by ``shard_params(params, mesh, rules)``:
    each sharded parameter is gathered at step entry and the updated one
    goes back to its piece (``param_rules``: the same rules). ``donate``
    is accepted: the step never reuses its inputs' storage."""
    from . import grad_sync
    from .mesh import use_mesh
    from .sharding_rules import param_shard_enabled
    from .collectives import all_reduce
    _refuse_sp(mesh, "make_data_parallel_step")
    if optimizer_update is None:
        def optimizer_update(p, g):
            return p - 0.01 * g
    overlap = grad_sync.overlap_enabled() if grad_overlap is None \
        else bool(grad_overlap)
    shard_on = param_shard_enabled() if param_shard is None \
        else bool(param_shard)
    rules = _resolver(mesh, param_rules) if shard_on else None
    cap = (int(bucket_mb * (1 << 20)) if bucket_mb
           else grad_sync.bucket_cap_bytes()) if overlap \
        else grad_sync.MONOLITH_CAP
    batch_sharding = NamedSharding(mesh, P("dp"))
    n_dp = mesh.axis_size("dp")

    def update(g, w, states, lr, wd, rescale):
        return optimizer_update(w, g), ()

    def step(params, batch):
        names = list(params)
        whole = [_whole(params[n]).detach() for n in names]
        local = {k: _local_rows(v, mesh) for k, v in batch.items()}
        rows = next(iter(local.values())).shape[0]
        weight = float(rows) / float(rows * n_dp)
        leaves = [w.clone().requires_grad_(True) for w in whole]
        with use_mesh(mesh):
            loss = loss_fn(dict(zip(names, leaves)), local)
        grads = torch.autograd.grad(loss * weight, leaves,
                                    materialize_grads=True)
        with torch.no_grad():
            # grad_sync's exchange with the user's rule as every
            # parameter's step function (no state, no scalars)
            plan = grad_sync.GradSyncPlan(
                [w.shape for w in whole], [w.dtype for w in whole],
                axis_size=n_dp, cap_bytes=cap)
            apply = grad_sync.make_bucketed_apply([update] * len(names), 0,
                                                  plan, mesh, "dp")
            new, _ = apply([g.detach() for g in grads], whole, (),
                           torch.zeros(2 * len(names) + 2,
                                       device=whole[0].device))
            total = loss.detach() * weight
            if n_dp > 1:
                total = all_reduce(total, mesh, "dp")
        out = {}
        for n, v, w in zip(names, (params[k] for k in names), new):
            if isinstance(v, ShardedTensor):
                sharding = v.sharding
                if shard_on and rules.plan(n, w.shape).sharded:
                    sharding = rules.plan(n, w.shape).sharding(mesh)
                out[n] = ShardedTensor(sharding.shard(w).clone(), w.shape,
                                       sharding)
            else:
                from ..ndarray import NDArray
                out[n] = NDArray(w) if isinstance(v, NDArray) else w
        return total, out

    return step, batch_sharding


class DistributedTrainer:
    """A Gluon trainer whose step runs on every rank of a mesh's ``dp``
    axis: the net and the loss traced into one graph, the gradients
    exchanged by ``grad_sync``, the update on each rank's slice.

    Usage: build a HybridBlock and call ``trainer.fit_batch(data,
    label)`` on every rank with the global batch (each rank takes its
    rows). Parameters live in the trainer, placed once at the first
    step; :meth:`sync_gluon_params` writes them back to the Gluon
    handles. The update is the optimizer's ``fused_step_fn`` (SGD and
    momentum, Adam, AdaGrad, RMSProp); an optimizer without one raises.

    ``grad_overlap`` (None: ``MXNET_GRAD_OVERLAP``): size-capped buckets
    and ZeRO-1 state, ``1/N`` a rank; off: one bucket and replicated
    state. ``param_shard`` (None: ``MXNET_PARAM_SHARD``): FSDP, each
    rank keeping its ``1/N`` slice of every bucket at rest, gathered at
    step entry; ``param_rules`` lay out the checkpoint's pieces. Both
    pairs of modes give the same bits. ``multihost`` is accepted: every
    trainer of the port is multi-process. The mesh's ``sp`` axis, if
    any, has size 1."""

    def __init__(self, net, loss_block, mesh, optimizer="sgd",
                 learning_rate=0.01, optimizer_params=None,
                 param_rules=None, grad_overlap=None, bucket_mb=None,
                 param_shard=None, multihost=None):
        from .. import optimizer as opt_mod
        self._net = net
        self._loss = loss_block
        self._mesh = mesh
        if isinstance(optimizer, opt_mod.Optimizer):
            self._opt = optimizer
        else:
            kwargs = dict(optimizer_params or {})
            kwargs.setdefault("learning_rate", learning_rate)
            self._opt = opt_mod.create(optimizer, **kwargs)
        if "dp" not in mesh.axis_names:
            raise MXNetError("DistributedTrainer: the mesh has no 'dp' axis "
                             "(axes: %s)" % list(mesh.axis_names))
        _refuse_sp(mesh, "DistributedTrainer")
        self._overlap = grad_overlap
        self._bucket_mb = bucket_mb
        self._param_rules = param_rules
        self._param_shard = param_shard
        self._param_plans = None
        self._mem_bd = None
        self._step_fn = None
        self._roster = None
        self._aux_roster = None
        self._param_vals = None       # this rank's storage, placed once
        self._aux_vals = None
        self._state_vals = None
        self._plan = None
        self._sync_state = None
        self._pending_restore = None
        self._gluon_dirty = False
        self.dispatch_count = 0
        self.last_sync_s = 0.0
        self._gather_s = 0.0

    @property
    def optimizer(self):
        return self._opt

    @property
    def overlap(self):
        """True when the built step uses size-capped buckets and sharded
        state (None before the first fit_batch)."""
        return None if self._step_fn is None else self._sync_state.sharded

    @property
    def param_shard(self):
        """True when the built step keeps the parameters sharded at rest
        (None before the first fit_batch)."""
        return None if self._step_fn is None \
            else self._param_plans is not None

    def state_bytes_per_device(self):
        """Resident optimizer-state bytes a rank: ``1/N`` with overlap."""
        return 0 if self._sync_state is None \
            else self._sync_state.state_bytes_per_device()

    def param_bytes_per_device(self):
        """Resident parameter bytes a rank: with FSDP the bucket slices
        (``1/N`` of the padded buckets), else every parameter whole; aux
        states whole."""
        if self._param_vals is None:
            return 0
        return sum(v.numel() * v.element_size()
                   for v in list(self._param_vals) + list(self._aux_vals))

    # -- build ------------------------------------------------------------
    def _build(self, data_local):
        from .. import random as _random
        from .. import symbol as sym_mod
        from ..cached_op import build_graph_callable
        from . import grad_sync
        from .sharding_rules import ShardingRules, param_shard_enabled

        net, mesh = self._net, self._mesh
        if any(p._data is None for p in net.collect_params().values()):
            from .. import autograd
            from ..ndarray import NDArray
            with autograd.pause():
                net(NDArray(data_local[:1]))
        loss_sym = self._loss(net(sym_mod.var("data")), sym_mod.var("label"))
        fn, arg_names, aux_names, n_rng, n_out = \
            build_graph_callable(loss_sym)
        params = {p.name: p for p in net.collect_params().values()}
        self._params = params
        roster = [n for n in arg_names if n in params]
        aux_roster = [n for n in aux_names if n in params]
        self._roster, self._aux_roster = roster, aux_roster
        indices = list(range(len(roster)))
        if not self._opt.idx2name:
            self._opt.idx2name = dict(enumerate(roster))
        weights_nd = [params[n].data() for n in roster]
        step_fns = [self._opt.fused_step_fn(i, w)
                    for i, w in zip(indices, weights_nd)]
        if any(f is None for f in step_fns):
            raise MXNetError(
                "DistributedTrainer: optimizer %s has no fused_step_fn "
                "update path for this roster — use SGD/momentum, Adam, "
                "AdaGrad or RMSProp" % type(self._opt).__name__)
        shard_on = param_shard_enabled() if self._param_shard is None \
            else bool(self._param_shard)
        plans = None
        if shard_on:
            rules = self._param_rules
            if not isinstance(rules, ShardingRules):
                rules = ShardingRules(mesh, overrides=rules)
            plans = [rules.plan(n, w.shape)
                     for n, w in zip(roster, weights_nd)]
            for n, pl in zip(roster, plans):
                if pl.sharded and pl.padded:
                    rules.note_padded(n)
        self._param_plans = plans
        self._mem_bd = None
        overlap = grad_sync.overlap_enabled() if self._overlap is None \
            else bool(self._overlap)
        cap = int(self._bucket_mb * (1 << 20)) if self._bucket_mb else None
        self._shapes = [w.shape for w in weights_nd]
        plan = grad_sync.GradSyncPlan(
            self._shapes, [w.dtype for w in weights_nd],
            axis_size=mesh.axis_size("dp"),
            cap_bytes=cap if overlap else grad_sync.MONOLITH_CAP)
        vals = [params[n].data()._data.detach() for n in roster]
        self._param_vals = self._at_rest(plan, vals) if plans is not None \
            else [v.clone() for v in vals]
        self._aux_vals = [params[n].data()._data.detach().clone()
                          for n in aux_roster]
        sync_state = grad_sync.ShardedOptState(plan, mesh, "dp",
                                               sharded=overlap)
        if not sync_state.probe(self._opt, indices, weights_nd):
            raise MXNetError("DistributedTrainer: optimizer %s state layout "
                             "has no sharded path" % type(self._opt).__name__)
        self._state_vals = list(sync_state.ensure())
        self._plan, self._sync_state = plan, sync_state
        self._apply = grad_sync.make_bucketed_apply(
            step_fns, sync_state.n_slots, plan, mesh, "dp",
            shard_state=overlap, gather_params=plans is None)
        device = vals[0].device if vals else torch.device("cpu")
        self._rng = _random.generator(device) if n_rng else None
        self._graph = (fn, arg_names, aux_names, n_out)
        self._device = device
        self._step_fn = self._step
        if self._pending_restore is not None:
            self._apply_restore(self._pending_restore)
            self._pending_restore = None

    def _at_rest(self, plan, whole):
        """FSDP's storage of the whole parameters: this rank's bucket
        slices."""
        from . import grad_sync
        index = self._mesh.axis_index("dp") if plan.axis_size > 1 else 0
        return grad_sync.bucket_slices(plan, whole, index)

    def _whole_params(self):
        """Every parameter's value (with FSDP, the entry gather)."""
        from . import grad_sync
        if self._param_plans is None:
            return list(self._param_vals)
        return grad_sync.gather_bucket_slices(
            self._plan, self._param_vals, self._shapes, self._mesh, "dp")

    # -- the step ---------------------------------------------------------
    def _step(self, data_v, label_v, scalars):
        from .collectives import all_reduce
        from .mesh import use_mesh
        fn, arg_names, aux_names, n_out = self._graph
        n_dp = self._mesh.axis_size("dp")
        n_rows = float(data_v.shape[0] * n_dp)
        t0 = time.perf_counter()
        whole = self._whole_params()
        self._gather_s = time.perf_counter() - t0
        pos = {n: k for k, n in enumerate(self._roster)}
        aux_pos = {n: k for k, n in enumerate(self._aux_roster)}
        leaves = [w.detach().requires_grad_(True) for w in whole]
        vals = [data_v if n == "data" else label_v if n == "label"
                else leaves[pos[n]] for n in arg_names]
        vals += [self._aux_vals[aux_pos[n]] for n in aux_names]
        with use_mesh(self._mesh):
            outs = fn({"__train__": True}, *vals, rng=self._rng)
            # the rows' SUM over the GLOBAL row count: the ranks'
            # gradients add up to the global mean's
            loss = outs[0].sum() / n_rows
            grads = torch.autograd.grad(loss, leaves,
                                        materialize_grads=True)
        new_aux = [a.detach() for a in outs[n_out:n_out
                                            + len(self._aux_roster)]]
        with torch.no_grad():
            new_ws, new_sts = self._apply(
                grads, [w.detach() for w in whole], self._state_vals,
                scalars)
            loss = loss.detach()
            if n_dp > 1:
                loss = all_reduce(loss, self._mesh, "dp")
        return loss, new_ws, new_sts, new_aux

    def fit_batch(self, data, label):
        """One training step on every rank: forward, backward, the
        gradient exchange and the update; returns the global mean loss.
        ``data``/``label`` are the global batch (each rank takes its
        ``dp`` rows) or this rank's rows from
        ``io.make_sharded_pipeline``."""
        from .. import telemetry
        from ..fused_step import pack_step_scalars
        from ..ndarray import NDArray
        from . import grad_sync
        data_v = _local_rows(data, self._mesh)
        label_v = _local_rows(label, self._mesh)
        if self._step_fn is None:
            self._build(data_v)
        device = self._device
        scalars = torch.from_numpy(pack_step_scalars(
            self._opt, list(range(len(self._roster))))).to(device)
        with telemetry.span("compute"):
            loss, new_ws, new_sts, new_aux = self._step_fn(
                data_v.to(device), label_v.to(device), scalars)
        self._param_vals = list(new_ws)
        self._state_vals = list(new_sts)
        self._aux_vals = list(new_aux)
        self._sync_state.store(new_sts)
        self.last_sync_s = self._gather_s + sum(self._apply.sync_seconds)
        if telemetry.enabled():
            if self._mem_bd is None:
                self._mem_bd = self._memory_breakdown()
            telemetry.memory_breakdown(**self._mem_bd)
        if self._sync_state.sharded:
            grad_sync.account_in_program_sync(
                self._plan, mesh=self._mesh,
                seconds=self._apply.sync_seconds)
        self._gluon_dirty = True
        self.dispatch_count += 1
        return NDArray(loss)

    def _memory_breakdown(self):
        """Resident bytes a rank by kind: ``params_sharded`` (FSDP's
        bucket slices), ``params_replicated`` (aux included) and
        ``opt_state``."""
        held = sum(v.numel() * v.element_size()
                   for v in self._param_vals or [])
        sharded, replicated = (held, 0) if self._param_plans is not None \
            else (0, held)
        replicated += sum(v.numel() * v.element_size()
                          for v in self._aux_vals or [])
        return {"params_sharded": sharded, "params_replicated": replicated,
                "opt_state": self.state_bytes_per_device()}

    def sync_gluon_params(self):
        """Write the trained values back into the Gluon Parameters (with
        FSDP gathered first: every rank calls it)."""
        if not self._gluon_dirty:
            return
        from ..ndarray import NDArray
        for n, v in zip(self._roster, self._whole_params()):
            self._params[n].set_data(NDArray(v))
        for n, v in zip(self._aux_roster, self._aux_vals):
            self._params[n].set_data(NDArray(v))
        self._gluon_dirty = False

    # -- checkpointing ----------------------------------------------------
    def _checkpoint_roster(self):
        arg = {}
        for pos, (n, v) in enumerate(zip(self._roster,
                                         self._whole_params())):
            pl = self._param_plans[pos] if self._param_plans else None
            if pl is not None and pl.sharded and not pl.padded:
                # an FSDP parameter is saved by the rules' pieces, each
                # rank writing its own; a padded one whole (the manifest
                # stays logical-shaped)
                sharding = pl.sharding(self._mesh)
                v = ShardedTensor(sharding.shard(v).clone(), v.shape,
                                  sharding)
            arg[n] = v
        aux = dict(zip(self._aux_roster, self._aux_vals))
        extra = self._sync_state.checkpoint_roster()
        # Adam's bias correction reads the update counts: they ride along
        opt = self._opt
        extra["opt:update_counts"] = _np.array(
            [opt._index_update_count.get(i, opt.begin_num_update)
             for i in range(len(self._roster))], _np.int64)
        return arg, aux, extra

    def save_checkpoint(self, prefix, epoch, manager=None):
        """One sharded manifest checkpoint of the parameters, the aux
        states and the optimizer state (the sharded pieces written by
        their ranks); every rank calls it. ``manager`` (a
        ``CheckpointManager``) saves asynchronously on a one-rank mesh."""
        from .. import checkpoint as ckpt
        assert self._step_fn is not None, \
            "fit_batch at least once before checkpointing"
        arg, aux, extra = self._checkpoint_roster()
        if manager is not None:
            manager.save(epoch, arg, aux, extra=extra)
            return
        ckpt.save_arrays(prefix, epoch,
                         ckpt.snapshot_params(arg, aux, extra=extra))

    def load_checkpoint(self, prefix, epoch, validate=True):
        """Elastic resume from a manifest checkpoint (any mesh size, either
        package): parameters re-placed by the current plans, the sharded
        optimizer state re-padded for the current axis. Before the first
        fit_batch the payload waits for the build."""
        from .. import checkpoint as ckpt
        flat = {k: v._data for k, v in
                ckpt.load_arrays(prefix, epoch, validate=validate,
                                 ctx=None).items()}
        if self._step_fn is None:
            self._pending_restore = flat
        else:
            self._apply_restore(flat)

    def _apply_restore(self, flat):
        from ..ndarray.ndarray import host_numpy
        flat = dict(flat)
        # the optimizer state first: a bucket-layout mismatch raises
        # before anything of the trainer changes
        counts = flat.pop("opt:update_counts", None)
        opt_flat = {k: host_numpy(v) for k, v in flat.items()
                    if k.startswith("opt:")}
        if opt_flat:
            self._sync_state.load_host_flats(opt_flat)
            self._state_vals = list(self._sync_state.ensure())
        whole = self._whole_params()
        for pos, n in enumerate(self._roster):
            key = "arg:%s" % n
            if key in flat:
                like = whole[pos]
                whole[pos] = flat[key].to(device=like.device,
                                          dtype=like.dtype).clone()
        self._param_vals = self._at_rest(self._plan, whole) \
            if self._param_plans is not None else whole
        for pos, n in enumerate(self._aux_roster):
            key = "aux:%s" % n
            if key in flat:
                like = self._aux_vals[pos]
                self._aux_vals[pos] = flat[key].to(device=like.device,
                                                   dtype=like.dtype).clone()
        if counts is not None:
            opt = self._opt
            for i, c in enumerate(host_numpy(counts).astype(_np.int64)
                                  .tolist()):
                if c > opt.begin_num_update:
                    opt._index_update_count[i] = int(c)
                    opt.num_update = max(opt.num_update, int(c))
        self._gluon_dirty = True
