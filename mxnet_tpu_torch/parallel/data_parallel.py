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
  batch's.
- **Sequence parallelism.** On a mesh with an ``sp`` axis each rank also
  takes its ``sp`` slice of dim 1 of the data and the labels (per-token
  labels, ``(B, T, ...)``); the net runs under the mesh, so the
  attention op's ``auto`` route is ring attention over ``sp`` and
  ``contrib.arange_like`` along dim 1 gives the global positions. The
  gradients are summed over ``sp`` and then exchanged over ``dp``; the
  loss is each rank's token sum over the global count. FSDP and ZeRO-1
  stay over ``dp``.
- **Tensor-parallel placement.** With ``param_shard`` and a ``tp`` axis
  larger than 1, the rules lay a projection weight out as a 2-D shard
  ``P(dp, tp)`` (the JAX package's placement): each rank keeps its
  piece at rest, with its optimizer state beside it, gathers the whole
  weights over both axes at step entry and updates its piece from the
  gradient summed over ``dp``. The ``tp`` ranks repeat the ``dp``
  work, as the JAX trainer's numbers are the global ones.
- Checkpoints go through ``checkpoint.py``'s manifest, every rank
  writing its pieces: elastic across mesh sizes, and across the
  packages (a JAX 8-device save loads on 2 ranks, and back). The 2-D
  pieces and their optimizer state are spanning arrays there, each
  piece under its global index (``opt:2d:<name>.slotS``).
- :meth:`DistributedTrainer.fit_batch` calls ``multihost.step_boundary``
  once a step: the ``proc_exit`` fault site and a detected host loss.
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


def _sp_size(mesh):
    return mesh.axis_size("sp") if "sp" in mesh.axis_names else 1


def _local_piece(value, mesh, need_seq=False, what="an input"):
    """This rank's ``dp`` rows of a batch array and, on a mesh with
    ``sp`` > 1, its ``sp`` slice of dim 1 (an array placed already keeps
    its rows; a 1-D one stays whole along the sequence, or raises with
    ``need_seq``)."""
    local = _local_rows(value, mesh)
    if isinstance(value, ShardedTensor) or _sp_size(mesh) == 1:
        return local
    if local.dim() < 2:
        if need_seq:
            raise MXNetError(
                "%s of shape %s has no sequence dim to split over the "
                "mesh's 'sp' axis: a sequence-parallel step takes per-"
                "token data and labels, (B, T, ...)"
                % (what, tuple(local.shape)))
        return local
    return NamedSharding(mesh, P(None, "sp")).shard(local)


def _sum_over(tensors, mesh, axes):
    """Each tensor summed over the mesh ``axes`` of size > 1."""
    from .collectives import all_reduce
    for a in axes:
        if a in mesh.axis_names and mesh.axis_size(a) > 1:
            tensors = [all_reduce(t, mesh, a) for t in tensors]
    return tensors


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
    mean; the returned loss is the global mean. On a mesh with ``sp`` >
    1 each rank also takes its ``sp`` slice of dim 1 of every array of
    two or more dims, runs ``loss_fn`` under the mesh (ring attention
    for the attention op) and the slices' gradients are summed too: the
    loss must then be a mean over the tokens it is given. ``optimizer_update(p, g)
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
    n_sp = _sp_size(mesh)
    batch_sharding = NamedSharding(mesh, P("dp", "sp") if n_sp > 1
                                   else P("dp"))
    n_dp = mesh.axis_size("dp")

    def update(g, w, states, lr, wd, rescale):
        return optimizer_update(w, g), ()

    def step(params, batch):
        names = list(params)
        whole = [_whole(params[n]).detach() for n in names]
        local = {k: _local_piece(v, mesh) for k, v in batch.items()}
        weight = 1.0 / float(n_dp * n_sp)
        leaves = [w.clone().requires_grad_(True) for w in whole]
        with use_mesh(mesh):
            loss = loss_fn(dict(zip(names, leaves)), local)
        grads = torch.autograd.grad(loss * weight, leaves,
                                    materialize_grads=True)
        with torch.no_grad():
            grads = _sum_over(grads, mesh, ("sp",))
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
            total, = _sum_over([loss.detach() * weight], mesh, ("dp", "sp"))
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


class _Shard2D:
    """The trainer's storage, update and optimizer state with ``param_
    shard`` on a live ``tp`` axis: each parameter at rest as its piece
    of the rules' spec (``P(dp, tp)`` for a projection weight, whole for
    a replicated one), the optimizer state beside it in the same layout
    (flat, ``n_slots`` vectors a parameter). The update sums the
    gradient over ``dp`` (the ``tp`` ranks computed the same one), cuts
    this rank's piece and runs the parameter's fused rule on it."""

    sharded = True

    def __init__(self, plans, mesh, step_fns, optimizer, weights_nd):
        from ..fused_step import _flat_state_handles
        self.plans, self.mesh, self.step_fns = plans, mesh, step_fns
        self.shardings = [pl.sharding(mesh) for pl in plans]
        flat = _flat_state_handles(optimizer.create_state_multi_precision(
            0, weights_nd[0])) if weights_nd else []
        self.slot_dtypes = [h._data.dtype for h in flat or []]
        self.n_slots = len(self.slot_dtypes)
        self._states = None
        self.sync_seconds = []

    def at_rest(self, whole):
        return [sh.shard(pl.pad(w)).clone() if pl.sharded else w.clone()
                for pl, sh, w in zip(self.plans, self.shardings, whole)]

    def whole(self, pieces):
        """Every parameter's logical value (sharded ones gathered over
        their axes)."""
        return [pl.logical(ShardedTensor(v, pl.padded_shape, sh).full())
                if pl.sharded else v
                for pl, sh, v in zip(self.plans, self.shardings, pieces)]

    def ensure(self, pieces=None):
        """The flat state tuple, zeros beside ``pieces`` on first use."""
        if self._states is None:
            self._piece_shapes = [tuple(v.shape) for v in pieces]
            self._device = pieces[0].device if pieces else None
            self._states = tuple(
                torch.zeros(v.numel(), dtype=dt, device=v.device)
                for v in pieces for dt in self.slot_dtypes)
        return self._states

    def store(self, states):
        self._states = tuple(states)

    def state_bytes_per_device(self):
        return sum(t.numel() * t.element_size() for t in self._states or ())

    def _key(self, pos, slot):
        return "opt:2d:%s.slot%d" % (self.plans[pos].name, slot)

    def checkpoint_roster(self):
        """``{'opt:2d:<name>.slotS': ...}`` for the manifest writer: each
        sharded parameter's state slot as a spanning array of the
        parameter's padded shape whose pieces are the ranks' (the
        manifest records each piece's global index), a replicated one's
        whole."""
        out = {}
        if self._states is None:
            return out
        k = self.n_slots
        for pos, (pl, sh) in enumerate(zip(self.plans, self.shardings)):
            for slot in range(k):
                st = self._states[pos * k + slot].view(
                    self._piece_shapes[pos])
                out[self._key(pos, slot)] = ShardedTensor(
                    st, pl.padded_shape, sh) if pl.sharded else st
        return out

    def load_host_flats(self, flat):
        """Restore from a checkpoint's ``opt:2d:`` host arrays, saved on
        any mesh: each cut to the parameter's logical shape, re-padded and
        re-cut for this rank's piece. Checks every entry before it changes
        anything."""
        k, new = self.n_slots, []
        for pos, (pl, sh) in enumerate(zip(self.plans, self.shardings)):
            for slot in range(k):
                key = self._key(pos, slot)
                if key not in flat:
                    raise MXNetError("2-D sharded optimizer state: the "
                                     "checkpoint is missing %s" % key)
                host = _np.asarray(flat[key])
                if host.ndim != len(pl.shape) or any(
                        h < d for h, d in zip(host.shape, pl.shape)):
                    raise MXNetError(
                        "2-D sharded optimizer state: %s has shape %s, the "
                        "parameter %s" % (key, host.shape, pl.shape))
                t = torch.from_numpy(_np.ascontiguousarray(
                    host[tuple(slice(0, d) for d in pl.shape)])).to(
                        self.slot_dtypes[slot])
                if pl.sharded:
                    t = sh.shard(pl.pad(t))
                new.append(t.reshape(-1).to(self._device).clone())
        self._states = tuple(new)

    def __call__(self, grads, pieces, states, scalars):
        """``(new_pieces, new_states)`` from this rank's gradient
        contributions (``sync_seconds``: the exchange's time)."""
        n, k = len(self.plans), self.n_slots
        t0 = time.perf_counter()
        grads = _sum_over(list(grads), self.mesh, ("dp",))
        self.sync_seconds = [time.perf_counter() - t0]
        new_ws, new_sts = [], []
        for i, (pl, sh, g, w) in enumerate(zip(self.plans, self.shardings,
                                               grads, pieces)):
            if pl.sharded:
                g = sh.shard(pl.pad(g))
            fn = self.step_fns[i]
            sdt = getattr(fn, "scalar_dtype", None) or g.dtype
            m = w.numel()
            nw, nst = fn(g.reshape(-1), w.reshape(-1),
                         tuple(states[i * k:(i + 1) * k]),
                         scalars[i].to(sdt).expand(m),
                         scalars[n + i].to(sdt).expand(m),
                         scalars[2 * n].to(sdt))
            new_ws.append(nw.view(w.shape))
            new_sts.extend(nst)
        return new_ws, new_sts


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
    trainer of the port is multi-process. On a mesh with ``sp`` > 1 each
    rank takes its slice of the sequence (the module docstring); with
    ``param_shard`` on a ``tp`` axis larger than 1 the parameters rest
    as the rules' 2-D shards (:class:`_Shard2D`)."""

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
        self._overlap = grad_overlap
        self._bucket_mb = bucket_mb
        self._param_rules = param_rules
        self._param_shard = param_shard
        self._param_plans = None
        self._shard2d = None
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
        self._shard2d = None
        if plans is not None and "tp" in mesh.axis_names \
                and mesh.axis_size("tp") > 1:
            self._shard2d = _Shard2D(plans, mesh, step_fns, self._opt,
                                     weights_nd)
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
        if self._shard2d is not None:
            sync_state = self._shard2d
            self._state_vals = list(sync_state.ensure(self._param_vals))
            self._apply = sync_state
        else:
            sync_state = grad_sync.ShardedOptState(plan, mesh, "dp",
                                                   sharded=overlap)
            if not sync_state.probe(self._opt, indices, weights_nd):
                raise MXNetError(
                    "DistributedTrainer: optimizer %s state layout has no "
                    "sharded path" % type(self._opt).__name__)
            self._state_vals = list(sync_state.ensure())
            self._apply = grad_sync.make_bucketed_apply(
                step_fns, sync_state.n_slots, plan, mesh, "dp",
                shard_state=overlap, gather_params=plans is None)
        self._plan, self._sync_state = plan, sync_state
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
        if self._shard2d is not None:
            return self._shard2d.at_rest(whole)
        index = self._mesh.axis_index("dp") if plan.axis_size > 1 else 0
        return grad_sync.bucket_slices(plan, whole, index)

    def _whole_params(self):
        """Every parameter's value (with FSDP, the entry gather)."""
        from . import grad_sync
        if self._param_plans is None:
            return list(self._param_vals)
        if self._shard2d is not None:
            return self._shard2d.whole(self._param_vals)
        return grad_sync.gather_bucket_slices(
            self._plan, self._param_vals, self._shapes, self._mesh, "dp")

    # -- the step ---------------------------------------------------------
    def _step(self, data_v, label_v, scalars):
        from .mesh import use_mesh
        fn, arg_names, aux_names, n_out = self._graph
        n_dp = self._mesh.axis_size("dp")
        # a row's loss is its mean over this rank's tokens
        n_rows = float(data_v.shape[0] * n_dp * _sp_size(self._mesh))
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
        with torch.no_grad():
            grads = _sum_over(list(grads), self._mesh, ("sp",))
        new_aux = [a.detach() for a in outs[n_out:n_out
                                            + len(self._aux_roster)]]
        with torch.no_grad():
            # the 2-D shards update this rank's pieces in place of the
            # whole weights
            held = self._param_vals if self._shard2d is not None \
                else [w.detach() for w in whole]
            new_ws, new_sts = self._apply(grads, held, self._state_vals,
                                          scalars)
            loss, = _sum_over([loss.detach()], self._mesh, ("dp", "sp"))
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
        from . import multihost
        # the proc_exit fault site ("this host dies at exactly step N")
        # and the typed surfacing of a peer loss the heartbeat detected
        multihost.step_boundary()
        data_v = _local_piece(data, self._mesh, True, "the data")
        label_v = _local_piece(label, self._mesh, True, "the label")
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
        if self._sync_state.sharded and self._shard2d is None:
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
        sizes = [v.numel() * v.element_size()
                 for v in self._param_vals or []]
        if self._shard2d is not None:
            sharded = sum(b for b, pl in zip(sizes, self._param_plans)
                          if pl.sharded)
            replicated = sum(sizes) - sharded
        elif self._param_plans is not None:
            sharded, replicated = sum(sizes), 0
        else:
            sharded, replicated = 0, sum(sizes)
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
        # every rank calls: the rank-mesh save even when nothing is
        # sharded (rank 0 writes the whole entries and the manifest)
        ckpt.save_arrays(prefix, epoch,
                         ckpt.snapshot_params(arg, aux, extra=extra),
                         every_rank=True)

    def load_checkpoint(self, prefix, epoch, validate=True):
        """Elastic resume from a manifest checkpoint (any mesh size, either
        package): parameters re-placed by the current plans, the sharded
        optimizer state re-padded for the current axis. Before the first
        fit_batch the payload waits for the build."""
        from .. import checkpoint as ckpt
        from ..context import cpu
        # on the host: the restore places each value where it lives
        flat = {k: v._data for k, v in
                ckpt.load_arrays(prefix, epoch, validate=validate,
                                 ctx=cpu()).items()}
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
