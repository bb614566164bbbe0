"""Pipeline parallelism over the ``pp`` axis of a rank mesh (counterpart
of ``mxnet_tpu/parallel/pipeline.py``).

A GPipe schedule: rank ``p`` of the axis is stage ``p`` and holds that
stage's parameters; the microbatches flow stage to stage by the autograd
``ppermute`` (``collectives.ppermute_grad``). The JAX package runs the
schedule as one ``lax.scan`` inside ``shard_map``; here every rank runs
the same ``n_micro + n_stages - 1`` ticks eagerly:

- stage 0 takes microbatch ``i`` at tick ``i``, every other stage its
  left neighbour's output of the tick before;
- the last stage keeps its output of tick ``i`` as microbatch ``i - (n_
  stages - 1)``'s result;
- a masked sum over ``pp`` (``reduce_from_axis``) hands the results to
  every stage.

Every rank builds the same autograd graph (the stage choices are
``torch.where`` masks, not branches), so the ``ppermute`` pairs meet in
the same order on every rank, forward and backward, and cannot deadlock.
The microbatch stack enters through ``copy_to_axis``: only stage 0 reads
it, and its gradient is summed over the stages, so a computation before
the pipeline gets the same gradient on every stage.
"""
from __future__ import annotations

import torch

from .collectives import copy_to_axis, ppermute_grad, reduce_from_axis

__all__ = ["pipeline_apply", "stack_stage_params"]


def _tree_map(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, t, *(r[i] for r in rest))
                          for i, t in enumerate(tree))
    return fn(tree, *rest)


def stack_stage_params(per_stage_params):
    """Stack a list of per-stage parameter trees (tensors in tuples,
    lists or dicts) into one tree whose leaves gain a leading stage
    dimension."""
    first = per_stage_params[0]
    return _tree_map(lambda *leaves: torch.stack(leaves, dim=0), first,
                     *per_stage_params[1:])


def _stages(mesh, axis):
    if mesh is None or axis not in mesh.axis_names:
        return 1
    return mesh.axis_size(axis)


def pipeline_apply(stage_fn, stacked_params, microbatches, *, mesh,
                   axis="pp", mb_spec=None):
    """Run ``microbatches`` ``(n_micro, mb, ...)`` through the chain of
    stages; returns the ``(n_micro, mb, ...)`` outputs on every stage.

    ``stage_fn(params_one_stage, x) -> y`` keeps ``x``'s shape.
    ``stacked_params`` is a tree of tensors whose leading dim is the
    stage: either the whole stack (``n_stages``; this rank takes its
    stage's entry) or this rank's ``(1, ...)`` piece. ``microbatches``
    is this rank's piece of the stack (the same on every stage; other
    dims may be split over other axes, ``mb_spec`` is accepted for the
    JAX signature). Differentiable through torch autograd: the backward
    runs the ticks in reverse."""
    n_stages = _stages(mesh, axis)
    n_micro = int(microbatches.shape[0])
    if n_micro < n_stages:
        raise ValueError(
            "pipeline_apply needs n_micro >= n_stages for a full "
            "schedule; got %d microbatches for %d stages"
            % (n_micro, n_stages))
    stage = mesh.axis_index(axis) if n_stages > 1 else 0

    def mine(w):
        if w.shape[0] == n_stages:
            return w[stage]
        if w.shape[0] == 1:
            return w[0]
        raise ValueError("pipeline_apply: a stage parameter's leading dim "
                         "is %d, neither the %d stages nor this rank's 1"
                         % (w.shape[0], n_stages))
    params = _tree_map(mine, stacked_params)
    if n_stages == 1:
        return torch.stack([stage_fn(params, microbatches[i])
                            for i in range(n_micro)])
    mbs = copy_to_axis(microbatches, mesh, axis)
    first = torch.tensor(stage == 0, device=mbs.device)
    last = torch.tensor(stage == n_stages - 1, device=mbs.device)
    ring = [(j, (j + 1) % n_stages) for j in range(n_stages)]
    state = torch.zeros_like(mbs[0])
    outs = [None] * n_micro
    ticks = n_micro + n_stages - 1
    for i in range(ticks):
        x = torch.where(first, mbs[min(i, n_micro - 1)], state)
        y = stage_fn(params, x)
        out_i = i - (n_stages - 1)
        if out_i >= 0:
            outs[out_i] = torch.where(last, y, torch.zeros_like(y))
        if i + 1 < ticks:
            state = ppermute_grad(y, mesh, axis, ring)
    return reduce_from_axis(torch.stack(outs), mesh, axis)
