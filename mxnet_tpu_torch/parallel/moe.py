"""Mixture-of-Experts with top-k routing over the ``ep`` axis of a rank
mesh (counterpart of ``mxnet_tpu/parallel/moe.py``).

Switch/GShard static-capacity dispatch: the token → expert routing is two
dense einsums over a one-hot ``(token, expert, slot)`` tensor, as in the
JAX package (top-k gating with the probabilities renormalised, a per-
expert capacity, the load-balance auxiliary loss). Ties in the top-k
keep the lower expert index (``jax.lax.top_k``'s order: a stable
descending sort).

**Over a mesh.** Each rank passes its tokens (``x`` split over the
mesh's data axis on dim 0 and over ``sp`` on dim 1, where the mesh has
them; replicated over ``ep_axis``) and its ``E / ep`` experts' weights
(``w1``/``w2``, rank ``i`` of the axis the ``i``-th block); ``gate_w``
is whole. The result is the JAX function on the global array, this
rank's tokens of it:

- routing is global: ``capacity`` counts every token, and a claim's slot
  is its place in the k-major order over the global token index ``s =
  b * T + t``. Each rank all-gathers the token ranks' top-k expert ids
  (a few KB), routes every token and keeps its own rows;
- ``expert_in`` of this rank's experts is the sum over the token ranks
  of their dispatched tokens (``collectives.psum``: each slot holds at
  most one token);
- the combine is this rank's experts' partial sum, then a sum over
  ``ep_axis`` (``reduce_from_axis``).

Gradient convention: each rank's loss holds its tokens' share (the
token ranks' gradients are summed, as data parallelism sums them), while
values replicated over ``ep_axis`` hold the whole gradient on every
``ep`` rank. The returned ``aux`` is the global loss on every rank; its
backward hands each rank the gradient of ``aux`` itself, so a rank adds
it once to its loss.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .collectives import (all_gather, copy_to_axis, psum,
                          reduce_from_axis)

__all__ = ["topk_route", "moe_ffn", "load_balance_loss"]


def _top_k(probs, k):
    """``jax.lax.top_k``: the ``k`` largest along the last dim, a tie
    keeping the lower index first."""
    order = torch.sort(probs, dim=-1, descending=True, stable=True).indices
    topi = order[..., :k]
    return torch.gather(probs, -1, topi), topi


def _slots(topi, E, capacity):
    """``(keep, slot)`` of every claim: ``keep`` ``(S, k, E)`` marks a
    claim inside its expert's capacity, ``slot`` ``(S, k)`` its place in
    the expert's queue (claims in k-major order: every top-1 pick before
    any top-2 pick)."""
    S, k = topi.shape
    choice = F.one_hot(topi, E)                              # (S, k, E)
    flat = choice.transpose(0, 1).reshape(k * S, E)
    pos = (torch.cumsum(flat, 0) - flat).reshape(k, S, E).transpose(0, 1)
    keep = (pos < capacity) & (choice > 0)
    return keep, (pos * choice).sum(-1), choice


def _dispatch_combine(keep, slot, topv, capacity, dtype):
    """The ``(S, E, C)`` one-hot dispatch and its gate-weighted combine
    (a dropped claim's slot index is past the capacity: its row is 0)."""
    slot1 = F.one_hot(slot.clamp(max=capacity - 1), capacity).to(dtype)
    keepf = keep.to(dtype)
    return (torch.einsum("ske,skc->sec", keepf, slot1),
            torch.einsum("ske,skc->sec", keepf * topv[..., None], slot1))


def topk_route(gate_logits, k, capacity):
    """Route each of S tokens to its top-k experts under a per-expert
    capacity. ``gate_logits`` ``(S, E)``; returns ``(dispatch, combine,
    aux)``: ``dispatch`` ``(S, E, C)`` one-hot (token s in slot c of
    expert e), ``combine`` the same weighted by the renormalised gate
    probability, ``aux`` the load-balance loss. A claim past an
    expert's capacity is dropped (combine weight 0)."""
    probs = torch.softmax(gate_logits, dim=-1)
    topv, topi = _top_k(probs, k)
    topv = topv / topv.sum(-1, keepdim=True).clamp_min(1e-9)
    keep, slot, choice = _slots(topi, probs.shape[-1], capacity)
    dispatch, combine = _dispatch_combine(keep, slot, topv, capacity,
                                          gate_logits.dtype)
    return dispatch, combine, load_balance_loss(
        probs, choice[:, 0, :].to(gate_logits.dtype))


def load_balance_loss(probs, top1_choice):
    """Switch aux loss: ``E * dot(mean gate prob, mean top-1
    assignment)``."""
    E = probs.shape[-1]
    return E * torch.sum(top1_choice.mean(0) * probs.mean(0))


def _token_axes(mesh, x):
    """The mesh axes the tokens of ``x`` are split over: the data axis on
    dim 0, ``sp`` on dim 1 (those of size > 1)."""
    from .mesh import data_axis
    axes = []
    for name, dim in ((data_axis(mesh), 0), ("sp", 1)):
        if name is not None and name in mesh.axis_names \
                and mesh.axis_size(name) > 1:
            axes.append((name, dim))
    return axes


def _experts(h, w1, w2):
    h = torch.einsum("ecd,edf->ecf", h, w1)
    return torch.einsum("ecf,efd->ecd", F.gelu(h, approximate="tanh"), w2)


def moe_ffn(x, gate_w, w1, w2, *, k=2, capacity_factor=1.25, mesh=None,
            ep_axis="ep"):
    """Top-k routed expert FFN. ``x`` ``(B, T, D)``, ``gate_w`` ``(D, E)``,
    ``w1`` ``(E, D, F)``, ``w2`` ``(E, F, D)``; returns ``(out (B, T, D),
    aux)``. With a mesh, ``x`` is this rank's tokens and ``w1``/``w2``
    its experts (the module docstring); ``out`` is this rank's tokens of
    the global result."""
    B, T, D = x.shape
    E = gate_w.shape[-1]
    tok_axes = _token_axes(mesh, x) if mesh is not None else []
    ep = mesh.axis_size(ep_axis) if mesh is not None \
        and ep_axis in mesh.axis_names else 1
    n_tok = 1
    for name, _ in tok_axes:
        n_tok *= mesh.axis_size(name)
    S = B * T * n_tok
    capacity = max(1, int(math.ceil(k * S / E * capacity_factor)))
    tokens = x.reshape(B * T, D)
    probs = torch.softmax(tokens @ gate_w, dim=-1)
    topv, topi = _top_k(probs, k)
    topv = topv / topv.sum(-1, keepdim=True).clamp_min(1e-9)
    if not tok_axes:
        glob = topi
    else:
        # every token rank's top-k ids, in the global token order
        glob = topi.reshape(B, T, k)
        for name, dim in reversed(tok_axes):
            glob = all_gather(glob.movedim(dim, 0).contiguous(), mesh,
                              name).movedim(0, dim)
        glob = glob.reshape(-1, k)
    keep, slot, choice = _slots(glob, E, capacity)
    if tok_axes:
        # this rank's tokens in the global order: its block of rows
        # (B, T) = (b, t) of the global (B * dp, T * sp) grid
        grid = [B, T]
        for name, dim in tok_axes:
            grid[dim] *= mesh.axis_size(name)
        rows = torch.arange(S, device=x.device).reshape(grid)
        for name, dim in tok_axes:
            rows = rows.narrow(dim, mesh.axis_index(name) * (B, T)[dim],
                               (B, T)[dim])
        mine = rows.reshape(-1)
        keep, slot = keep[mine], slot[mine]
    dt = x.dtype
    dispatch, combine = _dispatch_combine(keep, slot, topv, capacity, dt)
    # the Switch aux loss over all S tokens: this rank's share of the
    # mean gate probability, summed over the token ranks
    top1 = choice[:, 0, :].to(dt)
    if tok_axes:
        proxy = reduce_from_axis(probs.sum(0) / S, mesh,
                                 tuple(n for n, _ in tok_axes))
        aux = E * torch.sum(top1.mean(0) * proxy)
    else:
        aux = load_balance_loss(probs, top1)
    if ep > 1:
        per = E // ep
        lo = mesh.axis_index(ep_axis) * per
        dispatch = dispatch[:, lo:lo + per]
        combine = copy_to_axis(combine, mesh, ep_axis)[:, lo:lo + per]
        tokens = copy_to_axis(tokens, mesh, ep_axis)
    expert_in = torch.einsum("sec,sd->ecd", dispatch, tokens)
    if tok_axes:
        expert_in = psum(expert_in, mesh, tuple(n for n, _ in tok_axes))
    expert_out = _experts(expert_in, w1, w2)
    out = torch.einsum("sec,ecd->sd", combine, expert_out)
    if ep > 1:
        out = reduce_from_axis(out, mesh, ep_axis)
    return out.reshape(B, T, D), aux

