"""Sequence parallelism over the ``sp`` axis of a rank mesh: ring
attention and Ulysses (counterpart of ``mxnet_tpu/parallel/
ring_attention.py``).

Each rank holds its ``T / sp`` slice of the sequence, ``(B, T/sp, H,
D)``, rank ``i`` of the axis the ``i``-th slice; each function returns
this rank's slice of the attention output.

- :func:`ring_attention` — blockwise attention with the flash-style
  stable merge; the K/V slice rotates around the axis (``sp - 1``
  ``ppermute`` hops), so each rank streams every key past its queries.
  The block math is plain torch (``_block_attn``/``_merge_blocks``), as
  the JAX package's is ``jnp``: it launches none of the flash kernels.
- :func:`ulysses_attention` — an all-to-all scatters the heads and
  gathers the sequence, so each rank holds the WHOLE sequence for
  ``H / sp`` heads; :func:`local_attention` (the flash kernels on a CUDA
  tensor) runs there; a second all-to-all returns the slices.

Both are differentiable: the collectives are ``collectives``' autograd
forms, whose backward is the inverse collective (a ``ppermute`` along
the reversed pairs; the all-to-all with split and concat swapped).
Without a mesh, or on a mesh without ``axis``, both run
:func:`local_attention`.
"""
from __future__ import annotations

import math

import torch

from .collectives import all_to_all_grad, ppermute_grad

__all__ = ["ring_attention", "ulysses_attention", "local_attention"]


def _block_attn(q, k, v, scale, mask=None):
    """One attention block: ``(out_unnormalized, row_max, row_sum)``;
    q ``(B, Tq, H, D)``, k/v ``(B, Tk, H, D)``, scores ``(B, H, Tq, Tk)``."""
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if mask is not None:
        s = torch.where(mask, s, torch.full_like(s, -1e30))
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    if mask is not None:
        # rows with no valid key: exp(-1e30 + 1e30) = 1 is junk
        any_valid = mask.any(dim=-1)
        p = torch.where(any_valid[..., None], p, torch.zeros_like(p))
        m = torch.where(any_valid, m, torch.full_like(m, -1e30))
    l = p.sum(dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p, v)
    return o, m, l


def _merge_blocks(o1, m1, l1, o2, m2, l2):
    """Combine two softmax partials with stable rescaling."""
    m = torch.maximum(m1, m2)
    a1 = torch.exp(m1 - m)
    a2 = torch.exp(m2 - m)
    l = l1 * a1 + l2 * a2
    o = o1 * a1.transpose(1, 2)[..., None] + o2 * a2.transpose(1, 2)[..., None]
    return o, m, l


def local_attention(q, k, v, causal=False, scale=None):
    """Attention over whole (unsharded) ``(B, T, H, D)`` inputs: the
    port's ``flash_attention`` (the kernels on a CUDA tensor, which
    launch or raise; the plain version on a CPU tensor)."""
    from .flash_attention import flash_attention
    return flash_attention(q, k, v, causal=causal, scale=scale)


def _sp_size(mesh, axis):
    if mesh is None or axis not in getattr(mesh, "axis_names", ()):
        return 1
    return mesh.axis_size(axis)


def ring_attention(q, k, v, mesh=None, axis="sp", causal=False, scale=None):
    """Ring attention over this rank's sequence slice ``(B, T/sp, H,
    D)`` of q/k/v; returns this rank's slice of the output."""
    sp = _sp_size(mesh, axis)
    if sp == 1:
        return local_attention(q, k, v, causal=causal, scale=scale)
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    my = mesh.axis_index(axis)
    Tl = q.shape[1]
    q_pos = my * Tl + torch.arange(Tl, device=q.device)

    def mask_for(block):
        if not causal:
            return None
        k_pos = block * Tl + torch.arange(Tl, device=q.device)
        return (q_pos[:, None] >= k_pos[None, :])[None, None]

    o, m, l = _block_attn(q, k, v, scale, mask_for(my))
    perm = [(i, (i + 1) % sp) for i in range(sp)]
    kv = torch.stack([k, v])
    for step in range(1, sp):
        kv = ppermute_grad(kv, mesh, axis, perm)
        src = (my - step) % sp            # the owner of the K/V block held
        ob, mb, lb = _block_attn(q, kv[0], kv[1], scale, mask_for(src))
        o, m, l = _merge_blocks(o, m, l, ob, mb, lb)
    return o / torch.clamp_min(l.transpose(1, 2)[..., None], 1e-30)


def ulysses_attention(q, k, v, mesh=None, axis="sp", causal=False,
                      scale=None):
    """Ulysses (DeepSpeed) sequence parallelism over this rank's slice
    ``(B, T/sp, H, D)``: all-to-all to ``(B, T, H/sp, D)``, local
    attention, all-to-all back. ``H`` must divide by ``sp``."""
    sp = _sp_size(mesh, axis)
    if sp == 1:
        return local_attention(q, k, v, causal=causal, scale=scale)
    H = q.shape[2]
    if H % sp:
        raise ValueError("ulysses_attention: num heads %d must divide "
                         "sp=%d" % (H, sp))
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    # one exchange for q, k and v: (3, B, T/sp, H, D) -> (3, B, T, H/sp, D)
    qkv = all_to_all_grad(torch.stack([q, k, v]), mesh, axis, 3, 2)
    out = local_attention(qkv[0].contiguous(), qkv[1].contiguous(),
                          qkv[2].contiguous(), causal=causal, scale=scale)
    return all_to_all_grad(out, mesh, axis, 1, 2)
