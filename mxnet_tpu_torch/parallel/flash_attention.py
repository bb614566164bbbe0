"""Fused (flash) attention for the serving path: hand-written CUDA
kernels for Hopper (counterpart of ``mxnet_tpu/parallel/flash_attention.py``).

Two public functions keep the JAX package's signatures and its
``(B, T, H, D)`` layout:

- :func:`flash_attention` — prefill attention (causal, optionally
  segment-blocked for packed batches); on a CUDA tensor it launches
  ``csrc/flash_fwd.cu``, the counterpart of the TPU ``_fwd_kernel``;
- :func:`flash_decode` — one query row per sequence against a gathered
  KV cache with per-row valid lengths; on a CUDA tensor it launches
  ``csrc/flash_decode.cu``, the counterpart of ``_decode_kernel``.

On a CPU tensor each runs its plain PyTorch version
(:func:`_torch_reference` / :func:`_torch_decode`), which mirrors the
JAX package's ``_jnp_reference`` / ``_jnp_decode`` exactly: masked
scores are ``-1e30`` (an exact-zero softmax weight), the denominator is
floored at ``1e-30``, segment id 0 attends to nothing, and int8 K/V with
scales are dequantized up front. ``impl="plain"`` takes the plain
version on any device; it exists for the tests and ``chip_smoke.py``,
which hold each kernel against it on the card. On a CUDA tensor the
wrappers launch the kernel or raise: there is no fallback.

The int8 in-kernel-dequantizing decode kernel (``_decode_kernel_q8``)
and the backward kernels are not ported yet: ``flash_decode`` with
``k_scale``/``v_scale`` on a CUDA tensor raises NotImplementedError.

Each wrapper counts its kernel launches in :data:`launches`.
"""
from __future__ import annotations

import math

import torch

from ..base import MXNetError

__all__ = ["flash_attention", "flash_decode", "launches",
           "reset_launches"]

_NEG = -1e30

# kernel name -> launches since the last reset_launches()
launches = {"flash_fwd": 0, "flash_decode": 0}


def reset_launches():
    """Set every launch count to 0."""
    for name in launches:
        launches[name] = 0


def _torch_reference(q, k, v, scale, causal, segment_ids=None):
    """The plain prefill attention: ``_jnp_reference`` in torch."""
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if causal:
        Tq, Tk = q.shape[1], k.shape[1]
        mask = torch.tril(torch.ones((Tq, Tk), dtype=torch.bool,
                                     device=q.device))
        s = torch.where(mask[None, None], s, _NEG)
    if segment_ids is not None:
        # a position attends only inside its own segment; padding (id
        # 0) attends to nothing
        seg = torch.as_tensor(segment_ids, device=q.device)
        allowed = (seg[:, :, None] == seg[:, None, :]) \
            & (seg[:, :, None] > 0)
        s = torch.where(allowed[:, None], s, _NEG)
    p = torch.exp(s - torch.amax(s, dim=-1, keepdim=True)).to(q.dtype)
    p = p / torch.clamp_min(torch.sum(p, dim=-1, keepdim=True), 1e-30)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


def _torch_decode(q, k, v, lengths, scale):
    """The plain decode attention: ``_jnp_decode`` in torch. Key ``i``
    of row ``b`` is live iff ``i < lengths[b]``."""
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    T = k.shape[1]
    lens = torch.as_tensor(lengths, device=q.device).to(torch.int32)
    live = torch.arange(T, dtype=torch.int32,
                        device=q.device)[None, :] < lens[:, None]
    s = torch.where(live[:, None, None, :], s, _NEG)
    p = torch.exp(s - torch.amax(s, dim=-1, keepdim=True)).to(q.dtype)
    p = p / torch.clamp_min(torch.sum(p, dim=-1, keepdim=True), 1e-30)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


def _use_kernel(x, impl):
    """True for the kernel route, False for the plain version."""
    if impl == "plain":
        return False
    if impl is not None:
        raise ValueError("impl must be None or 'plain', got %r" % (impl,))
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise MXNetError("no attention kernel for device %s" % x.device)


def _check_cuda(name, dev, **tensors):
    for key, t in tensors.items():
        if t.device != dev:
            raise MXNetError("%s: %s is on %s, q on %s"
                             % (name, key, t.device, dev))
        if t.dtype != torch.float32:
            raise MXNetError("%s: the kernel takes float32, %s is %s"
                             % (name, key, t.dtype))


def _raise_on(rc, name):
    if rc != 0:
        raise MXNetError("%s: kernel launch failed with cudaError %d"
                         % (name, rc))


def _fwd_cuda(q, k, v, seg, scale, causal):
    """Launch ``flash_fwd.cu``: returns ``(o (B, Tq, H, D), lse (B, H,
    Tq) float32)``."""
    from . import _build
    _check_cuda("flash_attention", q.device, q=q, k=k, v=v)
    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    if D > 128:
        raise MXNetError("flash_attention: the kernel takes head_dim "
                         "<= 128, got %d" % D)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if seg is not None:
        seg = torch.as_tensor(seg, device=q.device).to(
            torch.int32).contiguous()
        if tuple(seg.shape) != (B, Tq):
            raise ValueError("flash_attention: segment_ids shape %s, "
                             "want %s" % (tuple(seg.shape), (B, Tq)))
    o = torch.empty_like(q)
    lse = torch.empty((B, H, Tq), dtype=torch.float32, device=q.device)
    if o.numel() == 0:
        return o, lse
    fn = _build.library("flash_fwd")
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                None if seg is None else seg.data_ptr(),
                o.data_ptr(), lse.data_ptr(), B, H, Tq, Tk, D,
                float(scale), int(bool(causal)),
                torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(rc, "flash_fwd")
    launches["flash_fwd"] += 1
    return o, lse


def _decode_cuda(q, k, v, lengths, scale):
    """Launch ``flash_decode.cu``: returns ``(B, 1, H, D)``."""
    from . import _build
    _check_cuda("flash_decode", q.device, q=q, k=k, v=v)
    B, _, H, D = q.shape
    T = k.shape[1]
    if D > 128:
        raise MXNetError("flash_decode: the kernel takes head_dim "
                         "<= 128, got %d" % D)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    lens = torch.as_tensor(lengths, device=q.device).to(
        torch.int32).contiguous()
    if tuple(lens.shape) != (B,):
        raise ValueError("flash_decode: lengths shape %s, want (%d,)"
                         % (tuple(lens.shape), B))
    o = torch.empty_like(q)
    if o.numel() == 0:
        return o
    fn = _build.library("flash_decode")
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), lens.data_ptr(),
                o.data_ptr(), B, H, T, D, float(scale),
                torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(rc, "flash_decode")
    launches["flash_decode"] += 1
    return o


def flash_decode(q, k, v, lengths, scale=None, k_scale=None,
                 v_scale=None, impl=None):
    """One autoregressive decode step of attention: a single cached-KV
    query per sequence.

    - ``q``: ``(B, 1, H, D)`` — the new token's query;
    - ``k``/``v``: ``(B, T, H, D)`` — the KV cache gathered to a fixed
      length ``T``, including the new token's own key/value already
      written at its position;
    - ``lengths``: ``(B,)`` int — per-row valid key count (the new
      token's position + 1); positions at or beyond a row's length get
      exact-zero weight, so the cache's garbage tail never leaks in.

    **Quantized caches**: int8 ``k``/``v`` plus ``k_scale``/``v_scale``
    (``(B, T)`` float32 per-position scales) are dequantized up front on
    the plain path; on a CUDA tensor this raises NotImplementedError
    until the in-kernel dequantizing kernel is ported."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if q.shape[1] != 1:
        raise ValueError(
            "flash_decode: expected a single query position, got "
            "q length %d" % q.shape[1])
    quant = k_scale is not None or v_scale is not None
    if quant and (k_scale is None or v_scale is None):
        raise ValueError(
            "flash_decode: quantized caches need BOTH k_scale and "
            "v_scale (B, T)")
    kernel = _use_kernel(q, impl)
    if quant:
        if kernel:
            raise NotImplementedError(
                "flash_decode: the int8 decode kernel (the TPU's "
                "_decode_kernel_q8) is not ported yet — dequantize the "
                "cache first, as the decode server does")
        k = k.to(torch.float32) * torch.as_tensor(
            k_scale, device=k.device).to(torch.float32)[:, :, None, None]
        v = v.to(torch.float32) * torch.as_tensor(
            v_scale, device=v.device).to(torch.float32)[:, :, None, None]
    if kernel:
        return _decode_cuda(q, k, v, lengths, scale)
    return _torch_decode(q, k.to(q.dtype), v.to(q.dtype), lengths, scale)


def flash_attention(q, k, v, causal=False, scale=None, segment_ids=None,
                    impl=None):
    """Attention over ``(B, T, H, D)`` tensors, for ANY sequence length.

    ``segment_ids`` (``(B, T)`` int, 1-based per sample, 0 = pad) turns
    on segment-blocked attention for PACKED batches: a position attends
    only within its own segment, cross-segment softmax weights are exact
    zeros, and padding attends to nothing — its rows hold values a
    masked loss must ignore (the kernel and the plain version may differ
    there)."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if segment_ids is not None and q.shape[1] != k.shape[1]:
        raise ValueError(
            "flash_attention: segment_ids requires self-attention "
            "(q and k sequence lengths %d vs %d differ)"
            % (q.shape[1], k.shape[1]))
    if _use_kernel(q, impl):
        return _fwd_cuda(q, k, v, segment_ids, scale, causal)[0]
    return _torch_reference(q, k, v, scale, causal,
                            segment_ids=segment_ids)
