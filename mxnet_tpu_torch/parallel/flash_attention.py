"""Fused (flash) attention: hand-written CUDA kernels for Hopper
(counterpart of ``mxnet_tpu/parallel/flash_attention.py``).

Two public functions keep the JAX package's signatures and its
``(B, T, H, D)`` layout:

- :func:`flash_attention` — attention for prefill and training (causal,
  optionally segment-blocked for packed batches); on a CUDA tensor it
  runs :class:`_Flash`, a ``torch.autograd.Function`` (the counterpart
  of the JAX ``custom_vjp``) whose forward launches ``csrc/flash_fwd.cu``
  (the TPU ``_fwd_kernel``) and whose backward launches
  ``csrc/flash_bwd_dkdv.cu`` and ``csrc/flash_bwd_dq.cu``
  (``_bwd_dkdv_kernel`` and ``_bwd_dq_kernel``), recomputing the
  probabilities from the forward's row LSE;
- :func:`flash_decode` — one query row per sequence against a gathered
  KV cache with per-row valid lengths; on a CUDA tensor it launches
  ``csrc/flash_decode.cu``, the counterpart of ``_decode_kernel``, or,
  for an int8 cache with per-position scales, ``csrc/flash_decode_q8.cu``,
  the counterpart of ``_decode_kernel_q8``, which dequantizes K and V
  while it stages them.

On a CPU tensor each runs its plain PyTorch version
(:func:`_torch_reference` / :func:`_torch_decode` /
:func:`_torch_decode_q8`), which mirrors the
JAX package's ``_jnp_reference`` / ``_jnp_decode`` exactly: masked
scores are ``-1e30`` (an exact-zero softmax weight), the denominator is
floored at ``1e-30``, segment id 0 attends to nothing, and int8 K/V with
scales are dequantized up front. ``impl="plain"`` takes the plain
version on any device; it exists for the tests and ``chip_smoke.py``,
which hold each kernel against it on the card. On a CUDA tensor the
wrappers launch the kernel or raise: there is no fallback.

bfloat16 (or float16) q/k/v/dO keep the JAX kernels' contract: float32
inside, outputs and gradients in the input dtype, the LSE and ``D =
rowsum(dO * O)`` in float32 (``D`` from the rounded output). The
wrappers upcast to float32, launch the same kernels (counted as
usual) and cast the results back; the plain versions upcast the same
way. Kernels that load bfloat16 natively are ROADMAP queue B work.

Each backward kernel has its plain version too (:func:`_torch_bwd_dkdv`,
:func:`_torch_bwd_dq`): the same LSE-recompute arithmetic in PyTorch.
``_Flash`` runs with them when it is applied with ``kernel=False``,
which is how the CPU tests reach the LSE-recompute backward. A masked
(q, k) pair gets an exact-zero probability in the backward, so a row
that attends to nothing (segment id 0) contributes no gradient; the
JAX kernels give such rows weights that depend on the tiling, so the
two agree where a masked loss puts a zero cotangent on those rows.

Each wrapper counts its kernel launches in :data:`launches`. A CUDA
graph capture enqueues kernels and runs none: inside
:func:`recording_launches` the calling thread's counts go to the block's
own dict instead, and a graph replay adds them back with
:func:`add_launches`. Inside :func:`counting_work` each launch also adds
its flops and bytes (the formulas of ``PERF.md`` §6's bound column) to
the block's dict: the compile watch costs a program once that way, the
kernels being invisible to torch's flop counter.
"""
from __future__ import annotations

import contextlib
import math
import threading

import torch

from ..base import MXNetError

__all__ = ["flash_attention", "flash_decode", "launches",
           "reset_launches", "recording_launches", "add_launches",
           "counting_work"]

_NEG = -1e30

# kernel name -> launches since the last reset_launches()
launches = {"flash_fwd": 0, "flash_decode": 0, "flash_decode_q8": 0,
            "flash_bwd_dkdv": 0, "flash_bwd_dq": 0}


# the dict a capture on this thread counts into (recording_launches)
_held = threading.local()


def reset_launches():
    """Set every launch count to 0."""
    for name in launches:
        launches[name] = 0


def _count(name):
    sink = getattr(_held, "counts", None)
    (launches if sink is None else sink)[name] += 1


@contextlib.contextmanager
def recording_launches():
    """Inside the block, this thread's launches count into the yielded
    dict, not :data:`launches` (other threads count as usual): what a
    CUDA graph captured inside holds, for :func:`add_launches` at each
    replay."""
    counts = dict.fromkeys(launches, 0)
    outer = getattr(_held, "counts", None)
    _held.counts = counts
    try:
        yield counts
    finally:
        _held.counts = outer


@contextlib.contextmanager
def counting_work():
    """Inside the block, this thread's kernel launches add their flops
    and the bytes of their tensors (each input read once, each output
    written once) into the yielded ``{"flops", "bytes"}`` dict."""
    work = {"flops": 0.0, "bytes": 0.0}
    outer = getattr(_held, "work", None)
    _held.work = work
    try:
        yield work
    finally:
        _held.work = outer


def _work(flops, *tensors):
    """One launch's flops (a callable, evaluated only inside
    :func:`counting_work`) and the bytes of its tensors."""
    work = getattr(_held, "work", None)
    if work is not None:
        work["flops"] += float(flops())
        work["bytes"] += float(sum(t.numel() * t.element_size()
                                   for t in tensors if t is not None))


def _pairs(B, Tq, Tk, causal, seg, device):
    """Live (q, k) pairs of a batch (the kernels' ``live_pair`` rule)."""
    if seg is not None:
        return int(_live_pairs(Tq, Tk, causal, seg, device).sum())
    if causal:
        return B * sum(min(i + 1, Tk) for i in range(Tq))
    return B * Tq * Tk


def add_launches(counts, times=1):
    """Add ``times`` x ``counts`` (a :func:`recording_launches` dict) to
    :data:`launches`: the kernels a graph replay ran."""
    for name, n in counts.items():
        launches[name] += n * times


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


def _live_pairs(Tq, Tk, causal, seg, device):
    """``(B or 1, 1, Tq, Tk)`` bool: the (q, k) pairs the masks let
    through — the causal triangle (top-left aligned) and, for packed
    batches, same nonzero segment. The kernels' rule is ``live_pair`` in
    ``csrc/flash_common.cuh``."""
    live = torch.ones((Tq, Tk), dtype=torch.bool, device=device)
    if causal:
        live = torch.tril(live)
    live = live[None, None]
    if seg is not None:
        seg = torch.as_tensor(seg, device=device)
        live = live & ((seg[:, :, None] == seg[:, None, :])
                       & (seg[:, :, None] > 0))[:, None]
    return live


def _torch_fwd_lse(q, k, v, seg, scale, causal):
    """The plain forward of :class:`_Flash`: ``(o, lse (B, H, Tq))``, with
    ``o`` from :func:`_torch_reference` and the row LSE over the masked
    scores (``-1e30`` masking, as the kernel's)."""
    o = _torch_reference(q, k, v, scale, causal, segment_ids=seg)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    s = torch.where(_live_pairs(q.shape[1], k.shape[1], causal, seg,
                                q.device), s, _NEG)
    return o, torch.logsumexp(s, dim=-1).to(torch.float32)


def _torch_bwd_p(q, k, lse, seg, scale, causal):
    """``P = exp(scale * Q K^T - LSE)``, exact zero on masked pairs: the
    probabilities both backward kernels recompute."""
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    live = _live_pairs(q.shape[1], k.shape[1], causal, seg, q.device)
    s = torch.where(live, s, _NEG)
    return torch.where(live, torch.exp(s - lse[..., None]), 0.0)


def _torch_bwd_ds(q, k, v, do, lse, dcap, seg, scale, causal):
    p = _torch_bwd_p(q, k, lse, seg, scale, causal)
    dp = torch.einsum("bqhd,bkhd->bhqk", do, v)
    return p, p * (dp - dcap[..., None]) * scale


def _torch_bwd_dkdv(q, k, v, do, lse, dcap, seg, scale, causal):
    """The plain version of ``flash_bwd_dkdv.cu``: ``(dk, dv)``, both
    ``(B, Tk, H, D)``, from ``lse``/``dcap`` ``(B, H, Tq)``."""
    p, ds = _torch_bwd_ds(q, k, v, do, lse, dcap, seg, scale, causal)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q)
    return dk, dv


def _torch_bwd_dq(q, k, v, do, lse, dcap, seg, scale, causal):
    """The plain version of ``flash_bwd_dq.cu``: ``dq (B, Tq, H, D)``."""
    _, ds = _torch_bwd_ds(q, k, v, do, lse, dcap, seg, scale, causal)
    return torch.einsum("bhqk,bkhd->bqhd", ds, k)


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


def _torch_decode_q8(q, k, v, k_scale, v_scale, lengths, scale):
    """The plain int8-cache decode attention: K and V dequantized up front
    (``int8 -> float32 x`` the position's scale, as ``gather_pages_q8``
    does), then :func:`_torch_decode`."""
    k = k.to(torch.float32) * torch.as_tensor(
        k_scale, device=k.device).to(torch.float32)[:, :, None, None]
    v = v.to(torch.float32) * torch.as_tensor(
        v_scale, device=v.device).to(torch.float32)[:, :, None, None]
    return _torch_decode(q, k.to(q.dtype), v.to(q.dtype), lengths, scale)


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


def _seg_plane(seg, B, Tq, device):
    """``segment_ids`` as a contiguous ``(B, Tq)`` int32 tensor, or None."""
    if seg is None:
        return None
    seg = torch.as_tensor(seg, device=device).to(torch.int32).contiguous()
    if tuple(seg.shape) != (B, Tq):
        raise ValueError("flash_attention: segment_ids shape %s, want %s"
                         % (tuple(seg.shape), (B, Tq)))
    return seg


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
    seg = _seg_plane(seg, B, Tq, q.device)
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
    _count("flash_fwd")
    _work(lambda: 4.0 * D * H * _pairs(B, Tq, Tk, causal, seg, q.device),
          q, k, v, seg, o, lse)
    return o, lse


def _bwd_cuda(name, q, k, v, do, lse, dcap, seg, scale, causal):
    """Launch ``flash_bwd_dkdv.cu`` (``name="flash_bwd_dkdv"``, returns
    ``(dk, dv)``) or ``flash_bwd_dq.cu`` (``"flash_bwd_dq"``, returns
    ``dq``). ``lse`` and ``dcap`` are ``(B, H, Tq)`` float32."""
    from . import _build
    _check_cuda(name, q.device, q=q, k=k, v=v, do=do, lse=lse, dcap=dcap)
    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    if D > 128:
        raise MXNetError("%s: the kernel takes head_dim <= 128, got %d"
                         % (name, D))
    if tuple(do.shape) != tuple(q.shape) or tuple(lse.shape) != (B, H, Tq) \
            or tuple(dcap.shape) != (B, H, Tq):
        raise ValueError("%s: do %s, lse %s, dcap %s do not match q %s"
                         % (name, tuple(do.shape), tuple(lse.shape),
                            tuple(dcap.shape), tuple(q.shape)))
    q, k, v, do = (x.contiguous() for x in (q, k, v, do))
    lse, dcap = lse.contiguous(), dcap.contiguous()
    seg = _seg_plane(seg, B, Tq, q.device)
    seg_ptr = None if seg is None else seg.data_ptr()
    fn = _build.library(name)
    dev = torch.cuda.device(q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if name == "flash_bwd_dkdv":
        out = (torch.empty_like(k), torch.empty_like(v))
        if out[0].numel() == 0:
            return out
        with dev:
            rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                    lse.data_ptr(), dcap.data_ptr(), seg_ptr,
                    out[0].data_ptr(), out[1].data_ptr(), B, H, Tq, Tk, D,
                    float(scale), int(bool(causal)), stream)
    else:
        out = torch.empty_like(q)
        if out.numel() == 0:
            return out
        with dev:
            rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                    lse.data_ptr(), dcap.data_ptr(), seg_ptr,
                    out.data_ptr(), B, H, Tq, Tk, D, float(scale),
                    int(bool(causal)), stream)
    _raise_on(rc, name)
    _count(name)
    _work(lambda: (8.0 if name == "flash_bwd_dkdv" else 6.0) * D * H
          * _pairs(B, Tq, Tk, causal, seg, q.device),
          q, k, v, do, lse, dcap, seg,
          *(out if isinstance(out, tuple) else (out,)))
    return out


class _Flash(torch.autograd.Function):
    """Differentiable flash attention, the counterpart of the JAX
    ``custom_vjp`` ``_flash``: the forward keeps the row LSE, the
    backward computes ``D = rowsum(dO * O)`` and recomputes the
    probabilities from it in the dK/dV kernel, then the dQ kernel.
    ``kernel=False`` runs the same steps through the plain versions.
    ``segment_ids`` gets no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, seg, scale, causal, kernel):
        seg = _seg_plane(seg, q.shape[0], q.shape[1], q.device)
        f32 = (_f32(q), _f32(k), _f32(v))
        if kernel:
            o, lse = _fwd_cuda(*f32, seg, scale, causal)
        else:
            o, lse = _torch_fwd_lse(*f32, seg, scale, causal)
        o = o.to(q.dtype)
        ctx.save_for_backward(q.contiguous(), k.contiguous(),
                              v.contiguous(), o, lse, seg)
        ctx.scale, ctx.causal, ctx.kernel = scale, causal, kernel
        return o

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, do):
        q, k, v, o, lse, seg = ctx.saved_tensors
        # D = rowsum(dO * O) in float32, laid out (B, H, Tq) like the LSE
        do32 = _f32(do).contiguous()
        dcap = torch.sum(do32 * _f32(o), dim=-1).permute(0, 2, 1) \
            .contiguous()
        args = (_f32(q), _f32(k), _f32(v), do32, lse, dcap, seg,
                ctx.scale, ctx.causal)
        if ctx.kernel:
            dk, dv = _bwd_cuda("flash_bwd_dkdv", *args)
            dq = _bwd_cuda("flash_bwd_dq", *args)
        else:
            dk, dv = _torch_bwd_dkdv(*args)
            dq = _torch_bwd_dq(*args)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None,
                None, None)


def _f32(x):
    """``x`` in float32: what a kernel computes in for a low-precision
    input, as the JAX kernels cast their bfloat16 tiles on load."""
    return x if x.dtype == torch.float32 else x.to(torch.float32)


def _decode_lengths(lengths, B, device):
    """``lengths`` as a contiguous ``(B,)`` int32 tensor on ``device``."""
    lens = torch.as_tensor(lengths, device=device).to(
        torch.int32).contiguous()
    if tuple(lens.shape) != (B,):
        raise ValueError("flash_decode: lengths shape %s, want (%d,)"
                         % (tuple(lens.shape), B))
    return lens


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
    lens = _decode_lengths(lengths, B, q.device)
    o = torch.empty_like(q)
    if o.numel() == 0:
        return o
    fn = _build.library("flash_decode")
    with torch.cuda.device(q.device):
        # 0 splits: the kernel's host code splits the cache itself
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), lens.data_ptr(),
                o.data_ptr(), B, H, T, D, float(scale), 0,
                torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(rc, "flash_decode")
    _count("flash_decode")
    _work(lambda: 4.0 * D * H * int(lens.clamp(0, T).sum()),
          q, k, v, lens, o)
    return o


def _decode_q8_cuda(q, k, v, k_scale, v_scale, lengths, scale):
    """Launch ``flash_decode_q8.cu`` on int8 ``k``/``v`` ``(B, T, H, D)``
    and float32 ``k_scale``/``v_scale`` ``(B, T)``: returns ``(B, 1, H,
    D)`` float32."""
    from . import _build
    _check_cuda("flash_decode", q.device, q=q)
    B, _, H, D = q.shape
    T = k.shape[1]
    k_scale = torch.as_tensor(k_scale, device=q.device)
    v_scale = torch.as_tensor(v_scale, device=q.device)
    _check_cuda("flash_decode", q.device, k_scale=k_scale, v_scale=v_scale)
    for key, t in (("k", k), ("v", v)):
        if t.device != q.device:
            raise MXNetError("flash_decode: %s is on %s, q on %s"
                             % (key, t.device, q.device))
        if t.dtype != torch.int8:
            raise MXNetError("flash_decode: the quantized kernel takes an "
                             "int8 cache, %s is %s" % (key, t.dtype))
        if tuple(t.shape) != (B, T, H, D):
            raise ValueError("flash_decode: %s shape %s, want %s"
                             % (key, tuple(t.shape), (B, T, H, D)))
    for key, t in (("k_scale", k_scale), ("v_scale", v_scale)):
        if tuple(t.shape) != (B, T):
            raise ValueError("flash_decode: %s shape %s, want %s"
                             % (key, tuple(t.shape), (B, T)))
    if D > 128:
        raise MXNetError("flash_decode: the kernel takes head_dim "
                         "<= 128, got %d" % D)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    k_scale, v_scale = k_scale.contiguous(), v_scale.contiguous()
    lens = _decode_lengths(lengths, B, q.device)
    o = torch.empty_like(q)
    if o.numel() == 0:
        return o
    fn = _build.library("flash_decode_q8")
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                k_scale.data_ptr(), v_scale.data_ptr(), lens.data_ptr(),
                o.data_ptr(), B, H, T, D, float(scale), 0,
                torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(rc, "flash_decode_q8")
    _count("flash_decode_q8")
    _work(lambda: 6.0 * D * H * int(lens.clamp(0, T).sum()),
          q, k, v, k_scale, v_scale, lens, o)
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
    (``(B, T)`` float32 per-position scales: a paged pool's per-page
    scales repeated over each page's slots) go to ``flash_decode_q8.cu``
    on a CUDA tensor, which dequantizes while it stages each tile, so
    the cache crosses device memory at a quarter of the float32 bytes;
    the plain path dequantizes up front. Both scales must be given
    together."""
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
            o = _decode_q8_cuda(_f32(q), k, v, k_scale, v_scale, lengths,
                                scale)
        else:
            o = _torch_decode_q8(_f32(q), k, v, k_scale, v_scale, lengths,
                                 scale)
        return o.to(q.dtype)
    if q.dtype == torch.float32:
        if kernel:
            return _decode_cuda(q, k, v, lengths, scale)
        return _torch_decode(q, k.to(q.dtype), v.to(q.dtype), lengths,
                             scale)
    # a low-precision query: float32 inside, the output in q's dtype
    q32, k32, v32 = _f32(q), _f32(k), _f32(v)
    o = _decode_cuda(q32, k32, v32, lengths, scale) if kernel \
        else _torch_decode(q32, k32, v32, lengths, scale)
    return o.to(q.dtype)


def flash_attention(q, k, v, causal=False, scale=None, segment_ids=None,
                    impl=None):
    """Attention over ``(B, T, H, D)`` tensors, for ANY sequence length,
    differentiable on every device: on a CUDA tensor through the kernels
    of :class:`_Flash`, on a CPU tensor through torch autograd of the
    plain version.

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
        return _Flash.apply(q, k, v, segment_ids, scale, causal, True)
    if q.dtype != torch.float32:
        # low precision: the kernels' contract through the plain
        # versions (float32 inside, D from the rounded output)
        return _Flash.apply(q, k, v, segment_ids, scale, causal, False)
    return _torch_reference(q, k, v, scale, causal,
                            segment_ids=segment_ids)
