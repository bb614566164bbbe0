"""Fused (flash) attention: hand-written CUDA kernels for Hopper
(counterpart of ``mxnet_tpu/parallel/flash_attention.py``).

Two public functions keep the JAX package's signatures and its
``(B, T, H, D)`` layout:

- :func:`flash_attention` — attention for prefill and training (causal,
  optionally segment-blocked for packed batches), differentiable;
- :func:`flash_decode` — one query row per sequence against a gathered
  KV cache with per-row valid lengths, for a float cache or an int8
  cache with per-position scales.

**The ops.** Each kernel is a ``torch.library`` custom op in the
``mxnet_tpu_torch`` namespace (:data:`OPS`), and both functions call
them on every device, so an eager call, a CUDA-graph capture and a
``torch.export`` trace all see the same node:

===================  ===========================  =====================
op                   ``cuda`` implementation      TPU kernel
===================  ===========================  =====================
``flash_fwd``        ``csrc/flash_fwd.cu``        ``_fwd_kernel``
``flash_bwd_dkdv``   ``csrc/flash_bwd_dkdv.cu``   ``_bwd_dkdv_kernel``
``flash_bwd_dq``     ``csrc/flash_bwd_dq.cu``     ``_bwd_dq_kernel``
``flash_decode``     ``csrc/flash_decode.cu``     ``_decode_kernel``
``flash_decode_q8``  ``csrc/flash_decode_q8.cu``  ``_decode_kernel_q8``
===================  ===========================  =====================

The ``cuda`` implementation launches the kernel through its ctypes
wrapper (:func:`_fwd_cuda`, :func:`_bwd_cuda`, :func:`_decode_cuda`,
:func:`_decode_q8_cuda`) or raises :class:`MXNetError`: there is no
fallback. The ``cpu`` implementation is the plain PyTorch version
(:func:`_torch_fwd_lse`, :func:`_torch_bwd_dkdv`, :func:`_torch_bwd_dq`,
:func:`_torch_decode`, :func:`_torch_decode_q8`), which mirrors the JAX
package's ``_jnp_reference`` / ``_jnp_decode`` exactly: masked scores
are ``-1e30`` (an exact-zero softmax weight), the denominator is
floored at ``1e-30``, segment id 0 attends to nothing, and int8 K/V
with scales are dequantized up front. Each op's fake implementation
gives its shapes (O like q, the LSE ``(B, H, Tq)`` float32), which is
how shape inference runs on ``meta`` tensors and how ``torch.export``
traces them. ``flash_fwd`` carries its autograd (the counterpart of the
JAX ``custom_vjp``): the backward takes ``D = rowsum(dO * O)`` in
float32 and calls ``flash_bwd_dkdv``, which recomputes the
probabilities from the forward's row LSE, then ``flash_bwd_dq``. A
masked (q, k) pair gets an exact-zero probability in the backward, so a
row that attends to nothing (segment id 0) contributes no gradient; the
JAX kernels give such rows weights that depend on the tiling, so the two
agree where a masked loss puts a zero cotangent on those rows.
``impl="plain"`` skips the ops: the plain forward under torch autograd
on any device, which the tests and ``chip_smoke.py`` hold each kernel
against on the card.

**Artifacts.** A program exported through ``torch.export`` (the deploy
path) holds the op nodes, whether it was traced on the CPU or on the
card, and dispatches them on the device it runs on: an artifact
exported on the CPU launches the kernels once it is moved to the card.
Loading such a program needs this module imported (which registers the
ops) and its kernel sources to build from, which
``deploy.load_compiled`` sees to.

bfloat16 (or float16) q/k/v/dO keep the JAX kernels' contract: float32
inside, outputs and gradients in the input dtype, the LSE and ``D`` in
float32, ``D`` from the output rounded to the input dtype. The casts
stay outside the ops: the wrappers upcast to float32, call the ops and
cast the results back; ``flash_fwd``'s ``out_dtype`` tells its backward
what the output was rounded to. Kernels that load bfloat16 natively are
ROADMAP queue B work.

Each kernel wrapper counts its launches in :data:`launches`. A CUDA
graph capture enqueues kernels and runs none: inside
:func:`recording_launches` the calling thread's counts go to the block's
own dict instead, and a graph replay adds them back with
:func:`add_launches`. Inside :func:`counting_work` each launch also adds
its flops and bytes (the formulas of ``PERF.md`` §6's bound column) to
the block's dict, and each plain route the flops of its dense products:
the compile watch costs a program once that way, the ops being opaque
to torch's flop counter.
"""
from __future__ import annotations

import contextlib
import math
import threading
from typing import Optional

import torch

from ..base import MXNetError

__all__ = ["flash_attention", "flash_decode", "launches",
           "reset_launches", "recording_launches", "add_launches",
           "counting_work", "OPS"]

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


def _masked_scores(q, k, scale, causal, segment_ids):
    """``scale * Q K^T`` ``(B, H, Tq, Tk)`` with masked pairs at
    ``-1e30``: the causal triangle, then (packed batches) a position
    attends only inside its own segment, padding (id 0) to nothing."""
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if causal:
        Tq, Tk = q.shape[1], k.shape[1]
        mask = torch.tril(torch.ones((Tq, Tk), dtype=torch.bool,
                                     device=q.device))
        s = torch.where(mask[None, None], s, _NEG)
    if segment_ids is not None:
        seg = torch.as_tensor(segment_ids, device=q.device)
        allowed = (seg[:, :, None] == seg[:, None, :]) \
            & (seg[:, :, None] > 0)
        s = torch.where(allowed[:, None], s, _NEG)
    return s


def _softmax_pv(s, v, dtype):
    p = torch.exp(s - torch.amax(s, dim=-1, keepdim=True)).to(dtype)
    p = p / torch.clamp_min(torch.sum(p, dim=-1, keepdim=True), 1e-30)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


def _torch_reference(q, k, v, scale, causal, segment_ids=None):
    """The plain prefill attention: ``_jnp_reference`` in torch."""
    return _softmax_pv(_masked_scores(q, k, scale, causal, segment_ids), v,
                       q.dtype)


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
    """The plain version of ``flash_fwd.cu``: ``(o, lse (B, H, Tq))``,
    ``o`` as :func:`_torch_reference` computes it and the row LSE over
    the same masked scores (``-1e30`` masking, as the kernel's)."""
    s = _masked_scores(q, k, scale, causal, seg)
    return _softmax_pv(s, v, q.dtype), \
        torch.logsumexp(s, dim=-1).to(torch.float32)


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


def _use_op(impl):
    """True for the op route (:data:`OPS`: the kernel on a CUDA tensor,
    the plain version on a CPU tensor), False for the plain version
    under torch autograd."""
    if impl == "plain":
        return False
    if impl is not None:
        raise ValueError("impl must be None or 'plain', got %r" % (impl,))
    return True


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


# ---------------------------------------------------------------------------
# the kernels as torch.library ops: one node in eager calls, CUDA-graph
# captures and torch.export traces alike
# ---------------------------------------------------------------------------

_NS = "mxnet_tpu_torch"
_Tensor = torch.Tensor
_OptTensor = Optional[torch.Tensor]


def _dense_work(B, H, Tq, Tk, D, products):
    """The flops of ``products`` dense ``(Tq x D) . (D x Tk)``-sized
    products over ``B x H``: what a plain version computes."""
    return lambda: 2.0 * products * B * H * Tq * Tk * D


@torch.library.custom_op(_NS + "::flash_fwd", mutates_args=(),
                         device_types="cpu")
def _flash_fwd(q: _Tensor, k: _Tensor, v: _Tensor, segment_ids: _OptTensor,
               scale: float, causal: bool,
               out_dtype: Optional[torch.dtype]) -> tuple[_Tensor, _Tensor]:
    """``(o, lse)``: float32 ``(B, Tq, H, D)`` and ``(B, H, Tq)``.
    ``out_dtype`` is the dtype the caller casts ``o`` to (None: float32);
    only the backward reads it."""
    B, Tq, H, D = q.shape
    o, lse = _torch_fwd_lse(q, k, v, segment_ids, scale, causal)
    o, lse = o.contiguous(), lse.contiguous()
    _work(_dense_work(B, H, Tq, k.shape[1], D, 2), q, k, v, segment_ids, o,
          lse)
    return o, lse


@_flash_fwd.register_kernel("cuda")
def _flash_fwd_kernel(q, k, v, segment_ids, scale, causal, out_dtype):
    return _fwd_cuda(q, k, v, segment_ids, scale, causal)


@_flash_fwd.register_fake
def _flash_fwd_fake(q, k, v, segment_ids, scale, causal, out_dtype):
    B, Tq, H, _ = q.shape
    return q.new_empty(q.shape), q.new_empty((B, H, Tq), dtype=torch.float32)


def _bwd_work(products, q, k, *tensors):
    B, Tq, H, D = q.shape
    _work(_dense_work(B, H, Tq, k.shape[1], D, products), q, k, *tensors)


@torch.library.custom_op(_NS + "::flash_bwd_dkdv", mutates_args=(),
                         device_types="cpu")
def _flash_bwd_dkdv(q: _Tensor, k: _Tensor, v: _Tensor, do: _Tensor,
                    lse: _Tensor, dcap: _Tensor, segment_ids: _OptTensor,
                    scale: float, causal: bool) -> tuple[_Tensor, _Tensor]:
    """``(dk, dv)``, both ``(B, Tk, H, D)``, from ``lse`` and ``dcap =
    rowsum(dO * O)`` laid out ``(B, H, Tq)``."""
    dk, dv = _torch_bwd_dkdv(q, k, v, do, lse, dcap, segment_ids, scale,
                             causal)
    dk, dv = dk.contiguous(), dv.contiguous()
    _bwd_work(4, q, k, v, do, lse, dcap, segment_ids, dk, dv)
    return dk, dv


@_flash_bwd_dkdv.register_kernel("cuda")
def _flash_bwd_dkdv_kernel(q, k, v, do, lse, dcap, segment_ids, scale,
                           causal):
    return _bwd_cuda("flash_bwd_dkdv", q, k, v, do, lse, dcap, segment_ids,
                     scale, causal)


@_flash_bwd_dkdv.register_fake
def _flash_bwd_dkdv_fake(q, k, v, do, lse, dcap, segment_ids, scale,
                         causal):
    return k.new_empty(k.shape), v.new_empty(v.shape)


@torch.library.custom_op(_NS + "::flash_bwd_dq", mutates_args=(),
                         device_types="cpu")
def _flash_bwd_dq(q: _Tensor, k: _Tensor, v: _Tensor, do: _Tensor,
                  lse: _Tensor, dcap: _Tensor, segment_ids: _OptTensor,
                  scale: float, causal: bool) -> _Tensor:
    """``dq (B, Tq, H, D)``, from the same inputs as ``flash_bwd_dkdv``."""
    dq = _torch_bwd_dq(q, k, v, do, lse, dcap, segment_ids, scale,
                       causal).contiguous()
    _bwd_work(3, q, k, v, do, lse, dcap, segment_ids, dq)
    return dq


@_flash_bwd_dq.register_kernel("cuda")
def _flash_bwd_dq_kernel(q, k, v, do, lse, dcap, segment_ids, scale, causal):
    return _bwd_cuda("flash_bwd_dq", q, k, v, do, lse, dcap, segment_ids,
                     scale, causal)


@_flash_bwd_dq.register_fake
def _flash_bwd_dq_fake(q, k, v, do, lse, dcap, segment_ids, scale, causal):
    return q.new_empty(q.shape)


def _flash_fwd_setup(ctx, inputs, output):
    q, k, v, segment_ids, scale, causal, out_dtype = inputs
    ctx.save_for_backward(q, k, v, output[0], output[1], segment_ids)
    ctx.scale, ctx.causal, ctx.out_dtype = scale, causal, out_dtype


def _flash_fwd_backward(ctx, do, _dlse):
    """The counterpart of the JAX ``custom_vjp``'s backward: ``D =
    rowsum(dO * O)`` in float32 from ``O`` as the caller received it
    (rounded to ``out_dtype``), then the dK/dV op, which recomputes the
    probabilities from the row LSE, then the dQ op. The LSE output and
    ``segment_ids`` get no gradient."""
    q, k, v, o, lse, seg = ctx.saved_tensors
    if ctx.out_dtype is not None:
        o = o.to(ctx.out_dtype).to(torch.float32)
    do = do.contiguous()
    dcap = torch.sum(do * o, dim=-1).permute(0, 2, 1).contiguous()
    args = (q, k, v, do, lse, dcap, seg, ctx.scale, ctx.causal)
    dk, dv = _flash_bwd_dkdv(*args)
    dq = _flash_bwd_dq(*args)
    return dq, dk, dv, None, None, None, None


_flash_fwd.register_autograd(_flash_fwd_backward,
                             setup_context=_flash_fwd_setup)


@torch.library.custom_op(_NS + "::flash_decode", mutates_args=(),
                         device_types="cpu")
def _flash_decode(q: _Tensor, k: _Tensor, v: _Tensor, lengths: _Tensor,
                  scale: float) -> _Tensor:
    """``(B, 1, H, D)`` float32 from float32 ``q``/``k``/``v`` and int32
    ``lengths (B,)``."""
    o = _torch_decode(q, k, v, lengths, scale).contiguous()
    B, _, H, D = q.shape
    _work(_dense_work(B, H, 1, k.shape[1], D, 2), q, k, v, lengths, o)
    return o


@_flash_decode.register_kernel("cuda")
def _flash_decode_kernel(q, k, v, lengths, scale):
    return _decode_cuda(q, k, v, lengths, scale)


@_flash_decode.register_fake
def _flash_decode_fake(q, k, v, lengths, scale):
    return q.new_empty(q.shape)


@torch.library.custom_op(_NS + "::flash_decode_q8", mutates_args=(),
                         device_types="cpu")
def _flash_decode_q8(q: _Tensor, k: _Tensor, v: _Tensor, k_scale: _Tensor,
                     v_scale: _Tensor, lengths: _Tensor,
                     scale: float) -> _Tensor:
    """The same on an int8 ``k``/``v`` with float32 per-position scales
    ``(B, T)``."""
    o = _torch_decode_q8(q, k, v, k_scale, v_scale, lengths,
                         scale).contiguous()
    B, _, H, D = q.shape
    _work(_dense_work(B, H, 1, k.shape[1], D, 2), q, k, v, k_scale,
          v_scale, lengths, o)
    return o


@_flash_decode_q8.register_kernel("cuda")
def _flash_decode_q8_kernel(q, k, v, k_scale, v_scale, lengths, scale):
    return _decode_q8_cuda(q, k, v, k_scale, v_scale, lengths, scale)


@_flash_decode_q8.register_fake
def _flash_decode_q8_fake(q, k, v, k_scale, v_scale, lengths, scale):
    return q.new_empty(q.shape)


# op name -> the op: what an exported program names, and what
# deploy.load_compiled checks an artifact's ``custom_ops`` against
OPS = {_NS + "::" + name: op for name, op in (
    ("flash_fwd", _flash_fwd), ("flash_bwd_dkdv", _flash_bwd_dkdv),
    ("flash_bwd_dq", _flash_bwd_dq), ("flash_decode", _flash_decode),
    ("flash_decode_q8", _flash_decode_q8))}


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
    if not _use_op(impl):
        if quant:
            return _torch_decode_q8(_f32(q), k, v, k_scale, v_scale,
                                    lengths, scale).to(q.dtype)
        return _torch_decode(_f32(q), _f32(k), _f32(v), lengths,
                             scale).to(q.dtype)
    lens = _decode_lengths(lengths, q.shape[0], q.device)
    if quant:
        o = _flash_decode_q8(_f32(q), k, v,
                             torch.as_tensor(k_scale, device=q.device),
                             torch.as_tensor(v_scale, device=q.device), lens,
                             float(scale))
    else:
        o = _flash_decode(_f32(q), _f32(k), _f32(v), lens, float(scale))
    return o.to(q.dtype)


def flash_attention(q, k, v, causal=False, scale=None, segment_ids=None,
                    impl=None):
    """Attention over ``(B, T, H, D)`` tensors, for ANY sequence length,
    differentiable on every device through op ``flash_fwd`` and its
    backward ops: the kernels on a CUDA tensor, their plain versions on
    a CPU tensor.

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
    if not _use_op(impl):
        return _torch_reference(_f32(q), _f32(k), _f32(v), scale, causal,
                                segment_ids=segment_ids).to(q.dtype)
    seg = _seg_plane(segment_ids, q.shape[0], q.shape[1], q.device)
    o, _lse = _flash_fwd(_f32(q), _f32(k), _f32(v), seg, float(scale),
                         bool(causal),
                         None if q.dtype == torch.float32 else q.dtype)
    return o.to(q.dtype)
