"""Fused attention on the registered-op surface (counterpart of
``mxnet_tpu/ops/attention.py``): ``_contrib_flash_attention`` over
``(B, T, H, D)`` inputs, with an optional 4th ``segment_ids`` input
(``(B, T)``, packed batches), and ``_contrib_decode_attention``, one
decode step of cached-KV attention (``impl`` auto|flash: the decode
kernel on a CUDA tensor, the plain version on a CPU tensor; dense: the
plain version on any device; ``block_k`` is the TPU kernel's key block,
accepted and unused).

``impl``:

- ``auto`` — ``ring`` when the active mesh (``parallel.mesh.use_mesh``)
  has an ``sp`` axis (``mesh_axis``) of size > 1, else ``flash``;
- ``flash`` — :func:`~mxnet_tpu_torch.parallel.flash_attention.
  flash_attention`: the CUDA kernels on a CUDA tensor (differentiable
  through their backward kernels), the plain version on a CPU tensor;
- ``dense`` — the plain version on any device (torch autograd);
- ``ring`` / ``ulysses`` — :mod:`~mxnet_tpu_torch.parallel.
  ring_attention` over the mesh's ``sp`` axis: each rank passes its
  sequence slice and gets its slice of the output back. Without an
  ``sp`` mesh both run local attention (``flash``). A ``segment_ids``
  plane is refused with them.

``block_q``/``block_k`` are the TPU kernel's blocks: accepted, unused
(the CUDA kernels pick their own tiles).

Both ops reach the ``mxnet_tpu_torch`` torch.library ops of
:mod:`~mxnet_tpu_torch.parallel.flash_attention` (``flash_fwd``,
``flash_decode``), so shape inference runs their bodies on ``meta``
tensors like any other op's (the ops' fake implementations give the
shapes), and ``deploy.export_compiled`` traces them into artifacts as
op nodes. On ``meta`` tensors ``ring``/``ulysses`` take the local op:
the sequence-sharded result has the same shape.
"""
from __future__ import annotations

import math

from .registry import register

__all__ = []


def _attention(attrs, query, key, value, segment_ids=None):
    from ..parallel.flash_attention import flash_attention
    from ..parallel.mesh import current_mesh, mesh_axes
    from ..parallel.ring_attention import ring_attention, ulysses_attention
    causal = bool(attrs.get("causal", False))
    scale = float(attrs.get("scale", 0.0)) or \
        1.0 / math.sqrt(query.shape[-1])
    impl = str(attrs.get("impl", "auto"))
    axis = str(attrs.get("mesh_axis", "sp"))
    mesh = current_mesh()
    has_sp = mesh is not None and mesh_axes(mesh).get(axis, 1) > 1 \
        and query.device.type != "meta"
    if impl == "auto":
        impl = "ring" if has_sp else "flash"
    if segment_ids is not None and impl in ("ring", "ulysses"):
        # packed batches: the sequence-sharded paths take no segment plane
        raise ValueError(
            "_contrib_flash_attention: segment_ids (packed batches) is "
            "supported by impl='flash'/'dense' only, not %r" % impl)
    if impl in ("ring", "ulysses"):
        fn = ring_attention if impl == "ring" else ulysses_attention
        return fn(query, key, value, mesh=mesh if has_sp else None,
                  axis=axis, causal=causal, scale=scale)
    if impl not in ("flash", "dense"):
        raise ValueError("_contrib_flash_attention: unknown impl %r"
                         % impl)
    return flash_attention(query, key, value, causal=causal, scale=scale,
                           segment_ids=segment_ids,
                           impl="plain" if impl == "dense" else None)


def _decode_attention(attrs, query, key_cache, value_cache, lengths):
    from ..parallel.flash_attention import flash_decode
    scale = float(attrs.get("scale", 0.0)) or \
        1.0 / math.sqrt(query.shape[-1])
    impl = str(attrs.get("impl", "auto"))
    if impl not in ("auto", "flash", "dense"):
        raise ValueError(
            "_contrib_decode_attention: unknown impl %r (auto|flash|dense)"
            % impl)
    return flash_decode(query, key_cache, value_cache, lengths, scale=scale,
                        impl="plain" if impl == "dense" else None)


register("_contrib_decode_attention", _decode_attention,
         arg_names=("query", "key_cache", "value_cache", "lengths"),
         defaults={"scale": 0.0, "impl": "auto", "block_k": 128},
         attr_docs={"scale": "score scale; 0 = 1/sqrt(head_dim)",
                    "impl": "auto|flash|dense (auto and flash: the "
                            "decode kernel on a CUDA tensor)",
                    "block_k": "the TPU kernel's key block; accepted, "
                               "unused"},
         description="One autoregressive decode step of cached-KV "
                     "attention: query (B, 1, H, D) against a gathered "
                     "KV cache (B, T, H, D) with per-row valid-key "
                     "counts (B,) — positions beyond a row's length "
                     "carry exact-zero weight.")


register("_contrib_flash_attention", _attention,
         arg_names=("query", "key", "value"),
         defaults={"causal": False, "scale": 0.0, "impl": "auto",
                   "mesh_axis": "sp", "block_q": 512, "block_k": 512},
         attr_docs={"causal": "apply a causal (lower-triangular) mask",
                    "scale": "score scale; 0 = 1/sqrt(head_dim)",
                    "impl": "auto|flash|dense|ring|ulysses",
                    "mesh_axis": "mesh axis carrying the sequence slices",
                    "block_q": "the TPU kernel's query block; accepted, "
                               "unused",
                    "block_k": "the TPU kernel's key block; accepted, "
                               "unused"},
         description="Fused attention over (B, T, H, D); an optional "
                     "4th input carries the (B, T) int32 segment-id "
                     "plane of a packed batch — cross-segment attention "
                     "masks to exact zero (impl flash/dense).")
