"""Fused attention on the registered-op surface (counterpart of
``mxnet_tpu/ops/attention.py``): ``_contrib_flash_attention`` over
``(B, T, H, D)`` inputs, with an optional 4th ``segment_ids`` input
(``(B, T)``, packed batches), and ``_contrib_decode_attention``, one
decode step of cached-KV attention (``impl`` auto|flash: the decode
kernel on a CUDA tensor, the plain version on a CPU tensor; dense: the
plain version on any device; ``block_k`` is the TPU kernel's key block,
accepted and unused).

``impl``:

- ``auto`` — ``flash``: the port has no device mesh yet, so there is no
  sequence-parallel axis for ``auto`` to pick ring attention on;
- ``flash`` — :func:`~mxnet_tpu_torch.parallel.flash_attention.
  flash_attention`: the CUDA kernels on a CUDA tensor (differentiable
  through their backward kernels), the plain version on a CPU tensor;
- ``dense`` — the plain version on any device (torch autograd);
- ``ring`` / ``ulysses`` — raise NotImplementedError until the mesh and
  the sequence-parallel kernels are ported (ROADMAP queue A item 12).
"""
from __future__ import annotations

import math

from .registry import register

__all__ = []


def _attention(attrs, query, key, value, segment_ids=None):
    from ..parallel.flash_attention import flash_attention
    causal = bool(attrs.get("causal", False))
    scale = float(attrs.get("scale", 0.0)) or \
        1.0 / math.sqrt(query.shape[-1])
    impl = str(attrs.get("impl", "auto"))
    if impl in ("ring", "ulysses"):
        raise NotImplementedError(
            "_contrib_flash_attention: impl=%r needs the device mesh and "
            "the sequence-parallel attention, not ported yet (ROADMAP "
            "queue A item 12)" % impl)
    if impl == "auto":
        impl = "flash"
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


def _like_query(attrs, query, *rest):
    """Output shape rule: the kernels cannot run on ``meta`` tensors."""
    return [(tuple(query.shape), query.dtype)]


register("_contrib_decode_attention", _decode_attention,
         output_shapes=_like_query,
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


register("_contrib_flash_attention", _attention, output_shapes=_like_query,
         arg_names=("query", "key", "value"),
         defaults={"causal": False, "scale": 0.0, "impl": "auto"},
         attr_docs={"causal": "apply a causal (lower-triangular) mask",
                    "scale": "score scale; 0 = 1/sqrt(head_dim)",
                    "impl": "auto|flash|dense|ring|ulysses"},
         description="Fused attention over (B, T, H, D); an optional "
                     "4th input carries the (B, T) int32 segment-id "
                     "plane of a packed batch — cross-segment attention "
                     "masks to exact zero (impl flash/dense).")
