"""mxnet_tpu_torch — the PyTorch/CUDA port of ``mxnet_tpu``.

The port runs beside the JAX package and mirrors its module paths, so
each module here has a counterpart of the same name under
``mxnet_tpu/``. It imports ``torch`` and ``numpy``, never ``jax`` and
nothing of ``mxnet_tpu``. Entry points run on ``cuda:0`` unless the
caller passes ``device="cpu"``; the attention kernels on the main path
are CUDA C++ written for Hopper (``parallel/csrc``), built with ``nvcc``
at first use.

This slice ports the token path of the LM server:
``serving.DecodeServer`` over ``serving.ToyDecoderLM``, with the paged
KV pool (``serving.kvcache``) and the prefill/decode attention kernels
(``parallel.flash_attention``). ``ROADMAP.md`` lists what waits for
later slices.
"""
from .base import MXNetError

__all__ = ["MXNetError"]
