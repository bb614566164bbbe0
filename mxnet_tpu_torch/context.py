"""Device choice (counterpart of ``mxnet_tpu/context.py``'s default
context): entry points run on ``cuda:0`` unless the caller names a
device, and never fall back to the CPU silently."""
from __future__ import annotations

import torch

from .base import MXNetError

__all__ = ["resolve_device"]


def resolve_device(device=None):
    """``device`` as a :class:`torch.device`; None means ``cuda:0`` and
    raises when no CUDA device is visible — pass ``device="cpu"`` to run
    on the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise MXNetError(
            "no CUDA device is visible: mxnet_tpu_torch runs on cuda:0 "
            "by default — pass device='cpu' to run on the CPU")
    return torch.device("cuda", 0)
