"""Carry a JAX parameter dict into the port.

The JAX ``ToyDecoderLM.init_params(seed)`` draws with ``jax.random``,
which torch cannot reproduce; the tests pass that dict through
``np.asarray`` and into :func:`params_from_numpy`, so both packages
serve the SAME weights.
"""
from __future__ import annotations

import numpy as np
import torch

from ..base import MXNetError
from ..context import resolve_device

__all__ = ["params_from_numpy"]


def params_from_numpy(tree, device=None, *, model):
    """``{name: np.ndarray}`` → ``{name: float32 tensor on device}``.

    The names and shapes are checked against ``model`` (anything with
    ``param_shapes()``, e.g. ``ToyDecoderLM``): a missing, extra,
    misshapen or non-float entry raises :class:`MXNetError`."""
    dev = resolve_device(device)
    out = {}
    for name, arr in tree.items():
        a = np.asarray(arr)
        if not np.issubdtype(a.dtype, np.floating):
            raise MXNetError("params_from_numpy: %s has dtype %s, want "
                             "a float array" % (name, a.dtype))
        out[name] = torch.from_numpy(np.array(a, np.float32)).to(dev)
    want = model.param_shapes()
    missing = sorted(set(want) - set(out))
    extra = sorted(set(out) - set(want))
    if missing or extra:
        raise MXNetError("params_from_numpy: names differ from the "
                         "model's (missing %s, extra %s)"
                         % (missing, extra))
    for name, shape in want.items():
        if tuple(out[name].shape) != tuple(shape):
            raise MXNetError(
                "params_from_numpy: %s has shape %s, the model wants %s"
                % (name, tuple(out[name].shape), tuple(shape)))
    return out
