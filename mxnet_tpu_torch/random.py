"""Random state (counterpart of ``mxnet_tpu/random.py``).

Randomness is explicit: every draw of the port takes a
``torch.Generator`` from :func:`generator`, one per device, each seeded
from :func:`seed` (default 0). ``seed(n)`` reseeds every device;
``seed(n, ctx)`` reseeds one. torch's generators give other numbers than
``jax.random`` from the same seed, so the tests hand both packages the
same numpy arrays instead.
"""
from __future__ import annotations

import threading

import torch

__all__ = ["seed", "current_seed", "generator"]

_lock = threading.Lock()
_seed_val = 0
_gens = {}          # device string -> torch.Generator


def _key(device):
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def seed(seed_state, ctx="all"):
    """Seed the generators (reference: python/mxnet/random.py:36):
    every device's with ``ctx="all"``, else only that context's."""
    global _seed_val
    with _lock:
        if ctx == "all":
            _seed_val = int(seed_state)
            _gens.clear()
        else:
            dev = _key(ctx.torch_device() if hasattr(ctx, "torch_device")
                       else ctx)
            _gens[str(dev)] = torch.Generator(device=dev).manual_seed(
                int(seed_state))


def current_seed():
    return _seed_val


def generator(device):
    """The generator of ``device`` (a ``torch.device`` or string),
    created from the current seed at first use."""
    dev = _key(device)
    with _lock:
        gen = _gens.get(str(dev))
        if gen is None:
            gen = torch.Generator(device=dev).manual_seed(_seed_val)
            _gens[str(dev)] = gen
    return gen
