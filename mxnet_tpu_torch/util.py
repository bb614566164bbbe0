"""Misc utilities (counterpart of ``mxnet_tpu/util.py``; parity:
python/mxnet/util.py)."""
from __future__ import annotations

import functools

__all__ = ["use_np_shape", "np_shape", "is_np_shape", "makedirs",
           "int64_enabled", "set_int64_tensor_size", "canonical_dtype"]


# -- large-tensor / int64 index support -------------------------------------
# The reference gates arrays of more than 2^31 elements behind the
# USE_INT64_TENSOR_SIZE build flag; here, as in the JAX package, it is a
# runtime knob (MXNET_INT64_TENSOR_SIZE=1 or set_int64_tensor_size(True)).
# torch indexes with int64 on every device, so the knob only decides
# whether canonical_dtype keeps 64-bit dtypes or names their 32-bit
# widths, as ``nd.array`` does with its inputs.

_INT64_FLAG = [None]


def set_int64_tensor_size(enabled: bool) -> None:
    _INT64_FLAG[0] = bool(enabled)


def int64_enabled() -> bool:
    if _INT64_FLAG[0] is None:
        from . import envs
        _INT64_FLAG[0] = bool(envs.get_bool("MXNET_INT64_TENSOR_SIZE"))
    return _INT64_FLAG[0]


_DEMOTE = {"i": "int32", "u": "uint32", "f": "float32"}


def canonical_dtype(dtype):
    """The dtype an array of ``dtype`` takes: 64-bit int/uint/float
    name their 32-bit widths unless int64 tensor size is enabled."""
    import numpy as np
    dtype = np.dtype(dtype)
    if dtype.itemsize == 8 and dtype.kind in _DEMOTE \
            and not int64_enabled():
        return np.dtype(_DEMOTE[dtype.kind])
    return dtype


def makedirs(d):
    import os
    os.makedirs(d, exist_ok=True)


_np_shape = [False]


def is_np_shape():
    return _np_shape[0]


class np_shape:
    def __init__(self, active=True):
        self._active = active
        self._prev = None

    def __enter__(self):
        self._prev = _np_shape[0]
        _np_shape[0] = self._active
        return self

    def __exit__(self, *args):
        _np_shape[0] = self._prev


def use_np_shape(func):
    @functools.wraps(func)
    def wrapper(*args, **kwargs):
        with np_shape(True):
            return func(*args, **kwargs)
    return wrapper
