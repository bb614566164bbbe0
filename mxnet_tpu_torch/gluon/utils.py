"""Gluon utilities (counterpart of ``mxnet_tpu/gluon/utils.py``):
``split_data``, ``split_and_load`` (over contexts on distinct devices,
one array split over their in-process mesh), ``clip_global_norm``,
``check_sha1``, ``download`` (a cached file only: it makes no network
call) and ``shape_is_known``."""
from __future__ import annotations

import hashlib
import os
import warnings

import numpy as np
import torch

from .. import ndarray as nd
from ..ndarray import NDArray

__all__ = ["split_data", "split_and_load", "clip_global_norm", "check_sha1",
           "download", "shape_is_known"]


def split_data(data, num_slice, batch_axis=0, even_split=True):
    """``num_slice`` slices of ``data`` along ``batch_axis``; the last
    takes the remainder with ``even_split=False`` (reference:
    utils.py:33)."""
    size = data.shape[batch_axis]
    if even_split and size % num_slice != 0:
        raise ValueError(
            "data with shape %s cannot be evenly split into %d slices "
            "along axis %d. Use a batch size that's multiple of %d or set "
            "even_split=False to allow uneven partitioning of data." % (
                str(data.shape), num_slice, batch_axis, num_slice))
    if num_slice == 1:
        return [data]
    step = size // num_slice
    return [data.slice_axis(batch_axis, i * step,
                            (i + 1) * step if i < num_slice - 1
                            or even_split else size)
            for i in range(num_slice)]


def split_and_load(data, ctx_list, batch_axis=0, even_split=True):
    """The batch as a one-element list (reference: utils.py:88; the JAX
    package's form). Contexts that resolve to one torch device are one:
    the whole batch on it. Over contexts on distinct devices the element
    is ONE array split along ``batch_axis`` over their in-process ``dp``
    mesh (a ``MeshNDArray``), so ``[net(x) for x in split_and_load(...)]``
    runs the global batch shard by shard against parameters replicated
    over the same mesh. A batch that does not divide over the devices
    raises ``ValueError``, or with ``even_split=False`` is replicated
    (every op then runs it whole, once)."""
    from ..context import as_context
    from ..ndarray.ndarray import MeshNDArray
    from ..parallel.mesh import dp_mesh, distinct_devices
    ctx_list = [as_context(c) for c in ctx_list]
    if not isinstance(data, NDArray):
        data = nd.array(data, ctx=ctx_list[0])
    devices = distinct_devices(ctx_list)
    if len(devices) < 2:
        return [data.as_in_context(ctx_list[0])]
    mesh = dp_mesh(devices)
    size = data.shape[batch_axis]
    whole = data._data.to(devices[0])
    if size % mesh.size == 0:
        value = mesh.split(whole, batch_axis)
    elif even_split:
        raise ValueError(
            "data with shape %s cannot be evenly split onto %d devices "
            "along axis %d. Use a batch size that's a multiple of %d or "
            "set even_split=False." % (str(data.shape), mesh.size,
                                       batch_axis, mesh.size))
    else:
        value = mesh.replicate(whole)
    return [MeshNDArray(value, ctx_list[0])]


def clip_global_norm(arrays, max_norm, check_isfinite=True):
    """Scale ``arrays`` in place so that their joint L2 norm is at most
    ``max_norm``; returns the norm before scaling (reference:
    utils.py:117). A non-finite norm warns with ``check_isfinite``."""
    def _norm(array):
        x = array.reshape((-1,))
        return nd.dot(x, x)
    assert len(arrays) > 0
    ctx = arrays[0].context
    total_norm = _norm(arrays[0]).as_in_context(ctx)
    for arr in arrays[1:]:
        total_norm = total_norm + _norm(arr).as_in_context(ctx)
    total_norm = float(total_norm.sqrt().asscalar())
    if check_isfinite and not np.isfinite(total_norm):
        warnings.warn(UserWarning("nan or inf is detected. Clipping "
                                  "results will be undefined."),
                      stacklevel=2)
    scale = max_norm / (total_norm + 1e-8)
    if scale < 1.0:
        with torch.no_grad():
            for arr in arrays:
                # in place: a gradient buffer keeps its tensor
                arr._data.mul_(scale)
    return total_norm


def check_sha1(filename, sha1_hash):
    """Whether ``filename``'s SHA-1 is ``sha1_hash``."""
    sha1 = hashlib.sha1()
    with open(filename, "rb") as f:
        while True:
            data = f.read(1048576)
            if not data:
                break
            sha1.update(data)
    return sha1.hexdigest() == sha1_hash


def download(url, path=None, overwrite=False, sha1_hash=None,
             retries=5, verify_ssl=True):
    """The local file for ``url`` (reference: utils.py:187): a cached
    file at ``path`` (a directory or a file name) that matches
    ``sha1_hash`` is returned; otherwise this raises. It makes no
    network call."""
    if path is None:
        fname = url.split("/")[-1]
    elif os.path.isdir(path):
        fname = os.path.join(path, url.split("/")[-1])
    else:
        fname = path
    if os.path.exists(fname) and not overwrite and \
            (not sha1_hash or check_sha1(fname, sha1_hash)):
        return fname
    raise RuntimeError(
        "download(%s): mxnet_tpu_torch makes no network call, and the "
        "file is not cached at %s" % (url, fname))


def shape_is_known(shape):
    """Whether every dim of ``shape`` is known (none is 0)."""
    if shape is None:
        return False
    for dim_size in shape:
        if dim_size == 0:
            return False
    return True
