"""Load numpy weights into a Gluon block by structural name.

A Gluon parameter's full name carries process-global counters
(``dense3_weight``), so two nets built in different processes, or by two
packages, name the same weight differently. The structural names of
:meth:`Block._collect_params_with_prefix` (``0.weight``,
``1.query_proj.weight``, ``features.1.running_mean``) depend only on
the block tree; the JAX package's blocks give the same ones, so
``{name: p.data().asnumpy()}`` from a JAX net (its auxiliary states,
BatchNorm's running statistics, PReLU's ``alpha``, InstanceNorm's
``gamma``/``beta`` and a transposed convolution's ``(in, out, kh, kw)``
weight too) loads into the port's copy of it.
The recurrent layers and cells of ``gluon.rnn`` and ``gluon.contrib.rnn``
load the same way: a
layer's per-layer, per-direction weights (``lstm.l0_i2h_weight`` ...)
bind its deferred input width from the given array.
"""
from __future__ import annotations

import numpy as np

from ..base import MXNetError
from .. import ndarray as nd
from .parameter import _merge_shapes

__all__ = ["params_from_numpy"]


def params_from_numpy(block, tree, ctx=None):
    """Set every parameter of ``block`` from ``tree`` (``{structural
    name: np.ndarray}``): a live parameter is overwritten, a deferred or
    uninitialized one is bound to the value (on its pending context, or
    ``ctx``). A missing, extra or misshapen entry raises
    :class:`MXNetError` before anything is set."""
    table = block._collect_params_with_prefix()
    missing = sorted(set(table) - set(tree))
    extra = sorted(set(tree) - set(table))
    if missing or extra:
        raise MXNetError("params_from_numpy: names differ from the "
                         "block's (missing %s, extra %s)" % (missing, extra))
    for name, param in table.items():
        shape = np.shape(tree[name])
        try:
            if param.shape is not None:
                _merge_shapes(param.shape, shape)
        except AssertionError:
            raise MXNetError("params_from_numpy: %s has shape %s, the "
                             "block wants %s" % (name, shape, param.shape))
    for name, param in table.items():
        bound = param._data is not None or param._pending is not None
        value = nd.array(np.asarray(tree[name]), dtype=param.dtype,
                         ctx=param.list_ctx()[0] if bound else ctx)
        param._load_init(value, ctx)
