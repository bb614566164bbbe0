"""Contrib layers (counterpart of
``mxnet_tpu/gluon/contrib/nn/basic_layers.py``): ``Concurrent`` and
``HybridConcurrent`` (children run on one input, their outputs joined
by ``Concat``), ``Identity``, ``SparseEmbedding``, ``SyncBatchNorm``
and the sub-pixel upsampling layers ``PixelShuffle1D``/``2D``/``3D`` (reshapes and one
transpose)."""
from __future__ import annotations

from ...block import Block, HybridBlock
from ...nn.basic_layers import BatchNorm, Sequential, HybridSequential

__all__ = ["Concurrent", "HybridConcurrent", "Identity", "SparseEmbedding",
           "PixelShuffle1D", "PixelShuffle2D", "PixelShuffle3D"]


class Concurrent(Sequential):
    """Parallel branches concatenated along ``axis`` (reference:
    basic_layers.py:38)."""

    def __init__(self, axis=-1, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self.axis = axis

    def forward(self, x):
        from .... import ndarray as nd
        out = [block(x) for block in self._children.values()]
        return nd.Concat(*out, dim=self.axis)


class HybridConcurrent(HybridSequential):
    """Hybridizable parallel branches concatenated along ``axis``
    (reference: basic_layers.py:69)."""

    def __init__(self, axis=-1, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self.axis = axis

    def hybrid_forward(self, F, x):
        out = [block(x) for block in self._children.values()]
        return F.Concat(*out, dim=self.axis)


class Identity(HybridBlock):
    """Its input, unchanged (a branch of a Concurrent block)."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)

    def hybrid_forward(self, F, x):
        return x


class SparseEmbedding(Block):
    """An embedding whose op says ``sparse_grad=True`` (reference:
    basic_layers.py:118). As in the JAX package its weight declares no
    ``grad_stype``, so the Trainer updates it densely; the row-lazy
    update is ``nn.Embedding(sparse_grad=True)``'s."""

    def __init__(self, input_dim, output_dim, dtype="float32",
                 weight_initializer=None, **kwargs):
        super().__init__(**kwargs)
        self._kwargs = {"input_dim": input_dim, "output_dim": output_dim,
                        "dtype": dtype, "sparse_grad": True}
        self.weight = self.params.get("weight",
                                      shape=(input_dim, output_dim),
                                      init=weight_initializer, dtype=dtype)

    def forward(self, x):
        from .... import ndarray as nd
        return nd.Embedding(x, self.weight.data(), **self._kwargs)

    def __repr__(self):
        s = "{block_name}({input_dim} -> {output_dim}, {dtype})"
        return s.format(block_name=self.__class__.__name__, **self._kwargs)


def _factors(factor, n):
    """``factor`` as ``n`` ints (one int repeated, or a sequence of
    ``n``)."""
    try:
        return (int(factor),) * n
    except TypeError:
        factors = tuple(int(fac) for fac in factor)
        assert len(factors) == n, "wrong length {}".format(len(factors))
        return factors


class SyncBatchNorm(BatchNorm):
    """Cross-device synchronized BatchNorm (reference:
    src/operator/contrib/sync_batch_norm.cc): BatchNorm over axis 1 whose
    training moments are the global batch's under a mesh that shards the
    batch over several ranks (``parallel.use_mesh``; the data-parallel
    trainers install theirs), as the JAX package's BatchNorm is inside a
    mesh program. ``num_devices`` is accepted for API parity."""

    def __init__(self, in_channels=0, num_devices=None, momentum=0.9,
                 epsilon=1e-5, center=True, scale=True,
                 use_global_stats=False, beta_initializer="zeros",
                 gamma_initializer="ones",
                 running_mean_initializer="zeros",
                 running_variance_initializer="ones", **kwargs):
        super().__init__(1, momentum, epsilon, center, scale,
                         use_global_stats, beta_initializer,
                         gamma_initializer, running_mean_initializer,
                         running_variance_initializer, in_channels,
                         **kwargs)
        self._num_devices = num_devices


class PixelShuffle1D(HybridBlock):
    """(N, C*f, W) -> (N, C, W*f) sub-pixel upsampling (reference:
    contrib/nn/basic_layers.py PixelShuffle1D)."""

    def __init__(self, factor):
        super().__init__()
        self._factor = int(factor)

    def hybrid_forward(self, F, x):
        f = self._factor
        x = F.Reshape(x, shape=(0, -4, -1, f, 0))   # (N, C, f, W)
        x = F.transpose(x, axes=(0, 1, 3, 2))       # (N, C, W, f)
        return F.Reshape(x, shape=(0, 0, -3))       # (N, C, W*f)

    def __repr__(self):
        return "{}({})".format(self.__class__.__name__, self._factor)


class PixelShuffle2D(HybridBlock):
    """(N, C*f1*f2, H, W) -> (N, C, H*f1, W*f2)."""

    def __init__(self, factor):
        super().__init__()
        self._factors = _factors(factor, 2)

    def hybrid_forward(self, F, x):
        f1, f2 = self._factors
        x = F.Reshape(x, shape=(0, -4, -1, f1 * f2, 0, 0))
        x = F.Reshape(x, shape=(0, 0, -4, f1, f2, 0, 0))
        x = F.transpose(x, axes=(0, 1, 4, 2, 5, 3))
        return F.Reshape(x, shape=(0, 0, -3, -3))

    def __repr__(self):
        return "{}({})".format(self.__class__.__name__, self._factors)


class PixelShuffle3D(HybridBlock):
    """(N, C*f1*f2*f3, D, H, W) -> (N, C, D*f1, H*f2, W*f3)."""

    def __init__(self, factor):
        super().__init__()
        self._factors = _factors(factor, 3)

    def hybrid_forward(self, F, x):
        f1, f2, f3 = self._factors
        x = F.Reshape(x, shape=(0, -4, -1, f1 * f2 * f3, 0, 0, 0))
        x = F.Reshape(x, shape=(0, 0, -4, f1, -1, 0, 0, 0))
        x = F.Reshape(x, shape=(0, 0, 0, -4, f2, f3, 0, 0, 0))
        # (N, C, f1, f2, f3, D, H, W) -> (N, C, D, f1, H, f2, W, f3)
        x = F.transpose(x, axes=(0, 1, 5, 2, 6, 3, 7, 4))
        return F.Reshape(x, shape=(0, 0, -3, -3, -3))

    def __repr__(self):
        return "{}({})".format(self.__class__.__name__, self._factors)
