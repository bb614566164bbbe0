"""Multi-head attention block (counterpart of
``mxnet_tpu/gluon/contrib/nn/attention.py``): query/key/value/out
projections around ``_contrib_flash_attention``, which runs the CUDA
flash kernels (forward and backward) on a CUDA tensor. Parameter names
match the JAX block's (``<prefix>query_weight`` and its siblings)."""
from __future__ import annotations

from ...block import HybridBlock
from ...nn.basic_layers import Dense

__all__ = ["MeshMultiHeadAttention"]


class MeshMultiHeadAttention(HybridBlock):
    """Multi-head attention over (B, T, C) inputs.

    Parameters
    ----------
    units : int
        Model width C (must divide by ``num_heads``).
    num_heads : int
    causal : bool
    impl : str
        'auto' | 'flash' | 'dense' | 'ring' | 'ulysses' — forwarded to
        ``_contrib_flash_attention`` (ring and Ulysses run over the ``sp``
        axis of the active mesh, ``parallel.use_mesh``, each rank on its
        sequence slice).
    use_bias : bool
    """

    def __init__(self, units, num_heads, causal=False, impl="auto",
                 use_bias=True, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        if units % num_heads:
            raise ValueError("units %d not divisible by num_heads %d"
                             % (units, num_heads))
        self._units = units
        self._num_heads = num_heads
        self._causal = causal
        self._impl = impl
        with self.name_scope():
            self.query_proj = Dense(units, use_bias=use_bias,
                                    flatten=False, prefix="query_")
            self.key_proj = Dense(units, use_bias=use_bias,
                                  flatten=False, prefix="key_")
            self.value_proj = Dense(units, use_bias=use_bias,
                                    flatten=False, prefix="value_")
            self.out_proj = Dense(units, use_bias=use_bias,
                                  flatten=False, prefix="out_")

    def hybrid_forward(self, F, query, key=None, value=None):
        key = query if key is None else key
        value = key if value is None else value
        H = self._num_heads
        D = self._units // H
        q = F.reshape(self.query_proj(query), shape=(0, 0, H, D))
        k = F.reshape(self.key_proj(key), shape=(0, 0, H, D))
        v = F.reshape(self.value_proj(value), shape=(0, 0, H, D))
        o = F._contrib_flash_attention(q, k, v, causal=self._causal,
                                       impl=self._impl)
        return self.out_proj(F.reshape(o, shape=(0, 0, self._units)))
