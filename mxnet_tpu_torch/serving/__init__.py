"""Stateful autoregressive serving on PyTorch/CUDA (counterpart of
``mxnet_tpu/serving``); this slice ports the decode server, its paged
KV pool and the reference model:

    model = ToyDecoderLM(vocab=50257, n_layers=12, n_heads=12,
                         head_dim=64, d_ff=3072, max_len=1024)
    params = model.init_params(seed=0)                  # on cuda:0
    with DecodeServer(model, params, seq_ladder=[64, 128]) as srv:
        req = srv.submit(prompt_tokens, max_new_tokens=32)
        for tok in req.tokens():                        # streams live
            ...

The one-shot ``InferenceServer`` and the fleet ``Router`` wait for
later slices.
"""
from .server import (ServerOverloadedError, RequestTimeoutError,
                     ServerClosedError, validate_priority)
from .kvcache import KVCachePool
from .decode import DecodeServer, DecodeRequest, ToyDecoderLM
from .convert import params_from_numpy
from ..bucketing.ladder import BucketLadder

__all__ = ["ServerOverloadedError", "RequestTimeoutError",
           "ServerClosedError", "validate_priority", "KVCachePool",
           "DecodeServer", "DecodeRequest", "ToyDecoderLM",
           "params_from_numpy", "BucketLadder"]
