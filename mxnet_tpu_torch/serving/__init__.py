"""Stateful autoregressive serving on PyTorch/CUDA (counterpart of
``mxnet_tpu/serving``): the decode server (its fixed program set as
CUDA graphs on the card), its paged KV pool, the reference model and the
fleet router over several decode servers:

    model = ToyDecoderLM(vocab=50257, n_layers=12, n_heads=12,
                         head_dim=64, d_ff=3072, max_len=1024)
    params = model.init_params(seed=0)                  # on cuda:0
    with DecodeServer(model, params, seq_ladder=[64, 128]) as srv:
        srv.warmup()                                    # the graphs
        req = srv.submit(prompt_tokens, max_new_tokens=32)
        for tok in req.tokens():                        # streams live
            ...

    router = Router([DecodeServer(model, params, ...) for _ in range(2)])
    req = router.submit(prompt_tokens, tenant="acme")   # fails over

The one-shot ``InferenceServer`` waits for a later slice.
"""
from .server import (ServerOverloadedError, RequestTimeoutError,
                     ServerClosedError, validate_priority)
from .kvcache import KVCachePool
from .decode import DecodeServer, DecodeRequest, ToyDecoderLM
from .convert import params_from_numpy
from .fleet import FleetMonitor, Replica
from .router import Router, RouterRequest
from ..bucketing.ladder import BucketLadder

__all__ = ["ServerOverloadedError", "RequestTimeoutError",
           "ServerClosedError", "validate_priority", "KVCachePool",
           "DecodeServer", "DecodeRequest", "ToyDecoderLM",
           "params_from_numpy", "FleetMonitor", "Replica", "Router",
           "RouterRequest", "BucketLadder"]
