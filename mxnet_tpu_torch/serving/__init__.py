"""Stateful autoregressive serving on PyTorch/CUDA (counterpart of
``mxnet_tpu/serving``): the continuous-batching inference server, the
decode server (its fixed program set as
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

One-shot requests over a deploy artifact's bucket ladder (or an
in-process batched callable) go through the continuous-batching
``InferenceServer`` (one CUDA graph per ladder bucket on the card):

    pred = mx.deploy.load_compiled("model.mxp")      # on cuda:0
    with serving.InferenceServer(pred, max_queue=256) as srv:
        srv.warmup()                                 # the graphs
        y = srv.submit(x).result(timeout=1.0)        # one sample
"""
from .batcher import BucketLadder, pad_batch, slice_rows
from .server import (InferenceServer, ServerOverloadedError,
                     RequestTimeoutError, ServerClosedError,
                     validate_priority)
from .kvcache import KVCachePool
from .decode import DecodeServer, DecodeRequest, ToyDecoderLM
from .convert import params_from_numpy
from .fleet import FleetMonitor, Replica
from .router import Router, RouterRequest

__all__ = ["InferenceServer", "pad_batch", "slice_rows",
           "ServerOverloadedError", "RequestTimeoutError",
           "ServerClosedError", "validate_priority", "KVCachePool",
           "DecodeServer", "DecodeRequest", "ToyDecoderLM",
           "params_from_numpy", "FleetMonitor", "Replica", "Router",
           "RouterRequest", "BucketLadder"]
