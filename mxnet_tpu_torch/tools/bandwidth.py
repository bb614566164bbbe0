"""KVStore push/pull bandwidth probe (counterpart of
``mxnet_tpu/tools/bandwidth.py``; reference tools/bandwidth/measure.py,
the harness behind BASELINE.md's second metric).

Measures the aggregate GB/s of repeated push + pull rounds over
layer-sized arrays (by default the weight shapes of a model-zoo network)
with the reference's accounting, and checks the reduced values. The
arrays live on the current context (``gpu(0)`` unless the caller asks
for the CPU).

Run: ``python -m mxnet_tpu_torch.tools.bandwidth --network resnet18_v1
--num-batches 5``.
"""
from __future__ import annotations

import argparse
import logging
import time

import numpy as np

__all__ = ["measure", "main"]


def _layer_shapes(network, num_classes, image_shape):
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.model_zoo import vision
    net = getattr(vision, network)(classes=num_classes)
    net.initialize(mx.init.Xavier())
    c, h, w = image_shape
    net(mx.nd.zeros((1, c, h, w)))
    return [tuple(p.data().shape) for p in net.collect_params().values()]


def measure(shapes, kv_type="local", num_workers=2, num_batches=5,
            test_results=True, optimizer=None, gc_type="none"):
    """One result row per batch: a dict with the error count and GB/s.
    The reference's accounting: each push moves every worker's copy once
    and each pull moves the merged value back, so one round is
    ``2 * total_bytes`` per worker copy."""
    import mxnet_tpu_torch as mx
    kv = mx.kv.create(kv_type)
    if gc_type != "none":
        kv.set_gradient_compression({"type": gc_type})
    if optimizer:
        kv.set_optimizer(mx.optimizer.create(optimizer))
    for i, s in enumerate(shapes):
        kv.init(i, mx.nd.zeros(s))
    total_bytes = sum(int(np.prod(s)) * 4 for s in shapes)
    results = []
    for b in range(num_batches):
        t0 = time.time()
        errors = 0
        pending = []
        for i, s in enumerate(shapes):
            vals = [mx.nd.ones(s) * (w + 1) for w in range(num_workers)]
            outs = [mx.nd.zeros(s) for _ in range(num_workers)]
            kv.push(i, vals)
            kv.pull(i, out=outs)
            pending.extend(outs)
            if test_results and optimizer is None:
                want = sum(w + 1 for w in range(num_workers))
                if not np.allclose(outs[0].asnumpy(), want):
                    errors += 1
        # wait on EVERY key's outputs before the end timestamp
        for o in pending:
            o.wait_to_read()
        dt = time.time() - t0
        gbps = 2 * total_bytes * num_workers / dt / 1e9
        # unrounded: a small payload over a slow batch is a few kB/s,
        # which six decimals of GB/s would read as 0; main() rounds
        # where it logs
        results.append({"batch": b, "error": errors, "time_s": dt,
                        "bandwidth_gbps": gbps})
    return results


def main(argv=None):
    p = argparse.ArgumentParser(
        description="benchmark kvstore push/pull bandwidth")
    p.add_argument("--network", type=str, default="resnet18_v1")
    p.add_argument("--num-workers", type=int, default=2,
                   help="simulated worker copies per key")
    p.add_argument("--kv-store", type=str, default="local")
    p.add_argument("--num-batches", type=int, default=5)
    p.add_argument("--test-results", type=int, default=1)
    p.add_argument("--image-shape", type=str, default="3,32,32")
    p.add_argument("--num-classes", type=int, default=10)
    p.add_argument("--optimizer", type=str, default="None")
    p.add_argument("--gc-type", type=str, default="none")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    shapes = _layer_shapes(args.network, args.num_classes,
                           tuple(int(x) for x in
                                 args.image_shape.split(",")))
    results = measure(
        shapes, kv_type=args.kv_store, num_workers=args.num_workers,
        num_batches=args.num_batches,
        test_results=bool(args.test_results),
        optimizer=None if args.optimizer == "None" else args.optimizer,
        gc_type=args.gc_type)
    for r in results:
        logging.info("iter %d: %.3f GB/s, %d errors, %.4f s",
                     r["batch"], r["bandwidth_gbps"], r["error"],
                     r["time_s"])
    return results


if __name__ == "__main__":
    main()
