"""The spread of phase 17 (c) on the card: one bfloat16 Module step
against one bfloat16 Gluon step (``chip_smoke.amp_gluon_vs_module``)
from the weights of several seeds, with cuDNN free and deterministic,
and, as the floor, two bfloat16 Module steps from the same weights (the
card's own run-to-run spread with cuDNN free). Prints each worst step
error; phase 17 holds (c) at ``AMP_STEP_REL``, set from these.

    python3 scratch/amp_step_spread.py
"""
import os
import sys
from contextlib import nullcontext

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as c  # noqa: E402


def module_twice(mx, x, y, seed):
    """Two bf16 Module steps from the same weights: the worst master
    step difference over the step's largest entry."""
    from mxnet_tpu_torch.amp import DtypePolicy
    feed = mx.io.DataBatch(data=[mx.nd.array(x)], label=[mx.nd.array(y)])
    ends = []
    for _ in range(2):
        mod = c.amp_module(mx, c.amp_resnet(mx, c.MODULE_BENCH[2]), x,
                           DtypePolicy("bfloat16"), seed=seed,
                           opt=dict(c.MODULE_STEP_SGD,
                                    multi_precision=True))
        # a master starts as its bf16 weight's float32 value
        before = {n: mod._exec.arg_dict[n]._data.float().clone()
                  for n in mod._param_names}
        mod.forward_backward(feed)
        mod.update()
        masters = c.masters_of(mod)
        # by position: each Module's net has its own name prefix
        ends.append([masters[n] - before[n] for n in mod._param_names
                     if n in masters])
        del mod
        torch.cuda.empty_cache()
    return max(float((a - b).abs().max()) / (float(b.abs().max()) or 1.0)
               for a, b in zip(*ends))


def main():
    import mxnet_tpu_torch as mx
    card = c.phase_device()
    c.AMP_STEP_REL = float("inf")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    batch, image, classes = c.MODULE_BENCH
    # phase 17's data: the first batch of phase 14's images and labels
    rs = np.random.RandomState(70)
    x = rs.randn(c.MODULE_IMAGES, 3, image, image).astype(np.float32)
    y = rs.randint(0, classes, c.MODULE_IMAGES).astype(np.float32)
    x, y = x[:batch], y[:batch]
    for det in (False, True):
        for seed in (1, 2, 3, 4):
            with c.deterministic_cudnn() if det else nullcontext():
                got = c.amp_gluon_vs_module(mx, x, y, seed)
            print("seed %d, %s: Module vs Gluon %s"
                  % (seed, "deterministic" if det else "cuDNN free", got))
            torch.cuda.empty_cache()
    with c.deterministic_cudnn():
        print("seed 1, deterministic, again: Module vs Gluon %s"
              % (c.amp_gluon_vs_module(mx, x, y, 1),))
    torch.cuda.empty_cache()
    for det in (False, True):
        with c.deterministic_cudnn() if det else nullcontext():
            print("seed 1, %s: Module vs Module %.4g"
                  % ("deterministic" if det else "cuDNN free",
                     module_twice(mx, x, y, 1)))
        torch.cuda.empty_cache()
    print("card:", card)


if __name__ == "__main__":
    main()
