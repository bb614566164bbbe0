"""How far chip_smoke.py's two Module.fit loss curves spread from run to
run on the card, which sets phase 14's SGD learning rate.

Phase 14 trains ResNet-50 v1 (1000 classes) through Module.fit on 64
random images, batch 32, 224x224, 10 epochs = 20 SGD steps; phase 16
trains AlexNet on 1024 images, batch 512, 5 epochs = 10 steps. Both
check that the mean loss of the last epoch is below the first's. The
weights, data and batch order are the same in every run; cuDNN's free
algorithm choice (atomics in the weight gradients) is not. This prints
each run's loss by epoch: ResNet-50 at several learning rates with
cuDNN free, at the largest one also twice with deterministic
algorithms, and AlexNet at its settings. Run from the repo's root on
one GPU:

    python3 scratch/module_fit_spread.py
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import numpy as np
import torch

import chip_smoke as cs
import mxnet_tpu_torch as mx

RUNS = 3
RATES = (0.1, 0.05, 0.025, 0.0125)


def show(what, epochs, steps, n_finite, fit_s):
    print("%s: loss by epoch %s; last - first %+.4f; finite %d of %d; "
          "%.2f s" % (what, " ".join("%.4f" % v for v in epochs),
                      epochs[-1] - epochs[0], n_finite, steps, fit_s),
          flush=True)


card = cs.phase_device()
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
batch, image, classes = cs.MODULE_BENCH
rs = np.random.RandomState(70)
x = rs.randn(cs.MODULE_IMAGES, 3, image, image).astype(np.float32)
y = rs.randint(0, classes, cs.MODULE_IMAGES).astype(np.float32)
for deterministic in (False, True):
    torch.backends.cudnn.deterministic = deterministic
    for lr in RATES[:1] if deterministic else RATES:
        for run in range(2 if deterministic else RUNS):
            sgd = dict(cs.MODULE_SGD, learning_rate=lr)
            mod, epochs, steps, n_finite = cs.module_fit(
                mx, x, y, batch, card, sgd)
            print("  resnet50 lr %g run %d%s: last - first %+.4f"
                  % (lr, run, ", deterministic" if deterministic else "",
                     epochs[-1] - epochs[0]), flush=True)
            del mod
            torch.cuda.empty_cache()
torch.backends.cudnn.deterministic = False
batch, image, classes = cs.ALEXNET_TRAIN
rs = np.random.RandomState(90)
x = rs.randn(cs.TRAIN_IMAGES, 3, image, image).astype(np.float32)
y = rs.randint(0, cs.TRAIN_LABELS, cs.TRAIN_IMAGES).astype(np.float32)
for run in range(RUNS):
    mod, curve = cs.alexnet_curve(mx, x, y)
    show("alexnet lr %g run %d" % (cs.ALEXNET_SGD["learning_rate"], run),
         *curve)
    del mod
    torch.cuda.empty_cache()
print("card:", card)
