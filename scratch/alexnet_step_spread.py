"""The rounding spread of one AlexNet SGD step on the card, which sets
chip_smoke.py's ALEXNET_STEP_REL.

At batch 512, 224x224, 1000 classes, fp32 with TF32 off, from the same
weights, batch and Dropout seed, it prints each weight's step difference
(the largest entry's share, and the norm's) between two Gluon steps
through cuDNN (free, then deterministic algorithms) and between a Gluon
step through cuDNN and one through torch's native convolutions; then
runs chip_smoke.alexnet_vs_gluon (the Module step against the Gluon
step). Run from the repo's root on one GPU:

    python3 scratch/alexnet_step_spread.py
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import numpy as np
import torch

import chip_smoke as cs
import mxnet_tpu_torch as mx
from mxnet_tpu_torch.gluon.model_zoo import vision

batch, image, classes = cs.ALEXNET_TRAIN
rs = np.random.RandomState(90)
x = rs.randn(batch, 3, image, image).astype(np.float32)
y = rs.randint(0, cs.TRAIN_LABELS, batch).astype(np.float32)


def gluon_step():
    """Each weight's step of one Gluon SGD step, by structural name."""
    mx.random.seed(2)
    net = vision.alexnet(classes=classes)
    net.initialize(mx.init.Xavier())
    net(mx.nd.zeros((1,) + x.shape[1:]))
    params = net._collect_params_with_prefix()
    old = {n: p.data()._data.detach().clone() for n, p in params.items()}
    trainer = mx.gluon.Trainer(net.collect_params(), "sgd", cs.ALEXNET_SGD)
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    data, label = mx.nd.array(x), mx.nd.array(y)
    mx.random.seed(3)
    with mx.autograd.record():
        loss = loss_fn(net(data), label)
    loss.backward()
    trainer.step(batch)
    return {n: p.data()._data.detach() - old[n] for n, p in params.items()}


def spread(what, a, b):
    rows = {n: (float((a[n] - b[n]).abs().max() / a[n].abs().max()),
                float((a[n] - b[n]).norm() / a[n].norm())) for n in a}
    print("%s: worst of largest entry %.3g, worst of norm %.3g" % (
        what, max(r[0] for r in rows.values()),
        max(r[1] for r in rows.values())))
    for n, (top, norm) in rows.items():
        print("    %-20s %.3g %.3g" % (n, top, norm))


cs.phase_device()
spread("cuDNN vs cuDNN", gluon_step(), gluon_step())
torch.backends.cudnn.deterministic = True
spread("cuDNN vs cuDNN, deterministic", gluon_step(), gluon_step())
a = gluon_step()
torch.backends.cudnn.enabled = False
b = gluon_step()
torch.backends.cudnn.enabled = True
spread("cuDNN (deterministic) vs native", a, b)
torch.backends.cudnn.deterministic = False
cs.alexnet_vs_gluon(mx, x, y)
