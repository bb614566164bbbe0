"""The legacy contrib autograd API (counterpart of
``mxnet_tpu/contrib/autograd.py``; reference:
python/mxnet/contrib/autograd.py): the pre-1.0 surface kept for old
scripts, thin shims over :mod:`mxnet_tpu_torch.autograd`."""
from __future__ import annotations

import functools

from .. import autograd as _ag

__all__ = ["set_is_training", "train_section", "test_section",
           "mark_variables", "backward", "compute_gradient",
           "grad_and_loss", "grad"]


def set_is_training(is_train):
    """The legacy global switch; returns the previous value."""
    prev = _ag.is_training()
    if bool(is_train) != prev:
        _ag.set_training(bool(is_train))
    return prev


def train_section():
    """``with train_section():`` records and runs in train mode."""
    return _ag.record(train_mode=True)


def test_section():
    """``with test_section():`` records in predict mode."""
    return _ag.record(train_mode=False)


def mark_variables(variables, gradients, grad_reqs="write"):
    return _ag.mark_variables(variables, gradients, grad_reqs)


def backward(outputs, out_grads=None, retain_graph=False):
    return _ag.backward(outputs, head_grads=out_grads,
                        retain_graph=retain_graph)


def compute_gradient(outputs):
    backward(outputs)


def grad_and_loss(func, argnum=None):
    """A function returning the gradients of ``func``'s arguments (those
    of ``argnum``) and its value (reference: contrib/autograd.py:163)."""
    @functools.wraps(func)
    def wrapped(*args):
        variables = list(args)
        if argnum is not None:
            argnums = [argnum] if isinstance(argnum, int) else argnum
            variables = [args[i] for i in argnums]
        grads = [x.zeros_like() for x in variables]
        mark_variables(variables, grads)
        with train_section():
            outputs = func(*args)
        backward([outputs] if not isinstance(outputs, (list, tuple))
                 else list(outputs))
        return grads, outputs
    return wrapped


def grad(func, argnum=None):
    """The gradient-only form of :func:`grad_and_loss`."""
    grad_with_loss_func = grad_and_loss(func, argnum)

    @functools.wraps(grad_with_loss_func)
    def wrapped(*args):
        return grad_with_loss_func(*args)[0]
    return wrapped
