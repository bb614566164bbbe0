"""Optimizers (counterpart of ``mxnet_tpu/optimizer/optimizer.py``):
the ``Optimizer`` base (update counts, lr/wd multipliers), the
registry (``register``/``create``), the ``Updater`` behind
``get_updater``, and the two update rules of this slice, ``SGD`` with
momentum and ``Adam``. Each update runs in place on the weight and its
states under ``torch.no_grad`` with the JAX update ops' arithmetic
(``ops/optimizer_ops.py``):

- SGD: ``g = clip(rescale * grad)``, ``mom = mu * mom - lr * (g + wd *
  w)``, ``w += mom`` (``w -= lr * (g + wd * w)`` without momentum);
- Adam: ``g = clip(rescale * grad + wd * w)``, ``m = b1 * m + (1 - b1) *
  g``, ``v = b2 * v + (1 - b2) * g^2``, ``w -= lr_t * m / (sqrt(v) +
  eps)``, with the bias correction folded into the step size: ``lr_t =
  lr * sqrt(1 - b2^t) / (1 - b1^t)`` (not ``torch.optim.Adam``'s form).
"""
from __future__ import annotations

import math

import torch

from ..base import MXNetError, Registry

__all__ = ["Optimizer", "SGD", "Adam", "Updater", "get_updater",
           "register", "create"]

_REG = Registry("optimizer", case_sensitive=False)


def register(klass):
    _REG.register(klass.__name__)(klass)
    return klass


class Optimizer:
    """Base optimizer: per-index update counting and lr/wd multiplier
    tables (reference: optimizer.py:37). With ``sym`` (what
    ``Module.init_optimizer`` passes), the symbol's ``__lr_mult__`` and
    ``__wd_mult__`` variable attributes seed the tables."""

    def __init__(self, rescale_grad=1., param_idx2name=None, wd=0.,
                 clip_gradient=None, learning_rate=0.01,
                 lr_scheduler=None, sym=None, begin_num_update=0,
                 multi_precision=False, param_dict=None):
        if param_idx2name is None:
            param_idx2name = {}
        if not isinstance(param_idx2name, dict):
            raise AssertionError("param_idx2name should be a dict of "
                                 "param indexes to names.")
        self.rescale_grad, self.clip_gradient = rescale_grad, clip_gradient
        self.lr, self.wd = learning_rate, wd
        self.lr_scheduler = lr_scheduler
        if lr_scheduler is not None:
            lr_scheduler.base_lr = learning_rate
        self.begin_num_update = self.num_update = begin_num_update
        self._index_update_count = {}
        self.multi_precision = multi_precision
        self.idx2name = dict(param_idx2name)
        self.sym_info = () if sym is None else \
            (sym.attr_dict(), sym.list_arguments())
        self.param_dict = param_dict or {}
        self.set_lr_mult({})
        self.set_wd_mult({})

    def create_state(self, index, weight):
        return None

    def update(self, index, weight, grad, state):
        raise NotImplementedError()

    def set_learning_rate(self, lr):
        if self.lr_scheduler is not None:
            raise UserWarning(
                "LRScheduler of the optimizer has already been defined.")
        self.lr = lr

    def _mults_from_sym(self, attr_key):
        """``{argument: multiplier}`` from the symbol's ``__lr_mult__`` or
        ``__wd_mult__`` variable attributes."""
        if not self.sym_info:
            return {}
        attrs, arg_names = self.sym_info
        return {n: float(attrs[n][attr_key]) for n in arg_names
                if attr_key in attrs.get(n, {})}

    def set_lr_mult(self, args_lr_mult):
        self.lr_mult = self._mults_from_sym("__lr_mult__")
        self.lr_mult.update(args_lr_mult)

    def set_wd_mult(self, args_wd_mult):
        # biases/betas get no decay; weights and norm gammas keep it
        self.wd_mult = {n: 0.0 for n in self.idx2name.values()
                        if not n.endswith(("_weight", "_gamma"))}
        self.wd_mult.update(self._mults_from_sym("__wd_mult__"))
        self.wd_mult.update(args_wd_mult)

    def _update_count(self, index):
        count = self._index_update_count.get(index,
                                             self.begin_num_update) + 1
        self._index_update_count[index] = count
        self.num_update = max(count, self.num_update)

    def _scaled(self, index, base, mult_table, param_attr):
        """``base`` scaled by the param_dict entry, the multiplier table
        or the name-keyed table, in that order."""
        if index in self.param_dict:
            return base * getattr(self.param_dict[index], param_attr)
        if index in mult_table:
            return base * mult_table[index]
        if index in self.idx2name:
            return base * mult_table.get(self.idx2name[index], 1.0)
        return base

    def _get_lr(self, index):
        base = self.lr if self.lr_scheduler is None else \
            self.lr_scheduler(self.num_update)
        return self._scaled(index, base, self.lr_mult, "lr_mult")

    def _get_wd(self, index):
        return self._scaled(index, self.wd, self.wd_mult, "wd_mult")

    def _step_inputs(self, index):
        """(lr, wd) for one index, counting the update."""
        self._update_count(index)
        return self._get_lr(index), self._get_wd(index)

    def _clip(self, g):
        clip = self.clip_gradient
        return g.clamp(-clip, clip) if clip is not None and clip > 0 else g


@register
class SGD(Optimizer):
    """SGD with momentum (reference: optimizer.py:498)."""

    def __init__(self, momentum=0.0, lazy_update=True, **kwargs):
        super().__init__(**kwargs)
        self.momentum, self.lazy_update = momentum, lazy_update

    def create_state(self, index, weight):
        return weight.zeros_like() if self.momentum != 0.0 else None

    def update(self, index, weight, grad, state):
        lr, wd = self._step_inputs(index)
        with torch.no_grad():
            w = weight._data
            g = self._clip(grad._data * self.rescale_grad)
            if self.momentum == 0.0:
                w.sub_(lr * (g + wd * w))
                return
            mom = state._data
            mom.mul_(self.momentum).sub_(lr * (g + wd * w))
            w.add_(mom)


@register
class Adam(Optimizer):
    """Adam with the bias correction folded into the step size
    (reference: optimizer.py:1148)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, lazy_update=True, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self.lazy_update = lazy_update

    def create_state(self, index, weight):
        return (weight.zeros_like(), weight.zeros_like())

    def update(self, index, weight, grad, state):
        lr, wd = self._step_inputs(index)
        t = self._index_update_count[index]
        lr = lr * math.sqrt(1. - self.beta2 ** t) / (1. - self.beta1 ** t)
        b1, b2 = self.beta1, self.beta2
        with torch.no_grad():
            w = weight._data
            mean, var = state[0]._data, state[1]._data
            g = self._clip(grad._data * self.rescale_grad + wd * w)
            mean.mul_(b1).add_((1 - b1) * g)
            var.mul_(b2).add_((1 - b2) * torch.square(g))
            w.sub_(lr * mean / (torch.sqrt(var) + self.epsilon))


def create(name, **kwargs):
    if isinstance(name, Optimizer):
        return name
    cls = _REG.find(str(name))
    if cls is None:
        raise MXNetError("Cannot find optimizer %s" % name)
    return cls(**kwargs)


class Updater:
    """Per-index optimizer state around one Optimizer (reference:
    optimizer.py:1608): the state is made at a parameter's first
    update."""

    def __init__(self, optimizer):
        self.optimizer = optimizer
        self.states = {}

    def __call__(self, index, grad, weight):
        if index not in self.states:
            self.states[index] = self.optimizer.create_state(index, weight)
        self.optimizer.update(index, weight, grad, self.states[index])


def get_updater(optimizer):
    return Updater(optimizer)
