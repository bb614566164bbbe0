"""SequentialModule — chain modules head to tail (counterpart of
``mxnet_tpu/module/sequential_module.py``; reference:
python/mxnet/module/sequential_module.py). Each child's outputs feed the
next child's data; the gradients flow back through
``get_input_grads``, so every child after the first binds with
``inputs_need_grad`` when training (a child Module then takes the eager
step, counted in ``fused_step_fallbacks``)."""
from __future__ import annotations

import logging

from ..base import MXNetError
from ..initializer import Uniform
from .base_module import BaseModule

__all__ = ["SequentialModule"]


class SequentialModule(BaseModule):
    """Container running child modules in order; each child's outputs
    feed the next child's data (reference: sequential_module.py:33).
    Add children with :meth:`add`; pass ``take_labels=True`` for the
    (usually last) module that consumes the labels."""

    META_TAKE_LABELS = "take_labels"
    META_AUTO_WIRING = "auto_wiring"

    def __init__(self, logger=logging):
        super().__init__(logger=logger)
        self._modules = []
        self._metas = []
        self._label_shapes = None
        self._data_shapes = None

    def add(self, module, **kwargs):
        if self.binded:
            raise MXNetError(
                "add() must be called before bind()")
        for key in kwargs:
            if key not in (self.META_TAKE_LABELS, self.META_AUTO_WIRING):
                raise MXNetError("unknown meta key %s" % key)
        self._modules.append(module)
        self._metas.append(dict(kwargs))
        return self

    # -- introspection ----------------------------------------------------
    @property
    def data_names(self):
        return self._modules[0].data_names if self._modules else []

    @property
    def output_names(self):
        return self._modules[-1].output_names if self._modules else []

    @property
    def data_shapes(self):
        assert self.binded
        return self._modules[0].data_shapes

    @property
    def label_shapes(self):
        assert self.binded
        return self._label_shapes

    @property
    def output_shapes(self):
        assert self.binded
        return self._modules[-1].output_shapes

    # -- parameters -------------------------------------------------------
    def get_params(self):
        assert self.binded and self.params_initialized
        args, auxs = {}, {}
        for m in self._modules:
            a, x = m.get_params()
            args.update(a)
            auxs.update(x)
        return args, auxs

    def init_params(self, initializer=Uniform(0.01), arg_params=None,
                    aux_params=None, allow_missing=False,
                    force_init=False, allow_extra=False):
        if self.params_initialized and not force_init:
            return
        assert self.binded
        for m in self._modules:
            m.init_params(initializer=initializer, arg_params=arg_params,
                          aux_params=aux_params,
                          allow_missing=allow_missing,
                          force_init=force_init, allow_extra=True)
        self.params_initialized = True

    # -- binding ----------------------------------------------------------
    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False,
             shared_module=None, grad_req="write"):
        if self.binded and not force_rebind:
            return
        if not self._modules:
            raise MXNetError("SequentialModule has no modules added")
        self._label_shapes = label_shapes
        cur_shapes = data_shapes
        n = len(self._modules)
        for i, (m, meta) in enumerate(zip(self._modules, self._metas)):
            labels = label_shapes if meta.get(self.META_TAKE_LABELS) \
                else None
            need_grad = inputs_need_grad if i == 0 \
                else for_training          # grads flow between stages
                                           # only when training
            m.bind(cur_shapes, labels, for_training=for_training,
                   inputs_need_grad=need_grad,
                   force_rebind=force_rebind, grad_req=grad_req)
            if i < n - 1:
                out_shapes = [(o[0], o[1]) if isinstance(o, tuple)
                              else (o.name, o.shape)
                              for o in m.output_shapes]
                in_names = self._modules[i + 1].data_names
                if len(in_names) != len(out_shapes):
                    raise MXNetError(
                        "module %d feeds %d outputs into module %d "
                        "which wants %d inputs"
                        % (i, len(out_shapes), i + 1, len(in_names)))
                from ..io.io import DataDesc
                cur_shapes = [DataDesc(name, shape) for name, (_, shape)
                              in zip(in_names, out_shapes)]
        self.binded = True
        self.for_training = for_training

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        assert self.binded and self.params_initialized
        for m in self._modules:
            m.init_optimizer(kvstore=kvstore, optimizer=optimizer,
                             optimizer_params=optimizer_params,
                             force_init=force_init)
        self.optimizer_initialized = True

    # -- compute ----------------------------------------------------------
    def forward(self, data_batch, is_train=None):
        assert self.binded and self.params_initialized
        from ..io.io import DataBatch
        batch = data_batch
        for i, m in enumerate(self._modules):
            m.forward(batch, is_train=is_train)
            if i == len(self._modules) - 1:
                break
            outs = m.get_outputs()
            batch = DataBatch(outs, data_batch.label)

    def backward(self, out_grads=None):
        assert self.binded
        grads = out_grads
        for i, m in reversed(list(enumerate(self._modules))):
            m.backward(out_grads=grads)
            if i == 0:
                break
            grads = m.get_input_grads()

    def update(self):
        for m in self._modules:
            m.update()

    def get_outputs(self, merge_multi_context=True):
        return self._modules[-1].get_outputs(merge_multi_context)

    def get_input_grads(self, merge_multi_context=True):
        assert self.binded
        return self._modules[0].get_input_grads(merge_multi_context)

    def update_metric(self, eval_metric, labels, pre_sliced=False):
        takers = [m for m, meta in zip(self._modules, self._metas)
                  if meta.get(self.META_TAKE_LABELS)]
        if takers:
            for m in takers:
                m.update_metric(eval_metric, labels, pre_sliced)
        else:
            # no module claimed labels: score against the tail output
            eval_metric.update(labels, self.get_outputs())

    def install_monitor(self, mon):
        for m in self._modules:
            m.install_monitor(mon)
