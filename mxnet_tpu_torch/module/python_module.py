"""PythonModule / PythonLossModule — module bodies written in Python
(counterpart of ``mxnet_tpu/module/python_module.py``; reference:
python/mxnet/module/python_module.py)."""
from __future__ import annotations

import logging

import numpy as np

from ..base import MXNetError
from .base_module import BaseModule

__all__ = ["PythonModule", "PythonLossModule"]


class PythonModule(BaseModule):
    """A module whose compute is written in Python against NDArrays —
    for gluing non-gradient components (losses computed on the side,
    metrics plumbing, data transforms) into a module pipeline
    (reference: python_module.py:30). Parameterless by default."""

    def __init__(self, data_names, label_names, output_names,
                 logger=logging):
        super().__init__(logger=logger)
        self._data_names = list(data_names)
        self._label_names = list(label_names or [])
        self._output_names = list(output_names)
        self._data_shapes = None
        self._label_shapes = None
        self._output_shapes = None

    # -- introspection ----------------------------------------------------
    @property
    def data_names(self):
        return self._data_names

    @property
    def output_names(self):
        return self._output_names

    @property
    def data_shapes(self):
        return self._data_shapes

    @property
    def label_shapes(self):
        return self._label_shapes

    @property
    def output_shapes(self):
        return self._output_shapes

    # -- parameters (none by default) -------------------------------------
    def get_params(self):
        return ({}, {})

    def init_params(self, initializer=None, arg_params=None,
                    aux_params=None, allow_missing=False,
                    force_init=False, allow_extra=False):
        self.params_initialized = True

    def update(self):
        pass

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        self.optimizer_initialized = True

    # -- binding ----------------------------------------------------------
    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False,
             shared_module=None, grad_req="write"):
        if self.binded and not force_rebind:
            self.logger.warning("Already bound, ignoring bind()")
            return
        self._data_shapes = data_shapes
        self._label_shapes = label_shapes
        self._output_shapes = self._compute_output_shapes()
        self.binded = True
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad

    def _compute_output_shapes(self):
        """Subclasses say what comes out given self._data_shapes."""
        raise NotImplementedError()

    def update_metric(self, eval_metric, labels, pre_sliced=False):
        if self._label_shapes is not None:
            raise NotImplementedError(
                "modules declaring labels must override update_metric")


class PythonLossModule(PythonModule):
    """Tail module computing a loss + input gradients in Python
    (reference: python_module.py:190). ``grad_func(scores, labels)``
    returns d loss / d scores as an NDArray."""

    def __init__(self, name="pyloss", data_names=("data",),
                 label_names=("softmax_label",), logger=logging,
                 grad_func=None):
        super().__init__(data_names, label_names,
                         [name + "_output"], logger=logger)
        self._name = name
        self._scores = None
        self._labels = None
        self._scores_grad = None
        if grad_func is not None and not callable(grad_func):
            raise MXNetError("grad_func must be callable")
        self._grad_func = grad_func

    def _compute_output_shapes(self):
        return [(self._name + "_output", self._data_shapes[0].shape)]

    def forward(self, data_batch, is_train=None):
        self._scores = data_batch.data[0]
        if data_batch.label:
            self._labels = data_batch.label[0]

    def get_outputs(self, merge_multi_context=True):
        return [self._scores]

    def backward(self, out_grads=None):
        if out_grads is not None:
            raise MXNetError(
                "PythonLossModule is a pipeline tail; it accepts no "
                "upstream gradient")
        if self._grad_func is not None:
            self._scores_grad = self._grad_func(self._scores,
                                                self._labels)
            return
        # default: cross-entropy-style grad of softmax scores
        from .. import ndarray as nd
        scores = self._scores.asnumpy()
        labels = self._labels.asnumpy().astype(np.int64).reshape(-1)
        grad = scores.copy()
        grad[np.arange(grad.shape[0]), labels] -= 1.0
        self._scores_grad = nd.array(grad / grad.shape[0])

    def get_input_grads(self, merge_multi_context=True):
        return [self._scores_grad]

    def install_monitor(self, mon):
        raise NotImplementedError()
