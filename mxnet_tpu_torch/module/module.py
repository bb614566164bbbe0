"""Module — a Symbol bound to one executor (counterpart of
``mxnet_tpu/module/module.py``).

``bind`` infers every shape from the data and label shapes and binds
the symbol through :class:`~mxnet_tpu_torch.executor.Executor` on one
device (``gpu(0)`` unless the module's context says otherwise).
``forward(is_train=True)`` runs the training forward under torch
autograd and ``backward`` its gradients; ``forward(is_train=False)`` is
the executor's predict run (a CUDA graph per input signature on the
card). ``update`` is the per-parameter ``Updater`` loop, in place (the
JAX package's fused step is bit-exact with that loop; the port's fused
step waits for ROADMAP queue A item 10). Parameters are written into
the bound arrays in place (``set_params``/``init_params``), so the
predict graph keeps replaying.

``group2ctxs`` places the symbol's ``ctx_group`` segments on their
devices (:mod:`~mxnet_tpu_torch.placement`).

Not ported: a multi-device context list and the kvstore (item 12),
``save_optimizer_states`` /
``load_optimizer_states`` (item 10; the JAX package pickles its own
NDArray classes, which the port cannot read).
"""
from __future__ import annotations

import logging

import torch

from .. import ndarray as nd
from ..context import Context, current_context
from ..initializer import Uniform, InitDesc
from .. import optimizer as opt
from ..model import (_create_kvstore, _update_params, load_checkpoint,
                     save_checkpoint)
from .base_module import (BaseModule, _check_input_names, _not_ported,
                          _parse_data_desc)

__all__ = ["Module"]


def _names_or_empty(names):
    return list(names) if names is not None else []


class Module(BaseModule):
    """Symbolic training and inference module (reference:
    module.py:42). ``context`` defaults to the current context
    (``gpu(0)`` unless the caller asks for the CPU)."""

    def __init__(self, symbol, data_names=("data",),
                 label_names=("softmax_label",), logger=logging,
                 context=None, work_load_list=None,
                 fixed_param_names=None, state_names=None,
                 group2ctxs=None, compression_params=None):
        super().__init__(logger=logger)
        context = current_context() if context is None else context
        self._context = [context] if isinstance(context, Context) \
            else list(context)
        self._symbol = symbol
        roles = {"data": _names_or_empty(data_names),
                 "label": _names_or_empty(label_names),
                 "state": _names_or_empty(state_names),
                 "fixed_param": _names_or_empty(fixed_param_names)}
        for role, names in roles.items():
            _check_input_names(symbol, names, role, role != "label")
        self._data_names = roles["data"]
        self._label_names = roles["label"]
        self._state_names = roles["state"]
        self._fixed_param_names = roles["fixed_param"]
        bound_inputs = set(self._data_names) | set(self._label_names) \
            | set(self._state_names)
        self._param_names = [a for a in symbol.list_arguments()
                             if a not in bound_inputs]
        self._aux_names = symbol.list_auxiliary_states()
        self._output_names = symbol.list_outputs()
        self._arg_params = self._aux_params = None
        self._params_dirty = False
        self._group2ctxs = group2ctxs
        self._optimizer = self._kvstore = self._updater = None
        self._exec = None

    # -- checkpointing -----------------------------------------------------
    @staticmethod
    def load(prefix, epoch, load_optimizer_states=False, **kwargs):
        """A module over ``prefix-symbol.json`` with the parameters of
        ``epoch`` (a manifest checkpoint or the single file), set at
        ``bind``."""
        if load_optimizer_states:
            _not_ported("Module.load(load_optimizer_states=True)")
        sym, args, auxs = load_checkpoint(prefix, epoch)
        mod = Module(symbol=sym, **kwargs)
        mod._arg_params, mod._aux_params = args, auxs
        mod.params_initialized = True
        return mod

    def save_checkpoint(self, prefix, epoch, save_optimizer_states=False,
                        remove_amp_cast=True):
        """``prefix-symbol.json`` and the single-file
        ``prefix-%04d.params`` (``model.save_checkpoint``), which both
        packages load; the manifest writer waits for ROADMAP queue A
        item 10."""
        if save_optimizer_states:
            _not_ported("save_checkpoint(save_optimizer_states=True)")
        arg_params, aux_params = self.get_params()
        save_checkpoint(prefix, epoch, self._symbol, arg_params, aux_params)
        logging.info('Saved checkpoint to "%s-%04d.params"', prefix, epoch)

    # -- properties --------------------------------------------------------
    data_names = property(lambda self: self._data_names)
    label_names = property(lambda self: self._label_names)
    output_names = property(lambda self: self._output_names)

    @property
    def data_shapes(self):
        assert self.binded
        return self._data_shapes

    @property
    def label_shapes(self):
        assert self.binded
        return self._label_shapes

    @property
    def output_shapes(self):
        assert self.binded
        outs = self._exec.outputs
        if outs and all(o is not None for o in outs):
            return [(name, o.shape)
                    for name, o in zip(self._output_names, outs)]
        _, out_shapes, _ = self._symbol.infer_shape(**self._feed_shapes())
        return list(zip(self._output_names, map(tuple, out_shapes)))

    def _feed_shapes(self):
        feed = {d.name: tuple(d.shape) for d in self._data_shapes}
        feed.update((d.name, tuple(d.shape))
                    for d in (self._label_shapes or []))
        return feed

    # -- params ------------------------------------------------------------
    def get_params(self):
        assert self.binded and self.params_initialized
        if self._params_dirty:
            self._sync_params_from_devices()
        return self._arg_params, self._aux_params

    def _fill_param(self, name, dst, provided, initializer, attrs,
                    allow_missing):
        """One bound array: the provided value copied in place, else the
        initializer keyed by the symbol's attributes."""
        if provided is not None and name in provided:
            src = provided[name]
            if src is not dst:
                with torch.no_grad():
                    dst._data.copy_(src._data)
            return
        if initializer is None:
            if not allow_missing:
                raise AssertionError(
                    "initializer required when arg/aux not provided")
            return
        initializer(InitDesc(name, attrs.get(name, None)), dst)

    def init_params(self, initializer=Uniform(0.01), arg_params=None,
                    aux_params=None, allow_missing=False, force_init=False,
                    allow_extra=False):
        if self.params_initialized and not force_init:
            return
        assert self.binded, "call bind before initializing the parameters"
        attrs = self._symbol.attr_dict()
        for name in self._param_names:
            self._fill_param(name, self._exec.arg_dict[name], arg_params,
                             initializer, attrs, allow_missing)
        for name in self._aux_names:
            self._fill_param(name, self._exec.aux_dict[name], aux_params,
                             initializer, attrs, allow_missing)
        self.params_initialized = True
        self._sync_params_from_devices()

    def set_params(self, arg_params, aux_params, allow_missing=False,
                   force_init=True, allow_extra=False):
        if not allow_missing:
            self.init_params(initializer=None, arg_params=arg_params,
                             aux_params=aux_params, allow_missing=False,
                             force_init=force_init, allow_extra=allow_extra)
            return
        if self.params_initialized and not force_init:
            return
        self._exec.copy_params_from(arg_params, aux_params,
                                    allow_extra_params=allow_extra)
        self.params_initialized = True
        self._params_dirty = False

    def _sync_params_from_devices(self):
        self._arg_params = {n: self._exec.arg_dict[n].copy()
                            for n in self._param_names}
        self._aux_params = {n: self._exec.aux_dict[n].copy()
                            for n in self._aux_names}
        self._params_dirty = False

    # -- bind --------------------------------------------------------------
    def _grad_req_for(self, name, for_training, inputs_need_grad,
                      grad_req):
        """The write/add/null request for one argument."""
        if not for_training or name in self._fixed_param_names:
            return "null"
        requested = grad_req if isinstance(grad_req, str) \
            else grad_req.get(name, "write")
        if name in self._param_names:
            return requested
        if inputs_need_grad and name in self._data_names:
            return requested
        return "null"            # labels, states

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False,
             shared_module=None, grad_req="write"):
        if force_rebind:
            self._exec = None
            self.binded = False
        if self.binded:
            self.logger.warning("Already binded, ignoring bind()")
            return
        if not for_training:
            assert not inputs_need_grad
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self._data_shapes, self._label_shapes = _parse_data_desc(
            self._data_names, self._label_names, data_shapes, label_shapes)
        arg_shapes, _, aux_shapes = self._symbol.infer_shape(
            **self._feed_shapes())
        arg_names = self._symbol.list_arguments()
        ctx = self._context[0]
        donor = shared_module._exec if shared_module is not None else None

        def buffer_for(name, shape, pool, share_ok):
            if donor is not None and share_ok and name in pool:
                return pool[name]
            return nd.zeros(shape, ctx=ctx)

        args = {name: buffer_for(name, shape,
                                 donor.arg_dict if donor else {},
                                 name in self._param_names)
                for name, shape in zip(arg_names, arg_shapes)}
        aux = {name: buffer_for(name, shape,
                                donor.aux_dict if donor else {}, True)
               for name, shape in zip(self._aux_names, aux_shapes)}
        reqs = {name: self._grad_req_for(name, for_training,
                                         inputs_need_grad, grad_req)
                for name in arg_names}
        grads = {name: nd.zeros(shape, ctx=ctx)
                 for name, shape in zip(arg_names, arg_shapes)
                 if reqs[name] != "null"}
        from ..executor import Executor
        # group2ctxs: the reference takes one group -> context dict per
        # data-parallel replica; one executor takes the first
        g2c = self._group2ctxs
        if isinstance(g2c, (list, tuple)):
            g2c = g2c[0] if g2c else None
        self._exec = Executor(
            self._symbol, self._context, args, grads, reqs, aux,
            batch_args=set(self._data_names) | set(self._label_names),
            group2ctx=g2c)
        self.binded = True
        if shared_module is not None and shared_module.params_initialized:
            self.set_params(*shared_module.get_params())
        elif self.params_initialized:
            # parameters loaded before bind (Module.load)
            self._exec.copy_params_from(self._arg_params, self._aux_params,
                                        allow_extra_params=True)

    # -- optimizer ---------------------------------------------------------
    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        """The optimizer and its per-parameter updater; a name is
        created with ``rescale_grad = 1/batch`` (a loss layer's gradient
        is summed over the batch)."""
        assert self.binded and self.params_initialized
        if self.optimizer_initialized and not force_init:
            self.logger.warning("optimizer already initialized, "
                                "ignoring...")
            return
        if self._params_dirty:
            self._sync_params_from_devices()
        kvstore, _ = _create_kvstore(kvstore, len(self._context),
                                     self._arg_params)
        rescale = 1.0 / self._data_shapes[0].shape[0]
        idx2name = dict(enumerate(self._param_names))
        if isinstance(optimizer, str):
            config = dict(optimizer_params)
            config.setdefault("rescale_grad", rescale)
            optimizer = opt.create(optimizer, sym=self.symbol,
                                   param_idx2name=idx2name, **config)
        else:
            assert isinstance(optimizer, opt.Optimizer)
            if optimizer.rescale_grad != rescale:
                self.logger.warning(
                    "Optimizer created manually outside Module but "
                    "rescale_grad is not normalized to 1.0/batch_size "
                    "(%s vs. %s).", optimizer.rescale_grad, rescale)
            if not optimizer.idx2name:
                optimizer.idx2name = idx2name.copy()
        self._optimizer = optimizer
        self._kvstore = kvstore
        self._updater = opt.get_updater(optimizer)
        self.optimizer_initialized = True

    # -- computation -------------------------------------------------------
    def forward(self, data_batch, is_train=None):
        assert self.binded and self.params_initialized
        if is_train is None:
            is_train = self.for_training
        feed = dict(zip(self._data_names, data_batch.data))
        if self._label_names and data_batch.label:
            feed.update(zip(self._label_names, data_batch.label))
        self._exec.forward(is_train=is_train, **feed)

    def backward(self, out_grads=None):
        assert self.binded and self.params_initialized
        self._exec.backward(out_grads=out_grads)
        self._params_dirty = True

    def update(self):
        """One optimizer step over every parameter with a gradient."""
        assert self.binded and self.params_initialized \
            and self.optimizer_initialized
        from .. import telemetry
        self._params_dirty = True
        with telemetry.span("optimizer"):
            _update_params([self._exec.arg_dict[n] for n in self._param_names],
                           [self._exec.grad_dict.get(n)
                            for n in self._param_names],
                           updater=self._updater)

    def get_outputs(self, merge_multi_context=True):
        assert self.binded and self.params_initialized
        return self._exec.outputs

    def get_input_grads(self, merge_multi_context=True):
        assert self.binded and self.params_initialized \
            and self.inputs_need_grad
        return [self._exec.grad_dict.get(n) for n in self._data_names]

    def get_states(self, merge_multi_context=True):
        assert self.binded and self.params_initialized
        return [self._exec.arg_dict[n] for n in self._state_names]

    def set_states(self, states=None, value=None):
        assert self.binded and self.params_initialized
        for i, name in enumerate(self._state_names):
            self._exec.arg_dict[name][:] = states[i] if states is not None \
                else value

    def update_metric(self, eval_metric, labels, pre_sliced=False):
        eval_metric.update_dict(
            dict(zip(self._label_names, labels)),
            dict(zip(self._output_names, self.get_outputs())))

    def install_monitor(self, mon):
        assert self.binded
        mon.install(self._exec)

    def save_optimizer_states(self, fname):
        _not_ported("Module.save_optimizer_states")

    def load_optimizer_states(self, fname):
        _not_ported("Module.load_optimizer_states")

    def reshape(self, data_shapes, label_shapes=None):
        """Rebind to new input shapes, sharing the parameters."""
        assert self.binded
        self._data_shapes, self._label_shapes = _parse_data_desc(
            self._data_names, self._label_names, data_shapes, label_shapes)
        self._exec = self._exec.reshape(**self._feed_shapes())
