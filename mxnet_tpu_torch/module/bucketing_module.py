"""BucketingModule (counterpart of ``mxnet_tpu/module/bucketing_module.py``;
reference: python/mxnet/module/bucketing_module.py).

Variable-length training with one :class:`~mxnet_tpu_torch.module.
Module` per bucket: ``sym_gen(bucket_key)`` gives each bucket's symbol,
and every bucket but the default binds with ``shared_module=`` the
default bucket's module, so all of them read and write the same
parameter tensors. One optimizer and one ``Updater`` (the optimizer
state) serve every bucket: ``init_optimizer`` hands them to each bound
module, and a bucket bound later borrows them at its first step
(:meth:`_sync_current`), so each bucket's fused step (one CUDA graph
per bucket, captured at the bucket's first step and replayed after)
updates the shared weights and states in place.

:meth:`stats` reports each bucket's graph counters under its
``bucketing:<key>`` site (``bucketing.bucket_site``): captures, replays
and recaptures of the fused step and of the predict graphs. A fit over
a ladder captures once per bucket seen and nothing in a later epoch:
the port's form of the JAX package's ``site_stats("bucketing")``
oracle.
"""
from __future__ import annotations

import logging

from ..bucketing.ladder import bucket_site, bucket_sort_key, format_bucket
from ..initializer import Uniform
from .base_module import BaseModule
from .module import Module

__all__ = ["BucketingModule"]

_NO_GRAPHS = {"captures": 0, "replays": 0, "recaptures": 0,
              "signatures": 0, "dispatches": 0}


def _borrow_optimizer(mod, donor):
    """``mod`` steps with ``donor``'s optimizer and Updater (the
    reference's ``Module.borrow_optimizer``): one optimizer state for
    every bucket."""
    mod._optimizer = donor._optimizer
    mod._updater = donor._updater
    mod._kvstore = donor._kvstore
    mod._update_on_kvstore = donor._update_on_kvstore
    mod.optimizer_initialized = True


class BucketingModule(BaseModule):
    """A module over ``sym_gen(bucket_key) -> (symbol, data_names,
    label_names)`` that switches executors on each batch's
    ``bucket_key``. ``context`` defaults to the current context
    (``gpu(0)`` unless the caller asks for the CPU)."""

    def __init__(self, sym_gen, default_bucket_key=None, logger=logging,
                 context=None, work_load_list=None, fixed_param_names=None,
                 state_names=None, group2ctxs=None, compression_params=None):
        super().__init__(logger=logger)
        assert default_bucket_key is not None
        self._default_bucket_key = default_bucket_key
        self._sym_gen = sym_gen
        self._context = context
        self._work_load_list = work_load_list
        self._fixed_param_names = fixed_param_names
        self._state_names = state_names
        self._group2ctxs = group2ctxs
        self._compression_params = compression_params
        self._buckets = {}
        self._curr_module = None
        self._curr_bucket_key = None
        self._params_dirty = False
        self._monitor = None
        self._grad_req = None

    def _reset_bind(self):
        self.binded = False
        self._buckets = {}
        self._curr_module = None
        self._curr_bucket_key = None

    @property
    def data_names(self):
        if self.binded:
            return self._curr_module.data_names
        _, data_names, _ = self._sym_gen(self._default_bucket_key)
        return data_names

    @property
    def output_names(self):
        if self.binded:
            return self._curr_module.output_names
        symbol, _, _ = self._sym_gen(self._default_bucket_key)
        return symbol.list_outputs()

    @property
    def data_shapes(self):
        assert self.binded
        return self._curr_module.data_shapes

    @property
    def label_shapes(self):
        assert self.binded
        return self._curr_module.label_shapes

    @property
    def output_shapes(self):
        assert self.binded
        return self._curr_module.output_shapes

    @property
    def symbol(self):
        assert self.binded
        return self._curr_module.symbol

    @property
    def _exec(self):
        """The current bucket's executor: the input pipeline places each
        batch on its bound arrays' device (every bucket binds on one
        context)."""
        return self._curr_module._exec if self._curr_module else None

    # -- params ------------------------------------------------------------
    def get_params(self):
        assert self.params_initialized
        self._curr_module._params_dirty = self._params_dirty
        params = self._curr_module.get_params()
        self._params_dirty = False
        return params

    def set_params(self, arg_params, aux_params, allow_missing=False,
                   force_init=True, allow_extra=False):
        if not allow_missing:
            self.init_params(initializer=None, arg_params=arg_params,
                             aux_params=aux_params,
                             allow_missing=allow_missing,
                             force_init=force_init, allow_extra=allow_extra)
            return
        if self.params_initialized and not force_init:
            return
        self._curr_module.set_params(arg_params, aux_params,
                                     allow_missing=allow_missing,
                                     force_init=force_init,
                                     allow_extra=allow_extra)
        for mod in self._buckets.values():
            if mod is not self._curr_module:
                mod.params_initialized = True
        self.params_initialized = True
        self._params_dirty = False

    def init_params(self, initializer=Uniform(0.01), arg_params=None,
                    aux_params=None, allow_missing=False, force_init=False,
                    allow_extra=False):
        if self.params_initialized and not force_init:
            return
        assert self.binded, "call bind before initializing the parameters"
        self._curr_module.init_params(initializer=initializer,
                                      arg_params=arg_params,
                                      aux_params=aux_params,
                                      allow_missing=allow_missing,
                                      force_init=force_init,
                                      allow_extra=allow_extra)
        self._params_dirty = False
        self.params_initialized = True

    # -- bind / switch -----------------------------------------------------
    def _new_module(self, bucket_key):
        symbol, data_names, label_names = self._sym_gen(bucket_key)
        module = Module(symbol, data_names, label_names, logger=self.logger,
                        context=self._context,
                        work_load_list=self._work_load_list,
                        fixed_param_names=self._fixed_param_names,
                        state_names=self._state_names,
                        group2ctxs=self._group2ctxs,
                        compression_params=self._compression_params)
        # the bucket's programs report under its own compile-watch site
        module._bucket_site = bucket_key
        return module

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        assert shared_module is None, \
            "shared_module for BucketingModule is not supported"
        if force_rebind:
            self._reset_bind()
        if self.binded:
            self.logger.warning("Already binded, ignoring bind()")
            return
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self.binded = True
        self._grad_req = grad_req
        module = self._new_module(self._default_bucket_key)
        module.bind(data_shapes, label_shapes, for_training,
                    inputs_need_grad, force_rebind=False,
                    shared_module=None, grad_req=self._grad_req)
        self._curr_module = module
        self._curr_bucket_key = self._default_bucket_key
        self._buckets[self._default_bucket_key] = module

    def switch_bucket(self, bucket_key, data_shapes, label_shapes=None):
        """Make ``bucket_key``'s module current, binding it (sharing the
        default bucket's parameters) the first time."""
        assert self.binded, "call bind before switching bucket"
        if bucket_key not in self._buckets:
            module = self._new_module(bucket_key)
            default = self._buckets[self._default_bucket_key]
            # the donor's cached _arg_params go stale the moment a
            # SIBLING bucket module steps (the live buffers are shared;
            # the caches are not): force a re-sync, so the shared bind
            # seeds from the current values instead of writing stale
            # ones back into the live buffers
            if self.params_initialized:
                default._params_dirty = True
            module.bind(data_shapes, label_shapes,
                        self._curr_module.for_training,
                        self._curr_module.inputs_need_grad,
                        force_rebind=False, shared_module=default,
                        grad_req=self._grad_req)
            if self._monitor is not None:
                module.install_monitor(self._monitor)
            self._buckets[bucket_key] = module
        self._curr_module = self._buckets[bucket_key]
        self._curr_bucket_key = bucket_key

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        assert self.binded and self.params_initialized
        if self.optimizer_initialized and not force_init:
            self.logger.warning("optimizer already initialized, ignoring.")
            return
        self._curr_module.init_optimizer(kvstore, optimizer,
                                         optimizer_params,
                                         force_init=force_init)
        for mod in self._buckets.values():
            if mod is not self._curr_module:
                _borrow_optimizer(mod, self._curr_module)
        self.optimizer_initialized = True

    def prepare(self, data_batch, sparse_row_id_fn=None):
        """Bind the next batch's bucket ahead of its step."""
        assert self.binded and self.params_initialized
        original_bucket_key = self._curr_bucket_key
        self.switch_bucket(data_batch.bucket_key, data_batch.provide_data,
                           data_batch.provide_label)
        self.switch_bucket(original_bucket_key, None, None)

    # -- computation -------------------------------------------------------
    def forward(self, data_batch, is_train=None):
        assert self.binded and self.params_initialized
        self.switch_bucket(data_batch.bucket_key, data_batch.provide_data,
                           data_batch.provide_label)
        self._sync_current()
        self._curr_module.forward(data_batch, is_train=is_train)

    def _sync_current(self):
        """Hand the default module's optimizer and Updater to the current
        bucket's module at its first step: the optimizer state is one,
        shared by every bucket's (fused) update."""
        default_mod = self._buckets[self._default_bucket_key]
        if self._curr_module is not default_mod \
                and not self._curr_module.optimizer_initialized \
                and default_mod.optimizer_initialized:
            _borrow_optimizer(self._curr_module, default_mod)

    def backward(self, out_grads=None):
        assert self.binded and self.params_initialized
        self._curr_module.backward(out_grads=out_grads)

    def update(self):
        assert self.binded and self.params_initialized and \
            self.optimizer_initialized
        self._params_dirty = True
        self._curr_module.update()

    def get_outputs(self, merge_multi_context=True):
        assert self.binded and self.params_initialized
        return self._curr_module.get_outputs(merge_multi_context)

    def get_input_grads(self, merge_multi_context=True):
        assert self.binded and self.params_initialized and \
            self.inputs_need_grad
        return self._curr_module.get_input_grads(merge_multi_context)

    def get_states(self, merge_multi_context=True):
        assert self.binded and self.params_initialized
        return self._curr_module.get_states(merge_multi_context)

    def set_states(self, states=None, value=None):
        assert self.binded and self.params_initialized
        self._curr_module.set_states(states, value)

    def update_metric(self, eval_metric, labels, pre_sliced=False):
        assert self.binded and self.params_initialized
        self._curr_module.update_metric(eval_metric, labels, pre_sliced)

    def install_monitor(self, mon):
        assert self.binded
        self._monitor = mon
        for mod in self._buckets.values():
            mod.install_monitor(mon)

    @property
    def default_bucket_key(self):
        return self._default_bucket_key

    def stats(self):
        """``{bucket_site(key): {"fused": ..., "predict": ...}}`` in
        bucket order: each bucket's fused-step graph counters (captures,
        replays, recaptures, signatures, dispatches; zeros before its
        first fused step) and its executor's predict-graph counters."""
        out = {}
        for key in sorted(self._buckets,
                          key=lambda k: bucket_sort_key(format_bucket(k))):
            mod = self._buckets[key]
            fused = mod._fused.stats() if mod._fused else dict(_NO_GRAPHS)
            out[bucket_site(key)] = {"fused": fused,
                                     "predict": mod._exec.stats()}
        return out
