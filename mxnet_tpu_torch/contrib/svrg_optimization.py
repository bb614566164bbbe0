"""SVRG: stochastic variance-reduced gradient training (counterpart of
``mxnet_tpu/contrib/svrg_optimization.py``; reference:
python/mxnet/contrib/svrg_optimization/{svrg_module,svrg_optimizer}.py).

Every ``update_freq`` epochs the parameters are snapshot and the FULL
dataset's gradient is taken at the snapshot; each step then applies the
corrected gradient g_i(w) - g_i(w_snap) + g_full(w_snap), which has g_i's
expectation and a shrinking variance.

Under the fused step (``MXNET_FUSED_STEP``, on by default) a Module's
``backward`` defers the whole step to ``update()``'s graph, and the
gradients never land in the executor's arrays. A corrected step
therefore runs its forward and backward eagerly, so that the gradients
land, corrects them in place, and takes the per-parameter update; each
such step counts in the profiler's ``fused_step_fallbacks``, as a
``Monitor``'s eager steps do. Steps before the first snapshot keep the
fused step. The snapshot module has no optimizer, so its ``backward``
is eager and its ``grad_req="add"`` arrays accumulate.
"""
from __future__ import annotations

import logging

from ..base import MXNetError
from ..module import Module

__all__ = ["SVRGModule"]


class SVRGModule(Module):
    """Module with SVRG-corrected updates (reference:
    svrg_module.py:29). Call :meth:`update_full_grads` once per
    ``update_freq`` epochs, then train as usual; :meth:`fit` does both."""

    def __init__(self, symbol, data_names=("data",),
                 label_names=("softmax_label",), logger=logging,
                 context=None, update_freq=2, **kwargs):
        super().__init__(symbol, data_names=data_names,
                         label_names=label_names, logger=logger,
                         context=context, **kwargs)
        if update_freq < 1:
            raise MXNetError("update_freq must be >= 1")
        self.update_freq = update_freq
        self._snap_params = None        # the parameters at the snapshot
        self._full_grads = None         # the full gradient there
        self._snap_mod = None

    def _ensure_snapshot_module(self):
        if self._snap_mod is None:
            self._snap_mod = Module(self._symbol,
                                    data_names=self.data_names,
                                    label_names=self.label_names,
                                    context=self._context)
            self._snap_mod.bind(self.data_shapes, self.label_shapes,
                                for_training=True, grad_req="add")
        return self._snap_mod

    def _zeroed_snapshot(self, arg_params, aux_params):
        mod = self._ensure_snapshot_module()
        mod.init_params(arg_params=arg_params, aux_params=aux_params,
                        allow_missing=False, force_init=True)
        for g in mod._exec.grad_arrays:
            if g is not None:
                g[:] = 0
        return mod

    def update_full_grads(self, train_data):
        """Snapshot the current parameters and accumulate the full
        dataset's gradient there (reference: svrg_module.py:214)."""
        assert self.binded and self.params_initialized
        args, auxs = self.get_params()
        self._snap_params = {k: v.copy() for k, v in args.items()}
        mod = self._zeroed_snapshot(args, auxs)
        train_data.reset()
        n_batches = 0
        for batch in train_data:
            mod.forward(batch, is_train=True)
            mod.backward()
            n_batches += 1
        train_data.reset()
        self._full_grads = {}
        for name, g in zip(mod._exec.arg_names, mod._exec.grad_arrays):
            if g is not None:
                self._full_grads[name] = g / float(n_batches)

    def _materialize_grads(self):
        """This step's forward and backward now, into the executor's
        gradient arrays; a step the fused step would have taken counts
        in ``fused_step_fallbacks``."""
        from .. import profiler
        if self._fused_eligible():
            profiler.increment_counter("fused_step_fallbacks")
        if self._pending_forward:
            self._exec.forward_backward(is_train=True)
        else:
            self._exec.backward()
        self._pending_forward = False
        self._pending_step = False
        self._params_dirty = True

    def _svrg_correct(self, batch):
        """g(w) - g(w_snap) + g_full, left in this module's gradient
        arrays."""
        _, auxs = self.get_params()
        mod = self._zeroed_snapshot(self._snap_params, auxs)
        mod.forward(batch, is_train=True)
        mod.backward()
        snap_grads = dict(zip(mod._exec.arg_names, mod._exec.grad_arrays))
        for name, g in zip(self._exec.arg_names, self._exec.grad_arrays):
            if g is None:
                continue
            sg = snap_grads.get(name)
            fg = self._full_grads.get(name)
            if sg is not None and fg is not None:
                g[:] = g - sg + fg

    def forward_backward(self, data_batch):
        if self._full_grads is None:
            super().forward_backward(data_batch)
            return
        self.forward(data_batch, is_train=True)
        self._materialize_grads()
        self._svrg_correct(data_batch)

    def fit(self, train_data, **kwargs):
        """The standard fit loop with a full-gradient snapshot before the
        first epoch and every ``update_freq`` epochs (reference:
        svrg_module.py:351)."""
        begin_epoch = kwargs.get("begin_epoch", 0)
        epoch_cb = kwargs.pop("epoch_end_callback", None)

        def wrapped_epoch_cb(epoch, *cb_args):
            if (epoch + 1 - begin_epoch) % self.update_freq == 0:
                self.update_full_grads(train_data)
            if epoch_cb is not None:
                epoch_cb(epoch, *cb_args)

        self.bind(train_data.provide_data, train_data.provide_label,
                  for_training=True)
        if not self.params_initialized:
            from ..initializer import Uniform
            self.init_params(kwargs.get("initializer", Uniform(0.01)))
        self.update_full_grads(train_data)
        return super().fit(train_data, epoch_end_callback=wrapped_epoch_cb,
                           **kwargs)
