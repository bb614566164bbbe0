"""Module — a Symbol bound to one executor (counterpart of
``mxnet_tpu/module/module.py``).

``bind`` infers every shape from the data and label shapes and binds
the symbol through :class:`~mxnet_tpu_torch.executor.Executor` on one
device (``gpu(0)`` unless the module's context says otherwise).
``forward(is_train=False)`` is the executor's predict run (a CUDA graph
per input signature on the card). Parameters are written into the bound
arrays in place (``set_params``/``init_params``; a value of another
float dtype, an AMP policy's bfloat16 weight, is adopted), so the
graphs keep replaying.

**The fused step** (``fused_step.py``), on by default as in the JAX
package: a training ``forward`` only stages the batch, ``backward``
defers, and ``update`` runs forward + backward + every parameter's
update as ONE CUDA graph replay (:class:`~mxnet_tpu_torch.fused_step.
FusedStepExecutor`), bit-identical to the eager path. Observing the
step before ``update`` (``get_outputs``, another ``forward``) runs the
eager forward and backward for that step instead. The eager path (the
executor's training forward under torch autograd, then the
per-parameter ``Updater`` loop) runs with ``MXNET_FUSED_STEP=0`` and
for JAX's fallback matrix, each case counted in
``profiler.counters()['fused_step_fallbacks']``: an optimizer without a
fused update (counted once), a monitor, ``inputs_need_grad``,
``grad_req='add'``, a placed executor and a graph that runs user Python
(a ``Custom`` op, whose code may read a device value on the host, which
a CUDA graph cannot hold) (counted per step).

Checkpoints go through ``checkpoint.save_arrays`` (checksummed shards
plus a manifest; shard 0 is the single-file ``.params`` both packages
read) with the optimizer state as a ``.states`` sibling in the JAX
package's pickle (``save_optimizer_states``/``load_optimizer_states``,
``Module.load(load_optimizer_states=True)``).

``group2ctxs`` places the symbol's ``ctx_group`` segments on their
devices (:mod:`~mxnet_tpu_torch.placement`).

**The kvstore** (``init_optimizer(kvstore=...)``, ``model.
_create_kvstore``): a ``dist`` store always, and ``local``/``device``
over several contexts, as in the JAX package. With ``update_on_kvstore``
each gradient is pushed, the store's optimizer updates its value and
the weight is pulled back in place; otherwise the gradients are summed
through the store (per key, or bucketed with ``MXNET_GRAD_OVERLAP=1``)
and the worker's updater applies them. Either exchange is the
telemetry ``sync`` phase. A step with a kvstore runs the eager path
(JAX's fallback matrix), and ``dist_sync`` rescales the gradients by
``1 / (batch x workers)``. A context list that resolves to one torch
device binds one executor over the whole batch. Contexts on distinct
devices (``[gpu(0), cpu(0)]``) bind ONE executor over their in-process
``dp`` mesh, as the JAX package binds one program: the batch is split on
dim 0 (a batch that does not divide over the devices raises
``MXNetError`` at ``bind`` and ``reshape``), the gradients are the whole
batch's, and ``get_outputs()`` are global arrays. Such a step runs the
eager path (the kvstore's, a ``local`` store by default over several
contexts, as in the JAX package), a fused-step fallback counted as
``mesh`` when there is no store.
"""
from __future__ import annotations

import logging

from .. import ndarray as nd
from ..context import Context, current_context
from ..initializer import Uniform, InitDesc
from .. import optimizer as opt
from ..model import (_bucketed_exchange, _create_kvstore,
                     _initialize_kvstore, _update_params,
                     _update_params_on_kvstore, load_checkpoint)
from ..base import MXNetError
from .base_module import BaseModule, _check_input_names, _parse_data_desc

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
        self._compression_params = compression_params
        self._optimizer = self._kvstore = self._updater = None
        self._update_on_kvstore = None
        self._preload_opt_states = None
        self._exec = None
        self._bucket_site = None      # a BucketingModule's bucket key
        self._fused = None            # FusedStepExecutor | False | None
        self._pending_step = False
        self._pending_forward = False
        self._noted_monitor_eager = False

    # -- checkpointing -----------------------------------------------------
    @staticmethod
    def load(prefix, epoch, load_optimizer_states=False, **kwargs):
        """A module over ``prefix-symbol.json`` with the parameters of
        ``epoch`` (a manifest checkpoint or the single file), set at
        ``bind``; with ``load_optimizer_states`` the ``.states`` sibling
        loads at ``init_optimizer``."""
        sym, args, auxs = load_checkpoint(prefix, epoch)
        mod = Module(symbol=sym, **kwargs)
        mod._arg_params, mod._aux_params = args, auxs
        mod.params_initialized = True
        if load_optimizer_states:
            mod._preload_opt_states = "%s-%04d.states" % (prefix, epoch)
        return mod

    def save_checkpoint(self, prefix, epoch, save_optimizer_states=False,
                        remove_amp_cast=True):
        """``prefix-symbol.json`` and one durable checkpoint through
        ``checkpoint.save_arrays``: checksummed shards (shard 0 is the
        single-file ``prefix-%04d.params``) and a manifest written last,
        the optimizer state's ``.states`` file beside them."""
        from .. import telemetry
        from ..checkpoint import save_arrays, snapshot_params
        with telemetry.span("checkpoint"):
            self._symbol.save("%s-symbol.json" % prefix)
            arg_params, aux_params = self.get_params()
            states = None
            if save_optimizer_states:
                assert self.optimizer_initialized
                states = self._optimizer_state_bytes()
            save_arrays(prefix, epoch, snapshot_params(arg_params,
                                                       aux_params),
                        states_bytes=states)
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
            self._exec.adopt_value(name, provided[name])
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
    def _check_mesh_batch(self, batch, what="bind"):
        """Raise where ``batch`` does not split over the context list's
        distinct devices (the in-process mesh shards it evenly)."""
        from ..parallel.mesh import context_mesh
        mesh = context_mesh(self._context)
        if mesh is not None and batch % mesh.size:
            raise MXNetError(
                "%s: batch size %d not divisible by %d devices (the dp "
                "mesh shards the batch evenly; the reference's uneven "
                "work_load_list split is not supported)"
                % (what, batch, mesh.size))

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
            self._fused = None
            self._pending_step = False
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
        self._check_mesh_batch(self._data_shapes[0].shape[0])
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
        self._exec._cw_bucket = self._bucket_site
        self.binded = True
        if shared_module is not None and shared_module.params_initialized:
            self.set_params(*shared_module.get_params())
        elif self.params_initialized:
            # parameters loaded before bind (Module.load)
            self._exec.copy_params_from(self._arg_params, self._aux_params,
                                        allow_extra_params=True)

    # -- optimizer ---------------------------------------------------------
    def _effective_batch(self, kvstore):
        """The batch a gradient sums over: this worker's, times the
        workers of a synchronous dist store."""
        batch = self._data_shapes[0].shape[0]
        if kvstore and "dist" in kvstore.type \
                and "_async" not in kvstore.type:
            batch *= kvstore.num_workers
        return batch

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        """The optimizer, the kvstore and the updater; a name is created
        with ``rescale_grad = 1/(batch x workers)`` (a loss layer's
        gradient is summed over the batch)."""
        assert self.binded and self.params_initialized
        if self.optimizer_initialized and not force_init:
            self.logger.warning("optimizer already initialized, "
                                "ignoring...")
            return
        if self._params_dirty:
            self._sync_params_from_devices()
        kvstore, update_on_kvstore = _create_kvstore(
            kvstore, len(self._context), self._arg_params)
        rescale = 1.0 / self._effective_batch(kvstore)
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
                    "rescale_grad is not normalized to 1.0/batch_size/"
                    "num_workers (%s vs. %s).", optimizer.rescale_grad,
                    rescale)
            if not optimizer.idx2name:
                optimizer.idx2name = idx2name.copy()
        self._optimizer = optimizer
        self._kvstore = kvstore
        self._update_on_kvstore = update_on_kvstore
        self._updater = None
        if kvstore:
            if self._compression_params:
                kvstore.set_gradient_compression(self._compression_params)
            if update_on_kvstore:
                kvstore.set_optimizer(optimizer)
            _initialize_kvstore(
                kvstore=kvstore,
                param_arrays=[self._exec.arg_dict[n]
                              for n in self._param_names],
                arg_params=self._arg_params, param_names=self._param_names,
                update_on_kvstore=update_on_kvstore)
        if not update_on_kvstore:
            self._updater = opt.get_updater(optimizer)
        self._fused = None
        self.optimizer_initialized = True
        if self._preload_opt_states is not None:
            self.load_optimizer_states(self._preload_opt_states)
            self._preload_opt_states = None

    # -- computation -------------------------------------------------------
    def forward(self, data_batch, is_train=None):
        assert self.binded and self.params_initialized
        if self._pending_step:
            # a deferred fused step is outstanding and this forward would
            # overwrite its staged inputs: run its eager forward and
            # backward now, so update() sees that batch's gradients
            self._exec.forward_backward(is_train=True)
            self._pending_step = False
        if is_train is None:
            is_train = self.for_training
        feed = dict(zip(self._data_names, data_batch.data))
        if self._label_names and data_batch.label:
            feed.update(zip(self._label_names, data_batch.label))
        monitored = self._exec._monitor_callback is not None and \
            self._exec._monitor_all
        if is_train and self.for_training and not monitored:
            # defer: backward() decides between the fused step and the
            # eager forward + backward; only stage the inputs here
            self._exec._gather_inputs(feed)
            self._pending_forward = True
        else:
            if is_train and self.for_training:
                # a monitor tapping every op: this step runs eagerly, a
                # counted fallback as a deferred monitored step is
                self._fused_eligible(count=True)
            self._exec.forward(is_train=is_train, **feed)
            self._pending_forward = False

    def backward(self, out_grads=None):
        """Deferred under the fused step: the gradients are consumed
        inside ``update()``'s graph and never land in the executor's
        gradient arrays. Set ``MXNET_FUSED_STEP=0`` to inspect them."""
        assert self.binded and self.params_initialized
        if out_grads is None and self._pending_forward \
                and self._fused_eligible(count=True):
            self._pending_step = True
            self._params_dirty = True
            return
        if self._pending_forward:
            self._exec.forward_backward(out_grads=out_grads, is_train=True)
        else:
            self._exec.backward(out_grads=out_grads)
        self._pending_forward = False
        self._pending_step = False
        self._params_dirty = True

    def _fused_eligible(self, count=False):
        """Whether this step can take the fused step; with ``count``, a
        step that JAX's fallback matrix sends to the eager path while the
        gate is on is counted in ``fused_step_fallbacks``."""
        from ..fused_step import fused_step_enabled
        if not self.optimizer_initialized or self._updater is None \
                or self._kvstore is not None or self._fused is False \
                or not fused_step_enabled():
            return False
        ex = self._exec
        reason = None
        if self.inputs_need_grad:
            reason = "inputs_need_grad"
        elif ex.grouped:
            reason = "placement"
        elif ex.mesh is not None:
            reason = "mesh"
        elif ex._monitor_callback is not None:
            reason = "monitor"
        elif any(ex._grad_req.get(n) == "add" for n in ex.arg_names):
            reason = "grad_req_add"
        elif ex._host_code:
            reason = "custom"
        if reason is None:
            return True
        if count:
            from .. import profiler, telemetry
            profiler.increment_counter("fused_step_fallbacks")
            if reason == "monitor" and telemetry.enabled() \
                    and not self._noted_monitor_eager:
                self._noted_monitor_eager = True
                telemetry.note("fused_step_eager_monitor")
        return False

    def _get_fused(self):
        """The FusedStepExecutor of the current executor and optimizer;
        None (cached as False, counted once) when the optimizer or its
        state layout has no fused update."""
        from ..fused_step import FusedStepExecutor
        fused = self._fused
        if fused is not None and fused is not False \
                and fused._ex is self._exec \
                and fused._opt is self._optimizer \
                and fused._updater is self._updater:
            return fused
        try:
            fused = FusedStepExecutor(self._exec, self._optimizer,
                                      self._updater, self._param_names)
            weights = [self._exec.arg_dict[self._param_names[i]]
                       for i in fused._indices]
            ok = fused.step_fns(fused._indices, weights) is not None \
                and fused._states_for(fused._indices,
                                      weights)[0] is not None
        except MXNetError:
            ok = False
        if not ok:
            from .. import profiler
            profiler.increment_counter("fused_step_fallbacks")
            self._fused = False
            return None
        self._fused = fused
        return fused

    def update(self):
        """One optimizer step: the fused step's graph replay when the
        step was deferred, else the per-parameter loop."""
        assert self.binded and self.params_initialized \
            and self.optimizer_initialized
        from .. import telemetry
        self._params_dirty = True
        if self._pending_step:
            self._pending_step = False
            fused = self._get_fused()
            if fused is not None:
                fused.step()          # spans "optimizer" itself
                self._pending_forward = False
                return
            with telemetry.span("compute"):
                self._exec.forward_backward(is_train=True)
            self._pending_forward = False
        weights = [self._exec.arg_dict[n] for n in self._param_names]
        grads = [self._exec.grad_dict.get(n) for n in self._param_names]
        if self._update_on_kvstore:
            # push/pull IS the cross-worker reduce, and the store's
            # optimizer runs inside the push: the "sync" phase
            with telemetry.span("sync"):
                _update_params_on_kvstore(weights, grads, self._kvstore,
                                          self._param_names)
            return
        kvstore = self._kvstore
        if kvstore is not None:
            # the worker-side update: the gradient exchange is "sync",
            # bucketed with MXNET_GRAD_OVERLAP=1, else per key
            with telemetry.span("sync"):
                if not _bucketed_exchange(grads, kvstore):
                    for i, name in enumerate(self._param_names):
                        if grads[i] is not None:
                            kvstore.push(name, [grads[i]], priority=-i)
                            kvstore.pull(name, [grads[i]], priority=-i)
        with telemetry.span("optimizer"):
            _update_params(weights, grads, updater=self._updater)

    def get_outputs(self, merge_multi_context=True):
        assert self.binded and self.params_initialized
        if self._pending_step:
            # observed between backward() and update(): run the eager
            # forward and backward for this step; update() then takes
            # the eager loop
            self._exec.forward_backward(is_train=True)
            self._pending_step = False
            self._pending_forward = False
        elif self._pending_forward:
            self._exec.forward(is_train=True)
            self._pending_forward = False
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

    # -- optimizer state ---------------------------------------------------
    def _optimizer_state_bytes(self):
        """The optimizer state's pickle for a checkpoint (taken on the
        training thread: the states change in place each step), the
        kvstore's under ``update_on_kvstore``; None before
        ``init_optimizer``."""
        if not self.optimizer_initialized:
            return None
        if self._update_on_kvstore:
            self._kvstore._ensure_updater()
            updater = self._kvstore._updater
        else:
            updater = self._updater
        return updater.get_states() if updater is not None else None

    def save_optimizer_states(self, fname):
        """The optimizer state, durably (tmp + fsync + rename), in the
        JAX package's pickle; the kvstore's under ``update_on_kvstore``."""
        assert self.optimizer_initialized
        if self._update_on_kvstore:
            self._kvstore.save_optimizer_states(fname)
            return
        from ..checkpoint import atomic_write_file
        atomic_write_file(fname, self._updater.get_states())

    def load_optimizer_states(self, fname):
        """States written by :meth:`save_optimizer_states` of either
        package."""
        assert self.optimizer_initialized
        if self._update_on_kvstore:
            self._kvstore.load_optimizer_states(fname)
            return
        with open(fname, "rb") as src:
            self._updater.set_states(src.read())

    def reshape(self, data_shapes, label_shapes=None):
        """Rebind to new input shapes, sharing the parameters."""
        assert self.binded
        self._data_shapes, self._label_shapes = _parse_data_desc(
            self._data_names, self._label_names, data_shapes, label_shapes)
        self._check_mesh_batch(self._data_shapes[0].shape[0], "reshape")
        self._exec = self._exec.reshape(**self._feed_shapes())
        self._fused = None
        self._pending_step = False
