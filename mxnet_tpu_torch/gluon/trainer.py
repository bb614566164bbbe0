"""Gluon Trainer (counterpart of ``mxnet_tpu/gluon/trainer.py``).

``step(batch_size)`` rescales the gradients by ``1/batch_size`` (times
``rescale_grad``, and divided by the loss scale under the
``scale_backoff`` guard: the caller multiplies the loss by
``fault.loss_scale()`` before backward), reduces them across workers
through the kvstore and applies the optimizer. ``batch_size`` is the
batch the summed gradient covers: a ``dist_sync`` user passes the
global batch, as in the JAX package. A parameter whose
gradient no backward wrote since the last step is stale: ``step``
raises unless ``ignore_stale_grad=True``, which skips it.

**The fused update** (``fused_step.py``, on unless
``MXNET_FUSED_STEP=0``): every parameter's update runs as ONE CUDA
graph replay (:class:`~mxnet_tpu_torch.fused_step.FusedUpdater`) over
the gradients autograd wrote into their buffers in place, bit-identical
to the per-parameter loop. An optimizer without a fused update runs the
loop, counted in ``profiler.counters()['fused_step_fallbacks']``.
``multi_precision=True`` keeps fp32 masters for bfloat16/float16
weights (``amp.DtypePolicy(...).apply(net)``).

**In-program sync over the in-process mesh** (parameters initialized
over contexts on distinct devices, and ``MXNET_GRAD_OVERLAP=1``): the
fused update runs through ``parallel.grad_sync``'s bucketed form over
the parameters' ``DeviceMesh`` (:meth:`Trainer._sync_mesh`), as the JAX
Trainer's does: each bucket's gradients are reduce-scattered over the
devices, each device updates its slice against ZeRO-1 flat-sharded
optimizer state that lives there, and the updated parameters are
all-gathered, with the non-finite guard and the planned fault splice.
Without the gate the plain fused update runs once over the gradients
(autograd already added the shards' contributions). ``save_states``
puts the sharded state back into the per-parameter layout first, so a
``.states`` file is the plain run's.

**Sparse gradients.** A parameter whose ``grad_stype`` is
``'row_sparse'`` (``nn.Embedding(sparse_grad=True)``) reaches the
optimizer as a RowSparseNDArray view of its dense gradient over the rows
its forwards looked up (:meth:`Trainer._to_row_sparse`), which the lazy
optimizers update alone. The row set depends on the data, so such a
step cannot be one CUDA graph: it runs the eager loop, counted in
``fused_step_fallbacks`` as in the JAX package. Every parameter's row
stash is dropped after a step.

``save_states``/``load_states`` write and read the optimizer state in
the JAX package's pickle, durably (``checkpoint.atomic_write_file``; the
shared background writer with ``background=True``).

**The kvstore** (``_resolve_kvstore``): a plain ``local``/``device``
name resolves to no store (every Parameter is one array on one device);
a ``dist``/``tpu`` name, or a ``KVStore``, to a real one, set up at the
first step. Then ``allreduce_grads`` pushes each gradient and pulls the
sum back into its buffer IN PLACE, so the fused update's graph keeps
replaying (one push/pull a size-capped bucket with
``MXNET_GRAD_OVERLAP=1``); with ``update_on_kvstore=True`` the store's
optimizer updates its copy and ``step`` pulls the weights back. The
exchange is the telemetry ``sync`` phase.

Telemetry, as in the JAX Trainer: each ``step``/``update`` is one step
boundary of the telemetry run (``telemetry.maybe_start`` starts one
from the environment; tick mode, the step spans from the previous
call), with the parameter update under the ``optimizer`` phase. Each
step also ticks the usage meter's training account
(``metering.training_step``).
"""
from __future__ import annotations

from .. import metering, telemetry
from .. import optimizer as opt
from .parameter import Parameter, ParameterDict

__all__ = ["Trainer"]


def _as_param_list(params):
    if isinstance(params, (dict, ParameterDict)):
        params = list(params.values())
    if not isinstance(params, (list, tuple)):
        raise ValueError(
            "First argument must be a list or dict of Parameters, "
            "got %s." % (type(params)))
    for p in params:
        if not isinstance(p, Parameter):
            raise ValueError(
                "First argument must be a list or dict of Parameters, "
                "got list of %s." % (type(p)))
    return list(params)


class Trainer:
    """Applies an Optimizer to a set of Parameters after backward
    (reference: trainer.py:27)."""

    def __init__(self, params, optimizer, optimizer_params=None,
                 kvstore="device", compression_params=None,
                 update_on_kvstore=None):
        self._params = _as_param_list(params)
        self._compression_params = compression_params
        self._kvstore_params = {"kvstore": kvstore,
                                "update_on_kvstore": update_on_kvstore}
        self._kv_initialized = False
        self._kvstore = None
        self._update_on_kvstore = None
        opts = dict(optimizer_params or {})
        self._scale = float(opts.get("rescale_grad", 1.0))
        roster = dict(enumerate(self._params))
        if isinstance(optimizer, opt.Optimizer):
            if opts:
                raise AssertionError(
                    "optimizer_params must be None if optimizer is an "
                    "instance of Optimizer instead of str")
            self._optimizer = optimizer
            optimizer.param_dict = roster
        else:
            self._optimizer = opt.create(optimizer, param_dict=roster,
                                         **opts)
        self._updaters = [opt.get_updater(self._optimizer)]
        self._fused_updater = None

    @property
    def learning_rate(self):
        sched = self._optimizer.lr_scheduler
        return self._optimizer.lr if sched is None \
            else sched(self._optimizer.num_update)

    @property
    def optimizer(self):
        return self._optimizer

    def set_learning_rate(self, lr):
        self._optimizer.set_learning_rate(lr)

    # -- the kvstore -------------------------------------------------------
    def _resolve_kvstore(self):
        """The store (reference: trainer.py:169): a plain local/device
        name resolves to none; a dist/tpu name makes one."""
        from .. import kvstore as kvs
        spec = self._kvstore_params["kvstore"]
        if isinstance(spec, kvs.KVStore):
            return spec
        if isinstance(spec, str) and ("dist" in spec or "tpu" in spec):
            return kvs.create(spec)
        return None

    def _init_kvstore(self):
        kv = self._resolve_kvstore()
        if kv is not None:
            if self._compression_params:
                kv.set_gradient_compression(self._compression_params)
            for i, param in enumerate(self._params):
                if param._data is not None:
                    kv.init(i, param.data())
        self._kvstore = kv
        self._update_on_kvstore = bool(
            self._kvstore_params["update_on_kvstore"])
        if kv is not None and self._update_on_kvstore:
            kv.set_optimizer(self._optimizer)
        self._kv_initialized = True

    def allreduce_grads(self):
        """Cross-worker gradient reduction (reference: trainer.py:331):
        each gradient pushed and, unless the store updates the weights,
        its sum pulled back in place; bucketed with
        ``MXNET_GRAD_OVERLAP=1`` (hosted updates keep the per-key loop:
        the store's optimizer runs per key)."""
        if not self._kv_initialized:
            self._init_kvstore()
        if self._kvstore is None:
            return
        if not self._update_on_kvstore:
            from ..parallel import grad_sync
            if grad_sync.overlap_enabled():
                items = [(i, p.grad()) for i, p in enumerate(self._params)
                         if p.grad_req != "null"]
                if grad_sync.bucketed_kvstore_sync(self._kvstore, items):
                    return
        for i, param in enumerate(self._params):
            if param.grad_req != "null":
                self._kvstore.push(i, param.grad())
                if not self._update_on_kvstore:
                    self._kvstore.pull(i, param.grad())

    def _step_rescale(self, batch_size):
        """``rescale_grad / batch_size``, divided by the loss scale under
        the scale_backoff guard."""
        from .. import fault
        scale = self._scale / batch_size
        if fault.guard_policy() == "scale_backoff":
            scale /= fault.loss_scale()
        self._optimizer.rescale_grad = scale

    def step(self, batch_size, ignore_stale_grad=False):
        """allreduce + update, rescaled by batch size
        (reference: trainer.py:302)."""
        telemetry.maybe_start(meta={"source": "gluon.Trainer"})
        self._step_rescale(batch_size)
        if not self._kv_initialized:
            self._init_kvstore()
        if self._kvstore is not None:
            with telemetry.span("sync"):
                self.allreduce_grads()
        self._update_step(batch_size, ignore_stale_grad)

    def update(self, batch_size, ignore_stale_grad=False):
        """Update only — the caller already ran allreduce_grads
        (reference: trainer.py:363)."""
        telemetry.maybe_start(meta={"source": "gluon.Trainer"})
        if not self._kv_initialized:
            self._init_kvstore()
        if self._kvstore is not None and self._update_on_kvstore:
            raise AssertionError(
                "update() when parameters are updated on kvstore is not "
                "supported. Try setting `update_on_kvstore` to False when "
                "creating trainer.")
        self._step_rescale(batch_size)
        self._update_step(batch_size, ignore_stale_grad)

    def _update_step(self, batch_size, ignore_stale_grad):
        with telemetry.span("optimizer"):
            fused = self._apply_updates(ignore_stale_grad)
        telemetry.step_tick(samples=batch_size)
        if not fused:
            # a fused update ticks the meter itself
            metering.training_step()

    def _sync_mesh(self):
        """The mesh the in-program bucketed sync runs over: the
        parameters' in-process ``DeviceMesh`` when they all share one
        and ``MXNET_GRAD_OVERLAP=1``; None otherwise (plain fused
        update)."""
        from ..parallel import grad_sync
        if not grad_sync.overlap_enabled():
            return None
        mesh = None
        for p in self._params:
            if p._data is None:
                continue
            m = p.mesh
            if m is None or (mesh is not None and m is not mesh):
                return None
            mesh = m
        return mesh

    def _get_fused(self):
        """The FusedUpdater over this Trainer's optimizer and Updater;
        None with ``MXNET_FUSED_STEP=0``. Over the in-process mesh with
        ``MXNET_GRAD_OVERLAP=1`` it carries the sync mesh
        (:meth:`_sync_mesh`)."""
        from ..fused_step import FusedUpdater, fused_step_enabled
        if not fused_step_enabled():
            if self._fused_updater is not None:
                # the gate can be flipped off mid-run: the live moments
                # may sit in the updater's ZeRO-sharded flats
                self._fused_updater.export_states_to_updater()
                self._fused_updater.invalidate_sync()
            return None
        mesh = self._sync_mesh()
        fused = self._fused_updater
        if fused is not None and fused._opt is self._optimizer \
                and fused._updater is self._updaters[0] \
                and fused._sync_mesh is mesh:
            return fused
        if fused is not None:
            # no ZeRO-sharded state stranded in a discarded updater
            fused.export_states_to_updater()
        self._fused_updater = FusedUpdater(self._optimizer,
                                           self._updaters[0],
                                           sync_mesh=mesh)
        return self._fused_updater

    @staticmethod
    def _to_row_sparse(param, grad):
        """The row_sparse view of ``grad`` over the rows the forwards
        looked up since the last step (the union of the stashed ids,
        sorted: rows whose gradient is exactly 0 stay in), or over its
        non-zero rows when nothing was stashed (a hybridized block)."""
        import torch
        from ..ndarray import NDArray
        from ..ndarray.sparse import RowSparseNDArray
        ids = getattr(param, "_sparse_row_ids", None)
        if ids is None:
            return grad.tostype("row_sparse")
        param._sparse_row_ids = None
        rows = torch.unique(torch.cat(
            [i._data.detach().reshape(-1).to(grad._data.device,
                                             torch.long) for i in ids]))
        rows_nd = NDArray(rows.to(torch.int32))
        return RowSparseNDArray(grad.take(rows_nd), rows_nd, grad.shape,
                                ctx=grad.context)

    def _apply_updates(self, ignore_stale_grad):
        """The step's updates; True when the fused update ran them. Under
        ``update_on_kvstore`` the store updated its copies in the push:
        each weight is pulled back in place."""
        hosted = self._kvstore is not None and self._update_on_kvstore
        work = []
        for i, param in enumerate(self._params):
            if param.grad_req == "null" or param._data is None:
                continue
            if not param._data._fresh_grad:
                if not ignore_stale_grad:
                    raise UserWarning(
                        "Gradient of Parameter `%s` on context %s has not "
                        "been updated by backward since last `step`. This "
                        "could mean a bug in your model that made it only "
                        "use a subset of the Parameters (Blocks) for this "
                        "iteration. If you are intentionally only using a "
                        "subset, call step with ignore_stale_grad=True to "
                        "suppress this warning and skip updating of "
                        "Parameters with stale gradient"
                        % (param.name, str(param.list_ctx()[0])))
                continue
            if hosted:
                param._data._fresh_grad = False
                continue
            work.append((i, param))
        sparse = any(p._grad_stype == "row_sparse" for _, p in work)
        fused_done = False
        if work and not sparse:
            fused = self._get_fused()
            if fused is not None:
                fused_done = fused.update(
                    [(i, p.data(), p.grad()) for i, p in work])
        elif sparse:
            from ..fused_step import fused_step_enabled
            if fused_step_enabled():
                from .. import profiler
                profiler.increment_counter("fused_step_fallbacks")
        for i, param in work:
            if not fused_done:
                grad = param.grad()
                if param._grad_stype == "row_sparse":
                    grad = self._to_row_sparse(param, grad)
                self._updaters[0](i, grad, param.data())
            param._data._fresh_grad = False
        # every parameter's stash goes (a frozen or stale one's too), so
        # no forward of this step leaks into the next
        for param in self._params:
            param._sparse_row_ids = None
        if hosted:
            for i, param in enumerate(self._params):
                if param.grad_req != "null" and param._data is not None:
                    self._kvstore.pull(i, param.data())
        return fused_done

    # -- optimizer-state checkpointing ------------------------------------
    def save_states(self, fname, background=False):
        """Durably write the optimizer state (tmp + fsync + rename through
        ``checkpoint.atomic_write_file``, fault-injectable at
        ``ckpt_write``/``ckpt_fsync``). The pickle is taken here, on the
        calling thread; ``background=True`` hands the write to the
        shared checkpoint writer (``checkpoint.flush_async_writes()``
        waits for it and raises on a failed write)."""
        from .. import checkpoint as ckpt
        if not self._kv_initialized:
            self._init_kvstore()
        if self._update_on_kvstore and self._kvstore is not None:
            updater = self._kvstore._updater
            assert updater is not None, \
                "Cannot save states for distributed training without " \
                "updater"
            payload = updater.get_states(dump_optimizer=True)
        else:
            if self._fused_updater is not None:
                self._fused_updater.export_states_to_updater()
            payload = self._updaters[0].get_states(dump_optimizer=True)
        if background:
            ckpt.write_bytes_async(fname, payload)
        else:
            ckpt.atomic_write_file(fname, payload)

    def load_states(self, fname):
        """States written by either package's ``save_states``; the
        optimizer comes with them, its ``param_dict`` reset to this
        Trainer's parameters."""
        if not self._kv_initialized:
            self._init_kvstore()
        if self._update_on_kvstore and self._kvstore is not None:
            self._kvstore.load_optimizer_states(fname)
            self._optimizer = self._kvstore._updater.optimizer
            self._optimizer.param_dict = dict(enumerate(self._params))
            return
        with open(fname, "rb") as src:
            blob = src.read()
        for updater in self._updaters:
            updater.set_states(blob)
            updater.optimizer = self._updaters[0].optimizer
        self._optimizer = self._updaters[0].optimizer
        self._optimizer.param_dict = dict(enumerate(self._params))
        self._fused_updater = None
