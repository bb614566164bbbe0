"""The fused train step (counterpart of ``mxnet_tpu/fused_step.py``):
the whole optimizer update, and on the Module path forward + backward
with it, as ONE CUDA graph replay per step.

The JAX fused step is one donated jitted program. Its counterpart here
is one CUDA graph per signature, held by the CachedOp's graph holder
(``cached_op._Graphs``) and captured by its ``_cuda_capture``:

- :class:`FusedUpdater` (the Gluon Trainer path): autograd already wrote
  the gradients into their buffers (in place, ``autograd._store_grad``),
  so the graph holds every parameter's update. It reads the gradients,
  weights and optimizer states in place and writes the new weights and
  states back in place;
- :class:`FusedStepExecutor` (the Module path): the graph holds the
  executor's training forward, its backward (``torch.autograd.grad``)
  and every update. ``Module.backward`` defers and ``Module.update``
  replays. BatchNorm's moving statistics are written once a step, and
  the gradients never land in the executor's gradient arrays.

The per-step scalars (lr and wd per parameter, the rescale, the loss
scale: :func:`pack_step_scalars`) are copied into one static device
buffer before each replay, so a learning-rate schedule tick or a
loss-scale change never recaptures. The update of each parameter is its
optimizer's ``fused_step_fn``, the eager update ops' arithmetic
operation for operation, so a fused step is bit-identical to the eager
loop. Off the card (a CPU bind) the same body runs directly, step by
step; the tests drive the graph bookkeeping on the CPU through a
stand-in capture (``set_graph_factory``).

Each graph holder reports to the compile watch under
``fused_step:module`` (``bucketing:<shape>`` for a bucket of a shape
ladder) or ``fused_step:trainer``, its compile milliseconds mirrored
into ``profiler.counters()['fused_step_compile_ms']``. The JAX package's
``fused_step:trainer_sync`` / ``fused_step:fsdp`` have no counterpart:
the port's ``DistributedTrainer`` updates eagerly.

Capture: the snapshot of every tensor the body writes (weights, states,
the moving statistics) is taken before the capture and put back after
it, so the capture's eager warm-up call changes nothing and each step
is applied once, by its replay. A capture that fails raises; there is
no silent eager path.

Fault tolerance stays inside the graph: planned ``grad`` faults splice
in per-parameter poison scalars (``fault.grad_poison``), and the
non-finite guard's skip is a ``torch.where`` that keeps the old weight
and state. Host accounting (skipped_steps, the loss-scale backoff) reads
the graph's finite mask, and only when a guard policy is on.

Fallback matrix (the eager loop, each case counted in
``profiler.counters()['fused_step_fallbacks']``): ``MXNET_FUSED_STEP=0``
(not counted: the gate is off), an optimizer without a
``fused_step_fn``, and on the Module path a monitor,
``inputs_need_grad``, ``grad_req='add'``, a placed (grouped)
executor, or a graph holding an op that runs user Python (``Custom``,
also inside a loop body: ``OpDef.runs_host_code``; its code may read a
device value on the host). A ``_foreach``/``_while_loop``/``_cond`` node
is captured in the step's graph like any op. Multi-precision low-dtype weights are not a fallback: SGD,
Adam, AdaGrad and RMSProp have multi-precision step functions.

**In-program sync** (``FusedUpdater(sync_mesh=)``, the Gluon Trainer
over the in-process mesh with ``MXNET_GRAD_OVERLAP=1``): the update runs
through ``parallel.grad_sync.make_bucketed_apply`` over the
``DeviceMesh``: bucketed reduce-scatter of the gradients, each device's
slice updated against ZeRO-1 flat-sharded state that lives on it
(``ShardedOptState``), the updated parameters all-gathered, with the
guard's skip and the fault splice per parameter as above. It spans
devices, so it runs eagerly, never as a CUDA graph, each step counted
in ``fused_step_sync_dispatches``. The JAX package's FSDP residency
(``fused_step:fsdp``) has no counterpart here: the port's rank-mesh
``DistributedTrainer`` holds it.
"""
from __future__ import annotations

import functools

import numpy as _np
import torch

from .base import MXNetError

__all__ = ["fused_step_enabled", "FusedStepExecutor", "FusedUpdater",
           "pack_step_scalars", "make_apply", "set_graph_factory"]


def fused_step_enabled():
    """The MXNET_FUSED_STEP gate: on by default, re-read each step."""
    from . import envs
    return envs.get_bool("MXNET_FUSED_STEP")


def _count(name, delta=1):
    from . import profiler
    profiler.increment_counter(name, delta)


def _default_graphs():
    from .cached_op import _Graphs
    return _Graphs()


_graph_factory = _default_graphs


def set_graph_factory(factory=None):
    """The graph holder each new fused signature gets: ``factory()``
    returns a ``cached_op._Graphs``; None restores the card's. The CPU
    tests pass a stand-in capture this way."""
    global _graph_factory
    _graph_factory = factory or _default_graphs


def _flat_state_handles(state):
    """One parameter's optimizer state as a flat list of NDArrays (None,
    one NDArray, or nested tuples of them); None for a leaf that is not
    an NDArray (that layout has no fused path)."""
    from .ndarray import NDArray
    if state is None:
        return []
    if isinstance(state, NDArray):
        return [state]
    if isinstance(state, (tuple, list)):
        out = []
        for s in state:
            sub = _flat_state_handles(s)
            if sub is None:
                return None
            out.extend(sub)
        return out
    return None


def pack_step_scalars(optimizer, indices):
    """The per-step scalar block as ONE host float32 vector ``[lr_0 ..
    lr_n-1, wd_0 .. wd_n-1, rescale, loss_scale]``, advancing the
    optimizer's update counters as the eager ``_step_inputs`` does."""
    from . import fault
    n = len(indices)
    block = _np.empty((2 * n + 2,), _np.float32)
    for k, i in enumerate(indices):
        lr, wd = optimizer.fused_step_scalars(i)
        block[k] = lr
        block[n + k] = wd
    block[2 * n] = optimizer.rescale_grad
    block[2 * n + 1] = fault.loss_scale()
    return block


def make_apply(step_fns, state_counts, guard, inject, unscale=False):
    """The all-parameter update over tensors: splice in the poisons,
    test finiteness, run each parameter's step function with its
    scalars, and under the guard keep the old weight and state of a
    non-finite gradient. ``unscale`` (the Module path's loss scaling):
    the gradients arrive multiplied by the loss scale, so the rescale
    is ``rescale / loss_scale``; the finiteness test sees the scaled
    gradient. Returns ``(new_weights, new_states, mask)`` (mask None
    without the guard)."""
    n = len(step_fns)

    def apply(grads, weights, states, scalars, poisons):
        rescale = scalars[2 * n]
        if unscale:
            rescale = rescale / scalars[2 * n + 1]
        new_ws, new_sts, oks = [], [], []
        si = 0
        for i, fn in enumerate(step_fns):
            g, w = grads[i], weights[i]
            st = tuple(states[si:si + state_counts[i]])
            si += state_counts[i]
            if inject:
                g = torch.where(torch.isfinite(poisons[i]), g,
                                poisons[i].to(g.dtype))
            if guard:
                ok = torch.isfinite(g).all()
            # the scalars in the gradient's dtype, as the eager ops see
            # Python floats; multi-precision step functions take float32
            sdt = getattr(fn, "scalar_dtype", None) or g.dtype
            nw, nst = fn(g, w, st, scalars[i].to(sdt),
                         scalars[n + i].to(sdt), rescale.to(sdt))
            if guard:
                nw = torch.where(ok, nw, w)
                nst = tuple(torch.where(ok, a, b) for a, b in zip(nst, st))
                oks.append(ok)
            new_ws.append(nw)
            new_sts.extend(nst)
        mask = torch.stack(oks) if oks else None
        return new_ws, new_sts, mask
    return apply


def _write_back(targets, values):
    with torch.no_grad():
        for t, v in zip(targets, values):
            t.copy_(v)


def _restoring_capture(capture, mutated):
    """``capture`` with every tensor of ``mutated()`` put back after it:
    the capture's warm-up call (and a stand-in's capturing call) must
    not apply a step."""
    def cap(body, device, pool):
        saved = [t.detach().clone() for t in mutated()]
        try:
            return capture(body, device, pool)
        finally:
            _write_back(mutated(), saved)
    return cap


class _FusedCore:
    """What both fused paths share: the step-function roster, the
    optimizer states of the SHARED Updater (so a ``.states`` file is the
    eager path's), the scalar block, the graph holders (one per static
    configuration) and the host-side guard accounting."""

    def __init__(self, optimizer, updater):
        self._opt = optimizer
        self._updater = updater
        self._graphs = {}        # static key -> cached_op._Graphs
        self._mutated = []       # what the current body writes
        self._trace_count = 0    # graph holders made (JAX's trace count)
        self.dispatch_count = 0  # fused steps run

    # -- rosters ----------------------------------------------------------
    def step_fns(self, indices, weights_nd):
        fns = []
        for i, w in zip(indices, weights_nd):
            fn = self._opt.fused_step_fn(i, w)
            if fn is None:
                return None
            fns.append(fn)
        return fns

    def _states_for(self, indices, weights_nd):
        """Per-index states from the shared Updater (made at first use as
        the eager path makes them), flattened, plus a count per
        parameter; ``(None, None)`` for a layout with no fused path."""
        handles, counts = [], []
        for i, w in zip(indices, weights_nd):
            if i not in self._updater.states:
                self._updater.states[i] = \
                    self._opt.create_state_multi_precision(i, w)
                self._updater.states_synced[i] = True
            flat = _flat_state_handles(self._updater.states[i])
            if flat is None:
                return None, None
            handles.extend(flat)
            counts.append(len(flat))
        return handles, tuple(counts)

    def _poisons(self, indices):
        """This step's planned grad faults as a poison vector; None when
        the plan has no grad site."""
        from . import fault
        p = fault.plan()
        if p is None or not p.has_site("grad"):
            return None
        return _np.asarray([fault.grad_poison() for _ in indices],
                           _np.float32)

    @staticmethod
    def _guard_active():
        from . import fault
        return fault.guard_policy() is not None

    @staticmethod
    def _loss_scaling_active(fns):
        """In-graph loss scaling (Module path): on when the scale_backoff
        guard owns a live scale AND the roster is multi-precision."""
        from . import fault
        return fault.guard_policy() == "scale_backoff" and \
            any(getattr(fn, "scalar_dtype", None) is not None for fn in fns)

    # -- the graph ---------------------------------------------------------
    def _device_block(self, block, device):
        """A host vector on ``device``: through pinned memory on the card
        (the caching host allocator keeps the block until its copy ran)."""
        t = torch.from_numpy(block)
        if device.type == "cuda":
            return t.pin_memory().to(device, non_blocking=True)
        return t.to(device)

    def _holder(self, key, generators=(), site=None):
        graphs = self._graphs.get(key)
        if graphs is None:
            graphs = _graph_factory()
            graphs.site = site
            base = graphs._capture
            if generators and graphs.device_type == "cuda":
                base = functools.partial(base, generators=tuple(generators))
            graphs._capture = _restoring_capture(base, lambda: self._mutated)
            self._graphs[key] = graphs
            self._trace_count += 1
        return graphs

    def _run(self, key, body, tensors, mutated, generators=(),
             site=None):
        """``body(feed)`` by graph replay where the holder serves the
        tensors (the first two, the scalar and poison blocks, staged),
        directly otherwise. Returns the body's outputs. ``site`` (a
        ``compile_watch.Site``) is what the holder reports under."""
        graphs = self._holder(key, generators, site)
        if graphs.serves(tensors):
            self._mutated = mutated
            try:
                return graphs.run(body, tensors, (0, 1))
            finally:
                self._mutated = []
        return graphs.eager(body, tensors, (0, 1))

    def stats(self):
        """The fused graphs' counters, summed over their signatures:
        captures, replays, recaptures, signatures; and ``dispatches``,
        the fused steps run."""
        out = {"captures": 0, "replays": 0, "recaptures": 0,
               "signatures": 0}
        for graphs in self._graphs.values():
            st = graphs.stats()
            for k in out:
                out[k] += st[k]
        out["dispatches"] = self.dispatch_count
        return out

    # -- host-side accounting ---------------------------------------------
    def _post_step(self, indices, mask):
        """One metered training step; under the guard, read the graph's
        finite mask (the one host sync of a guarded fused step), roll
        back the counts of skipped parameters and run the guard's
        per-step bookkeeping."""
        from . import metering
        metering.training_step()
        self.dispatch_count += 1
        _count("fused_step_dispatches")
        if mask is None:
            return
        from . import fault
        finite = mask.detach().to("cpu").numpy()
        for i, ok in zip(indices, finite):
            if not ok:
                self._opt.fused_rollback_count(i)
        fault.fused_step_guard(bool(finite.all()))

    def _key(self, kind, counts, guard, inject, scale_loss, indices):
        key = (kind, counts, guard, inject, scale_loss, tuple(indices),
               self._opt.fused_static_key())
        _count("fused_step_cache_hits" if key in self._graphs
               else "fused_step_cache_misses")
        return key

    def _blocks(self, indices, device):
        poisons = self._poisons(indices)
        inject = poisons is not None
        if poisons is None:
            poisons = _np.zeros((len(indices),), _np.float32)
        scalars = pack_step_scalars(self._opt, indices)
        return (self._device_block(scalars, device),
                self._device_block(poisons, device), inject)


class FusedStepExecutor(_FusedCore):
    """Module-path fused step: the bound executor's training forward, its
    backward and every parameter's update in ONE CUDA graph.
    ``Module.update`` drives it."""

    def __init__(self, executor, optimizer, updater, param_names):
        super().__init__(optimizer, updater)
        self._ex = executor
        self._param_names = list(param_names)
        gpos = list(executor._grad_positions)
        names = [executor.arg_names[p] for p in gpos]
        # the fused roster is the grad-carrying subset; frozen params
        # ride along untouched. Optimizer indices stay the full-roster
        # positions, as the eager Updater keys them.
        pos = {n: i for i, n in enumerate(self._param_names)}
        if any(n not in pos for n in names):
            raise MXNetError("fused step: grad-carrying args %s are not all "
                             "parameters %s" % (names, self._param_names))
        self._gpos = gpos
        self._indices = [pos[n] for n in names]

    def step(self):
        """One training step (forward + backward + every update) as one
        graph replay; the outputs land in the executor's outputs."""
        from . import telemetry
        ex = self._ex
        weights_nd = [ex.arg_arrays[p] for p in self._gpos]
        fns = self.step_fns(self._indices, weights_nd)
        if fns is None:
            raise MXNetError("fused step: the optimizer has no fused "
                             "update")
        handles, counts = self._states_for(self._indices, weights_nd)
        if handles is None:
            raise MXNetError("fused step: the optimizer state layout has "
                             "no fused update")
        guard = self._guard_active()
        scale_loss = self._loss_scaling_active(fns)
        device = weights_nd[0]._data.device if weights_nd \
            else ex._ctx.torch_device()
        scal, pois, inject = self._blocks(self._indices, device)
        key = self._key("module", counts, guard, inject, scale_loss,
                        self._indices)
        apply = make_apply(fns, counts, guard, inject, unscale=scale_loss)
        n_args, n_aux = len(ex.arg_arrays), len(ex.aux_arrays)
        n_params, gpos = len(fns), self._gpos
        args = [a._data for a in ex.arg_arrays]
        aux = [a._data for a in ex.aux_arrays]
        states = [h._data for h in handles]
        tensors = [scal, pois] + args + aux + states

        def body(feed):
            a = feed[2:2 + n_args]
            x = feed[2 + n_args:2 + n_args + n_aux]
            st = feed[2 + n_args + n_aux:]
            og_scale = feed[0][2 * n_params + 1] if scale_loss else None
            outs, grads = ex.fused_forward_backward(a, x, og_scale)
            ws = [a[p] for p in gpos]
            with torch.no_grad():
                new_ws, new_sts, mask = apply(grads, ws, st, feed[0],
                                              feed[1])
            _write_back(ws + list(st), new_ws + list(new_sts))
            return list(outs) + ([mask] if mask is not None else [])

        mutated = [args[p] for p in gpos] + aux + states
        with telemetry.span("optimizer"):
            res = self._run(key, body, tensors, mutated,
                            ex.rng_generators(), self._site(key, ex))
        n_out = len(ex.output_names)
        ex._store_outputs(res[:n_out])
        self._post_step(self._indices, res[n_out] if guard else None)
        return ex.outputs


    @staticmethod
    def _site(key, ex):
        """The compile-watch site of one static configuration:
        ``fused_step:module``, or the bucket's own ``bucketing:<shape>``
        for one bucket of a shape ladder (a bucket switch is never
        storm-flagged as churn)."""
        from .compile_watch import Site
        names = ["scalars", "poisons"] + list(ex.arg_names) \
            + ["aux:%s" % n for n in ex.aux_names]
        bucket = getattr(ex, "_cw_bucket", None)
        if bucket is None:
            return Site("fused_step:module", statics=key, names=names,
                        counter="fused_step_compile_ms")
        from .bucketing.ladder import bucket_site
        return Site(bucket_site(bucket), statics=key + ("fused", bucket),
                    names=names, counter="fused_step_compile_ms")


class FusedUpdater(_FusedCore):
    """Gluon-Trainer-path fused update: autograd already produced the
    gradients, so the graph is the all-parameter update, one replay
    instead of a few kernels per parameter. With ``sync_mesh`` (an
    in-process ``DeviceMesh``) the update is the bucketed, ZeRO-1
    sharded in-program sync (module docstring)."""

    def __init__(self, optimizer, updater, sync_mesh=None, sync_axis="dp"):
        super().__init__(optimizer, updater)
        self._sync_mesh = sync_mesh
        self._sync_axis = sync_axis
        self._sync_plan = None
        self._sync_state = None
        self._sync_sig = None
        self._sync_failed_sig = None
        self._sync_weights = None

    def update(self, items):
        """``items``: ordered ``[(index, weight_nd, grad_nd)]``. Returns
        True when the fused update ran; False (nothing modified) sends
        the caller to the eager loop, counted."""
        indices = [i for i, _, _ in items]
        weights_nd = [w for _, w, _ in items]
        fns = self.step_fns(indices, weights_nd)
        if fns is None:
            _count("fused_step_fallbacks")
            return False
        if self._sync_mesh is not None \
                and self._update_sync(items, indices, weights_nd, fns):
            return True
        handles, counts = self._states_for(indices, weights_nd)
        if handles is None:
            _count("fused_step_fallbacks")
            return False
        guard = self._guard_active()
        scal, pois, inject = self._blocks(indices,
                                          weights_nd[0]._data.device)
        key = self._key("trainer", counts, guard, inject, False, indices)
        apply = make_apply(fns, counts, guard, inject)
        n = len(items)
        grads = [g._data for _, _, g in items]
        weights = [w._data for w in weights_nd]
        states = [h._data for h in handles]
        tensors = [scal, pois] + grads + weights + states

        def body(feed):
            g = feed[2:2 + n]
            w = feed[2 + n:2 + 2 * n]
            st = feed[2 + 2 * n:]
            with torch.no_grad():
                new_ws, new_sts, mask = apply(g, w, st, feed[0], feed[1])
            _write_back(list(w) + list(st), new_ws + list(new_sts))
            return [mask] if mask is not None else []

        # the Trainer's own "optimizer" span holds this update
        from .compile_watch import Site
        site = Site("fused_step:trainer", statics=key,
                    names=["scalars", "poisons"]
                    + ["grad%d" % i for i in indices]
                    + ["param%d" % i for i in indices],
                    counter="fused_step_compile_ms")
        res = self._run(key, body, tensors, weights + states, site=site)
        self._post_step(indices, res[0] if guard else None)
        return True

    # -- the in-program sync ---------------------------------------------
    def _sync_setup(self, indices, weights_nd):
        """The bucket plan and sharded state of this roster, rebuilt when
        it changes and seeded from the shared Updater's per-parameter
        states (consumed, so the replicated copies do not defeat the 1/N
        layout); None when the optimizer's state layout has no sharded
        path."""
        from .parallel import grad_sync
        sig = tuple((tuple(w.shape), str(w.dtype), i)
                    for i, w in zip(indices, weights_nd))
        if sig == self._sync_sig and self._sync_state is not None:
            self._sync_weights = list(weights_nd)
            return self._sync_plan, self._sync_state
        if sig == self._sync_failed_sig:
            return None
        if self._sync_state is not None:
            self.export_states_to_updater()
        plan = grad_sync.GradSyncPlan(
            [w.shape for w in weights_nd],
            [w._data.dtype for w in weights_nd],
            axis_size=self._sync_mesh.size)
        state = grad_sync.ShardedOptState(plan, self._sync_mesh,
                                          self._sync_axis)
        if not state.probe(self._opt, indices, weights_nd):
            self._sync_failed_sig = sig
            return None
        seed = {}
        for pos, i in enumerate(indices):
            st = self._updater.states.pop(i, None)
            self._updater.states_synced.pop(i, None)
            flat = _flat_state_handles(st)
            if flat:
                seed[pos] = [h.asnumpy() for h in flat]
        if seed:
            state.seed_per_param(seed)
        else:
            state.ensure()
        self._sync_plan, self._sync_state = plan, state
        self._sync_sig = sig
        self._sync_weights = list(weights_nd)
        return plan, state

    def invalidate_sync(self):
        """The next update rebuilds and re-seeds the sharded state (the
        Updater's states were just replaced)."""
        self._sync_sig = None
        self._sync_state = None
        self._sync_failed_sig = None

    def export_states_to_updater(self):
        """The flat-sharded state put back into the shared Updater's
        per-parameter layout (what ``Trainer.save_states`` pickles), so a
        ``.states`` file is interchangeable with every non-sync run."""
        if self._sync_state is None or self._sync_weights is None:
            return
        from .ndarray.ndarray import tensor_from_numpy
        indices = [i for (_, _, i) in self._sync_sig]
        shapes = {pos: tuple(w.shape)
                  for pos, w in enumerate(self._sync_weights)}
        per_param = self._sync_state.export_per_param(shapes)
        for pos, i in enumerate(indices):
            w = self._sync_weights[pos]
            template = self._opt.create_state_multi_precision(i, w)
            flat = _flat_state_handles(template)
            vals = per_param.get(pos)
            if flat is None or vals is None:
                continue
            for h, v in zip(flat, vals):
                h._set_data(tensor_from_numpy(v).to(h._data.device))
            self._updater.states[i] = template
            self._updater.states_synced[i] = True
        # the Updater holds the live state now; a later sync step
        # re-seeds from it
        self.invalidate_sync()

    def _update_sync(self, items, indices, weights_nd, fns):
        """One step of the bucketed reduce-scatter and sharded update;
        False (nothing modified) when the roster has no sharded path."""
        from .parallel import grad_sync
        built = self._sync_setup(indices, weights_nd)
        if built is None:
            return False
        plan, sync_state = built
        states = sync_state.ensure()
        guard = self._guard_active()
        dev0 = self._sync_mesh.devices[0]
        scal, pois, inject = self._blocks(indices, dev0)
        apply = grad_sync.make_bucketed_apply(
            fns, sync_state.n_slots, plan, self._sync_mesh,
            self._sync_axis, guard=guard, inject=inject)
        weights = [w._data for w in weights_nd]
        grads = [g._data for _, _, g in items]
        with torch.no_grad():
            new_ws, new_sts, mask = apply(grads, weights, states, scal,
                                          pois)
            _write_back(weights, new_ws)
        sync_state.store(new_sts)
        _count("fused_step_sync_dispatches")
        grad_sync.account_in_program_sync(plan,
                                          seconds=apply.sync_seconds)
        self._post_step(indices, mask)
        return True
