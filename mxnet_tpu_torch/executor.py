"""Executor — a Symbol bound to arrays on one device (counterpart of
``mxnet_tpu/executor.py``).

``bind`` turns the graph into a plan: the ops in topological order,
each with its normalized attributes and the slots its inputs come from
(the JAX package's ``_build_plan``). The plan runs two ways:

- **predict** (``forward(is_train=False)``): on a CUDA bind, one CUDA
  graph per input signature (``cached_op._Graphs``, the holder of the
  hybridized CachedOp, with its capture lock), the counterpart of the
  JAX executor's one jitted program. The batch arguments (a Module's
  data and labels) are staged into the graph's static buffers, every
  other argument and auxiliary state is read in place; a capture that
  fails raises. On the CPU the plan runs op by op. A graph with an op
  that draws random numbers in predict mode (Dropout with
  ``mode="always"``; a train-mode Dropout draws nothing there) runs op
  by op on either device, each such run counted as ``eager_rng`` in
  ``stats()``; so does a graph with an op that runs user Python
  (``Custom``, or a loop whose body holds one), counted as
  ``eager_host``. A ``_foreach``/``_while_loop``/``_cond`` node is one
  op of the plan, captured whole in the graph;
- **train** (``forward(is_train=True)``, ``forward_backward``): op by op
  under torch autograd over the arguments that carry a gradient.
  ``backward`` takes ``torch.autograd.grad`` of the stored forward, as
  the reference's backward consumes its stored activations, so a
  training forward updates BatchNorm's moving statistics once (the JAX
  executor's ``backward`` runs its forward again and updates them a
  second time). Without a pending training forward, ``backward`` runs
  one.

Everything is written in place: inputs, parameters
(``copy_params_from``), the moving statistics and the gradients
(``grad_req`` ``write`` copies, ``add`` accumulates, ``null`` has no
array; an argument the outputs do not depend on gets zeros, as JAX's
``vjp`` gives). A CUDA graph remembers the storage of what it reads in
place, so a replaced tensor would cost a recapture each batch.

The conv-bias/BatchNorm peephole of the JAX executor
(``_plan_bias_defer``) is kept: in a training run, a biased convolution
whose only consumer is a train-mode channel BatchNorm runs without its
bias, and the bias, detached, is added to the BatchNorm's mean outputs
and moving-mean write-back instead; its gradient is exactly 0.

``group2ctx`` places the plan's ``ctx_group`` segments on their devices
(:mod:`~mxnet_tpu_torch.placement`): op by op in both modes, never a
CUDA graph, counted as ``grouped`` in ``stats()``. A ``group2ctx`` that names no group of the graph
leaves placement off.

A bind over a context list whose contexts resolve to one torch device
(``[cpu(0), cpu(1)]`` on the host, ``[gpu(0), gpu(0)]`` on the card) is
one executor over the whole batch. Over contexts on distinct devices
(``[gpu(0), cpu(0)]``) it is the JAX package's in-program data
parallelism over their in-process ``dp`` mesh: the batch arguments
(``batch_args``: a Module's data and labels) are ``MeshNDArray`` s split
on dim 0 (one whose dim 0 does not divide stays whole, replicated, as in
the JAX package; ``Module`` raises for it), the parameters and auxiliary states stay one array on
the first device, replicated to each shard by the ops' mesh rules
(``ops.registry.call``), and the outputs are global arrays. Both modes
run the plan node by node in lockstep over the shards (never a CUDA
graph), each run counted under ``lockstep`` in ``ops.mesh_stats()``;
the gradients of the parameters are the whole batch's (autograd adds the
shards'). ``group2ctx`` over such a list raises. The predict program
reports to the compile watch under ``executor:fwd:eval``
(``bucketing:<shape>`` for a bucket of a shape ladder); the train
programs, op by op, have no site. Not ported: the compile-cache token
(ROADMAP queue A step 7).
"""
from __future__ import annotations

import torch

from .base import MXNetError
from .context import Context
from . import ops as _ops
from .parallel.mesh import MeshTensor, is_split

__all__ = ["Executor"]


def _bind_context(ctx):
    """``(first context, mesh)`` of a bind: the mesh is the list's
    in-process ``DeviceMesh`` when its contexts resolve to distinct torch
    devices, else None."""
    if isinstance(ctx, (list, tuple)):
        from .context import as_context
        from .parallel.mesh import context_mesh
        ctxs = [as_context(c) for c in ctx]
        return ctxs[0], context_mesh(ctxs)
    return (ctx if isinstance(ctx, Context) else Context(ctx)), None


def _parts(value):
    """A value's tensors: a split ``MeshTensor``'s shards, else itself."""
    return value.shards if is_split(value) else [value]


def _ones_like(v):
    return v.map(torch.ones_like) if isinstance(v, MeshTensor) \
        else torch.ones_like(v)


class Executor:
    """A Symbol bound to argument, gradient and auxiliary arrays
    (reference: executor.py)."""

    def __init__(self, symbol, ctx, args, args_grad=None, grad_req="write",
                 aux_states=None, batch_args=None, group2ctx=None):
        self._symbol = symbol
        self._group2ctx = group2ctx
        self._ctx_arg = ctx
        self._ctx, self._mesh = _bind_context(ctx)
        self._batch_args = set(batch_args or ())
        self.arg_names = symbol.list_arguments()
        self.aux_names = symbol.list_auxiliary_states()
        self.output_names = symbol.list_outputs()

        if isinstance(args, dict):
            missing = [n for n in self.arg_names if n not in args]
            if missing:
                raise MXNetError("bind: missing arguments %s" % missing)
            self.arg_arrays = [args[n] for n in self.arg_names]
        else:
            args = list(args)
            if len(args) != len(self.arg_names):
                raise MXNetError("bind: expected %d args, got %d"
                                 % (len(self.arg_names), len(args)))
            self.arg_arrays = args

        if isinstance(grad_req, str):
            self._grad_req = {n: grad_req for n in self.arg_names}
        elif isinstance(grad_req, (list, tuple)):
            self._grad_req = dict(zip(self.arg_names, grad_req))
        else:
            self._grad_req = {n: grad_req.get(n, "null")
                              for n in self.arg_names}
        if isinstance(args_grad, dict) or args_grad is None:
            args_grad = args_grad or {}
            self.grad_arrays = [args_grad.get(n) for n in self.arg_names]
        else:
            args_grad = list(args_grad)
            self.grad_arrays = args_grad + \
                [None] * (len(self.arg_names) - len(args_grad))
        for n, g in zip(self.arg_names, self.grad_arrays):
            if g is None:
                self._grad_req[n] = "null"

        aux_states = aux_states if aux_states is not None else []
        if isinstance(aux_states, dict):
            self.aux_arrays = [aux_states[n] for n in self.aux_names]
        else:
            self.aux_arrays = list(aux_states)
        if len(self.aux_arrays) != len(self.aux_names):
            raise MXNetError("bind: expected %d aux states, got %d"
                             % (len(self.aux_names), len(self.aux_arrays)))

        if self._mesh is not None:
            if group2ctx:
                raise MXNetError(
                    "bind: group2ctx over contexts on distinct devices "
                    "(%s) places segments and splits the batch at once; "
                    "give one or the other" % (self._mesh,))
            self.arg_arrays = [self._mesh_batch(a) if n in
                               self._batch_args else a
                               for n, a in zip(self.arg_names,
                                               self.arg_arrays)]
        self.arg_dict = dict(zip(self.arg_names, self.arg_arrays))
        self.grad_dict = dict(zip(self.arg_names, self.grad_arrays))
        self.aux_dict = dict(zip(self.aux_names, self.aux_arrays))
        self.outputs = [None] * len(symbol._outputs)
        self._monitor_callback = None
        self._monitor_all = False
        self._tape = None            # (leaves, outputs) of a train forward
        self._build_plan()
        from .cached_op import _Graphs
        from . import placement
        self.graphs = _Graphs()
        self._cw_bucket = None      # a bucket of a shape ladder: its site
        self._grouped_runs = 0
        self._op_ctxs = placement.op_contexts(self._plan_nodes, group2ctx,
                                              self._ctx)
        self._op_devices = None
        if self._op_ctxs is not None:
            self._op_devices = [c.torch_device() for c in self._op_ctxs]
            placement.place(self._plan, self._op_devices, self.arg_arrays,
                            self.grad_arrays, self.aux_arrays)
            self._bias_defer = {}

    def _mesh_batch(self, arr):
        """A batch argument as a ``MeshNDArray`` split on dim 0 over the
        mesh; one that does not split stays as it is (replicated)."""
        from .ndarray.ndarray import MeshNDArray
        if isinstance(arr, MeshNDArray) or not arr.shape \
                or arr.shape[0] % self._mesh.size:
            return arr
        return MeshNDArray(self._mesh.split(
            arr._data.detach().to(self._mesh.devices[0]), 0), self._ctx)

    @property
    def mesh(self):
        """The in-process ``dp`` mesh of a bind over contexts on distinct
        devices; None otherwise."""
        return self._mesh

    # -- graph plan ------------------------------------------------------
    def _build_plan(self):
        arg_pos = {n: i for i, n in enumerate(self.arg_names)}
        aux_pos = {n: i for i, n in enumerate(self.aux_names)}
        self._plan = []
        self._plan_names = []
        self._plan_nodes = []
        node_slot = {}
        for node in self._symbol._topo_nodes():
            if node.is_variable():
                if node.name in aux_pos:
                    node_slot[id(node)] = ("var", ("aux", aux_pos[node.name]))
                elif node.name in arg_pos:
                    node_slot[id(node)] = ("var", ("arg", arg_pos[node.name]))
                else:
                    raise MXNetError("unbound variable %s" % node.name)
                continue
            nattrs = _ops.normalize_attrs(node.op, node.attrs)
            bindings = []
            for (src, i) in node.inputs:
                kind, ref = node_slot[id(src)]
                bindings.append(ref if kind == "var" else ("res", ref, i))
            # mutable input -> aux slot its new value is written back to
            aux_wb = [aux_pos.get(node.inputs[mi][0].name)
                      if mi < len(node.inputs)
                      and node.inputs[mi][0].is_variable() else None
                      for mi in node.op.mutable_inputs]
            slot = len(self._plan)
            self._plan.append((node.op, nattrs, tuple(bindings), aux_wb,
                               slot))
            self._plan_names.append(node.name)
            self._plan_nodes.append(node)
            node_slot[id(node)] = ("res", slot)
        self._head_refs = []
        for (n, i) in self._symbol._outputs:
            kind, ref = node_slot[id(n)]
            self._head_refs.append((ref[0], ref[1], 0) if kind == "var"
                                   else ("res", ref, i))
        self._needs_rng = any(op.needs_rng for op, *_ in self._plan)
        self._predict_draws = any(op.draws_in(nattrs, False)
                                  for op, nattrs, *_ in self._plan)
        self._host_code = any(op.runs_host_code(nattrs)
                              for op, nattrs, *_ in self._plan)
        self._grad_positions = [i for i, n in enumerate(self.arg_names)
                                if self._grad_req.get(n, "null") != "null"]
        self._plan_bias_defer()

    def _plan_bias_defer(self):
        """Peephole: a Convolution with a bias whose SOLE consumer is a
        train-mode channel-axis BatchNorm (the JAX executor's
        ``_plan_bias_defer``). BN subtracts the batch mean, which holds
        the bias, so ``BN(conv(x) + b)`` equals ``BN(conv(x))`` with the
        batch and moving means shifted by ``b`` (the variance does not
        move), and the bias gradient, the per-channel sum of BN's input
        gradient, is zero. A training run skips the bias pass: the conv
        runs biasless and the bias goes into BN's mean outputs.
        Predict runs are untouched: with the moving statistics the bias
        is live. ResNet v1's bottleneck keeps biased 1x1 convs, so this
        is on its path."""
        consumers = {}
        for pi, (op, nattrs, bindings, aux_wb, slot) in enumerate(self._plan):
            for b in bindings:
                if b[0] == "res":
                    consumers.setdefault((b[1], b[2]), []).append(pi)
        for h in self._head_refs:
            if h[0] == "res":
                consumers.setdefault((h[1], h[2]), []).append("head")
        self._bias_defer = {}
        for pi, (op, nattrs, bindings, aux_wb, slot) in enumerate(self._plan):
            if op.name != "Convolution" or nattrs.get("no_bias") \
                    or len(bindings) != 3:
                continue
            cons = consumers.get((slot, 0), [])
            if len(cons) != 1 or cons[0] == "head":
                continue
            bn_op, bn_attrs, bn_bind, _, _ = self._plan[cons[0]]
            if bn_op.name != "BatchNorm" \
                    or int(bn_attrs.get("axis", 1)) != 1 \
                    or bn_attrs.get("use_global_stats", False) \
                    or bn_bind[0] != ("res", slot, 0):
                continue
            self._bias_defer[pi] = (cons[0], bindings[2])

    def _make_graph_fn(self, is_train, allow_rewrites=True, tap=None):
        """``run(arg_vals, aux_vals) -> (outputs, new aux values)`` over
        tensors; ``tap(name, value)`` sees each op output (the monitor's
        per-op path, which runs the graph as defined: no peephole). A
        grouped executor moves each op's inputs to the op's device and
        draws from that device's generator."""
        plan, plan_names, head_refs = self._plan, self._plan_names, \
            self._head_refs
        bias_defer = self._bias_defer if (is_train and allow_rewrites) \
            else {}
        bn_bias = {bn_pi: (bias_b, float(self._plan[bn_pi][1].get(
            "momentum", 0.9))) for bn_pi, bias_b in bias_defer.values()}
        devices, rngs = self._op_devices, None
        if self._needs_rng:
            from . import random as _random
            rngs = [_random.generator(d) if op.needs_rng else None
                    for (op, *_), d in zip(
                        plan, devices or [self._ctx.torch_device()]
                        * len(plan))]

        def run(arg_vals, aux_vals):
            results = []
            new_aux = list(aux_vals)

            def resolve(b):
                if b[0] == "arg":
                    return arg_vals[b[1]]
                if b[0] == "aux":
                    return new_aux[b[1]]
                return results[b[1]][b[2]]
            for pi, (op, nattrs, bindings, aux_wb, slot) in enumerate(plan):
                attrs = nattrs
                if pi in bias_defer:
                    bindings = bindings[:2]
                    attrs = dict(attrs, no_bias=True)
                if "__train__" in op.defaults:
                    attrs = dict(attrs, __train__=is_train)
                vals = [resolve(b) for b in bindings]
                if devices is not None:
                    # the cross-group transfer: a no-op inside a segment
                    vals = [v.to(devices[pi]) for v in vals]
                out = _ops.call(op, attrs, vals,
                                rngs[pi] if op.needs_rng else None)
                if not isinstance(out, (tuple, list)):
                    out = (out,)
                n_out = op.resolve_num_outputs(attrs)
                if pi in bn_bias:
                    bias_b, momentum = bn_bias[pi]
                    out = _bn_add_bias(out, resolve(bias_b), momentum, n_out)
                if tap is not None:
                    for oi in range(n_out):
                        tap(plan_names[pi] + "_output"
                            + (str(oi) if n_out > 1 else ""), out[oi])
                results.append(tuple(out[:n_out]))
                for wb, val in zip(aux_wb, out[n_out:]):
                    if wb is not None:
                        new_aux[wb] = val
            outs = [arg_vals[h[1]] if h[0] == "arg" else
                    new_aux[h[1]] if h[0] == "aux" else results[h[1]][h[2]]
                    for h in head_refs]
            return tuple(outs), tuple(new_aux)
        return run

    # -- execution -------------------------------------------------------
    def _gather_inputs(self, kwargs):
        """Write the given inputs into the bound arrays, in place (a new
        tensor only where the shape changes: a new signature)."""
        from .ndarray import NDArray
        from .ndarray.ndarray import MeshNDArray
        for k, v in kwargs.items():
            if k not in self.arg_dict:
                raise MXNetError("unknown argument %s" % k)
            dst = self.arg_dict[k]
            if isinstance(dst, MeshNDArray):
                src = v if isinstance(v, NDArray) else torch.as_tensor(v)
                dst.assign(src)
                continue
            src = v._data if isinstance(v, NDArray) else torch.as_tensor(v)
            # a floating NDArray of another float dtype (a bfloat16 batch
            # for bfloat16 weights): the bound array adopts its dtype
            adopt = isinstance(v, NDArray) and src.dtype != dst._data.dtype \
                and src.is_floating_point() and dst._data.is_floating_point()
            if tuple(src.shape) == dst.shape and not adopt:
                with torch.no_grad():
                    dst._data.copy_(src)
            else:
                dst._set_data(src.to(dst._data.device,
                                     src.dtype if adopt else dst._data.dtype,
                                     copy=True))

    def _values(self):
        from .ndarray.ndarray import raw_value
        return ([raw_value(a) for a in self.arg_arrays],
                [a._data for a in self.aux_arrays])

    def _store_outputs(self, outs):
        from .ndarray.ndarray import MeshNDArray, wrap_value
        for i, o in enumerate(outs):
            cur = self.outputs[i]
            if cur is None or isinstance(cur, MeshNDArray) \
                    != isinstance(o, MeshTensor):
                self.outputs[i] = wrap_value(o, self._ctx)
            elif isinstance(cur, MeshNDArray):
                cur._mt = o
            else:
                cur._data = o

    def _store_aux(self, old, new_aux):
        """The moving statistics an op updated, copied into their arrays."""
        with torch.no_grad():
            for arr, before, val in zip(self.aux_arrays, old, new_aux):
                if val is not before:
                    arr._data.copy_(val)

    def _predict(self):
        """The plan in predict mode: one CUDA graph per signature on the
        card, op by op elsewhere, and op by op (counted) for a plan that
        draws in predict mode or a grouped executor."""
        args, aux = self._values()
        run = self._make_graph_fn(False)
        tensors = args + aux
        if self._mesh is not None:
            _ops.registry.note_lockstep("executor:fwd:eval")
            with torch.no_grad():
                return run(args, aux)[0]
        if self._op_devices is not None:
            self._grouped_runs += 1
            with torch.no_grad():
                return run(args, aux)[0]
        if self.graphs.site is None:
            self.graphs.site = self._cw_site()
        n_args = len(args)
        data = tuple(i for i, n in enumerate(self.arg_names)
                     if n in self._batch_args)

        def body(feed):
            with torch.no_grad():
                return run(feed[:n_args], feed[n_args:])[0]
        serves = self.graphs.serves(tensors)
        if serves and self._host_code:
            self.graphs.note_eager_host()
        elif serves and not self._predict_draws:
            return tuple(self.graphs.run(body, tensors, data))
        elif serves:
            self.graphs.note_eager_rng()
        return tuple(self.graphs.eager(body, tensors, data))

    def _cw_site(self):
        """The predict program's compile-watch site: ``executor:fwd:
        eval``, or the bucket's own ``bucketing:<shape>`` for one bucket
        of a shape ladder; arguments named as the symbol names them."""
        from .compile_watch import Site
        names = list(self.arg_names) + ["aux:%s" % n
                                        for n in self.aux_names]
        if self._cw_bucket is None:
            return Site("executor:fwd:eval", names=names)
        from .bucketing.ladder import bucket_site
        return Site(bucket_site(self._cw_bucket),
                    statics=("bucket", "fwd", False, self._cw_bucket),
                    names=names)

    def _forward_tape(self, args, aux, is_train):
        """One forward under torch autograd over the grad-carrying
        arguments of the given argument and auxiliary tensors (the bound
        arrays' own); the moving statistics are written back once (train
        mode). Returns ``(leaves, outputs)``."""
        args = list(args)
        leaves = []
        for p in self._grad_positions:
            args[p] = args[p].detach()
            if isinstance(args[p], MeshTensor):
                for shard in args[p].shards:
                    shard.requires_grad_(True)
            else:
                args[p].requires_grad_(True)
            leaves.append(args[p])
        if self._mesh is not None:
            _ops.registry.note_lockstep("executor:fwd:train")
        with torch.enable_grad():
            outs, new_aux = self._make_graph_fn(is_train)(args, aux)
        if is_train:
            self._store_aux(aux, new_aux)
        return leaves, outs

    @staticmethod
    def _tape_grads(leaves, outs, ogs):
        """``torch.autograd.grad`` of the outputs that carry a graph, with
        head gradients ``ogs``; None for a leaf they do not reach. A
        split output or leaf (the mesh) goes shard by shard: a leaf's
        gradient is then a ``MeshTensor``."""
        live = [(o, g) for o, g in zip(outs, ogs) if o.requires_grad]
        if not live:
            return [None] * len(leaves)
        roots, heads = [], []
        for o, g in live:
            if is_split(o) and not is_split(g):
                g = o.mesh.split(g, o.axis)
            roots += _parts(o)
            heads += _parts(g)
        parts = [_parts(leaf) for leaf in leaves]
        grads = iter(torch.autograd.grad(
            roots, [t for p in parts for t in p], grad_outputs=heads,
            allow_unused=True))
        out = []
        for leaf, p in zip(leaves, parts):
            g = [next(grads) for _ in p]
            out.append(g[0] if not is_split(leaf)
                       else None if any(x is None for x in g)
                       else MeshTensor(g, leaf.mesh, leaf.axis))
        return out

    def _train(self, is_train):
        """One training forward; returns the outputs, keeping the tape
        for ``backward``."""
        self._tape = self._forward_tape(*self._values(), is_train)
        return tuple(o.detach() for o in self._tape[1])

    def fused_forward_backward(self, args, aux, og_scale=None):
        """The training forward and its backward over the bound arrays'
        argument and auxiliary tensors, for the fused step to capture
        (the JAX executor's ``fused_plan``): the head gradients are ones
        (times ``og_scale``, a 0-d tensor, under loss scaling; a loss
        layer ignores them). Returns ``(outputs, grads)``, zeros for a
        grad-carrying argument the outputs do not reach; nothing reads a
        device value on the host."""
        leaves, outs = self._forward_tape(args, aux, True)
        ogs = [torch.ones_like(o) for o in outs]
        if og_scale is not None:
            ogs = [g * og_scale.to(g.dtype) for g in ogs]
        grads = self._tape_grads(leaves, outs, ogs)
        return [o.detach() for o in outs], \
            [torch.zeros_like(x) if g is None else g
             for x, g in zip(leaves, grads)]

    def rng_generators(self):
        """The distinct ``torch.Generator``s a training run of the plan
        draws from (a CUDA graph registers them, so each replay draws
        anew)."""
        if not self._needs_rng:
            return []
        from . import random as _random
        devices = self._op_devices or [self._ctx.torch_device()] \
            * len(self._plan)
        gens = []
        for (op, *_), d in zip(self._plan, devices):
            if op.needs_rng:
                g = _random.generator(d)
                if all(g is not h for h in gens):
                    gens.append(g)
        return gens

    @property
    def cw_cache_token(self):
        """The bound graph's content fingerprint for the persistent
        compile cache (``compile_cache.graph_token`` of its JSON): two
        symbols of one shape signature differ there. None while no cache
        is on (not latched: one may come on later) or when the graph
        does not serialize."""
        if not hasattr(self, "_cw_token"):
            from . import compile_cache
            if not compile_cache.enabled():
                return None
            try:
                self._cw_token = compile_cache.graph_token(
                    self._symbol.tojson())
            except Exception:       # a graph that will not serialize
                self._cw_token = None
        return self._cw_token

    @property
    def grouped(self):
        """True for a placed executor (``group2ctx`` names a group)."""
        return self._op_ctxs is not None

    def stats(self):
        """The predict graphs' counters (``cached_op._Graphs.stats``) and
        ``grouped``: the predict runs of a placed executor, op by op
        because a CUDA graph cannot hold a segment on the host."""
        return dict(self.graphs.stats(), grouped=self._grouped_runs)

    def forward(self, is_train=False, **kwargs):
        """Run the graph on the bound arrays (``kwargs`` are written into
        them first); returns :attr:`outputs`."""
        self._gather_inputs(kwargs)
        self._tape = None
        if self._monitor_callback is not None and self._monitor_all:
            args, aux = self._values()
            from .ndarray.ndarray import wrap_value
            run = self._make_graph_fn(
                bool(is_train), allow_rewrites=False,
                tap=lambda name, v: self._monitor_callback(
                    name, wrap_value(v.detach(), self._ctx)))
            with torch.no_grad():
                outs, new_aux = run(args, aux)
            if is_train:
                self._store_aux(aux, new_aux)
        elif is_train:
            outs = self._train(True)
        else:
            outs = self._predict()
        self._store_outputs(outs)
        if self._monitor_callback is not None and not self._monitor_all:
            self._run_monitor()
        return self.outputs

    def backward(self, out_grads=None, is_train=True):
        """Gradients of the last training forward into the grad arrays
        (``out_grads``: the head gradients, ones by default; a loss
        layer ignores them). Without a pending training forward, runs
        one first."""
        if self._tape is None:
            self.forward_backward(out_grads=out_grads, is_train=is_train)
            return
        self._write_grads(out_grads)
        if self._monitor_callback is not None:
            self._run_monitor()

    def forward_backward(self, out_grads=None, is_train=True, **kwargs):
        """One forward and its backward: the moving statistics update
        once."""
        self._gather_inputs(kwargs)
        if not self._grad_positions:
            self.forward(is_train=is_train)
            return
        self._store_outputs(self._train(bool(is_train)))
        self._write_grads(out_grads)
        if self._monitor_callback is not None:
            self._run_monitor()

    def _write_grads(self, out_grads):
        from .ndarray import NDArray
        leaves, outs = self._tape
        self._tape = None
        if out_grads is None:
            ogs = [_ones_like(o) for o in outs]
        else:
            if isinstance(out_grads, NDArray):
                out_grads = [out_grads]
            ogs = [g._data for g in out_grads]
        grads = self._tape_grads(leaves, outs, ogs)
        with torch.no_grad():
            for p, g in zip(self._grad_positions, grads):
                tgt = self.grad_arrays[p]._data
                if isinstance(g, MeshTensor):
                    g = g.full()
                if self._grad_req[self.arg_names[p]] == "add":
                    if g is not None:
                        tgt.add_(g)
                elif g is None:
                    tgt.zero_()
                else:
                    tgt.copy_(g)

    # -- misc API parity -------------------------------------------------
    def reshape(self, partial_shaping=False, allow_up_sizing=False,
                **kwargs):
        """An executor for new input shapes, sharing every array whose
        shape stays."""
        from .ndarray import zeros
        arg_shapes, _, _ = self._symbol.infer_shape(**kwargs)
        new_args = [arr if arr.shape == tuple(shape)
                    else zeros(shape, ctx=self._ctx, dtype=arr.dtype)
                    for arr, shape in zip(self.arg_arrays, arg_shapes)]
        grads = {}
        for name, g, shape in zip(self.arg_names, self.grad_arrays,
                                  arg_shapes):
            if g is not None:
                grads[name] = g if g.shape == tuple(shape) \
                    else zeros(shape, ctx=self._ctx, dtype=g.dtype)
        return Executor(self._symbol, self._ctx_arg, new_args, grads,
                        self._grad_req, self.aux_arrays,
                        batch_args=self._batch_args,
                        group2ctx=self._group2ctx)

    def copy_params_from(self, arg_params, aux_params=None,
                         allow_extra_params=False):
        """Copy parameter values into the bound arrays, in place (a value
        of another float dtype is adopted: :meth:`adopt_value`)."""
        for table, params, what in ((self.arg_dict, arg_params,
                                     "arguments"),
                                    (self.aux_dict, aux_params or {},
                                     "auxiliary states")):
            for name, arr in params.items():
                if name in table:
                    self.adopt_value(name, arr)
                elif not allow_extra_params:
                    raise MXNetError("Found name \"%s\" that is not in the "
                                     "%s" % (name, what))

    def adopt_value(self, name, src):
        """Write ``src`` into the bound array ``name`` (an argument or an
        auxiliary state): in place when the dtypes agree; a value of
        another floating dtype (an AMP policy's bfloat16 weight) replaces
        the array in that dtype, and the argument's gradient array
        follows it."""
        dst = self.arg_dict[name] if name in self.arg_dict \
            else self.aux_dict[name]
        if src is dst:
            return
        if src._data.dtype == dst._data.dtype \
                or not (src._data.is_floating_point()
                        and dst._data.is_floating_point()):
            with torch.no_grad():
                dst._data.copy_(src._data)
            return
        dst._set_data(src._data.detach().to(dst._data.device, copy=True))
        grad = self.grad_dict.get(name)
        if grad is not None:
            grad._set_data(torch.zeros_like(dst._data))

    def set_monitor_callback(self, callback, monitor_all=False):
        """``callback(name, NDArray)`` after each forward on every output,
        or, with ``monitor_all``, on every op's output (the plan then
        runs op by op, as defined)."""
        self._monitor_callback = callback
        self._monitor_all = monitor_all

    def _run_monitor(self):
        for name, out in zip(self.output_names, self.outputs):
            self._monitor_callback(name, out)

    @property
    def output_dict(self):
        return dict(zip(self.output_names, self.outputs))

    def debug_str(self):
        lines = ["Symbol Outputs:"]
        lines += ["\toutput=%s" % n for n in self.output_names]
        lines += ["Op:%s" % op.name for op, *_ in self._plan]
        return "\n".join(lines)


def _bn_add_bias(out, bias, momentum, n_out):
    """Shift a BatchNorm's mean outputs by a deferred conv bias: the
    batch mean (an output under ``output_mean_var``) by the whole bias,
    the moving-mean write-back by its ``(1 - momentum)`` share (the
    blend ``momentum * old + (1 - momentum) * batch_mean``). The bias is
    detached: BN's mean output carries no gradient."""
    bias = bias.detach()
    out = list(out)
    if n_out == 3:
        out[1] = out[1] + bias.to(out[1].dtype)
    out[n_out] = out[n_out] + ((1.0 - momentum) * bias).to(out[n_out].dtype)
    return tuple(out)
