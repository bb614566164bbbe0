"""CachedOp — a traced Symbol graph run as one operator (counterpart of
``mxnet_tpu/cached_op.py``, the Gluon ``hybridize`` backend).

:func:`build_graph_callable` turns a Symbol into a plan over torch
tensors: ``fn(attrs, *args_then_aux, rng=None)`` runs the graph's ops in
topological order and returns the outputs followed by the new values of
the auxiliary states (BatchNorm's moving statistics), the JAX package's
contract. :class:`CachedOp` runs that plan:

- on CUDA tensors, outside ``autograd.record()`` and in predict mode, as
  ONE CUDA graph per input signature (shapes, strides, dtypes), the
  counterpart of the JAX CachedOp's one jitted XLA executable. The graph
  is captured at the signature's first call (an eager call on a side
  stream first, which lets cuDNN pick its algorithms and allocate its
  workspace outside the capture) and replayed after: the data inputs
  are copied into the graph's static buffers, the other inputs
  (parameters, auxiliary states) are read in place, and the outputs are
  copied out of the graph's buffers, so a later call never changes what
  an earlier one returned. A graph remembers the storage of the inputs
  it reads in place: a replaced tensor (not one written in place, as
  ``Parameter.set_data`` does) recaptures the signature's graph, and
  :meth:`CachedOp.stats` counts it. A capture that fails raises; there
  is no eager fallback;
- otherwise op by op through :func:`~mxnet_tpu_torch.ndarray.invoke_nd`:
  torch autograd records it under ``record()``, and the auxiliary
  states are written back in place (train mode updates the moving
  statistics).

Predict mode keeps its graph whatever ops the plan holds, unless one of
them draws random numbers in predict mode (``OpDef.draws_in``: Dropout
draws nothing there unless ``mode="always"``). Such a plan runs op by op
on the card too, and :meth:`CachedOp.stats` counts each such call
(``eager_rng``): a graph would replay one frozen mask. A plan holding an
op that runs user Python (``Custom``, or a loop whose body holds one:
``OpDef.runs_host_code``) never takes a graph either, in either mode: it
runs op by op, each call on the card counted as ``eager_host``, since
the user's code may read a device value on the host. A control-flow
node (``_foreach``, ``_while_loop``, ``_cond``) is captured whole with
the rest of the plan.

Each graph holder reports to :mod:`~mxnet_tpu_torch.compile_watch`
under its site (``op:_cachedopN.<head>`` here): a capture on the card,
or the first call of a signature on the CPU, is one recorded compile
while the watch is on.

Over a batch split on the in-process mesh (a ``MeshNDArray`` input:
``split_and_load`` over contexts on distinct devices) the plan runs node
by node in lockstep over the shards, each node by its op's mesh rule
(``ops.registry.call``), in both modes and never as a CUDA graph;
``ops.mesh_stats()`` counts each such call under ``lockstep``.

A plan that runs inside another program's body (an
``InferenceServer`` bucket over an in-process callable holding a
hybridized block) runs op by op there: its ops are captured by the outer
graph, and a capture of its own would nest inside the outer one.

The JAX CachedOp hands the persistent compile cache a graph token
(``compile_cache.graph_token`` of its symbol's JSON) because the cache
keeps its XLA program. No program of the port is persisted: a CUDA graph
cannot be written to disk, so a restart captures each signature again.
What the cache keeps is the device code a capture's warm-up call builds
(:mod:`~mxnet_tpu_torch.compile_cache`), so a restart builds and
compiles nothing again, and CachedOp takes no token.
"""
from __future__ import annotations

import gc
import itertools
import threading
import time

import torch

from .base import MXNetError
from . import ops as _ops
from .ops.registry import OpDef

__all__ = ["CachedOp", "build_graph_callable"]

_counter = itertools.count()

# torch.cuda.graph syncs the device and empties the cache before it
# captures: one capture at a time in the process
_CAPTURE_LOCK = threading.Lock()

# set on a thread while it runs a program's body (a capture's warm-up
# and capture, or a CPU program's call): a graph holder reached from
# there runs its body directly, inside the outer program
_body = threading.local()


def in_program():
    """True while this thread runs the body of a graph holder's
    program."""
    return getattr(_body, "depth", 0) > 0


class _InBody:
    def __enter__(self):
        _body.depth = getattr(_body, "depth", 0) + 1

    def __exit__(self, *exc):
        _body.depth -= 1


def build_graph_callable(symbol):
    """A replay plan over ``symbol``: returns ``(fn, arg_names,
    aux_names, n_rng, n_out)``, where ``fn(attrs, *vals, rng=None)``
    takes the arguments then the auxiliary states (in the order of
    ``arg_names`` and ``aux_names``) and returns the ``n_out`` outputs
    followed by the new auxiliary values. ``attrs["__train__"]`` sets
    the train mode of every op that has one; ``rng`` (a
    ``torch.Generator``) feeds the ``n_rng`` ops that draw."""
    arg_names = symbol.list_arguments()
    aux_names = symbol.list_auxiliary_states()
    arg_pos = {n: i for i, n in enumerate(arg_names)}
    aux_pos = {n: len(arg_names) + i for i, n in enumerate(aux_names)}

    plan = []
    node_slot = {}
    n_rng = 0
    for node in symbol._topo_nodes():
        if node.is_variable():
            pos = aux_pos.get(node.name, arg_pos.get(node.name))
            if pos is None:
                raise MXNetError("unbound variable %s" % node.name)
            node_slot[id(node)] = ("var", pos)
            continue
        bindings = tuple((*node_slot[id(s)], i) for (s, i) in node.inputs)
        aux_wb = [aux_pos.get(node.inputs[mi][0].name)
                  if mi < len(node.inputs)
                  and node.inputs[mi][0].is_variable() else None
                  for mi in node.op.mutable_inputs]
        n_rng += int(node.op.needs_rng)
        plan.append((node.op, _ops.normalize_attrs(node.op, node.attrs),
                     bindings, aux_wb))
        node_slot[id(node)] = ("res", len(plan) - 1)

    head_refs = [(*node_slot[id(n)], i) for (n, i) in symbol._outputs]
    n_args, n_aux = len(arg_names), len(aux_names)

    def fn(attrs, *vals, rng=None):
        is_train = bool(attrs.get("__train__", False))
        cur = list(vals)        # args + aux (aux replaced as ops update it)
        results = []
        for (op, nattrs, bindings, aux_wb) in plan:
            ivals = [cur[ref] if kind == "var" else results[ref][i]
                     for (kind, ref, i) in bindings]
            a = dict(nattrs, __train__=is_train) \
                if "__train__" in op.defaults else nattrs
            out = _ops.call(op, a, ivals, rng)
            if not isinstance(out, (tuple, list)):
                out = (out,)
            k = op.resolve_num_outputs(a)
            results.append(tuple(out[:k]))
            for wb, val in zip(aux_wb, out[k:]):
                if wb is not None:
                    cur[wb] = val
        outs = [cur[ref] if kind == "var" else results[ref][i]
                for (kind, ref, i) in head_refs]
        return tuple(outs) + tuple(cur[n_args:n_args + n_aux])

    return fn, arg_names, aux_names, n_rng, len(head_refs)


def _cuda_capture(body, device, pool, generators=()):
    """Capture ``body()`` as a CUDA graph on ``device``: one eager call on
    a side stream first (it builds the kernels, lets cuDNN pick its
    algorithms and sets up cuBLAS outside the capture), then the capture
    into the graph memory pool ``pool``. The mode is thread-local, so
    other threads keep launching and synchronising while this one
    captures. ``generators`` are the ``torch.Generator``s the body draws
    from, registered with the graph so that each replay draws anew.
    Returns ``(replay, output, launches)``: the graph's replay, the
    body's output (its buffers, written by each replay) and the kernel
    launches it holds."""
    from .parallel import flash_attention as fa
    cur = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
    side.wait_stream(cur)
    with torch.cuda.stream(side):
        body()
    cur.wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    for gen in generators:
        graph.register_generator_state(gen)
    # Python's cyclic collector stays off while the stream captures: a
    # collected block can free another CUDA graph, whose destruction is
    # not permitted during a capture and invalidates it
    collecting = gc.isenabled()
    gc.disable()
    try:
        with fa.recording_launches() as held:
            with torch.cuda.graph(graph, pool=pool,
                                  capture_error_mode="thread_local"):
                out = body()
    finally:
        if collecting:
            gc.enable()
    return graph.replay, out, held


class _Entry:
    """One captured signature: its replay, output buffers, kernel
    launches, the static buffers of its data inputs, the storage of the
    inputs it reads in place (kept alive with it), and its cost entry
    in the compile watch (None while the watch is off)."""

    __slots__ = ("replay", "outputs", "launches", "static", "bound", "held",
                 "cost")

    def __init__(self, replay, outputs, launches, static, bound, held,
                 cost=None):
        self.replay = replay
        self.outputs = outputs
        self.launches = launches
        self.static = static
        self.bound = bound
        self.held = held
        self.cost = cost


def _replaced(names, old_bound, new_bound, data_indices, n):
    """The names of the in-place inputs whose storage changed between
    two bindings of one signature."""
    kept = [i for i in range(n) if i not in data_indices]
    return [str(names[i]) if names is not None and i < len(names)
            else "arg%d" % i
            for i, a, b in zip(kept, old_bound, new_bound) if a != b]


class _Graphs:
    """A CachedOp's graphs, one per input signature, on devices of
    ``device_type``. ``capture(body, device, pool)`` makes a graph
    (:func:`_cuda_capture` on the card; the tests drive the bookkeeping
    on the CPU with a stand-in)."""

    def __init__(self, device_type="cuda", capture=_cuda_capture):
        self.device_type = device_type
        self._capture = capture
        self._pool = None
        self._entries = {}
        self._eager = {}        # signature -> (bound, held, cost)
        self._lock = threading.Lock()
        self.captures = 0
        self.replays = 0
        self.recaptures = 0
        self.eager_rng = 0
        self.eager_host = 0
        # the compile watch's site (compile_watch.Site); None reports
        # nothing
        self.site = None

    def note_eager_rng(self):
        """Count one call the graphs could have served that ran op by op
        because the plan draws in predict mode."""
        with self._lock:
            self.eager_rng += 1

    def note_eager_host(self):
        """Count one call the graphs could have served that ran op by op
        because the plan runs user Python (a ``Custom`` op)."""
        with self._lock:
            self.eager_host += 1

    def serves(self, tensors):
        return bool(tensors) and all(t.device.type == self.device_type
                                     for t in tensors)

    @staticmethod
    def _key(tensors, data_indices):
        sig = tuple((tuple(t.shape), t.stride(), t.dtype, t.device)
                    for t in tensors)
        bound = tuple(t.data_ptr() for i, t in enumerate(tensors)
                      if i not in data_indices)
        return sig, bound

    def run(self, body, tensors, data_indices):
        """``body(feed)`` by graph replay; ``feed`` is ``tensors`` with
        each data input replaced by its static buffer. Returns copies of
        the outputs. Inside another program's body (:func:`in_program`)
        the body runs directly, its ops captured by the outer graph;
        inside ``engine.naive_engine()`` it runs op by op (no capture,
        no replay)."""
        from . import compile_watch, engine
        from .parallel import flash_attention as fa
        if in_program():
            return list(body(list(tensors)))
        if engine.is_naive():
            return list(self.eager(body, tensors, data_indices))
        sig, bound = self._key(tensors, data_indices)
        entry = self._entries.get(sig)
        if entry is None or entry.bound != bound:
            entry = self._capture_entry(sig, body, tensors, data_indices,
                                        bound, again=entry)
        for i, buf in zip(data_indices, entry.static):
            buf.copy_(tensors[i])
        entry.replay()
        fa.add_launches(entry.launches)
        with self._lock:
            self.replays += 1
        if entry.cost is not None:
            compile_watch.accrue(self.site, entry.cost)
        return [o.clone() for o in entry.outputs]

    def _capture_entry(self, sig, body, tensors, data_indices, bound,
                       again):
        from . import compile_watch
        self._entries.pop(sig, None)        # its graph and pool blocks go
        static = [tensors[i].clone() for i in data_indices]
        feed = list(tensors)
        for i, buf in zip(data_indices, static):
            feed[i] = buf
        device = tensors[0].device
        if device.type == "cuda" and self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()

        def call():
            with _InBody():
                return body(feed)
        watched = self.site is not None and compile_watch.enabled()
        cost = {}
        if watched:
            call, cost = compile_watch.counted(call)
        with _CAPTURE_LOCK:
            t0 = time.perf_counter()
            replay, outputs, launches = self._capture(call, device,
                                                      self._pool)
            dur = time.perf_counter() - t0
        held = [t for i, t in enumerate(tensors) if i not in data_indices]
        entry = _Entry(replay, outputs, dict(launches), static, bound, held)
        if watched:
            replaced = () if again is None else _replaced(
                self.site.names, again.bound, bound, data_indices,
                len(tensors))
            entry.cost = compile_watch.note_compile(
                self.site, tensors, dur, cost, replaced)
        self._entries[sig] = entry
        with self._lock:
            self.captures += 1
            self.recaptures += int(again is not None)
        return entry

    def eager(self, body, tensors, data_indices=()):
        """``body(tensors)`` called directly (off the card, or where the
        caller runs op by op). While the watch is on, the first call of
        a signature (with its in-place inputs' storage) is this site's
        compile, timed and costed; later calls accrue its cost."""
        from . import compile_watch
        if self.site is None or not compile_watch.enabled():
            with _InBody():
                return body(tensors)
        sig, bound = self._key(tensors, data_indices)
        seen = self._eager.get(sig)
        if seen is not None and seen[0] == bound \
                and seen[2] is not None:
            with _InBody():
                out = body(tensors)
            compile_watch.accrue(self.site, seen[2])
            return out

        def call():
            with _InBody():
                return body(tensors)
        call, cost = compile_watch.counted(call)
        t0 = time.perf_counter()
        out = call()
        dur = time.perf_counter() - t0
        replaced = () if seen is None else _replaced(
            self.site.names, seen[0], bound, data_indices, len(tensors))
        entry = compile_watch.note_compile(self.site, tensors, dur, cost,
                                           replaced)
        held = [t for i, t in enumerate(tensors) if i not in data_indices]
        self._eager[sig] = (bound, held, entry)
        compile_watch.accrue(self.site, entry)
        return out

    def stats(self):
        with self._lock:
            return {"captures": self.captures, "replays": self.replays,
                    "recaptures": self.recaptures,
                    "signatures": len(self._entries),
                    "eager_rng": self.eager_rng,
                    "eager_host": self.eager_host}


class CachedOp:
    """A Symbol graph as one callable over NDArrays (reference:
    ndarray.CachedOp / MXCreateCachedOpEx). Inputs are the graph's
    arguments then its auxiliary states; ``data_indices`` names the
    inputs that change from call to call (a block's call arguments):
    the CUDA graphs stage them into static buffers and read every other
    input in place. ``flags`` (``hybridize``'s keyword arguments, the
    reference's ``static_alloc`` and the like) are accepted and unused:
    a CUDA graph allocates statically by construction."""

    def __init__(self, sym, flags=(), data_indices=()):
        self.symbol = sym
        fn, arg_names, aux_names, n_rng, n_out = build_graph_callable(sym)
        self.arg_names = arg_names
        self.aux_names = aux_names
        self.num_inputs = len(arg_names) + len(aux_names)
        self._fn = fn
        self._n_out = n_out
        self._data_indices = tuple(data_indices)
        nodes = [(n.op, _ops.normalize_attrs(n.op, n.attrs))
                 for n in sym._topo_nodes() if n.op is not None]
        self._predict_draws = any(op.draws_in(a, False) for op, a in nodes)
        self._host_code = any(op.runs_host_code(a) for op, a in nodes)
        # name the op after the graph's head, so a trace tells which
        # hybridized block ran
        outs = sym.list_outputs()
        head = "".join(c if c.isalnum() or c == "_" else "_"
                       for c in (outs[0] if outs else "graph"))[:40]
        self._op = OpDef(
            "_cachedop%d.%s" % (next(_counter), head), fn,
            arg_names=arg_names + aux_names,
            defaults={"__train__": False}, num_outputs=n_out,
            needs_rng=bool(n_rng),
            mutable_inputs=range(len(arg_names), self.num_inputs),
            description="CachedOp(%s)" % outs, mesh="native")
        self.graphs = _Graphs()
        from .compile_watch import Site
        self.graphs.site = Site("op:%s" % self._op.name,
                                names=arg_names + aux_names)

    def __call__(self, *inputs):
        from . import autograd
        from .ndarray.ndarray import NDArray, invoke_nd
        if len(inputs) != self.num_inputs:
            raise MXNetError(
                "CachedOp expects %d inputs (%d args + %d aux), got %d"
                % (self.num_inputs, len(self.arg_names),
                   len(self.aux_names), len(inputs)))
        from .parallel.mesh import is_split
        from .ndarray.ndarray import raw_value
        if any(is_split(raw_value(x)) for x in inputs):
            return invoke_nd(self._op, list(inputs), {})
        tensors = [x._data for x in inputs]
        serves = self.graphs.serves(tensors)
        if serves and self._host_code:
            self.graphs.note_eager_host()
        if autograd.is_recording() or autograd.is_training():
            return invoke_nd(self._op, list(inputs), {})
        if serves and self._predict_draws and not self._host_code:
            self.graphs.note_eager_rng()
        if not serves or self._predict_draws or self._host_code:
            return self.graphs.eager(
                lambda _t: invoke_nd(self._op, list(inputs), {}), tensors,
                self._data_indices)
        outs = [NDArray(o) for o in self.graphs.run(
            self._graph_body, tensors, self._data_indices)]
        return outs[0] if len(outs) == 1 else outs

    def _graph_body(self, feed):
        """The plan in predict mode; an auxiliary state the plan updates
        is written back into its input buffer inside the graph."""
        with torch.no_grad():
            res = self._fn({"__train__": False}, *feed)
            for old, new in zip(feed[len(self.arg_names):],
                                res[self._n_out:]):
                if new is not old:
                    old.copy_(new)
        return res[:self._n_out]

    def stats(self):
        """Graph counters: captures (recaptures included), replays (one
        per call by graph, the capturing call too), recaptures (a
        signature captured again over replaced tensors), the live
        signatures, and the predict calls on the graphs' device that ran
        op by op because the plan draws (``eager_rng``) or, in either
        mode, because it runs user Python (``eager_host``)."""
        return self.graphs.stats()
