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
(``eager_rng``): a graph would replay one frozen mask.

The JAX CachedOp's graph token for the persistent compile cache has no
counterpart here until ``compile_cache.py`` is ported (ROADMAP queue A
item 11).
"""
from __future__ import annotations

import gc
import itertools
import threading

import torch

from .base import MXNetError
from . import ops as _ops
from .ops.registry import OpDef

__all__ = ["CachedOp", "build_graph_callable"]

_counter = itertools.count()

# torch.cuda.graph syncs the device and empties the cache before it
# captures: one capture at a time in the process
_CAPTURE_LOCK = threading.Lock()


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
            out = op.forward(a, *ivals, rng=rng) if op.needs_rng \
                else op.forward(a, *ivals)
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
    launches, the static buffers of its data inputs, and the storage of
    the inputs it reads in place (kept alive with it)."""

    __slots__ = ("replay", "outputs", "launches", "static", "bound", "held")

    def __init__(self, replay, outputs, launches, static, bound, held):
        self.replay = replay
        self.outputs = outputs
        self.launches = launches
        self.static = static
        self.bound = bound
        self.held = held


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
        self._lock = threading.Lock()
        self.captures = 0
        self.replays = 0
        self.recaptures = 0
        self.eager_rng = 0

    def note_eager_rng(self):
        """Count one call the graphs could have served that ran op by op
        because the plan draws in predict mode."""
        with self._lock:
            self.eager_rng += 1

    def serves(self, tensors):
        return bool(tensors) and all(t.device.type == self.device_type
                                     for t in tensors)

    def run(self, body, tensors, data_indices):
        """``body(feed)`` by graph replay; ``feed`` is ``tensors`` with
        each data input replaced by its static buffer. Returns copies of
        the outputs."""
        from .parallel import flash_attention as fa
        sig = tuple((tuple(t.shape), t.stride(), t.dtype, t.device)
                    for t in tensors)
        bound = tuple(t.data_ptr() for i, t in enumerate(tensors)
                      if i not in data_indices)
        entry = self._entries.get(sig)
        if entry is None or entry.bound != bound:
            entry = self._capture_entry(sig, body, tensors, data_indices,
                                        bound, again=entry is not None)
        for i, buf in zip(data_indices, entry.static):
            buf.copy_(tensors[i])
        entry.replay()
        fa.add_launches(entry.launches)
        with self._lock:
            self.replays += 1
        return [o.clone() for o in entry.outputs]

    def _capture_entry(self, sig, body, tensors, data_indices, bound,
                       again):
        self._entries.pop(sig, None)        # its graph and pool blocks go
        static = [tensors[i].clone() for i in data_indices]
        feed = list(tensors)
        for i, buf in zip(data_indices, static):
            feed[i] = buf
        device = tensors[0].device
        if device.type == "cuda" and self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        with _CAPTURE_LOCK:
            replay, outputs, launches = self._capture(
                lambda: body(feed), device, self._pool)
        held = [t for i, t in enumerate(tensors) if i not in data_indices]
        entry = _Entry(replay, outputs, dict(launches), static, bound, held)
        self._entries[sig] = entry
        with self._lock:
            self.captures += 1
            self.recaptures += int(again)
        return entry

    def stats(self):
        with self._lock:
            return {"captures": self.captures, "replays": self.replays,
                    "recaptures": self.recaptures,
                    "signatures": len(self._entries),
                    "eager_rng": self.eager_rng}


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
        self._predict_draws = any(
            n.op.draws_in(_ops.normalize_attrs(n.op, n.attrs), False)
            for n in sym._topo_nodes() if n.op is not None)
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
            description="CachedOp(%s)" % outs)
        self.graphs = _Graphs()

    def __call__(self, *inputs):
        from . import autograd
        from .ndarray.ndarray import NDArray, invoke_nd
        if len(inputs) != self.num_inputs:
            raise MXNetError(
                "CachedOp expects %d inputs (%d args + %d aux), got %d"
                % (self.num_inputs, len(self.arg_names),
                   len(self.aux_names), len(inputs)))
        tensors = [x._data for x in inputs]
        if autograd.is_recording() or autograd.is_training() \
                or not self.graphs.serves(tensors):
            return invoke_nd(self._op, list(inputs), {})
        if self._predict_draws:
            self.graphs.note_eager_rng()
            return invoke_nd(self._op, list(inputs), {})
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
        op by op because the plan draws (``eager_rng``)."""
        return self.graphs.stats()
