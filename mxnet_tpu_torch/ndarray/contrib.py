"""``mx.nd.contrib`` (counterpart of ``mxnet_tpu/ndarray/contrib.py``):
the ``_contrib_*`` ops under their short names (``nd.contrib.ctc_loss``,
``nd.contrib.boolean_mask``, ...), installed as the JAX package's
``contrib/_alias.py`` installs them, and the imperative control flow,
``foreach``, ``while_loop`` and ``cond``: Python loops over NDArrays,
each step's ops recorded as any others, so gradients flow.

``while_loop`` zero-fills the rows of its stacked outputs beyond the
steps it ran (the JAX package's choice; the reference leaves them
undefined). The DGL graph-sampling functions (``dgl_*``) take and give
``CSRNDArray`` graphs over the lowered ``_contrib_dgl_*`` host ops, in
the reference's output grouping.
"""
from __future__ import annotations

from ..base import MXNetError

__all__ = ["foreach", "while_loop", "cond", "install_contrib_ops",
           "dgl_csr_neighbor_uniform_sample",
           "dgl_csr_neighbor_non_uniform_sample", "dgl_subgraph",
           "dgl_adjacency", "dgl_graph_compact"]


def install_contrib_ops(namespace, make_stub):
    """Install each ``_contrib_<name>`` op as ``<name>`` into
    ``namespace`` (a dict), built by ``make_stub``."""
    from .. import ops as _ops
    for name in _ops.list_ops():
        if name.startswith("_contrib_"):
            namespace.setdefault(name[len("_contrib_"):],
                                 make_stub(_ops.get_op(name)))


def _as_list(x):
    if x is None:
        return [], True
    if isinstance(x, (list, tuple)):
        return list(x), False
    return [x], True


def foreach(body, data, init_states):
    """Run ``body`` over dim 0 of ``data``; ``body(data_item, states) ->
    (outputs, new_states)``. Returns the outputs stacked on a new dim 0
    and the final states."""
    from . import stack as _stack, split as _split
    data_list, data_single = _as_list(data)
    states, states_single = _as_list(init_states)
    if not data_list:
        raise MXNetError("foreach needs at least one data input")
    length = data_list[0].shape[0]
    if any(d.shape[0] != length for d in data_list[1:]):
        raise MXNetError("foreach data inputs disagree on dim 0")
    # the steps' slices by one op, so a recorded loop's Symbol
    # (autograd.get_symbol) reaches the data through it
    slices = [_as_list(_split(d, num_outputs=length, axis=0,
                              squeeze_axis=True))[0] for d in data_list]
    collected, outs_single = None, True
    for i in range(length):
        eles = [s[i] for s in slices]
        outs, states = body(eles[0] if data_single else eles,
                            states[0] if states_single else list(states))
        outs, outs_single = _as_list(outs)
        states, _ = _as_list(states)
        if collected is None:
            collected = [[] for _ in outs]
        for slot, o in zip(collected, outs):
            slot.append(o)
    stacked = [_stack(*slot, axis=0) for slot in (collected or [])]
    return (stacked[0] if outs_single and stacked else stacked,
            states[0] if states_single else states)


def while_loop(cond, func, loop_vars, max_iterations=None):
    """Run ``func`` while ``cond`` holds, at most ``max_iterations``
    times; ``cond(*loop_vars)`` is a scalar NDArray, ``func(*loop_vars)
    -> (outputs, new_loop_vars)``. The stacked outputs have
    ``max_iterations`` rows; the final loop vars come second."""
    from . import stack as _stack, zeros_like as _zeros_like
    loop_vars, single_var = _as_list(loop_vars)
    if max_iterations is None:
        raise MXNetError("while_loop requires max_iterations")
    if not loop_vars:
        raise MXNetError("while_loop requires at least one loop var")
    collected, outs_single, steps = None, True, 0
    while steps < int(max_iterations) and \
            bool(cond(*loop_vars).asnumpy().reshape(())):
        step = func(*loop_vars)
        if not (isinstance(step, tuple) and len(step) == 2):
            raise MXNetError(
                "while_loop func must return (outputs, new_loop_vars)")
        outs, new_vars = step
        outs, outs_single = _as_list(outs)
        new_vars, _ = _as_list(new_vars)
        if len(new_vars) != len(loop_vars):
            raise MXNetError(
                "while_loop func returned %d loop_vars, expected %d"
                % (len(new_vars), len(loop_vars)))
        loop_vars = new_vars
        if collected is None:
            collected = [[] for _ in outs]
        for slot, o in zip(collected, outs):
            slot.append(o)
        steps += 1
    if collected is None:
        raise MXNetError(
            "while_loop executed zero steps; cannot infer output shapes "
            "(the reference raises here too)")
    stacked = [_stack(*(slot + [_zeros_like(slot[0])]
                        * (int(max_iterations) - len(slot))), axis=0)
               for slot in collected]
    return (stacked[0] if outs_single else stacked,
            loop_vars[0] if single_var else loop_vars)


def cond(pred, then_func, else_func):
    """``then_func()`` if the scalar NDArray ``pred`` is nonzero, else
    ``else_func()`` (the branches close over outer NDArrays)."""
    return then_func() if bool(pred.asnumpy().reshape(())) else else_func()


# -- DGL graph sampling (the CSR API over the lowered ops) -----------------

def _csr_pieces(csr):
    return [csr.indptr, csr.indices, csr.data]


def _mk_csr(indptr, cols, eids, shape, ctx):
    from .sparse import CSRNDArray
    return CSRNDArray(eids, cols, indptr, shape, ctx=ctx)


def _invoke(name, arrays, attrs):
    from .. import ops as _ops
    from .ndarray import invoke_nd
    outs = invoke_nd(_ops.get_op(name), list(arrays), attrs)
    return outs if isinstance(outs, (list, tuple)) else [outs]


def _dgl_sample(csr, seeds, uniform, probability=None, num_hops=1,
                num_neighbor=2, max_num_vertices=100):
    """The two neighbour samplers: every seed array's vertices, then (non
    uniform) their probabilities, then the sub-CSRs, then the layers
    (dgl_graph.cc:758/852)."""
    seeds = list(seeds) if isinstance(seeds, (list, tuple)) else [seeds]
    n = len(seeds)
    raw = _csr_pieces(csr) + seeds
    if not uniform:
        raw = [probability] + raw
    outs = _invoke("_contrib_dgl_csr_neighbor_%s_sample"
                   % ("uniform" if uniform else "non_uniform"), raw,
                   {"num_args": len(raw), "num_hops": num_hops,
                    "num_neighbor": num_neighbor,
                    "max_num_vertices": max_num_vertices})
    per = 5 if uniform else 6
    verts, probs, csrs, layers = [], [], [], []
    for i in range(n):
        it = iter(outs[per * i:per * (i + 1)])
        verts.append(next(it))
        if not uniform:
            probs.append(next(it))
        layer = next(it)
        indptr, cols, eids = next(it), next(it), next(it)
        csrs.append(_mk_csr(indptr, cols, eids,
                            (int(max_num_vertices), csr.shape[1]),
                            csr.context))
        layers.append(layer)
    out = verts + probs + csrs + layers
    return out if len(out) > 1 else out[0]


def dgl_csr_neighbor_uniform_sample(csr, seeds, num_hops=1, num_neighbor=2,
                                    max_num_vertices=100):
    return _dgl_sample(csr, seeds, True, num_hops=num_hops,
                       num_neighbor=num_neighbor,
                       max_num_vertices=max_num_vertices)


def dgl_csr_neighbor_non_uniform_sample(csr, probability, seeds,
                                        num_hops=1, num_neighbor=2,
                                        max_num_vertices=100):
    return _dgl_sample(csr, seeds, False, probability=probability,
                       num_hops=num_hops, num_neighbor=num_neighbor,
                       max_num_vertices=max_num_vertices)


def _csr_groups(outs, sizes, ctx, mapping):
    """The op's flat triples as CSRNDArrays: one a graph, then (with
    ``mapping``) one more a graph."""
    k = len(sizes)
    res = [_mk_csr(outs[3 * g], outs[3 * g + 1], outs[3 * g + 2],
                   (sizes[g], sizes[g]), ctx) for g in range(k)]
    if mapping:
        res += [_mk_csr(outs[3 * (k + g)], outs[3 * (k + g) + 1],
                        outs[3 * (k + g) + 2], (sizes[g], sizes[g]), ctx)
                for g in range(k)]
    return res if len(res) > 1 else res[0]


def dgl_subgraph(csr, *vids, return_mapping=False):
    outs = _invoke("_contrib_dgl_subgraph", _csr_pieces(csr) + list(vids),
                   {"num_args": 3 + len(vids),
                    "return_mapping": return_mapping})
    return _csr_groups(outs, [int(v.shape[0]) for v in vids], csr.context,
                       return_mapping)


def dgl_adjacency(csr):
    outs = _invoke("_contrib_dgl_adjacency", _csr_pieces(csr), {})
    return _mk_csr(outs[0], outs[1], outs[2], csr.shape, csr.context)


def dgl_graph_compact(*args, return_mapping=False, graph_sizes=()):
    """``dgl_graph_compact(csr1, ..., csrN, vids1, ..., vidsN)``: each
    sampled sub-CSR renumbered through its vertex-id array."""
    if len(args) % 2:
        raise ValueError("dgl_graph_compact takes N csr graphs followed "
                         "by N vertex-id arrays")
    n_g = len(args) // 2
    csrs, vids = args[:n_g], args[n_g:]
    raw = [p for c in csrs for p in _csr_pieces(c)] + list(vids)
    outs = _invoke("_contrib_dgl_graph_compact", raw,
                   {"num_args": len(raw), "return_mapping": return_mapping,
                    "graph_sizes": tuple(graph_sizes)})
    sizes = [int(graph_sizes[g]) if g < len(graph_sizes) else c.shape[0]
             for g, c in enumerate(csrs)]
    return _csr_groups(outs, sizes, csrs[0].context, return_mapping)


def _install():
    from . import register as _register
    install_contrib_ops(globals(), _register.make_stub)


_install()
