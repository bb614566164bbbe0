"""The DGL graph-sampling ops (counterpart of ``mxnet_tpu/ops/dgl.py``):
``_contrib_dgl_csr_neighbor_uniform_sample``,
``_contrib_dgl_csr_neighbor_non_uniform_sample``,
``_contrib_dgl_subgraph``, ``_contrib_dgl_adjacency`` and
``_contrib_dgl_graph_compact``.

Graph sampling is ragged, data-dependent integer work, which the
reference runs on CPU threads in any build: these are host numpy ops, as
in the JAX package, over its lowered calling convention (a CSR graph
arrives as its ``(indptr, indices, eids)`` triple and leaves the same
way; ``nd.contrib``'s ``dgl_*`` functions wrap the triples into
``CSRNDArray``). Their results come back on the caller's device. Each
is registered with ``host_code``: a CachedOp or an executor runs a plan
holding one op by op (counted as ``eager_host``), never as a CUDA graph.

The sampling draws from numpy's global ``RandomState`` as the JAX
package does (fresh sub-seeds a call, one stream a seed array), so
under ``np.random.seed`` the two packages draw sample for sample alike.
Sampled-vertex arrays have ``max_num_vertices + 1`` slots, the count in
the last, -1 padding; layer arrays ``max_num_vertices``.
"""
from __future__ import annotations

import numpy as np
import torch

from .registry import register

__all__ = []


def _host_op(fn):
    """``fn`` over numpy copies of the inputs; its outputs as tensors on
    the first input's device."""
    def body(attrs, *inputs):
        outs = fn(attrs, *[x.detach().cpu().numpy() for x in inputs])
        outs = outs if isinstance(outs, tuple) else (outs,)
        return tuple(torch.from_numpy(np.ascontiguousarray(o))
                     .to(inputs[0].device) for o in outs)
    body.__doc__ = fn.__doc__
    body.__name__ = fn.__name__
    return body


def _row(indptr, indices, eids, v):
    lo, hi = int(indptr[v]), int(indptr[v + 1])
    return indices[lo:hi], eids[lo:hi]


def _sample_subgraph(indptr, indices, eids, seeds, num_hops,
                     num_neighbor, max_v, prob=None, rng=None):
    """BFS neighbour sampling from ``seeds``: (verts, layer, sub_indptr,
    sub_cols, sub_eids), with the vertices' probabilities second when
    ``prob`` is given."""
    if rng is None:
        rng = np.random
    seeds = np.unique(seeds[seeds >= 0].astype(np.int64))
    layer_of = {int(v): 0 for v in seeds[:max_v]}
    chosen = {}                    # vertex -> (cols, eids) kept edges
    frontier = list(layer_of)
    for hop in range(1, num_hops + 1):
        nxt = []
        for v in frontier:
            cols, es = _row(indptr, indices, eids, v)
            deg = cols.shape[0]
            if deg == 0:
                continue
            k = min(num_neighbor, deg)
            if prob is not None:
                p = np.asarray(prob[cols], np.float64)
                s = p.sum()
                if s <= 0:
                    continue          # no neighbour to draw
                p = p / s
                k = min(k, int(np.count_nonzero(p)))
                pick = rng.choice(deg, size=k, replace=False, p=p)
            else:
                pick = rng.choice(deg, size=k, replace=False)
            chosen[v] = (cols[pick], es[pick])
            for u in chosen[v][0]:
                u = int(u)
                if u not in layer_of and len(layer_of) < max_v:
                    layer_of[u] = hop
                    nxt.append(u)
        frontier = nxt
    verts = np.array(sorted(layer_of), np.int64)
    n = verts.shape[0]
    vout = np.full((max_v + 1,), -1, np.int64)
    vout[:n] = verts
    vout[-1] = n
    lout = np.full((max_v,), -1, np.int64)
    lout[:n] = [layer_of[int(v)] for v in verts]
    sub_indptr = np.zeros((max_v + 1,), np.int64)
    cols_acc, eids_acc = [], []
    for i, v in enumerate(verts):
        c, e = chosen.get(int(v), (np.empty(0, np.int64),
                                   np.empty(0, np.int64)))
        keep = np.isin(c, verts)
        cols_acc.append(c[keep])
        eids_acc.append(e[keep])
        sub_indptr[i + 1] = sub_indptr[i] + int(keep.sum())
    sub_indptr[n + 1:] = sub_indptr[n]
    sub_cols = (np.concatenate(cols_acc) if cols_acc
                else np.empty(0, np.int64)).astype(np.int64)
    sub_eids = (np.concatenate(eids_acc) if eids_acc
                else np.empty(0, np.int64)).astype(np.int64)
    outs = [vout, lout, sub_indptr, sub_cols, sub_eids]
    if prob is not None:
        pout = np.full((max_v,), -1.0, np.float32)
        pout[:n] = np.asarray(prob, np.float32)[verts]
        outs.insert(1, pout)
    return outs


def _call_rngs(n):
    """One ``RandomState`` a seed array, each seeded from numpy's global
    stream: fresh neighbourhoods every call (the reference seeds a call
    from the clock), pinned by ``np.random.seed``."""
    return [np.random.RandomState(np.random.randint(0, 2**31 - 1))
            for _ in range(n)]


def _sample_attrs(attrs):
    return (int(attrs.get("num_hops", 1)), int(attrs.get("num_neighbor", 2)),
            int(attrs.get("max_num_vertices", 100)))


def _uniform_sample(attrs, indptr, indices, eids, *seed_arrays):
    hops, neighbors, max_v = _sample_attrs(attrs)
    outs = []
    for s, rng in zip(seed_arrays, _call_rngs(len(seed_arrays))):
        outs.extend(_sample_subgraph(indptr, indices, eids, s, hops,
                                     neighbors, max_v, rng=rng))
    return tuple(outs)


def _non_uniform_sample(attrs, prob, indptr, indices, eids, *seed_arrays):
    hops, neighbors, max_v = _sample_attrs(attrs)
    outs = []
    for s, rng in zip(seed_arrays, _call_rngs(len(seed_arrays))):
        outs.extend(_sample_subgraph(indptr, indices, eids, s, hops,
                                     neighbors, max_v, prob=prob, rng=rng))
    return tuple(outs)


register("_contrib_dgl_csr_neighbor_uniform_sample",
         _host_op(_uniform_sample),
         arg_names=("indptr", "indices", "eids", "seeds"),
         key_var_num_args="num_args", host_code=True,
         defaults={"num_args": 4, "num_hops": 1, "num_neighbor": 2,
                   "max_num_vertices": 100},
         num_outputs=lambda attrs: 5 * (int(attrs.get("num_args", 4)) - 3))

register("_contrib_dgl_csr_neighbor_non_uniform_sample",
         _host_op(_non_uniform_sample),
         arg_names=("probability", "indptr", "indices", "eids", "seeds"),
         key_var_num_args="num_args", host_code=True,
         defaults={"num_args": 5, "num_hops": 1, "num_neighbor": 2,
                   "max_num_vertices": 100},
         num_outputs=lambda attrs: 6 * (int(attrs.get("num_args", 5)) - 4))


def _subgraph(attrs, indptr, indices, eids, *vid_arrays):
    """Vertex-induced subgraphs with renumbered ids (new edge ids 0..),
    and with ``return_mapping`` the original edge ids as a parallel
    CSR."""
    mapping = bool(attrs.get("return_mapping", False))
    new_csrs, old_csrs = [], []
    for vids in vid_arrays:
        vids = vids.astype(np.int64)
        pos = {int(v): i for i, v in enumerate(vids)}
        sub_indptr = np.zeros((vids.shape[0] + 1,), np.int64)
        cols, new_es, old_es = [], [], []
        for i, v in enumerate(vids):
            c, e = _row(indptr, indices, eids, int(v))
            keep = np.isin(c, vids)
            kept_cols = [pos[int(u)] for u in c[keep]]
            new_es.extend(range(len(cols), len(cols) + len(kept_cols)))
            cols.extend(kept_cols)
            old_es.extend(e[keep].tolist())
            sub_indptr[i + 1] = len(cols)
        cols = np.asarray(cols, np.int64)
        new_csrs.extend([sub_indptr, cols, np.asarray(new_es, np.int64)])
        if mapping:
            old_csrs.extend([sub_indptr.copy(), cols.copy(),
                             np.asarray(old_es, np.int64)])
    return tuple(new_csrs + old_csrs)


register("_contrib_dgl_subgraph", _host_op(_subgraph),
         arg_names=("indptr", "indices", "eids", "vids"),
         key_var_num_args="num_args", host_code=True,
         defaults={"num_args": 4, "return_mapping": False},
         num_outputs=lambda attrs: (int(attrs.get("num_args", 4)) - 3)
         * (6 if attrs.get("return_mapping") else 3))


def _adjacency(attrs, indptr, indices, eids):
    """The CSR structure with unit float values."""
    return (indptr.astype(np.int64), indices.astype(np.int64),
            np.ones((indices.shape[0],), np.float32))


register("_contrib_dgl_adjacency", _host_op(_adjacency),
         arg_names=("indptr", "indices", "eids"), host_code=True,
         num_outputs=3)


def _graph_compact(attrs, *args):
    """num_g sampled CSR triples, then their num_g vertex-id arrays: each
    graph's column ids renumbered from the parent's id space into its
    rows' 0..size-1 (``vids[g][i] -> i`` for i < graph_sizes[g]), fresh
    edge ids 0..nnz-1; with ``return_mapping`` a parallel CSR carrying
    the original edge ids."""
    mapping = bool(attrs.get("return_mapping", False))
    sizes = attrs.get("graph_sizes", ())
    if not isinstance(sizes, (list, tuple)):
        sizes = (sizes,)
    n_g = len(args) // 4
    if n_g * 4 != len(args):
        raise ValueError(
            "_contrib_dgl_graph_compact expects num_g CSR triples plus "
            "num_g vertex-id arrays (got %d pieces)" % len(args))
    outs, map_outs = [], []
    for g in range(n_g):
        indptr, indices, eids = args[3 * g:3 * g + 3]
        vids = args[3 * n_g + g].astype(np.int64)
        size = int(sizes[g]) if g < len(sizes) else int(vids[-1])
        row_ids = vids[:size]
        if np.any(row_ids < 0):
            raise ValueError(
                "graph %d: sampled vertex array has -1 inside its "
                "first graph_sizes=%d slots" % (g, size))
        sub_indptr = indptr[:size + 1].astype(np.int64)
        nnz = int(sub_indptr[-1])
        old_cols = indices[:nnz].astype(np.int64)
        order = np.argsort(row_ids, kind="stable")
        sorted_ids = row_ids[order]
        slot = np.searchsorted(sorted_ids, old_cols)
        slot_c = np.minimum(slot, size - 1 if size else 0)
        bad = ((old_cols < 0) | (slot >= size)
               | (sorted_ids[slot_c] != old_cols))
        if np.any(bad):
            raise ValueError(
                "graph %d: %d column ids are not in the sampled vertex "
                "set" % (g, int(bad.sum())))
        new_cols = order[slot_c].astype(np.int64)
        outs.extend([sub_indptr, new_cols, np.arange(nnz, dtype=np.int64)])
        if mapping:
            map_outs.extend([sub_indptr.copy(), new_cols.copy(),
                             eids[:nnz].astype(np.int64)])
    return tuple(outs + map_outs)


register("_contrib_dgl_graph_compact", _host_op(_graph_compact),
         arg_names=("graph", "vids"),
         key_var_num_args="num_args", host_code=True,
         defaults={"num_args": 4, "return_mapping": False,
                   "graph_sizes": ()},
         num_outputs=lambda attrs: (int(attrs.get("num_args", 4)) // 4)
         * 3 * (2 if attrs.get("return_mapping") else 1))
