"""The port's DGL graph-sampling ops (``mxnet_tpu_torch/ops/dgl.py``,
host numpy ops) against the JAX package's on the CPU: the JAX suite's
scenarios (``tests/test_dgl_ops.py``) run through both packages'
``nd.contrib.dgl_*`` functions and the five registered ops, every
output equal (values; dtypes but for the integer width) and, under ``np.random.seed``, every
sample drawn alike. The ops are host code (``OpDef.runs_host_code``): a
hybridized block holding one runs op by op, counted as ``eager_host``
by its CachedOp, and never takes a graph."""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu.ops as jops
import mxnet_tpu_torch as tmx
import mxnet_tpu_torch.ops as tops
from mxnet_tpu_torch import cached_op

DGL = ["_contrib_dgl_adjacency", "_contrib_dgl_subgraph",
       "_contrib_dgl_graph_compact",
       "_contrib_dgl_csr_neighbor_uniform_sample",
       "_contrib_dgl_csr_neighbor_non_uniform_sample"]


@pytest.fixture(autouse=True)
def _port_on_cpu(monkeypatch):
    monkeypatch.setenv("MXNET_DEFAULT_CONTEXT", "cpu")


def _graph(mx, n=5):
    """A ring of ``n`` with chords (n = 5: the JAX suite's toy graph),
    symmetric, edge ids = positions."""
    rows = [sorted({(v - 1) % n, (v + 1) % n} | ({(v + 2) % n} if n > 5
                                                  else set()))
            for v in range(n)]
    indptr = np.cumsum([0] + [len(r) for r in rows]).astype(np.int64)
    indices = np.array([u for r in rows for u in r], np.int64)
    eids = np.arange(indices.shape[0], dtype=np.int64)
    return mx.nd.sparse.CSRNDArray(mx.nd.array(eids.astype(np.float32)),
                                   mx.nd.array(indices),
                                   mx.nd.array(indptr), (n, n))


def _np(x):
    if isinstance(x, (list, tuple)):
        return [_np(v) for v in x]
    if hasattr(x, "indptr"):
        return [x.indptr.asnumpy(), x.indices.asnumpy(), x.data.asnumpy(),
                tuple(x.shape)]
    return x.asnumpy()


def _same(got, want):
    if isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
    elif isinstance(want, tuple):
        assert got == want
    else:
        # integers are int64 in the port, int32 in the JAX package's
        # arrays (JAX without x64)
        assert got.dtype == want.dtype or (
            got.dtype.kind == want.dtype.kind == "i"), (got.dtype,
                                                        want.dtype)
        np.testing.assert_array_equal(got, want)


def _both(fn):
    """``fn(mx)`` through each package from one numpy seed."""
    out = {}
    for mx in (jmx, tmx):
        np.random.seed(7)
        out[mx] = _np(fn(mx))
    _same(out[tmx], out[jmx])
    return out[tmx]


@pytest.mark.parametrize("n,seeds,hops,nbrs,max_v", [
    (5, [0], 1, 2, 4), (5, [0, 1, 2, 3, 4], 1, 1, 6), (9, [3, 7], 2, 2, 8)])
def test_uniform_sample_draws_like_jax(n, seeds, hops, nbrs, max_v):
    out = _both(lambda mx: mx.nd.contrib.dgl_csr_neighbor_uniform_sample(
        _graph(mx, n), mx.nd.array(np.array(seeds, np.float32)),
        num_hops=hops, num_neighbor=nbrs, max_num_vertices=max_v))
    assert out[0][-1] >= 1


def test_uniform_sample_of_two_seed_arrays():
    _both(lambda mx: mx.nd.contrib.dgl_csr_neighbor_uniform_sample(
        _graph(mx, 9), [mx.nd.array(np.array([0.0], np.float32)),
                        mx.nd.array(np.array([4.0, 5.0], np.float32))],
        num_hops=2, num_neighbor=2, max_num_vertices=6))


def test_non_uniform_sample_draws_like_jax():
    out = _both(lambda mx: mx.nd.contrib.dgl_csr_neighbor_non_uniform_sample(
        _graph(mx), mx.nd.array(np.array([1, 1, 1, 0, 0], np.float32)),
        mx.nd.array(np.array([1], np.float32)), num_hops=2, num_neighbor=2,
        max_num_vertices=5))
    v = out[0]
    assert not {3, 4} & set(v[:int(v[-1])].tolist()) - {1}


def test_successive_calls_draw_like_jax():
    """One seed, 8 calls: fresh neighbourhoods each call, the same in
    both packages."""
    def run(mx):
        g = _graph(mx, 9)
        seeds = mx.nd.array(np.arange(9, dtype=np.float32))
        return [mx.nd.contrib.dgl_csr_neighbor_uniform_sample(
            g, seeds, num_hops=1, num_neighbor=1, max_num_vertices=10)[1]
            for _ in range(8)]
    draws = _both(run)
    assert len({tuple(d[1].tolist()) for d in draws}) > 1


@pytest.mark.parametrize("mapping", [False, True])
def test_subgraph_like_jax(mapping):
    _both(lambda mx: mx.nd.contrib.dgl_subgraph(
        _graph(mx, 9), mx.nd.array(np.array([0, 1, 2, 7], np.float32)),
        mx.nd.array(np.array([3, 4], np.float32)), return_mapping=mapping))


def test_adjacency_and_compact_like_jax():
    def run(mx):
        g = _graph(mx)
        adj = mx.nd.contrib.dgl_adjacency(g)
        verts, subg, _ = mx.nd.contrib.dgl_csr_neighbor_uniform_sample(
            g, mx.nd.array(np.array([3], np.float32)), num_hops=1,
            num_neighbor=2, max_num_vertices=4)
        n = int(verts.asnumpy()[-1])
        comp = mx.nd.contrib.dgl_graph_compact(
            subg, verts, graph_sizes=(n,), return_mapping=True)
        return [adj, verts, subg] + list(comp)
    _both(run)


def test_registered_ops_match_jax_with_their_signatures():
    """Each op through ``ops.invoke`` on the lowered triples: the same
    outputs, the registered ``host_code``."""
    indptr = np.array([0, 2, 4, 6, 8, 10], np.int64)
    indices = np.array([1, 4, 0, 2, 1, 3, 2, 4, 0, 3], np.int64)
    eids = np.arange(10, dtype=np.int64)
    prob = np.array([1, 1, 1, 0, 0], np.float32)
    seeds = np.array([1, 2], np.int64)
    cases = {
        "_contrib_dgl_adjacency": ([indptr, indices, eids], {}),
        "_contrib_dgl_subgraph": ([indptr, indices, eids, seeds],
                                  {"num_args": 4, "return_mapping": True}),
        "_contrib_dgl_csr_neighbor_uniform_sample": (
            [indptr, indices, eids, seeds], {"num_args": 4, "num_hops": 2}),
        "_contrib_dgl_csr_neighbor_non_uniform_sample": (
            [prob, indptr, indices, eids, seeds], {"num_args": 5}),
    }
    for name, (arrays, attrs) in cases.items():
        res = {}
        for ops, conv in ((jops, np.asarray),
                          (tops, lambda a: torch.from_numpy(a.copy()))):
            np.random.seed(3)
            outs, _ = ops.invoke(ops.get_op(name),
                                 [conv(a) for a in arrays], attrs)
            res[ops] = [np.asarray(o) for o in outs]
        _same(res[tops], res[jops])
        assert tops.get_op(name).runs_host_code({})
    assert all(tops.get_op(n).runs_host_code({}) for n in DGL)


def test_hybridized_block_runs_the_op_op_by_op_counted(monkeypatch):
    """A hybridized block holding ``dgl_adjacency``: its CachedOp runs
    each predict call op by op, counted as ``eager_host``, and captures
    nothing (the graph holder through a stand-in capture)."""
    captures = []

    def standin(fn, *args):
        captures.append(1)
        raise AssertionError("a host op was captured")
    monkeypatch.setattr(cached_op._Graphs.__init__, "__defaults__",
                        ("cpu", standin))

    class Adj(tmx.gluon.HybridBlock):
        def hybrid_forward(self, F, indptr, indices, eids):
            outs = F.contrib.dgl_adjacency(indptr, indices, eids)
            return outs[2] * 2.0

    blk = Adj()
    blk.hybridize()
    args = [tmx.nd.array(np.array([0, 2, 4, 6, 8, 10], np.int64)),
            tmx.nd.array(np.array([1, 4, 0, 2, 1, 3, 2, 4, 0, 3], np.int64)),
            tmx.nd.array(np.arange(10, dtype=np.int64))]
    for _ in range(3):
        out = blk(*args)
    np.testing.assert_array_equal(out.asnumpy(), np.full(10, 2.0, np.float32))
    st = blk._cached_op.stats()
    assert st["eager_host"] == 3 and st["captures"] == 0 and not captures
