"""Port parity: sparse storage (``mxnet_tpu_torch/ndarray/sparse.py``),
the lazy row updates, ``Embedding(sparse_grad=True)`` through the
Trainer, the row_sparse kvstore, ``LibSVMIter``, sparse saves and
checkpoints and the five sparse op names, against ``mxnet_tpu`` on the
CPU.

Every case of ``tests/test_sparse.py`` but the factorization machine
(``tests/test_torch_sparse_fm.py``) runs through both packages on the
same numpy inputs: values at ROADMAP rule 5's tolerance, index arrays
and their dtypes exactly (int32, what the JAX package's arrays hold on
the CPU), the lazy optimizers' untouched rows bit for bit."""
import numpy as np
import pytest
import scipy.sparse as spsp
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu.base import MXNetError as JaxMXNetError
from torch_parity import hold, rand

TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True)
def _port_on_cpu(monkeypatch):
    monkeypatch.setenv("MXNET_DEFAULT_CONTEXT", "cpu")


@pytest.fixture(autouse=True)
def _fresh_names():
    from mxnet_tpu.name import NameManager as JaxNames
    from mxnet_tpu_torch.name import NameManager as PortNames
    with JaxNames(), PortNames():
        yield


def _both(fn):
    """``fn(mx)`` through the port and the JAX package: (port, jax)."""
    return fn(tmx), fn(jmx)


def _rand_dense(shape, density=0.3, seed=0):
    rng = np.random.RandomState(seed)
    d = rng.uniform(-1, 1, shape) * (rng.uniform(size=shape) < density)
    return d.astype(np.float32)


def _same_sparse(got, want, tol=None):
    """Two sparse arrays alike: storage, shape, components (index arrays
    exactly, values at ``tol`` or exactly), component dtypes."""
    assert got.stype == want.stype and got.shape == want.shape
    parts = ("data", "indices", "indptr") if got.stype == "csr" \
        else ("data", "indices")
    for part in parts:
        g, w = getattr(got, part).asnumpy(), getattr(want, part).asnumpy()
        assert g.dtype == w.dtype, (part, g.dtype, w.dtype)
        if part == "data" and tol is not None:
            np.testing.assert_allclose(g, w, **tol)
        else:
            np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got.asnumpy(), want.asnumpy())


# -- CSRNDArray --------------------------------------------------------------

def test_csr_roundtrip_forms():
    dense = _rand_dense((5, 7))
    coo = spsp.coo_matrix(dense)

    def run(mx):
        sp = mx.nd.sparse
        c1 = sp.csr_matrix(dense)
        c1.check_format()
        return [c1, sp.csr_matrix(spsp.csr_matrix(dense)),
                sp.csr_matrix((c1.data.asnumpy(), c1.indices.asnumpy(),
                               c1.indptr.asnumpy()), shape=(5, 7)),
                sp.csr_matrix((coo.data, (coo.row, coo.col)), shape=(5, 7)),
                sp.csr_matrix((5, 7)), sp.csr_matrix(mx.nd.array(dense))]
    got, want = _both(run)
    for g, w in zip(got, want):
        _same_sparse(g, w)
    np.testing.assert_array_equal(got[0].asnumpy(), dense)
    np.testing.assert_array_equal(got[0].asscipy().toarray(), dense)
    assert got[0]._aux_types == want[0]._aux_types
    assert got[0].indices.dtype == np.int32


def test_csr_slice():
    dense = _rand_dense((6, 4))

    def run(mx):
        c = mx.nd.sparse.csr_matrix(dense)
        return [c[2:5], c[1], c[-1], c[4:2]]
    got, want = _both(run)
    for g, w in zip(got, want):
        _same_sparse(g, w)
    np.testing.assert_array_equal(got[0].asnumpy(), dense[2:5])
    with pytest.raises(MXNetError):
        tmx.nd.sparse.csr_matrix(dense)[::2]


@pytest.mark.parametrize("rhs_shape,transpose_a", [
    ((8, 3), False), ((6, 3), True), ((8,), False), ((6,), True)])
def test_csr_dot(rhs_shape, transpose_a):
    """Matrix and vector right-hand sides, plain and transposed."""
    dense = _rand_dense((6, 8), seed=1)
    rhs = np.random.RandomState(2).uniform(size=rhs_shape) \
        .astype(np.float32)

    def run(mx):
        return mx.nd.dot(mx.nd.sparse.csr_matrix(dense), mx.nd.array(rhs),
                         transpose_a=transpose_a)
    got, want = _both(run)
    assert got.shape == want.shape and got.stype == "default"
    np.testing.assert_allclose(got.asnumpy(), want.asnumpy(), **TOL)
    ref = (dense.T if transpose_a else dense) @ rhs
    np.testing.assert_allclose(got.asnumpy(), ref, rtol=1e-5, atol=1e-6)


def test_dot_of_other_storage_densifies():
    dense = _rand_dense((4, 5), seed=3)
    rhs = rand(4, 5, 2)

    def run(mx):
        sp = mx.nd.sparse
        r = sp.row_sparse_array(dense)
        return [mx.nd.dot(r, mx.nd.array(rhs)),
                sp.dot(sp.csr_matrix(dense), mx.nd.array(rhs.T),
                       transpose_b=True),
                mx.nd.dot(mx.nd.array(dense.T), sp.csr_matrix(dense))]
    for g, w in zip(*_both(run)):
        np.testing.assert_allclose(g.asnumpy(), w.asnumpy(), **TOL)


# -- RowSparseNDArray --------------------------------------------------------

def test_rsp_roundtrip_and_retain():
    dense = np.zeros((10, 3), np.float32)
    dense[[1, 4, 8]] = np.random.RandomState(0).uniform(size=(3, 3))

    def run(mx):
        sp = mx.nd.sparse
        r = sp.row_sparse_array(dense)
        r.check_format()
        r2 = sp.row_sparse_array((r.data.asnumpy(), [1, 4, 8]),
                                 shape=(10, 3))
        return [r, r2, sp.retain(r, mx.nd.array([4, 8, 9])),
                r.retain([8, 1]), sp.row_sparse_array((10, 3))]
    got, want = _both(run)
    for g, w in zip(got, want):
        _same_sparse(g, w)
    assert list(got[2].indices.asnumpy()) == [4, 8]
    np.testing.assert_array_equal(got[0].asnumpy(), dense)


def test_rsp_arithmetic():
    dense = np.zeros((8, 2), np.float32)
    dense[[0, 3]] = 1.5
    dense2 = np.zeros((8, 2), np.float32)
    dense2[[3, 6]] = 2.0

    def run(mx):
        sp = mx.nd.sparse
        r = sp.row_sparse_array(dense)
        r2 = sp.row_sparse_array(dense2)
        return [r * 2, -r, r / 4, r + r, r + r2, r - r2, 2 * r,
                sp.add(r, r2), sp.subtract(r, r2), sp.multiply(r, 3.0),
                sp.divide(r, 2.0)], [r + mx.nd.ones((8, 2)),
                                     mx.nd.ones((8, 2)) + r, r * r]
    (got, got_d), (want, want_d) = _both(run)
    for g, w in zip(got, want):
        _same_sparse(g, w, TOL)
    assert list(got[4].indices.asnumpy()) == [0, 3, 6]
    for g, w in zip(got_d, want_d):
        assert g.stype == w.stype == "default"
        np.testing.assert_allclose(g.asnumpy(), w.asnumpy(), **TOL)


def test_csr_add_keeps_csr_stype():
    a_d = np.array([[1.0, 0, 2], [0, 0, 3]], np.float32)
    b_d = np.array([[0.0, 5, 2], [1, 0, 0]], np.float32)

    def run(mx):
        a, b = mx.nd.sparse.csr_matrix(a_d), mx.nd.sparse.csr_matrix(b_d)
        return [a + b, a - b, a * 2.0]
    got, want = _both(run)
    for g, w in zip(got, want):
        assert g.stype == "csr"
        _same_sparse(g, w, TOL)
    np.testing.assert_array_equal(got[0].tostype("default").asnumpy(),
                                  a_d + b_d)


def test_cast_storage_and_zeros():
    dense = _rand_dense((4, 5), seed=4)
    vec = np.array([0, 1.5, 0, -2], np.float32)

    def run(mx):
        nd = mx.nd.array(dense)
        sp = mx.nd.sparse
        return [nd.tostype("csr"), nd.tostype("row_sparse"),
                mx.nd.cast_storage(nd, "csr"), sp.cast_storage(nd,
                                                               "row_sparse"),
                mx.nd.array(vec).tostype("row_sparse"),
                sp.zeros("row_sparse", (3, 2)), sp.zeros("csr", (3, 2)),
                sp.empty("csr", (2, 2)), sp.array(spsp.csr_matrix(dense))], \
            [nd.tostype("csr").tostype("default"),
             nd.tostype("row_sparse").tostype("default"),
             sp.zeros("default", (2, 3))]
    (got, got_d), (want, want_d) = _both(run)
    for g, w in zip(got, want):
        _same_sparse(g, w)
    for g, w in zip(got_d, want_d):
        assert g.stype == "default"
        np.testing.assert_array_equal(g.asnumpy(), w.asnumpy())
    np.testing.assert_array_equal(got_d[0].asnumpy(), dense)
    with pytest.raises(MXNetError):
        tmx.nd.array(dense).tostype("dia")


def test_copies_contexts_and_the_dense_api():
    dense = _rand_dense((5, 3), seed=5)
    r = tmx.nd.sparse.row_sparse_array(dense)
    c = tmx.nd.sparse.csr_matrix(dense)
    for a in (r, c):
        for b in (a.copy(), a.copyto(tmx.cpu()), a.as_in_context(tmx.cpu(1)),
                  a.astype("float64")):
            assert b.stype == a.stype
            np.testing.assert_array_equal(b.asnumpy(), dense)
        assert a.astype("float64").dtype == np.float64
        assert a.size == 15 and a.ndim == 2 and len(a) == 5
        out = tmx.nd.zeros((5, 3))
        a.copyto(out)
        np.testing.assert_array_equal(out.asnumpy(), dense)
        with pytest.raises(MXNetError):
            a._data
        with pytest.raises(MXNetError):
            a.reshape((15,))
        a.wait_to_read()
    z = tmx.nd.sparse.zeros("row_sparse", (5, 3))
    r.copyto(z)
    np.testing.assert_array_equal(z.asnumpy(), dense)
    with pytest.raises(MXNetError):
        c.copyto(z)
    assert r[:] is r
    with pytest.raises(MXNetError):
        r[1:2]


# -- the five op names through the parity harness ----------------------------

def test_square_sum_matches_jax():
    x = rand(11, 4, 5, 3)
    for attrs in ({}, {"axis": 1}, {"axis": (0, 2), "keepdims": True},
                  {"axis": -1, "exclude": True}, {"keepdims": True}):
        hold("_square_sum", [x], attrs)


def test_getnnz_matches_jax():
    x = _rand_dense((6, 7), seed=12)
    for attrs in ({}, {"axis": 0}, {"axis": 1}):
        hold("_contrib_getnnz", [x], attrs, grad=False)
    got = tmx.nd.contrib.getnnz(tmx.nd.array(x), axis=1)
    assert got.dtype == jmx.nd.contrib.getnnz(jmx.nd.array(x)).dtype


def test_sparse_embedding_and_retain_ops_match_jax():
    ids = np.array([[0, 3], [5, 3]], np.float32)
    hold("_contrib_SparseEmbedding", [ids, rand(13, 7, 4)],
         {"input_dim": 7, "output_dim": 4})
    hold("_sparse_retain", [rand(14, 6, 3), np.array([4, 1], np.float32)])
    # repeated ids and ids outside the rows name nothing more
    hold("_sparse_retain", [rand(14, 6, 3),
                            np.array([4, -1, 9, 1, 4], np.float32)])


@pytest.mark.parametrize("stype", ["default", "row_sparse", "csr"])
def test_cast_storage_op_matches_jax(stype):
    hold("cast_storage", [rand(15, 3, 4)], {"stype": stype})


def test_cast_storage_op_rejects_an_unknown_stype():
    with pytest.raises(MXNetError):
        tmx.nd.op.cast_storage(tmx.nd.array(rand(16, 2, 2)), stype="dia")


# -- the lazy optimizers -----------------------------------------------------

LAZY = [("sgd", {"momentum": 0.9}), ("sgd", {}), ("adam", {}),
        ("adagrad", {}), ("ftrl", {})]


def _lazy_case(mx, opt_name, opt_kwargs, steps=2):
    """tests/test_sparse.py's _lazy_case: two lazy steps on rows 2 and 7
    (the second with a zero gradient row), and the dense oracle on the
    touched block; the weight and states after each."""
    F, K = 10, 4
    rng = np.random.RandomState(5)
    w0 = rng.uniform(size=(F, K)).astype(np.float32)
    touched = [2, 7]
    g_rows = [rng.uniform(size=(2, K)).astype(np.float32)
              for _ in range(steps)]
    g_rows[1][1] = 0.0
    opt = mx.optimizer.create(opt_name, learning_rate=0.1, wd=0.01,
                              **opt_kwargs)
    w = mx.nd.array(w0)
    state = opt.create_state(0, w)
    oracle = mx.optimizer.create(opt_name, learning_rate=0.1, wd=0.01,
                                 **opt_kwargs)
    w_block = mx.nd.array(w0[touched])
    state_block = oracle.create_state(0, w_block)
    for g in g_rows:
        opt.update(0, w, mx.nd.sparse.row_sparse_array(
            (g, touched), shape=(F, K)), state)
        oracle.update(0, w_block, mx.nd.array(g), state_block)
    states = state if isinstance(state, (tuple, list)) else [state]
    return (w0, touched, w.asnumpy(), w_block.asnumpy(),
            [s.asnumpy() for s in states if s is not None])


@pytest.mark.parametrize("opt_name,kwargs", LAZY)
def test_lazy_update_matches_jax(opt_name, kwargs):
    got, want = _both(lambda mx: _lazy_case(mx, opt_name, kwargs))
    w0, touched, w, w_block, states = got
    untouched = [i for i in range(w0.shape[0]) if i not in touched]
    np.testing.assert_array_equal(w[untouched], w0[untouched])
    for s in states:
        np.testing.assert_array_equal(s[untouched], 0 * s[untouched])
    np.testing.assert_allclose(w[touched], w_block, **TOL)
    np.testing.assert_allclose(w, want[2], **TOL)
    for g, j in zip(states, want[4]):
        np.testing.assert_allclose(g, j, **TOL)


@pytest.mark.parametrize("opt_name", ["sgd", "adam"])
def test_lazy_update_false_densifies_like_jax(opt_name):
    def run(mx):
        opt = mx.optimizer.create(opt_name, learning_rate=0.1, wd=0.01,
                                  lazy_update=False, momentum=0.9) \
            if opt_name == "sgd" else \
            mx.optimizer.create(opt_name, learning_rate=0.1, wd=0.01,
                                lazy_update=False)
        w = mx.nd.array(rand(17, 6, 3))
        state = opt.create_state(0, w)
        opt.update(0, w, mx.nd.sparse.row_sparse_array(
            (rand(18, 1, 3), [4]), shape=(6, 3)), state)
        return w.asnumpy()
    got, want = _both(run)
    np.testing.assert_allclose(got, want, **TOL)
    # wd (and SGD's momentum) moves every row, touched or not
    assert (got != rand(17, 6, 3)).all(axis=1).all()


# -- the kvstore -------------------------------------------------------------

def test_kvstore_row_sparse_pull():
    w = np.random.RandomState(6).uniform(size=(9, 3)).astype(np.float32)

    def run(mx):
        kv = mx.kv.create("local")
        kv.init(0, mx.nd.array(w))
        out = mx.nd.sparse.zeros("row_sparse", (9, 3))
        kv.row_sparse_pull(0, out=out, row_ids=mx.nd.array([7, 2, 7, 0]))
        outs = [mx.nd.sparse.zeros("row_sparse", (9, 3)) for _ in range(2)]
        kv.init(1, mx.nd.array(w * 2))
        kv.row_sparse_pull([0, 1], out=outs,
                           row_ids=[mx.nd.array([5]), mx.nd.array([8, 1])])
        return [out] + outs
    got, want = _both(run)
    for g, j in zip(got, want):
        _same_sparse(g, j)
    assert list(got[0].indices.asnumpy()) == [0, 2, 7]
    np.testing.assert_array_equal(got[0].data.asnumpy(), w[[0, 2, 7]])
    for mx, err in ((tmx, MXNetError), (jmx, JaxMXNetError)):
        kv = mx.kv.create("local")
        kv.init("w", mx.nd.ones((4, 2)))
        with pytest.raises(err):
            kv.row_sparse_pull("w", out=mx.nd.zeros((4, 2)),
                               row_ids=mx.nd.array(np.array([0, 2])))


def test_kvstore_push_rsp():
    """A row_sparse push reaches the updater as row_sparse; without an
    updater the stored value becomes the pushed array (pull skips it
    unless ignore_sparse=False); a list push sums by row union; 2-bit
    compression leaves a sparse push alone."""
    d = np.zeros((6, 2), np.float32)
    d[[1, 3]] = 2.0
    e = np.zeros((6, 2), np.float32)
    e[[3, 5]] = 1.0

    def run(mx):
        sp = mx.nd.sparse
        kv = mx.kv.create("local")
        kv.init(1, mx.nd.zeros((6, 2)))
        updates = []
        kv.set_updater(lambda k, g, s: updates.append(g))
        kv.push(1, sp.row_sparse_array(d))
        plain = mx.kv.create("local")
        plain.set_gradient_compression({"type": "2bit", "threshold": 0.5})
        plain.init(2, mx.nd.zeros((6, 2)))
        plain.push(2, [sp.row_sparse_array(d), sp.row_sparse_array(e)])
        skipped = mx.nd.ones((6, 2))
        plain.pull(2, out=skipped)
        pulled = sp.zeros("row_sparse", (6, 2))
        plain.pull(2, out=pulled, ignore_sparse=False)
        return updates[0], plain._data[2], skipped.asnumpy(), pulled
    got, want = _both(run)
    for i in (0, 1, 3):
        assert got[i].stype == "row_sparse"
        _same_sparse(got[i], want[i])
    np.testing.assert_array_equal(got[2], np.ones((6, 2), np.float32))
    np.testing.assert_array_equal(got[1].asnumpy(), d + e)


def test_bucketed_sync_declines_a_sparse_gradient():
    from mxnet_tpu_torch.parallel import grad_sync
    kv = tmx.kv.create("local")
    items = [(0, tmx.nd.ones((3, 2))),
             (1, tmx.nd.sparse.row_sparse_array(np.eye(3, 2,
                                                       dtype=np.float32)))]
    assert grad_sync.bucketed_kvstore_sync(kv, items) is False
    assert not hasattr(kv, "_grad_bucket_plan")


def test_fault_poisons_and_telemetry_sizes_a_sparse_value():
    from mxnet_tpu import fault as jfault, telemetry as jtel
    from mxnet_tpu_torch import fault as tfault, telemetry as ttel
    d = np.zeros((5, 3), np.float32)
    d[[0, 4]] = 1.0
    for mx, fault, tel in ((tmx, tfault, ttel), (jmx, jfault, jtel)):
        r = mx.nd.sparse.row_sparse_array(d)
        bad = fault._corrupt(r, "nan")
        assert bad.stype == "row_sparse"
        assert np.isnan(bad.data.asnumpy()).all()
        np.testing.assert_array_equal(r.asnumpy(), d)
        assert not fault._all_finite(bad) and fault._all_finite(r)
        assert tel._nbytes(r) == 2 * 3 * 4 + 2 * 4


# -- Embedding(sparse_grad=True) through the Trainer -------------------------

def _embedding(mx, n, k, w0, opt, hybridize=False):
    net = mx.gluon.nn.Embedding(n, k, sparse_grad=True)
    net.initialize(mx.init.Xavier())
    net.weight.set_data(mx.nd.array(w0))
    if hybridize:
        net.hybridize()
    trainer = mx.gluon.Trainer(net.collect_params(), "sgd", opt)
    return net, trainer


def _record(mx, net, trainer, loss_fn):
    with mx.autograd.record():
        loss = loss_fn(mx, net)
    loss.backward()
    trainer.step(1)
    return net.weight.data().asnumpy().copy()


def test_embedding_sparse_grad_lazy_rows():
    w0 = rand(20, 20, 4)

    def run(mx):
        net, trainer = _embedding(mx, 20, 4, w0, {"learning_rate": 1.0,
                                                  "momentum": 0.9})
        return _record(mx, net, trainer, lambda mx, net: (
            net(mx.nd.array([[1, 5], [5, 9]])) ** 2).sum())
    got, want = _both(run)
    touched = [1, 5, 9]
    untouched = [i for i in range(20) if i not in touched]
    np.testing.assert_array_equal(got[untouched], w0[untouched])
    assert np.abs(got[touched] - w0[touched]).sum() > 0
    np.testing.assert_allclose(got, want, **TOL)
    assert tmx.gluon.nn.Embedding(3, 2, sparse_grad=True) \
        .weight._grad_stype == "row_sparse"


def _zero_grad_row(mx, hybridize):
    """Step 1 touches rows 2 and 4; step 2 touches row 2 with a zero
    upstream gradient. Eager: row 2 takes its momentum step (the ids are
    stashed); hybridized: nothing is stashed and the non-zero scan
    leaves row 2 frozen, as in the JAX package."""
    w0 = rand(21, 10, 3)
    net, trainer = _embedding(mx, 10, 3, w0, {"learning_rate": 0.5,
                                              "momentum": 0.9}, hybridize)
    w1 = _record(mx, net, trainer,
                 lambda mx, net: net(mx.nd.array([2, 4])).sum())
    w2 = _record(mx, net, trainer,
                 lambda mx, net: (net(mx.nd.array([2])) * 0.0).sum())
    return w1, w2


@pytest.mark.parametrize("hybridize", [False, True])
def test_embedding_touched_zero_grad_row(hybridize):
    (w1, w2), (j1, j2) = _both(lambda mx: _zero_grad_row(mx, hybridize))
    np.testing.assert_allclose(w1, j1, **TOL)
    np.testing.assert_allclose(w2, j2, **TOL)
    np.testing.assert_array_equal(w2[4], w1[4])
    moved = np.abs(w2[2] - w1[2]).sum() > 0
    assert moved != hybridize
    assert moved == (np.abs(j2[2] - j1[2]).sum() > 0)


def test_embedding_rows_union_across_forwards():
    w0 = rand(22, 10, 3)

    def run(mx):
        net, trainer = _embedding(mx, 10, 3, w0, {"learning_rate": 0.5})
        stash = []

        def loss_fn(mx, net):
            loss = net(mx.nd.array([2])).sum() + net(mx.nd.array([7])).sum()
            stash.append(len(net.weight._sparse_row_ids))
            return loss
        w1 = _record(mx, net, trainer, loss_fn)
        return w1, stash, net.weight._sparse_row_ids
    (w1, stash, after), (j1, jstash, jafter) = _both(run)
    assert stash == jstash == [2] and after is None and jafter is None
    for row in (2, 7):
        assert np.abs(w1[row] - w0[row]).sum() > 0
    np.testing.assert_allclose(w1, j1, **TOL)


def test_sparse_step_runs_eagerly_and_counts_a_fallback():
    tmx.profiler.reset_counters()
    w0 = rand(23, 8, 2)
    net, trainer = _embedding(tmx, 8, 2, w0, {"learning_rate": 0.1})
    for _ in range(2):
        _record(tmx, net, trainer,
                lambda mx, net: net(mx.nd.array([1, 3])).sum())
    assert tmx.profiler.counters().get("fused_step_fallbacks") == 2
    assert trainer._fused_updater is None


def test_contrib_sparse_embedding_updates_densely_like_jax():
    """The JAX package gives SparseEmbedding's weight no grad_stype, so
    its Trainer updates every row (wd and momentum reach untouched
    rows): the port keeps that."""
    w0 = rand(24, 6, 2)

    def run(mx):
        net = mx.gluon.contrib.nn.SparseEmbedding(6, 2)
        net.initialize()
        net.weight.set_data(mx.nd.array(w0))
        trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                                   {"learning_rate": 0.1, "wd": 0.1})
        return _record(mx, net, trainer,
                       lambda mx, net: net(mx.nd.array([1, 4])).sum()), \
            repr(net)
    (got, rep), (want, jrep) = _both(run)
    np.testing.assert_allclose(got, want, **TOL)
    assert (got[0] != w0[0]).all() and rep == jrep


def test_parameter_storage_types_and_row_sparse_data():
    p = tmx.gluon.Parameter("w", shape=(4, 3), grad_stype="row_sparse")
    assert p.stype == "default" and p._grad_stype == "row_sparse"
    p.initialize(init=tmx.init.One())
    rows = p.row_sparse_data(tmx.nd.array([3, 1]))
    np.testing.assert_array_equal(rows.asnumpy(), np.ones((2, 3)))


# -- LibSVMIter ---------------------------------------------------------------

_LIBSVM = "1 0:1.5 3:2.0\n0 1:1.0\n1 2:0.5 3:1.0\n0 0:2.0\n\n1 1:3.0\n"


@pytest.mark.parametrize("round_batch", [True, False])
def test_libsvm_iter_yields_csr(tmp_path, round_batch):
    f = tmp_path / "data.libsvm"
    f.write_text(_LIBSVM)
    lab = tmp_path / "label.libsvm"
    lab.write_text("0 0:1 1:2\n0 1:1\n0 0:3\n0 1:4\n0 0:5 1:5\n")

    def run(mx):
        out = []
        for kw in ({}, {"label_libsvm": str(lab), "label_shape": (2,)}):
            it = mx.io.LibSVMIter(data_libsvm=str(f), data_shape=(4,),
                                  batch_size=2, round_batch=round_batch,
                                  **kw)
            batches = [(b.data[0], b.label[0].asnumpy(), b.pad)
                       for b in it]
            it.reset()
            out.append((batches, it.next().data[0], it.provide_data,
                        it.provide_label))
        return out
    for (gb, g_first, g_pd, g_pl), (jb, j_first, j_pd, j_pl) in zip(
            *_both(run)):
        assert len(gb) == len(jb) == 3
        for (gd, gl, gp), (jd, jl, jp) in zip(gb, jb):
            assert gd.stype == "csr"
            _same_sparse(gd, jd)
            np.testing.assert_array_equal(gl, jl)
            assert gl.dtype == jl.dtype and gp == jp
        _same_sparse(g_first, j_first)
        assert [(d.name, d.shape) for d in g_pd + g_pl] == \
            [(d.name, d.shape) for d in j_pd + j_pl]
    np.testing.assert_array_equal(gb[0][0].asnumpy(),
                                  [[1.5, 0, 0, 2.0], [0, 1.0, 0, 0]])


# -- nd.save / nd.load and checkpoints ----------------------------------------

def _sparse_payload(mx):
    sp = mx.nd.sparse
    return {"csr": sp.csr_matrix(_rand_dense((4, 6), seed=30)),
            "rsp": sp.row_sparse_array(_rand_dense((7, 3), density=0.4,
                                                   seed=31)),
            "dense": mx.nd.array(rand(32, 2, 3))}


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_nd_save_load_sparse_across_packages(tmp_path, writer):
    src, dst = (jmx, tmx) if writer == "jax" else (tmx, jmx)
    fname = str(tmp_path / "s.nd")
    payload = _sparse_payload(src)
    src.nd.save(fname, payload)
    got = dst.nd.load(fname)
    assert sorted(got) == sorted(payload)
    for k in ("csr", "rsp"):
        _same_sparse(got[k], payload[k])
    np.testing.assert_array_equal(got["dense"].asnumpy(),
                                  payload["dense"].asnumpy())
    src.nd.save(fname, [payload["rsp"], payload["dense"]])
    lst = dst.nd.load(fname)
    assert isinstance(lst, list) and lst[0].stype == "row_sparse"
    _same_sparse(lst[0], payload["rsp"])


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_sparse_checkpoint_entry_through_writer_and_reader(tmp_path,
                                                           writer):
    from mxnet_tpu import checkpoint as jck
    from mxnet_tpu_torch import checkpoint as tck
    (src, sck), (dst, dck) = ((jmx, jck), (tmx, tck)) if writer == "jax" \
        else ((tmx, tck), (jmx, jck))
    payload = _sparse_payload(src)
    prefix = str(tmp_path / "ck")
    roster = {"arg:emb": payload["rsp"], "arg:w": payload["dense"],
              "aux:feat": payload["csr"]}
    if src is jmx:
        # the JAX snapshot raises on a sparse entry (see the next test):
        # its writer is fed the component layout it means to spill
        from mxnet_tpu.ndarray.ndarray import _flatten_entry
        flat = {}
        for k, v in roster.items():
            _flatten_entry(k, v, flat)
    else:
        flat = sck.snapshot_params(
            {"emb": payload["rsp"], "w": payload["dense"]},
            {"feat": payload["csr"]})
    sck.save_arrays(prefix, 3, flat)
    dck.validate_manifest(prefix, 3)
    flat = dck.load_arrays(prefix, 3)
    assert sorted(flat) == ["arg:emb", "arg:w", "aux:feat"]
    _same_sparse(flat["arg:emb"], payload["rsp"])
    _same_sparse(flat["aux:feat"], payload["csr"])
    np.testing.assert_array_equal(flat["arg:w"].asnumpy(),
                                  payload["dense"].asnumpy())
    if dst is tmx:
        host = tck.load_param_arrays(prefix, 3)
        assert isinstance(host["emb"], torch.Tensor)
        np.testing.assert_array_equal(host["emb"].numpy(),
                                      payload["rsp"].asnumpy())
        args, auxs = tck.restore_params(prefix, 3)
        assert args["emb"].stype == "row_sparse" \
            and auxs["feat"].stype == "csr"


def test_jax_snapshot_of_a_sparse_entry_raises():
    """A reference finding the port does not copy: the JAX package's
    ``checkpoint.snapshot_params`` reads ``value._data`` before its
    sparse branch (mxnet_tpu/checkpoint.py:219), and a sparse array's
    ``_data`` raises, so a sparse entry never reaches the component
    spill. The port's writer spills it (the test above)."""
    from mxnet_tpu import checkpoint as jck
    with pytest.raises(JaxMXNetError):
        jck.snapshot_params({"emb": _sparse_payload(jmx)["rsp"]})
