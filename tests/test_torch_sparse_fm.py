"""BASELINE config 4 on the CPU: ``tests/test_sparse.py``'s factorization
machine (two ``nn.Embedding(sparse_grad=True)`` and the pairwise term,
``SigmoidBinaryCrossEntropyLoss``, Adam lr 0.02) through the port's
Gluon Trainer, held to the JAX package step by step from the same
initial weights and batches (rtol 1e-5, atol 1e-6), and trained until it
converges as ``test_factorization_machine_trains`` asserts; and its rows
through a libsvm file and ``mx.io.LibSVMIter``, which feeds it in
``chip_smoke.py`` phase 23."""
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

TOL = dict(rtol=1e-5, atol=1e-6)
F, K, NNZ, N, B = 50, 4, 5, 256, 32


@pytest.fixture(autouse=True)
def _port_on_cpu(monkeypatch):
    monkeypatch.setenv("MXNET_DEFAULT_CONTEXT", "cpu")


@pytest.fixture(autouse=True)
def _fresh_names():
    from mxnet_tpu.name import NameManager as JaxNames
    from mxnet_tpu_torch.name import NameManager as PortNames
    with JaxNames(), PortNames():
        yield


def _data():
    rng = np.random.RandomState(7)
    idx = rng.randint(0, F, (N, NNZ))
    vals = rng.uniform(0.5, 1.5, (N, NNZ)).astype(np.float32)
    true_w = rng.normal(0, 1, F).astype(np.float32)
    y = ((true_w[idx] * vals).sum(1) > 0).astype(np.float32)
    return idx, vals, y


def _init():
    rng = np.random.RandomState(8)
    return (rng.normal(0, 0.05, (F, 1)).astype(np.float32),
            rng.normal(0, 0.05, (F, K)).astype(np.float32))


def _fm(mx, hybrid=False):
    """The FM of tests/test_sparse.py:302-314 as a HybridBlock: eager,
    or hybridized with ``hybrid``."""
    nn = mx.gluon.nn

    class FM(mx.gluon.HybridBlock):
        def __init__(self, **kw):
            super().__init__(**kw)
            with self.name_scope():
                self.w = nn.Embedding(F, 1, sparse_grad=True)
                self.v = nn.Embedding(F, K, sparse_grad=True)

        def hybrid_forward(self, F_, idx, vals):
            linear = (F_.squeeze(self.w(idx), axis=2) * vals).sum(1)
            vx = self.v(idx) * vals.expand_dims(2)
            s1 = vx.sum(1) ** 2
            s2 = (vx ** 2).sum(1)
            return linear + 0.5 * (s1 - s2).sum(1)

    net = FM()
    net.initialize(mx.init.Normal(0.05))
    w0, v0 = _init()
    net.w.weight.set_data(mx.nd.array(w0))
    net.v.weight.set_data(mx.nd.array(v0))
    if hybrid:
        net.hybridize()
    return net


def _steps(mx, n_steps, hybrid=False):
    """``n_steps`` Trainer steps over the first batches; the loss of
    each and the weights after."""
    idx, vals, y = _data()
    net = _fm(mx, hybrid)
    trainer = mx.gluon.Trainer(net.collect_params(), "adam",
                               {"learning_rate": 0.02})
    loss_fn = mx.gluon.loss.SigmoidBinaryCrossEntropyLoss()
    losses = []
    for b in range(n_steps):
        sl = slice(b * B, (b + 1) * B)
        with mx.autograd.record():
            loss = loss_fn(net(mx.nd.array(idx[sl]), mx.nd.array(vals[sl])),
                           mx.nd.array(y[sl]))
        loss.backward()
        trainer.step(B)
        losses.append(loss.asnumpy())
    return losses, net.w.weight.data().asnumpy(), \
        net.v.weight.data().asnumpy()


@pytest.mark.parametrize("n_steps", [1, 4])
def test_fm_steps_match_jax(n_steps):
    (tl, tw, tv), (jl, jw, jv) = (_steps(tmx, n_steps),
                                  _steps(jmx, n_steps))
    for g, w in zip(tl, jl):
        np.testing.assert_allclose(g, w, **TOL)
    np.testing.assert_allclose(tw, jw, **TOL)
    np.testing.assert_allclose(tv, jv, **TOL)
    # lazy Adam: rows no batch looked up keep their initial values
    idx = _data()[0][:n_steps * B]
    untouched = sorted(set(range(F)) - set(idx.ravel().tolist()))
    w0, v0 = _init()
    np.testing.assert_array_equal(tv[untouched], v0[untouched])


def test_hybridized_fm_scans_for_rows_like_jax():
    """Hybridized, the lookups stash no ids: the Trainer takes the
    gradient's non-zero rows, in both packages."""
    (tl, tw, tv), (jl, jw, jv) = (_steps(tmx, 2, True),
                                  _steps(jmx, 2, True))
    for g, w in zip(tl, jl):
        np.testing.assert_allclose(g, w, **TOL)
    np.testing.assert_allclose(tw, jw, **TOL)
    np.testing.assert_allclose(tv, jv, **TOL)


def test_factorization_machine_trains():
    """tests/test_sparse.py's convergence gate on the port."""
    idx, vals, y = _data()
    net = _fm(tmx)
    trainer = tmx.gluon.Trainer(net.collect_params(), "adam",
                                {"learning_rate": 0.02})
    loss_fn = tmx.gluon.loss.SigmoidBinaryCrossEntropyLoss()
    losses = []
    for _ in range(8):
        ep = []
        for b in range(N // B):
            sl = slice(b * B, (b + 1) * B)
            with tmx.autograd.record():
                loss = loss_fn(net(tmx.nd.array(idx[sl]),
                                   tmx.nd.array(vals[sl])),
                               tmx.nd.array(y[sl]))
            loss.backward()
            trainer.step(B)
            ep.append(float(loss.asnumpy().mean()))
        losses.append(np.mean(ep))
    assert losses[-1] < losses[0] * 0.6, losses


def test_fm_data_through_libsvm_iter(tmp_path):
    """The FM's rows written as a libsvm file (a row's repeated ids
    summed) come back from ``LibSVMIter`` as csr batches equal to them,
    labels alike, in order."""
    idx, vals, y = _data()
    dense = np.zeros((N, F), np.float32)
    np.add.at(dense, (np.arange(N)[:, None], idx), vals)
    path = tmp_path / "fm.libsvm"
    with open(path, "w") as f:
        for r in range(N):
            cols = np.nonzero(dense[r])[0]
            f.write("%d %s\n" % (y[r], " ".join(
                "%d:%r" % (c, float(dense[r, c])) for c in cols)))
    it = tmx.io.LibSVMIter(data_libsvm=str(path), data_shape=(F,),
                           batch_size=B)
    seen = 0
    for batch in it:
        csr = batch.data[0]
        assert csr.stype == "csr" and csr.shape == (B, F)
        np.testing.assert_array_equal(csr.asnumpy(), dense[seen:seen + B])
        np.testing.assert_array_equal(batch.label[0].asnumpy(),
                                      y[seen:seen + B])
        seen += B
    assert seen == N
