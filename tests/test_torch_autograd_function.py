"""The port's ``autograd.Function``, ``autograd.get_symbol`` and
``contrib.autograd`` against the JAX package's, on the CPU
(``tests/test_autograd.py::test_get_symbol``, ``tests/test_contrib_band.py``'s
legacy autograd case).

``get_symbol`` reads the notes ``invoke_nd`` leaves on outputs made under
``record()`` (only there); a Gluon parameter's array becomes a variable
of the parameter's name, so the Symbol binds with the block's
parameters. ``Function`` is the JAX package's surface over a
``torch.autograd.Function``."""
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True)
def _port_on_cpu(monkeypatch):
    monkeypatch.setenv("MXNET_DEFAULT_CONTEXT", "cpu")


def _fc_symbol(mx):
    x = mx.nd.ones((2, 2))
    w = mx.nd.ones((3, 2))
    b = mx.nd.zeros((3,))
    x.attach_grad()
    with mx.autograd.record():
        y = mx.nd.FullyConnected(x, w, b, num_hidden=3)
    return mx.autograd.get_symbol(y), y


def test_get_symbol_matches_jax():
    got, _ = _fc_symbol(tmx)
    want, _ = _fc_symbol(jmx)
    assert len(got.list_arguments()) == 3
    assert got.list_arguments() == want.list_arguments()
    assert [n["op"] for n in __import__("json").loads(got.tojson())["nodes"]] \
        == [n["op"] for n in __import__("json").loads(want.tojson())["nodes"]]


def test_get_symbol_binds_and_recomputes():
    """A chain of recorded ops through a Gluon block: the Symbol binds
    with the block's parameters by name and the data as ``var0``, and
    gives the recorded output."""
    net = tmx.gluon.nn.HybridSequential(prefix="m_")
    with net.name_scope():
        net.add(tmx.gluon.nn.Dense(5, in_units=4, activation="tanh"))
        net.add(tmx.gluon.nn.Dense(3, in_units=5))
    net.initialize(tmx.init.Xavier())
    x = tmx.nd.array(np.random.RandomState(0).randn(2, 4)
                     .astype(np.float32))
    with tmx.autograd.record():
        y = (net(x) * 2.0).softmax()
    sym = tmx.autograd.get_symbol(y)
    params = net.collect_params()
    args = {n: params[n].data() for n in sym.list_arguments()
            if n in params}
    assert sorted(args) == sorted(params.keys())
    data = [n for n in sym.list_arguments() if n not in params]
    assert data == ["var0"]
    args["var0"] = x
    out = sym.bind(tmx.cpu(), args).forward()[0]
    np.testing.assert_allclose(out.asnumpy(), y.asnumpy(), **TOL)


def test_notes_only_under_record():
    x = tmx.nd.ones((2,))
    y = x * 2 + 1
    assert y._tape is None
    with tmx.autograd.record():
        z = x * 2 + 1
    assert z._tape is not None and z._tape[0].op.name == "_plus_scalar"


class _Sigmoid:
    """MXNet's autograd.Function example (the stable sigmoid), written
    for the package ``mx``: its output is kept on ``self`` (the JAX
    package's Function has no ``save_for_backward``)."""

    @staticmethod
    def make(mx):
        class Sigmoid(mx.autograd.Function):
            def forward(self, x):
                y = 1 / (1 + mx.nd.exp(-x))
                self.y = y
                return y

            def backward(self, dy):
                y = self.y
                return dy * y * (1 - y)
        return Sigmoid


def _function_grads(mx, use_function):
    rs = np.random.RandomState(1)
    x = mx.nd.array(rs.randn(3, 4).astype(np.float32) * 3)
    w = mx.nd.array(rs.randn(4, 4).astype(np.float32))
    x.attach_grad()
    w.attach_grad()
    with mx.autograd.record():
        h = mx.nd.dot(x, w)
        s = _Sigmoid.make(mx)()(h) if use_function else mx.nd.sigmoid(h)
        loss = (s * s).sum()
    loss.backward()
    return [s.asnumpy(), x.grad.asnumpy(), w.grad.asnumpy()]


def test_function_matches_the_builtin_sigmoid_and_jax():
    got = _function_grads(tmx, True)
    for g, w in zip(got, _function_grads(tmx, False)):
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6)
    for g, w in zip(got, _function_grads(jmx, True)):
        np.testing.assert_allclose(g, w, **TOL)


def test_function_outside_record_is_forward_alone():
    f = _Sigmoid.make(tmx)()
    y = f(tmx.nd.zeros((2,)))
    np.testing.assert_allclose(y.asnumpy(), [0.5, 0.5])
    assert not y._data.requires_grad


def _legacy(mx):
    from importlib import import_module
    old_ag = import_module(mx.__name__ + ".contrib.autograd")
    x = mx.nd.array([1.0, 2.0, 3.0])

    def f(x):
        return (x * x).sum()
    grads, loss = old_ag.grad_and_loss(f)(x)
    g_only = old_ag.grad(f)(x)
    prev = old_ag.set_is_training(True)
    now = mx.autograd.is_training()
    old_ag.set_is_training(prev)
    return [grads[0].asnumpy(), loss.asnumpy(), g_only[0].asnumpy(),
            np.array([prev, now])]


def test_legacy_contrib_autograd_matches_jax():
    got, want = _legacy(tmx), _legacy(jmx)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-6)
    np.testing.assert_allclose(got[0], [2.0, 4.0, 6.0])
    assert float(got[1]) == 14.0
    assert tmx.contrib.autograd.train_section is not None
