"""The rest of the Gluon surface, the port against the JAX package on
the CPU from the same numpy inputs: the ``LeakyReLU`` (six act_types),
``InstanceNorm`` and ``norm`` ops, the nine ``gluon.nn`` layers and the
three ``PixelShuffle``s (eager and hybridized), the ten losses and
``CTCLoss`` (over the ``ctc_loss`` op of the operator breadth), forward
hooks, ``summary``, ``Constant``/``get_constant``, ``gluon.utils`` and
the five initializers (identical arrays under one ``np.random.seed``).
Forward values and input and parameter gradients are held at
``rtol=1e-5, atol=1e-6``. JAX blocks are built under a fresh
NameManager, so the process-wide name counters do not move."""
import contextlib
import hashlib
import io
import warnings

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.gluon.convert import params_from_numpy

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


def _rand(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _grads(mx, fn, arrays, head, train_mode=True):
    """(output, input gradients) of ``fn(mx, *arrays)`` under record,
    backward from ``head``."""
    nds = [mx.nd.array(a) for a in arrays]
    for n in nds:
        n.attach_grad()
    with mx.autograd.record(train_mode=train_mode):
        out = fn(mx, *nds)
    out.backward(mx.nd.array(head))
    return out.asnumpy(), [n.grad.asnumpy() for n in nds]


def _hold(fn, arrays, head, train_mode=True):
    want, wgrads = _grads(jmx, fn, arrays, head, train_mode)
    got, ggrads = _grads(tmx, fn, arrays, head, train_mode)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)
    for g, w in zip(ggrads, wgrads):
        np.testing.assert_allclose(g, w, **TOL)


# ---------------------------------------------------------------------------
# ops
# ---------------------------------------------------------------------------

LEAKY = {
    "leaky": lambda mx, x: mx.nd.LeakyReLU(x, act_type="leaky", slope=0.2),
    "elu": lambda mx, x: mx.nd.LeakyReLU(x, act_type="elu", slope=0.7),
    "selu": lambda mx, x: mx.nd.LeakyReLU(x, act_type="selu"),
    "gelu": lambda mx, x: mx.nd.LeakyReLU(x, act_type="gelu"),
    "rrelu_predict": lambda mx, x: mx.nd.LeakyReLU(
        x, act_type="rrelu", lower_bound=0.1, upper_bound=0.3)[0],
}


@pytest.mark.parametrize("name", sorted(LEAKY))
def test_leaky_relu_act_types_match_jax(name):
    x = _rand(1, 2, 3, 4, 5)
    _hold(lambda mx, a: LEAKY[name](mx, a), [x], _rand(2, 2, 3, 4, 5),
          train_mode=False)


def test_leaky_relu_prelu_gradients_reach_gamma():
    x, gamma = _rand(3, 2, 3, 4, 4), np.array([0.1, 0.5, 2.0], np.float32)
    _hold(lambda mx, a, g: mx.nd.LeakyReLU(a, g, act_type="prelu"),
          [x, gamma], _rand(4, 2, 3, 4, 4))


def test_rrelu_draws_slopes_in_training_only():
    op = tmx.ops.get_op("LeakyReLU")
    attrs = {"act_type": "rrelu"}
    assert op.draws_in(attrs, True) and not op.draws_in(attrs, False)
    assert not op.draws_in({"act_type": "leaky"}, True)
    assert tmx.ops.get_op("LeakyReLU").resolve_num_outputs(attrs) == 2
    tmx.random.seed(9)
    x = tmx.nd.array(-np.abs(_rand(5, 64, 64)) - 0.1)
    x.attach_grad()
    with tmx.autograd.record():
        out, mask = tmx.nd.LeakyReLU(x, act_type="rrelu")
    out.backward(tmx.nd.ones(out.shape))
    m = mask.asnumpy()
    assert m.min() >= 0.125 and m.max() < 0.334
    np.testing.assert_allclose(m.mean(), (0.125 + 0.334) / 2, atol=5e-3)
    np.testing.assert_allclose(out.asnumpy(), m * x.asnumpy(), **TOL)
    np.testing.assert_allclose(x.grad.asnumpy(), m, **TOL)
    pred, pmask = tmx.nd.LeakyReLU(x, act_type="rrelu")
    np.testing.assert_allclose(pmask.asnumpy(), (0.125 + 0.334) / 2)


@pytest.mark.parametrize("eps", [1e-3, 1e-5])
def test_instance_norm_op_matches_jax(eps):
    x = _rand(6, 2, 3, 5, 4)
    gamma, beta = _rand(7, 3), _rand(8, 3)
    _hold(lambda mx, a, g, b: mx.nd.InstanceNorm(a, g, b, eps=eps),
          [x, gamma, beta], _rand(9, 2, 3, 5, 4))
    assert tmx.ops.get_op("InstanceNorm").defaults["eps"] == 1e-3


@pytest.mark.parametrize("kw", [
    dict(), dict(ord=1), dict(axis=1), dict(axis=(0, 2), keepdims=True),
    dict(ord=1, axis=-1, keepdims=True)],
    ids=["l2_all", "l1_all", "l2_axis1", "l2_axes_keep", "l1_last_keep"])
def test_norm_op_matches_jax(kw):
    x = _rand(10, 3, 4, 5)
    want = jmx.nd.norm(jmx.nd.array(x), **kw).asnumpy()
    head = _rand(11, *want.shape) if want.shape else np.float32(1.0)
    _hold(lambda mx, a: mx.nd.norm(a, **kw), [x], head)


# ---------------------------------------------------------------------------
# gluon.nn layers
# ---------------------------------------------------------------------------

def _weights(net):
    return {k: p.data().asnumpy()
            for k, p in net._collect_params_with_prefix().items()}


def _pair(make, x):
    """The block from ``make(mx)`` in both packages with the JAX block's
    weights (after a deferred-init forward on ``x``) in both."""
    jnet = make(jmx)
    jnet.initialize()
    jnet(jmx.nd.array(x))
    weights = _weights(jnet)
    tnet = make(tmx)
    tnet.initialize()
    params_from_numpy(tnet, weights)
    return jnet, tnet


def _block_run(mx, net, x, head):
    xin = mx.nd.array(x)
    xin.attach_grad()
    with mx.autograd.record():
        out = net(xin)
    out.backward(mx.nd.array(head))
    grads = {k: p.grad().asnumpy()
             for k, p in net._collect_params_with_prefix().items()
             if p.grad_req != "null"}
    return out.asnumpy(), xin.grad.asnumpy(), grads


LAYERS = {
    "LeakyReLU": (lambda mx: mx.gluon.nn.LeakyReLU(0.2), (2, 3, 4, 4)),
    "PReLU": (lambda mx: mx.gluon.nn.PReLU(
        alpha_initializer=mx.init.Constant(0.3)), (2, 3, 4, 4)),
    "ELU": (lambda mx: mx.gluon.nn.ELU(0.8), (2, 3, 4, 4)),
    "SELU": (lambda mx: mx.gluon.nn.SELU(), (2, 3, 4, 4)),
    "GELU": (lambda mx: mx.gluon.nn.GELU(), (2, 3, 4, 4)),
    "Swish": (lambda mx: mx.gluon.nn.Swish(1.5), (2, 3, 4, 4)),
    "InstanceNorm": (lambda mx: mx.gluon.nn.InstanceNorm(
        scale=True, gamma_initializer=mx.init.Constant(1.5),
        beta_initializer=mx.init.Constant(-0.25)), (2, 3, 5, 4)),
    "InstanceNorm_noscale": (lambda mx: mx.gluon.nn.InstanceNorm(
        in_channels=3), (2, 3, 5, 4)),
    "HybridLambda_name": (lambda mx: mx.gluon.nn.HybridLambda("tanh"),
                          (2, 6)),
    "HybridLambda_fn": (lambda mx: mx.gluon.nn.HybridLambda(
        lambda F, x: F.LeakyReLU(x, act_type="elu", slope=0.5)), (2, 6)),
    "PixelShuffle1D": (lambda mx: mx.gluon.contrib.nn.PixelShuffle1D(3),
                       (2, 6, 4)),
    "PixelShuffle2D": (lambda mx: mx.gluon.contrib.nn.PixelShuffle2D(
        (2, 3)), (2, 12, 3, 2)),
    "PixelShuffle3D": (lambda mx: mx.gluon.contrib.nn.PixelShuffle3D(2),
                       (1, 16, 2, 3, 2)),
}


@pytest.mark.parametrize("hybridize", [False, True], ids=["eager", "hybrid"])
@pytest.mark.parametrize("name", sorted(LAYERS))
def test_layer_forward_and_gradients_match_jax(name, hybridize):
    make, shape = LAYERS[name]
    x = _rand(20, *shape)
    jnet, tnet = _pair(make, x)
    if hybridize:
        jnet.hybridize()
        tnet.hybridize()
    head_shape = jnet(jmx.nd.array(x)).shape
    head = _rand(21, *head_shape)
    want, wgx, wgp = _block_run(jmx, jnet, x, head)
    got, ggx, ggp = _block_run(tmx, tnet, x, head)
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(ggx, wgx, **TOL)
    assert sorted(ggp) == sorted(wgp)
    for k in wgp:
        np.testing.assert_allclose(ggp[k], wgp[k], **TOL, err_msg=k)
    # predict mode, off the tape
    np.testing.assert_allclose(tnet(tmx.nd.array(x)).asnumpy(),
                               jnet(jmx.nd.array(x)).asnumpy(), **TOL)


def test_lambda_blocks_and_reprs_match_jax():
    for mx in (jmx, tmx):
        assert repr(mx.gluon.nn.Lambda("tanh")) == "Lambda(tanh)"
        with pytest.raises(AssertionError):
            mx.gluon.nn.Lambda("no_such_op")
        with pytest.raises(ValueError):
            mx.gluon.nn.HybridLambda(3)
    x = _rand(22, 3, 4)
    got = tmx.gluon.nn.Lambda(lambda a: a * 2 + 1)(tmx.nd.array(x))
    np.testing.assert_allclose(got.asnumpy(), x * 2 + 1, **TOL)
    got = tmx.gluon.nn.Lambda("tanh")(tmx.nd.array(x)).asnumpy()
    np.testing.assert_allclose(got, np.tanh(x), **TOL)
    makes = [lambda mx: mx.gluon.nn.LeakyReLU(0.2),
             lambda mx: mx.gluon.nn.InstanceNorm(in_channels=3),
             lambda mx: mx.gluon.nn.HybridLambda("tanh"),
             lambda mx: mx.gluon.contrib.nn.PixelShuffle2D((2, 3)),
             lambda mx: mx.gluon.contrib.nn.PixelShuffle1D(2)]
    for make in makes:
        assert repr(make(tmx)) == repr(make(jmx))
    with pytest.raises(AssertionError):
        tmx.gluon.nn.LeakyReLU(-0.1)
    prelu = tmx.gluon.nn.PReLU()
    assert list(prelu.params.keys()) == [prelu.prefix + "alpha"]
    inorm = tmx.gluon.nn.InstanceNorm()
    assert sorted(k[len(inorm.prefix):] for k in inorm.params.keys()) \
        == ["beta", "gamma"]
    assert inorm.gamma.grad_req == "null" and inorm.beta.grad_req == "write"


def test_pixel_shuffle_element_identity():
    """tests/test_gluon.py's oracle: out[n, c, w*f + i] = in[n, c*f + i,
    w], and its 3-D counterpart."""
    x = tmx.nd.array(np.arange(2 * 6 * 4, dtype=np.float32)
                     .reshape(2, 6, 4))
    out = tmx.gluon.contrib.nn.PixelShuffle1D(3)(x)
    assert out.shape == (2, 2, 12)
    inp, got = x.asnumpy(), out.asnumpy()
    for w in range(4):
        for i in range(3):
            assert got[0, 0, w * 3 + i] == inp[0, i, w]
    x3 = tmx.nd.array(_rand(1, 1, 8, 2, 2, 2))
    out3 = tmx.gluon.contrib.nn.PixelShuffle3D(2)(x3)
    assert out3.shape == (1, 1, 4, 4, 4)
    inp3, got3 = x3.asnumpy(), out3.asnumpy()
    for d in range(2):
        for h in range(2):
            for w in range(2):
                for i in range(2):
                    for j in range(2):
                        for k in range(2):
                            assert got3[0, 0, d * 2 + i, h * 2 + j,
                                        w * 2 + k] == \
                                inp3[0, (i * 2 + j) * 2 + k, d, h, w]


def test_params_from_numpy_takes_the_new_layers_parameters():
    """One set of numpy weights into both packages: PReLU's alpha,
    InstanceNorm's gamma/beta, a Conv2DTranspose weight (in, out, kh,
    kw) and BatchNorm's running statistics."""
    def make(mx):
        net = mx.gluon.nn.HybridSequential()
        with net.name_scope():
            net.add(mx.gluon.nn.Conv2DTranspose(4, 4, 2, 1, use_bias=False,
                                                in_channels=3),
                    mx.gluon.nn.BatchNorm(in_channels=4),
                    mx.gluon.nn.PReLU(),
                    mx.gluon.nn.InstanceNorm(in_channels=4, scale=True))
        return net
    rs = np.random.RandomState(23)
    weights = {"0.weight": rs.randn(3, 4, 4, 4).astype(np.float32),
               "1.gamma": rs.rand(4).astype(np.float32) + 0.5,
               "1.beta": rs.randn(4).astype(np.float32),
               "1.running_mean": rs.randn(4).astype(np.float32),
               "1.running_var": rs.rand(4).astype(np.float32) + 0.5,
               "2.alpha": np.array([0.3], np.float32),
               "3.gamma": rs.rand(4).astype(np.float32) + 0.5,
               "3.beta": rs.randn(4).astype(np.float32)}
    jnet = make(jmx)
    jnet.initialize()
    for k, p in jnet._collect_params_with_prefix().items():
        p.set_data(jmx.nd.array(weights[k]))
    tnet = make(tmx)
    tnet.initialize()
    params_from_numpy(tnet, weights)
    assert {k: p.shape for k, p in
            tnet._collect_params_with_prefix().items()} == \
        {k: p.shape for k, p in jnet._collect_params_with_prefix().items()}
    x = _rand(24, 2, 3, 5, 5)
    np.testing.assert_allclose(tnet(tmx.nd.array(x)).asnumpy(),
                               jnet(jmx.nd.array(x)).asnumpy(), **TOL)
    for k, v in _weights(tnet).items():
        np.testing.assert_array_equal(v, weights[k])


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

def _pos(seed, *shape):
    return (np.random.RandomState(seed).rand(*shape) * 0.9 + 0.05
            ).astype(np.float32)


def _sign(seed, *shape):
    return np.where(np.random.RandomState(seed).rand(*shape) > 0.5,
                    1.0, -1.0).astype(np.float32)


def _bits(seed, *shape):
    return (np.random.RandomState(seed).rand(*shape) > 0.5
            ).astype(np.float32)


SW = _pos(30, 4, 1)

LOSSES = {
    "L1": (lambda mx: mx.gluon.loss.L1Loss(weight=0.5),
           [_rand(31, 4, 5), _rand(32, 4, 5), SW]),
    "SigmoidBCE_logits": (lambda mx: mx.gluon.loss.SigmoidBCELoss(),
                          [_rand(33, 4, 5) * 3, _bits(34, 4, 5), SW]),
    "SigmoidBCE_logits_pos_weight": (
        lambda mx: mx.gluon.loss.SigmoidBinaryCrossEntropyLoss(),
        [_rand(33, 4, 5) * 3, _bits(34, 4, 5), SW, _pos(35, 5) * 3]),
    "SigmoidBCE_probs": (
        lambda mx: mx.gluon.loss.SigmoidBCELoss(from_sigmoid=True),
        [_pos(36, 4, 5), _bits(37, 4, 5), SW]),
    "SigmoidBCE_probs_pos_weight": (
        lambda mx: mx.gluon.loss.SigmoidBCELoss(from_sigmoid=True),
        [_pos(36, 4, 5), _bits(37, 4, 5), SW, _pos(38, 5) * 3]),
    "KLDiv_logits": (lambda mx: mx.gluon.loss.KLDivLoss(),
                     [np.log(_pos(39, 4, 5)), _pos(40, 4, 5), SW]),
    "KLDiv_softmax": (lambda mx: mx.gluon.loss.KLDivLoss(from_logits=False),
                      [_rand(41, 4, 5), _pos(42, 4, 5), SW]),
    "Huber": (lambda mx: mx.gluon.loss.HuberLoss(rho=0.5),
              [_rand(43, 4, 5), _rand(44, 4, 5), SW]),
    "Hinge": (lambda mx: mx.gluon.loss.HingeLoss(margin=0.8),
              [_rand(45, 4, 5), _sign(46, 4, 5), SW]),
    "SquaredHinge": (lambda mx: mx.gluon.loss.SquaredHingeLoss(),
                     [_rand(47, 4, 5), _sign(48, 4, 5), SW]),
    "Logistic_signed": (lambda mx: mx.gluon.loss.LogisticLoss(),
                        [_rand(49, 4, 5) * 2, _sign(50, 4, 5), SW]),
    "Logistic_binary": (lambda mx: mx.gluon.loss.LogisticLoss(
        label_format="binary"), [_rand(51, 4, 5) * 2, _bits(52, 4, 5), SW]),
    "Triplet": (lambda mx: mx.gluon.loss.TripletLoss(margin=2.0),
                [_rand(53, 4, 5), _rand(54, 4, 5), _rand(55, 4, 5)]),
    "PoissonNLL_logits": (lambda mx: mx.gluon.loss.PoissonNLLLoss(),
                          [_rand(56, 4, 5), _pos(57, 4, 5) * 4, SW]),
    "PoissonNLL_full": (lambda mx: mx.gluon.loss.PoissonNLLLoss(
        from_logits=False, compute_full=True),
        [_pos(58, 4, 5) * 3, _pos(59, 4, 5) * 4, SW]),
    "CosineEmbedding": (lambda mx: mx.gluon.loss.CosineEmbeddingLoss(
        margin=0.1), [_rand(60, 4, 5), _rand(61, 4, 5),
                      np.array([1, -1, 1, -1], np.float32), SW[:, 0]]),
}


@pytest.mark.parametrize("name", sorted(LOSSES))
def test_loss_forward_and_gradient_match_jax(name):
    make, arrays = LOSSES[name]

    def run(mx):
        loss = make(mx)
        args = [mx.nd.array(a) for a in arrays]
        args[0].attach_grad()
        with mx.autograd.record():
            out = loss(*args)
        out.backward()
        return out.asnumpy(), args[0].grad.asnumpy()
    want, wgrad = run(jmx)
    got, ggrad = run(tmx)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(ggrad, wgrad, **TOL)


def test_loss_oracles_of_the_reference_tests():
    """tests/test_gluon.py's cases: L1 is the mean absolute error, Huber
    one value a sample; the losses repr as the JAX package's."""
    p = _rand(62, 4, 5)
    l1 = tmx.gluon.loss.L1Loss()(tmx.nd.array(p), tmx.nd.zeros((4, 5)))
    np.testing.assert_allclose(l1.asnumpy(), np.abs(p).mean(axis=1), **TOL)
    h = tmx.gluon.loss.HuberLoss()(tmx.nd.array(p), tmx.nd.zeros((4, 5)))
    assert h.shape == (4,)
    assert tmx.gluon.loss.SigmoidBCELoss is \
        tmx.gluon.loss.SigmoidBinaryCrossEntropyLoss
    for name in ("L1Loss", "HingeLoss", "TripletLoss", "KLDivLoss"):
        assert repr(getattr(tmx.gluon.loss, name)()) == \
            repr(getattr(jmx.gluon.loss, name)())
    with pytest.raises(ValueError):
        tmx.gluon.loss.LogisticLoss(label_format="other")


@pytest.mark.parametrize("layout,label_layout,lengths,hybridize", [
    ("NTC", "NT", False, False), ("TNC", "TN", False, False),
    ("NTC", "NT", True, False), ("NTC", "NT", True, True)])
def test_ctc_loss_matches_jax(layout, label_layout, lengths, hybridize):
    """gluon.loss.CTCLoss over the ``ctc_loss`` op: the losses and the
    prediction's gradient against the JAX package's loss block, with the
    sequence and label lengths given or read from zero padding."""
    pred = _rand(63, 3, 10, 6) * 2
    label = np.array([[1, 2, 2, 0], [3, 1, 4, 5], [5, 0, 0, 0]], np.float32)
    if layout == "TNC":
        pred = pred.transpose(1, 0, 2)
    if label_layout == "TN":
        label = label.T
    extra = [np.array([10, 8, 4], np.float32),
             np.array([3, 4, 1], np.float32)] if lengths else []

    def run(mx):
        loss = mx.gluon.loss.CTCLoss(layout=layout, label_layout=label_layout,
                                     weight=0.5)
        if hybridize:
            loss.hybridize()
        args = [mx.nd.array(a) for a in [pred, label] + extra]
        args[0].attach_grad()
        with mx.autograd.record():
            out = loss(*args)
        out.backward()
        return out.asnumpy(), args[0].grad.asnumpy()
    want, wgrad = run(jmx)
    got, ggrad = run(tmx)
    assert got.shape == want.shape == (3,)
    np.testing.assert_allclose(got, want, **TOL)
    # the gradient runs back through T logaddexp steps: float32 rounding
    # of XLA's and torch's steps differ in the last ulps
    np.testing.assert_allclose(ggrad, wgrad, rtol=1e-5, atol=2e-6)


# ---------------------------------------------------------------------------
# hooks, summary, Constant
# ---------------------------------------------------------------------------

def _hooked(mx):
    net = mx.gluon.nn.HybridSequential()
    with net.name_scope():
        net.add(mx.gluon.nn.Conv2D(4, 3, padding=1, in_channels=2),
                mx.gluon.nn.BatchNorm(in_channels=4),
                mx.gluon.nn.LeakyReLU(0.1),
                mx.gluon.nn.Dense(3, in_units=4 * 5 * 5))
    net.initialize(mx.init.Xavier())
    return net


def test_forward_hooks_run_around_each_call_and_detach():
    for mx in (jmx, tmx):
        net = _hooked(mx)
        calls = []
        pre = net[2].register_forward_pre_hook(
            lambda blk, args: calls.append(("pre", type(blk).__name__,
                                            args[0].shape)))
        post = net[2].register_forward_hook(
            lambda blk, args, out: calls.append(("post", out.shape)))
        whole = net.register_forward_hook(
            lambda blk, args, out: calls.append(("net", out.shape)))
        x = mx.nd.array(_rand(63, 2, 2, 5, 5))
        net(x)
        assert calls == [("pre", "LeakyReLU", (2, 4, 5, 5)),
                         ("post", (2, 4, 5, 5)), ("net", (2, 3))]
        pre.detach()
        post.detach()
        calls.clear()
        net(x)
        assert calls == [("net", (2, 3))]
        whole.detach()
        net(x)
        assert calls == [("net", (2, 3))]


def _summary(mx, net, x):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        net.summary(mx.nd.array(x))
    return buf.getvalue()


def test_summary_prints_the_jax_table():
    x = _rand(64, 2, 2, 5, 5)
    want = _summary(jmx, _hooked(jmx), x)
    got = _summary(tmx, _hooked(tmx), x)
    assert got == want
    assert "Total params: 395" in got and "Trainable params: 387" in got
    shared = tmx.gluon.nn.HybridSequential()
    with shared.name_scope():
        dense = tmx.gluon.nn.Dense(4, in_units=4)
        shared.add(dense, tmx.gluon.nn.Dense(4, in_units=4,
                                             params=dense.params))
    shared.initialize()
    text = _summary(tmx, shared, _rand(65, 1, 4))
    assert "Shared params in forward computation graph: 20" in text
    assert "Unique parameters in model: 20" in text


def test_block_summary_and_repr_case_of_the_reference_tests():
    net = tmx.gluon.nn.HybridSequential()
    with net.name_scope():
        net.add(tmx.gluon.nn.Dense(4, in_units=3))
    net.initialize()
    repr(net)
    text = _summary(tmx, net, np.ones((1, 3), np.float32))
    assert "Dense-1" in text and "Total params: 16" in text


class _Offset:
    """A block adding a constant held by ``get_constant``."""

    @staticmethod
    def make(mx):
        class Offset(mx.gluon.HybridBlock):
            def __init__(self, **kwargs):
                super().__init__(**kwargs)
                self.dense = mx.gluon.nn.Dense(3, in_units=4)
                self.const = self.params.get_constant(
                    "const", np.arange(3, dtype=np.float32))

            def hybrid_forward(self, F, x, const):
                return F.broadcast_add(self.dense(x), const)
        return Offset()


@pytest.mark.parametrize("hybridize", [False, True], ids=["eager", "hybrid"])
def test_constant_gets_no_gradient_and_trainer_skips_it(hybridize):
    x = _rand(66, 2, 4)
    jnet, tnet = _pair(_Offset.make, x)
    if hybridize:
        jnet.hybridize()
        tnet.hybridize()
    head = _rand(67, 2, 3)
    want, wgx, wgp = _block_run(jmx, jnet, x, head)
    got, ggx, ggp = _block_run(tmx, tnet, x, head)
    np.testing.assert_allclose(got, want, **TOL)
    assert sorted(ggp) == sorted(wgp) == ["dense.bias", "dense.weight"]
    assert isinstance(tnet.const, tmx.gluon.Constant)
    assert tnet.const.grad_req == "null"
    trainer = tmx.gluon.Trainer(tnet.collect_params(), "sgd",
                                {"learning_rate": 0.5})
    trainer.step(2)
    np.testing.assert_array_equal(tnet.const.data().asnumpy(),
                                  np.arange(3, dtype=np.float32))
    assert not np.allclose(tnet.dense.weight.data().asnumpy(),
                           _weights(jnet)["dense.weight"])


def test_get_constant_lookup_rules_match_jax():
    for mx in (jmx, tmx):
        pd = mx.gluon.ParameterDict("blk_")
        c = pd.get_constant("c", [1.0, 2.0])
        assert pd.get_constant("c") is c
        assert c.name == "blk_c" and c.shape == (2,)
        with pytest.raises(KeyError):
            pd.get_constant("missing")
        pd.get("w", shape=(2,))
        with pytest.raises(AssertionError):
            pd.get_constant("w", [0.0])
        c.initialize()
        np.testing.assert_array_equal(c.data().asnumpy(), [1.0, 2.0])
    assert tmx.gluon.Constant is tmx.gluon.parameter.Constant


# ---------------------------------------------------------------------------
# gluon.utils
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("num,even", [(1, True), (2, True), (3, False)])
def test_split_data_matches_jax(num, even):
    x = _rand(70, 8, 3)
    want = jmx.gluon.utils.split_data(jmx.nd.array(x), num, 0, even)
    got = tmx.gluon.split_data(tmx.nd.array(x), num, 0, even)
    assert len(got) == len(want) == num
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.asnumpy(), w.asnumpy())
    with pytest.raises(ValueError):
        tmx.gluon.utils.split_data(tmx.nd.array(x), 3)


def test_split_and_load_over_one_context(monkeypatch):
    x = _rand(71, 4, 3)
    out = tmx.gluon.split_and_load(x, [tmx.cpu()])
    assert len(out) == 1 and out[0].context == tmx.cpu()
    np.testing.assert_array_equal(out[0].asnumpy(), x)
    assert len(tmx.gluon.utils.split_and_load(
        tmx.nd.array(x), [tmx.cpu(), tmx.cpu()])) == 1
    # contexts on one torch device are one: the whole batch, one array,
    # as the JAX package's mesh array holds it
    two = tmx.gluon.utils.split_and_load(x, [tmx.cpu(0), tmx.cpu(1)])
    want = jmx.gluon.utils.split_and_load(x, [jmx.cpu(0), jmx.cpu(1)])
    assert len(two) == len(want) == 1
    np.testing.assert_array_equal(two[0].asnumpy(), want[0].asnumpy())
    dense = tmx.gluon.nn.Dense(2, in_units=3)
    dense.initialize(ctx=[tmx.cpu(0), tmx.cpu(1)])
    assert len(dense.weight.list_data()) == len(dense.weight.list_grad()) == 1
    assert dense.weight.list_ctx() == [tmx.cpu(0), tmx.cpu(1)]
    # on distinct devices (this test's first form raised for them): one
    # array split over the in-process mesh, as the JAX mesh array
    real = tmx.Context.torch_device
    monkeypatch.setattr(tmx.Context, "torch_device", lambda self: (
        torch.device("cpu", self.device_id) if self.device_type == "cpu"
        else real(self)))
    apart = tmx.gluon.utils.split_and_load(x, [tmx.cpu(0), tmx.cpu(1)])
    assert len(apart) == 1 and isinstance(apart[0], tmx.nd.MeshNDArray)
    assert apart[0].shape == (4, 3) and apart[0].context == tmx.cpu(0)
    assert [tuple(s.shape) for s in apart[0]._mt.shards] == [(2, 3), (2, 3)]
    np.testing.assert_array_equal(apart[0].asnumpy(), want[0].asnumpy())


@pytest.mark.parametrize("max_norm", [0.5, 1e3])
def test_clip_global_norm_matches_jax(max_norm):
    arrays = [_rand(72, 3, 4), _rand(73, 5)]

    def run(mx):
        nds = [mx.nd.array(a) for a in arrays]
        norm = mx.gluon.utils.clip_global_norm(nds, max_norm)
        return norm, [n.asnumpy() for n in nds]
    wnorm, want = run(jmx)
    gnorm, got = run(tmx)
    np.testing.assert_allclose(gnorm, wnorm, **TOL)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **TOL)


def test_clip_global_norm_scales_gradient_buffers_in_place():
    net = tmx.gluon.nn.Dense(3, in_units=4)
    net.initialize()
    with tmx.autograd.record():
        out = net(tmx.nd.array(_rand(74, 2, 4) * 10))
    out.backward()
    grads = [p.grad() for p in net.collect_params().values()]
    tensors = [g._data for g in grads]
    tmx.gluon.clip_global_norm(grads, 0.1)
    assert all(g._data is t for g, t in zip(grads, tensors))
    total = np.sqrt(sum((g.asnumpy() ** 2).sum() for g in grads))
    np.testing.assert_allclose(total, 0.1, rtol=1e-5)
    bad = [tmx.nd.array(np.array([np.nan, 1.0], np.float32))]
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        tmx.gluon.clip_global_norm(bad, 1.0)
        tmx.gluon.clip_global_norm(bad, 1.0, check_isfinite=False)
    assert len(caught) == 1


def test_sha1_download_and_shape_helpers(tmp_path):
    payload = b"mxnet" * 100
    path = tmp_path / "weights.bin"
    path.write_bytes(payload)
    digest = hashlib.sha1(payload).hexdigest()
    utils = tmx.gluon.utils
    assert utils.check_sha1(str(path), digest)
    assert not utils.check_sha1(str(path), "0" * 40)
    url = "https://example.invalid/models/weights.bin"
    assert utils.download(url, path=str(tmp_path)) == str(path)
    assert utils.download(url, path=str(path), sha1_hash=digest) == \
        str(path)
    for kwargs in (dict(path=str(path), sha1_hash="0" * 40),
                   dict(path=str(path), overwrite=True),
                   dict(path=str(tmp_path / "absent.bin"))):
        with pytest.raises(RuntimeError):
            utils.download(url, **kwargs)
        with pytest.raises(RuntimeError):
            jmx.gluon.utils.download(url, **kwargs)
    for shape in (None, (2, 0), (2, 3), ()):
        assert utils.shape_is_known(shape) == \
            jmx.gluon.utils.shape_is_known(shape)


# ---------------------------------------------------------------------------
# initializers
# ---------------------------------------------------------------------------

INITS = {
    "Orthogonal_uniform": (lambda mx: mx.init.Orthogonal(), "fc_weight",
                           (6, 4)),
    "Orthogonal_normal_wide": (lambda mx: mx.init.Orthogonal(
        scale=0.5, rand_type="normal"), "conv_weight", (3, 2, 2, 2)),
    "MSRAPrelu": (lambda mx: mx.init.MSRAPrelu(), "conv_weight",
                  (8, 3, 3, 3)),
    "MSRAPrelu_in": (lambda mx: mx.init.MSRAPrelu("in", 0.1),
                     "fc_weight", (5, 7)),
    "msra_alias": (lambda mx: mx.init.create("msra"), "fc_weight", (4, 6)),
    "Bilinear": (lambda mx: mx.init.Bilinear(), "up_weight",
                 (2, 3, 4, 4)),
    "Bilinear_odd": (lambda mx: mx.init.Bilinear(), "up_weight",
                     (1, 1, 3, 5)),
    "LSTMBias_bias": (lambda mx: mx.init.LSTMBias(2.0), "lstm_i2h_bias",
                      (16,)),
    "LSTMBias_other": (lambda mx: mx.init.LSTMBias(), "lstm_state", (8,)),
    "Mixed_bias": (lambda mx: mx.init.Mixed(
        [".*bias", ".*"], [mx.init.Zero(), mx.init.Orthogonal()]),
        "fc_bias", (4,)),
    "Mixed_weight": (lambda mx: mx.init.Mixed(
        [".*bias", ".*"], [mx.init.Zero(), mx.init.Orthogonal()]),
        "fc_weight", (4, 5)),
}


@pytest.mark.parametrize("name", sorted(INITS))
def test_initializers_are_identical_under_one_numpy_seed(name):
    make, pname, shape = INITS[name]

    def run(mx):
        np.random.seed(1234)
        arr = mx.nd.zeros(shape)
        make(mx)(mx.init.InitDesc(pname), arr)
        return arr.asnumpy()
    want = run(jmx)
    got = run(tmx)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_mixed_without_a_match_raises_and_initializers_build_layers():
    mixed = tmx.init.Mixed([".*bias"], [tmx.init.Zero()])
    with pytest.raises(ValueError):
        mixed("fc_weight", tmx.nd.zeros((2, 2)))
    with pytest.raises(ValueError):
        tmx.init.Mixed([".*"], [])
    np.random.seed(5)
    net = tmx.gluon.nn.Dense(4, in_units=4)
    net.initialize(tmx.init.Orthogonal(scale=1.0))
    w = net.weight.data().asnumpy()
    np.testing.assert_allclose(w @ w.T, np.eye(4), atol=1e-5)
    up = tmx.gluon.nn.Conv2DTranspose(2, 4, 2, 1, in_channels=2,
                                      weight_initializer=tmx.init.Bilinear())
    up.initialize()
    # f = 2, c = 0.75: rows and columns weigh 0.25, 0.75, 0.75, 0.25
    np.testing.assert_allclose(up.weight.data().asnumpy()[0, 0, 1],
                               0.75 * np.array([0.25, 0.75, 0.75, 0.25]))
