"""The port's sampling ops and ``mx.nd.random``/``mx.sym.random``,
held to the JAX package by distribution: the sampler tests of
tests/test_random_samplers.py (moments, bounds, rowwise tensor
parameters, shuffle, seed determinism) with its sample size and
tolerances, run on the port on the CPU. torch's generators give other
numbers than ``jax.random``, so nothing is compared element by element;
shapes, dtypes and attribute defaults are compared with the JAX ops'."""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx

N = 40000
RTOL = 0.08

SAMPLERS = ["_random_uniform", "_random_normal", "_random_gamma",
            "_random_exponential", "_random_poisson", "_random_randint",
            "_random_negative_binomial",
            "_random_generalized_negative_binomial", "_sample_uniform",
            "_sample_normal", "_sample_gamma", "_sample_exponential",
            "_sample_poisson", "_sample_negative_binomial",
            "_sample_generalized_negative_binomial", "_sample_multinomial",
            "_shuffle"]


@pytest.fixture(autouse=True)
def _port_on_cpu(monkeypatch):
    monkeypatch.setenv("MXNET_DEFAULT_CONTEXT", "cpu")


def _draw(op, **attrs):
    mx.random.seed(42)
    fn = getattr(mx.nd, op)
    return fn(shape=(N,), **attrs).asnumpy()


def test_the_17_samplers_and_two_aliases_are_registered_like_jax():
    from mxnet_tpu.ops import registry as jreg
    for name in SAMPLERS + ["multinomial", "shuffle"]:
        op = mx.ops.get_op(name)
        jop = jreg.get_op(name)
        assert op.needs_rng and jop.needs_rng
        assert op.arg_names == list(jop.arg_names), name
        assert op.defaults == jop.defaults, name
    assert mx.ops.get_op("multinomial") is mx.ops.get_op(
        "_sample_multinomial")
    assert mx.ops.get_op("shuffle") is mx.ops.get_op("_shuffle")


def test_uniform_moments_and_bounds():
    s = _draw("_random_uniform", low=-2.0, high=3.0)
    assert s.min() >= -2.0 and s.max() < 3.0
    np.testing.assert_allclose(s.mean(), 0.5, atol=0.05)
    np.testing.assert_allclose(s.var(), 25.0 / 12, rtol=RTOL)


def test_normal_moments():
    s = _draw("_random_normal", loc=1.5, scale=2.0)
    np.testing.assert_allclose(s.mean(), 1.5, atol=0.05)
    np.testing.assert_allclose(s.std(), 2.0, rtol=RTOL)


def test_gamma_moments():
    s = _draw("_random_gamma", alpha=3.0, beta=2.0)
    np.testing.assert_allclose(s.mean(), 6.0, rtol=RTOL)      # a*b
    np.testing.assert_allclose(s.var(), 12.0, rtol=2 * RTOL)  # a*b^2
    assert s.min() > 0


def test_exponential_moments():
    s = _draw("_random_exponential", lam=4.0)
    np.testing.assert_allclose(s.mean(), 0.25, rtol=RTOL)
    np.testing.assert_allclose(s.std(), 0.25, rtol=2 * RTOL)


def test_poisson_moments():
    s = _draw("_random_poisson", lam=7.0)
    np.testing.assert_allclose(s.mean(), 7.0, rtol=RTOL)
    np.testing.assert_allclose(s.var(), 7.0, rtol=2 * RTOL)
    assert np.all(s == np.round(s))


def test_randint_bounds_and_uniformity():
    s = _draw("_random_randint", low=3, high=9)
    assert s.min() == 3 and s.max() == 8
    counts = np.bincount(s.astype(int))[3:9]
    np.testing.assert_allclose(counts / N, 1 / 6, atol=0.02)


def test_negative_binomial_moments():
    k, p = 5.0, 0.4
    s = _draw("_random_negative_binomial", k=k, p=p)
    np.testing.assert_allclose(s.mean(), k * (1 - p) / p, rtol=RTOL)
    np.testing.assert_allclose(s.var(), k * (1 - p) / p ** 2,
                               rtol=2 * RTOL)


def test_generalized_negative_binomial_moments():
    mu, alpha = 4.0, 0.25
    s = _draw("_random_generalized_negative_binomial", mu=mu,
              alpha=alpha)
    np.testing.assert_allclose(s.mean(), mu, rtol=RTOL)
    np.testing.assert_allclose(s.var(), mu + alpha * mu ** 2,
                               rtol=2 * RTOL)
    # alpha=0 degenerates to Poisson
    s0 = _draw("_random_generalized_negative_binomial", mu=mu,
               alpha=0.0)
    np.testing.assert_allclose(s0.var(), mu, rtol=2 * RTOL)


def test_tensor_parameter_samplers_rowwise():
    mx.random.seed(0)
    lo = mx.nd.array(np.array([0.0, 5.0], np.float32))
    hi = mx.nd.array(np.array([1.0, 9.0], np.float32))
    s = mx.nd._sample_uniform(lo, hi, shape=(8000,)).asnumpy()
    assert s.shape == (2, 8000)
    np.testing.assert_allclose(s.mean(1), [0.5, 7.0], atol=0.08)
    mu = mx.nd.array(np.array([-3.0, 2.0], np.float32))
    sig = mx.nd.array(np.array([1.0, 0.5], np.float32))
    n = mx.nd._sample_normal(mu, sig, shape=(8000,)).asnumpy()
    np.testing.assert_allclose(n.mean(1), [-3.0, 2.0], atol=0.08)
    np.testing.assert_allclose(n.std(1), [1.0, 0.5], rtol=RTOL)


def test_per_element_samplers_rowwise():
    """The four samplers the JAX package keeps in ops/extra.py: each row
    follows its own parameters."""
    mx.random.seed(5)
    two = lambda a, b: mx.nd.array(np.array([a, b], np.float32))
    g = mx.nd._sample_gamma(two(2.0, 5.0), two(1.0, 0.5),
                            shape=(N,)).asnumpy()
    np.testing.assert_allclose(g.mean(1), [2.0, 2.5], rtol=RTOL)
    e = mx.nd._sample_exponential(two(1.0, 4.0), shape=(N,)).asnumpy()
    np.testing.assert_allclose(e.mean(1), [1.0, 0.25], rtol=RTOL)
    p = mx.nd._sample_poisson(two(2.0, 9.0), shape=(N,)).asnumpy()
    np.testing.assert_allclose(p.mean(1), [2.0, 9.0], rtol=RTOL)
    np.testing.assert_allclose(p.var(1), [2.0, 9.0], rtol=2 * RTOL)
    nb = mx.nd._sample_negative_binomial(two(5.0, 2.0), two(0.4, 0.5),
                                         shape=(N,)).asnumpy()
    np.testing.assert_allclose(nb.mean(1), [7.5, 2.0], rtol=RTOL)
    np.testing.assert_allclose(nb.var(1), [18.75, 4.0], rtol=2 * RTOL)
    gnb = mx.nd._sample_generalized_negative_binomial(
        two(4.0, 2.0), two(0.25, 0.5), shape=(N,)).asnumpy()
    np.testing.assert_allclose(gnb.mean(1), [4.0, 2.0], rtol=RTOL)
    np.testing.assert_allclose(gnb.var(1), [8.0, 4.0], rtol=2 * RTOL)
    for s in (g, e, p, nb, gnb):
        assert s.shape == (2, N) and s.dtype == np.float32
    assert np.all(p == np.round(p)) and np.all(nb == np.round(nb))


def test_shuffle_is_permutation():
    mx.random.seed(3)
    x = mx.nd.array(np.arange(24, dtype=np.float32).reshape(8, 3))
    s = mx.nd._shuffle(x).asnumpy()
    # rows permuted intact along axis 0
    orig = x.asnumpy()
    matched = set()
    for row in s:
        hits = np.where((orig == row).all(axis=1))[0]
        assert hits.size >= 1
        matched.add(int(hits[0]))
    assert matched == set(range(8))
    # 32 draws of an 8-row shuffle: fixed order would be a ~1e-7 fluke
    draws = {tuple(mx.nd._shuffle(x).asnumpy()[:, 0].astype(int))
             for _ in range(32)}
    assert len(draws) > 1


def test_seeding_determinism():
    mx.random.seed(1234)
    a = mx.nd._random_normal(loc=0.0, scale=1.0, shape=(64,)).asnumpy()
    mx.random.seed(1234)
    b = mx.nd._random_normal(loc=0.0, scale=1.0, shape=(64,)).asnumpy()
    np.testing.assert_array_equal(a, b)
    c = mx.nd._random_normal(loc=0.0, scale=1.0, shape=(64,)).asnumpy()
    assert not np.array_equal(b, c)      # stream advances


def test_seed_with_a_context_reseeds_that_device_only():
    mx.random.seed(7)
    a = mx.nd.random.normal(shape=(16,), ctx=mx.cpu()).asnumpy()
    mx.random.seed(7, ctx=mx.cpu())
    b = mx.nd.random.normal(shape=(16,), ctx=mx.cpu()).asnumpy()
    np.testing.assert_array_equal(a, b)
    assert mx.random.current_seed() == 7
    gen = mx.random.generator("cpu")
    assert mx.nd.random.uniform(shape=(4,)).context == mx.cpu()
    assert gen is mx.random.generator("cpu")


def test_multinomial_follows_the_probabilities_and_get_prob():
    mx.random.seed(11)
    probs = np.array([[0.1, 0.2, 0.7], [0.5, 0.5, 0.0]], np.float32)
    out, lp = mx.nd.random.multinomial(mx.nd.array(probs), shape=(N,),
                                       get_prob=True)
    s = out.asnumpy()
    assert s.shape == (2, N) and s.dtype == np.int32
    for row in range(2):
        freq = np.bincount(s[row], minlength=3) / N
        np.testing.assert_allclose(freq, probs[row], atol=0.02)
    np.testing.assert_allclose(
        lp.asnumpy(), np.log(np.maximum(probs, 1e-20))[
            np.arange(2)[:, None], s], rtol=1e-5, atol=1e-6)
    one = mx.nd.random.multinomial(mx.nd.array(probs[0]))
    assert one.shape == () and 0 <= int(one.asscalar()) < 3


CASES = [
    ("uniform", dict(low=-1.0, high=2.0, shape=(3, 4))),
    ("normal", dict(loc=1.0, scale=3.0, shape=(5,))),
    ("gamma", dict(alpha=2.0, beta=0.5, shape=(2, 2))),
    ("exponential", dict(scale=2.0, shape=(6,))),
    ("poisson", dict(lam=3.0, shape=(2, 3))),
    ("negative_binomial", dict(k=3, p=0.5, shape=(4,))),
    ("generalized_negative_binomial", dict(mu=2.0, alpha=0.5, shape=(4,))),
    ("randint", dict(low=0, high=5, shape=(3,))),
]


@pytest.mark.parametrize("name,kwargs", CASES, ids=[c[0] for c in CASES])
def test_nd_random_scalar_calls_give_jax_shapes_and_dtypes(name, kwargs):
    got = getattr(mx.nd.random, name)(**kwargs)
    want = getattr(jmx.nd.random, name)(**kwargs)
    assert got.shape == want.shape
    assert got.dtype == want.dtype
    assert got.context == mx.cpu()


TENSOR_CASES = [
    ("uniform", lambda nd: (nd.array([0.0, 1.0]), nd.array([1.0, 3.0]))),
    ("normal", lambda nd: (nd.array([0.0, 1.0]), nd.array([1.0, 2.0]))),
    ("gamma", lambda nd: (nd.array([1.0, 2.0]), nd.array([1.0, 2.0]))),
    ("poisson", lambda nd: (nd.array([1.0, 2.0]),)),
    ("negative_binomial", lambda nd: (nd.array([2.0, 3.0]),
                                      nd.array([0.5, 0.4]))),
    ("generalized_negative_binomial",
     lambda nd: (nd.array([2.0, 3.0]), nd.array([0.5, 0.4]))),
]


@pytest.mark.parametrize("name,params", TENSOR_CASES,
                         ids=[c[0] for c in TENSOR_CASES])
def test_nd_random_tensor_calls_give_jax_shapes_and_dtypes(name, params):
    got = getattr(mx.nd.random, name)(*params(mx.nd), shape=(3, 5))
    want = getattr(jmx.nd.random, name)(*params(jmx.nd), shape=(3, 5))
    assert got.shape == want.shape == (2, 3, 5)
    assert got.dtype == want.dtype


def test_randn_shuffle_out_and_dtype():
    x = mx.nd.random.randn(2, 3, loc=1.0)
    assert x.shape == (2, 3)
    out = mx.nd.zeros((4,))
    r = mx.nd.random.uniform(shape=(4,), out=out)
    assert r is out and float(out.asnumpy().min()) >= 0.0
    h = mx.nd.random.normal(shape=(8,), dtype="float64")
    assert h.dtype == np.float64
    data = mx.nd.array(np.arange(10, dtype=np.float32))
    assert sorted(mx.nd.random.shuffle(data).asnumpy().tolist()) == \
        list(range(10))


def test_exponential_with_an_ndarray_scale_draws_at_that_mean():
    """The port hands the op the rate ``1/scale`` for an NDArray scale
    too; the JAX package's wrapper hands the scale over as the rate (a
    mean of 1/scale)."""
    mx.random.seed(2)
    scale = np.array([0.5, 4.0], np.float32)
    s = mx.nd.random.exponential(mx.nd.array(scale), shape=(N,)).asnumpy()
    np.testing.assert_allclose(s.mean(1), scale, rtol=RTOL)
    j = jmx.nd.random.exponential(jmx.nd.array(scale),
                                  shape=(N,)).asnumpy()
    np.testing.assert_allclose(j.mean(1), 1.0 / scale, rtol=RTOL)


def test_sym_random_in_a_graph():
    data = mx.sym.var("data")
    noise = mx.sym.random.normal(0, 1, shape=(2, 3))
    graph = data + noise
    _, out_shapes, _ = graph.infer_shape(data=(2, 3))
    assert out_shapes == [(2, 3)]
    ex = graph.bind(mx.cpu(), {"data": mx.nd.zeros((2, 3))})
    a = ex.forward()[0].asnumpy()
    b = ex.forward()[0].asnumpy()
    assert a.shape == (2, 3) and not np.array_equal(a, b)
    mu = mx.sym.var("mu")
    s = mx.sym.random.uniform(mu, mu + 1, shape=(4,))
    _, out_shapes, _ = s.infer_shape(mu=(3,))
    assert out_shapes == [(3, 4)]
    m = mx.sym.random.multinomial(mu, shape=(5,), get_prob=True)
    assert len(m.list_outputs()) == 2
    for name in ("uniform", "normal", "gamma", "exponential", "poisson",
                 "randint", "multinomial", "shuffle"):
        assert callable(getattr(mx.sym.random, name))
        assert hasattr(jmx.sym.random, name)


def test_a_draw_is_made_on_the_requested_device_from_its_generator():
    """Nothing is drawn from torch's global generator."""
    torch.manual_seed(0)
    before = torch.random.get_rng_state()
    mx.nd.random.normal(shape=(8,))
    mx.nd.random.multinomial(mx.nd.array([0.5, 0.5]), shape=(4,))
    mx.nd.random.shuffle(mx.nd.array(np.arange(4.0)))
    mx.nd._sample_poisson(mx.nd.array([1.0]), shape=(4,))
    assert torch.equal(before, torch.random.get_rng_state())
