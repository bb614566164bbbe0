"""Port parity: the framework core of mxnet_tpu_torch (NDArray, the op
registry and ops, autograd, initializers, Gluon blocks, losses, the
optimizers and Trainer) against the JAX package, on the CPU.

The same numpy inputs and weights go through both packages; weights
cross by structural name with ``gluon.convert.params_from_numpy``.
Tolerances: fp32 ops and single forward/backward passes at rtol=1e-5,
atol=1e-6 (same formula, other summation order); the tiny LM's losses
and parameters after three Trainer steps at rtol = atol = 1e-5 (ROADMAP
rule 5, logits). The port runs on the CPU here by
``MXNET_DEFAULT_CONTEXT=cpu``; its default is the CUDA device.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch.gluon.convert import params_from_numpy

TOL = dict(rtol=1e-5, atol=1e-6)
STEP_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _port_on_cpu(monkeypatch):
    monkeypatch.setenv("MXNET_DEFAULT_CONTEXT", "cpu")


@pytest.fixture(autouse=True)
def _fresh_names():
    """Blocks built here take their names from fresh counters, so the
    process-wide ones, which tests in other files may read (block
    names such as ``meshmultiheadattention0_``), do not move."""
    from mxnet_tpu.name import NameManager as JaxNames
    from mxnet_tpu_torch.name import NameManager as PortNames
    with JaxNames(), PortNames():
        yield


def _rand(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _both(fn):
    """fn(mx) on both packages, results as numpy."""
    return [np.asarray(fn(mx).asnumpy()) for mx in (jmx, tmx)]


# ---------------------------------------------------------------------------
# NDArray
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("src", [
    [[1, 2], [3, 4]],
    np.arange(6, dtype=np.float64).reshape(2, 3),
    np.arange(6, dtype=np.int64),
    np.ones((2, 2), np.float32),
], ids=["list", "float64", "int64", "float32"])
def test_array_dtype_rules_match(src):
    j, t = jmx.nd.array(src), tmx.nd.array(src)
    assert t.dtype == j.dtype
    assert t.shape == j.shape
    np.testing.assert_array_equal(t.asnumpy(), j.asnumpy())


def test_creation_and_conversion_match():
    j = jmx.nd.zeros((2, 3)) + jmx.nd.ones((2, 3)) * 2
    t = tmx.nd.zeros((2, 3)) + tmx.nd.ones((2, 3)) * 2
    np.testing.assert_array_equal(t.asnumpy(), j.asnumpy())
    assert t.astype("int32").dtype == j.astype("int32").dtype
    assert t.context == tmx.cpu() and t.as_in_context(tmx.cpu()) is t
    c = t.copy()
    c[:] = 0
    assert float(t.sum().asscalar()) == 12.0     # a copy, not an alias
    assert t.reshape((3, 2)).shape == (3, 2) and len(t) == 2


@pytest.mark.parametrize("op", [
    lambda a, b: a + b, lambda a, b: a - b, lambda a, b: a * b,
    lambda a, b: a / (b * b + 1), lambda a, b: a ** 2 + 0.5 * b,
    lambda a, b: 3.0 - a, lambda a, b: 2.0 / (a * a + 1),
    lambda a, b: -a, lambda a, b: a > b, lambda a, b: a <= 0.1,
    lambda a, b: a == a, lambda a, b: a != b,
], ids=["add", "sub", "mul", "div", "pow", "rsub", "rdiv", "neg", "gt",
        "le_scalar", "eq", "ne"])
def test_operators_match(op):
    a, b = _rand(1, 3, 4), _rand(2, 4)           # b broadcasts over rows
    got, want = _both(lambda mx: op(mx.nd.array(a), mx.nd.array(b)))
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("kw", [
    dict(), dict(axis=1), dict(axis=(0, 2), keepdims=True),
    dict(axis=0, exclude=True), dict(axis=(0, 1, 2), exclude=True),
], ids=["all", "axis1", "axes_keep", "exclude", "exclude_all"])
@pytest.mark.parametrize("name", ["sum", "mean"])
def test_reductions_match(name, kw):
    x = _rand(3, 2, 3, 4)
    got, want = _both(lambda mx: getattr(mx.nd, name)(mx.nd.array(x), **kw))
    np.testing.assert_allclose(got, want, **TOL)


# ---------------------------------------------------------------------------
# registered ops through nd.<OpName>
# ---------------------------------------------------------------------------

OPS = {
    "fc_flatten": lambda mx, x, w, b: mx.nd.FullyConnected(
        x, w, b, num_hidden=5),
    "fc_noflatten": lambda mx, x, w, b: mx.nd.FullyConnected(
        x.reshape((2, 3, 4)), w[:, :4], None, num_hidden=5, no_bias=True,
        flatten=False),
    "relu": lambda mx, x, w, b: mx.nd.Activation(x, act_type="relu"),
    "sigmoid": lambda mx, x, w, b: mx.nd.Activation(x, act_type="sigmoid"),
    "tanh": lambda mx, x, w, b: mx.nd.Activation(x, act_type="tanh"),
    "softrelu": lambda mx, x, w, b: mx.nd.Activation(x,
                                                      act_type="softrelu"),
    "layernorm_last": lambda mx, x, w, b: mx.nd.LayerNorm(
        x, w[0, :12], b[:12] if b.shape[0] >= 12 else w[1, :12], eps=1e-5),
    "layernorm_axis1": lambda mx, x, w, b: mx.nd.LayerNorm(
        x.reshape((2, 3, 4)), w[0, :3], w[1, :3], axis=1),
    "softmax": lambda mx, x, w, b: mx.nd.softmax(x, axis=-1),
    "log_softmax": lambda mx, x, w, b: mx.nd.log_softmax(x, axis=0),
    "reshape_codes": lambda mx, x, w, b: mx.nd.reshape(
        x.reshape((2, 3, 4)), shape=(-3, -2)),
    "reshape_split": lambda mx, x, w, b: mx.nd.reshape(
        x, shape=(0, -4, 3, -1)),
    "reshape_reverse": lambda mx, x, w, b: mx.nd.reshape(
        x.reshape((2, 3, 4)), shape=(-1, 0), reverse=True),
}


@pytest.mark.parametrize("name", sorted(OPS))
def test_ops_match(name):
    x, w, b = _rand(4, 2, 12), _rand(5, 5, 12), _rand(6, 5)
    got, want = _both(lambda mx: OPS[name](mx, mx.nd.array(x),
                                           mx.nd.array(w), mx.nd.array(b)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)


# ---------------------------------------------------------------------------
# mixed bfloat16/float32 operands: JAX's promotion rules
# ---------------------------------------------------------------------------

# a result computed through bfloat16 intermediates, held across the
# packages: the port rounds each op's bfloat16 result as the JAX program
# is written, while XLA keeps float32 between ops whose result is
# converted to float32 next (its excess-precision simplification), so
# the two part by at most one bfloat16 step (2^-7 relative at most);
# measured on the CPU: 5.2e-3 (LayerNorm with float32 affine terms),
# 3.3e-3 (FullyConnected in bfloat16 with a float32 bias), 0 for the
# ops whose output stays bfloat16 (BatchNorm, softmax, SoftmaxOutput)
BF16_TOL = dict(rtol=8e-3, atol=1e-5)


def _dt(mx, a, dtype):
    return mx.nd.array(a).astype(dtype)


def _both_dtype(fn):
    """fn(mx) on both packages: [(dtype name, float32 numpy)] each."""
    out = []
    for mx in (jmx, tmx):
        r = fn(mx)
        out.append((str(r.dtype), r.astype("float32").asnumpy()))
    return out


MIXED = {
    # name: (fn(mx, x, w, b), tolerance)
    "fc_f32_data_bf16_weight": (lambda mx, x, w, b: mx.nd.FullyConnected(
        _dt(mx, x, "float32"), _dt(mx, w, "bfloat16"),
        _dt(mx, b, "bfloat16"), num_hidden=5), TOL),
    "fc_bf16_data_f32_bias": (lambda mx, x, w, b: mx.nd.FullyConnected(
        _dt(mx, x, "bfloat16"), _dt(mx, w, "bfloat16"),
        _dt(mx, b, "float32"), num_hidden=5), BF16_TOL),
    "layernorm_bf16_data_f32_affine": (lambda mx, x, w, b: mx.nd.LayerNorm(
        _dt(mx, x, "bfloat16"), _dt(mx, w[0], "float32"),
        _dt(mx, w[1], "float32"), eps=1e-5), BF16_TOL),
    "batchnorm_bf16_data_f32_terms": (lambda mx, x, w, b: mx.nd.BatchNorm(
        _dt(mx, x.reshape(2, 3, 4), "bfloat16"), _dt(mx, b[:3], "float32"),
        _dt(mx, b[2:], "float32"), _dt(mx, w[0, :3] * 0.1, "float32"),
        _dt(mx, np.abs(w[1, :3]) + 0.5, "float32"), fix_gamma=False),
        TOL),
    "embedding_bf16_weight": (lambda mx, x, w, b: mx.nd.Embedding(
        mx.nd.array(np.array([[0, 4], [2, 1]], np.float32)),
        _dt(mx, w, "bfloat16"), input_dim=5, output_dim=12), TOL),
    "softmax_bf16": (lambda mx, x, w, b: mx.nd.softmax(
        _dt(mx, x, "bfloat16"), axis=-1), TOL),
    "softmax_output_bf16": (lambda mx, x, w, b: mx.nd.SoftmaxOutput(
        _dt(mx, x, "bfloat16"), mx.nd.array(np.array([1, 3], np.float32))),
        TOL),
}


@pytest.mark.parametrize("name", sorted(MIXED))
def test_mixed_dtype_ops_promote_like_jax(name):
    """Each product and normalization op on mixed bfloat16/float32
    operands returns JAX's dtype and JAX's values (a float32 operand
    promotes the product, as ``jnp.dot`` does; LayerNorm's float32
    affine terms promote its output)."""
    fn, tol = MIXED[name]
    x, w, b = _rand(4, 2, 12), _rand(5, 5, 12), _rand(6, 5)
    (jd, jv), (td, tv) = _both_dtype(lambda mx: fn(mx, x, w, b))
    assert td == jd
    np.testing.assert_allclose(tv, jv, **tol)


@pytest.mark.parametrize("op", ["Convolution", "Deconvolution"])
def test_mixed_dtype_convolution_raises_like_jax(op):
    """``lax.conv_general_dilated`` takes one dtype: mixed data and
    weight raise in both packages."""
    x = _rand(1, 1, 2, 6, 6)
    w = _rand(2, 2, 3, 3, 3) if op == "Convolution" else _rand(2, 2, 3, 3,
                                                                3)
    for mx in (jmx, tmx):
        with pytest.raises(Exception):
            getattr(mx.nd, op)(_dt(mx, x, "float32"), _dt(mx, w, "bfloat16"),
                               kernel=(3, 3), num_filter=3, no_bias=True)\
                .asnumpy()


def test_layernorm_dense_under_bf16_policy_returns_float32():
    """``LayerNorm -> Dense`` under ``DtypePolicy("bfloat16")`` on a
    bfloat16 input: the policy keeps gamma/beta float32, so LayerNorm
    returns float32 and the Dense product runs in float32 over its
    bfloat16 weight, as in JAX (the port returned bfloat16 before)."""
    x = _rand(9, 4, 8)
    outs = []
    for mx in (jmx, tmx):
        net = mx.gluon.nn.HybridSequential()
        net.add(mx.gluon.nn.LayerNorm(in_channels=8))
        net.add(mx.gluon.nn.Dense(6, in_units=8))
        net.initialize(mx.init.Xavier())
        for i, p in enumerate(net.collect_params().values()):
            p.set_data(mx.nd.array(np.random.RandomState(i).uniform(
                -0.5, 0.5, p.shape).astype(np.float32)))
        mx.amp.DtypePolicy("bfloat16").apply(net)
        out = net(mx.nd.array(x).astype("bfloat16"))
        outs.append((str(out.dtype), out.asnumpy()))
    (jd, jv), (td, tv) = outs
    assert jd == td == "float32"
    np.testing.assert_allclose(tv, jv, **BF16_TOL)


@pytest.mark.parametrize("mode,keepdims", [("clip", False), ("wrap", True)])
def test_embedding_and_pick_match(mode, keepdims):
    w = _rand(7, 10, 4)
    idx = np.array([[0, 9, 3], [11, -1, 5]], np.float32)   # out of range
    got, want = _both(lambda mx: mx.nd.Embedding(
        mx.nd.array(idx), mx.nd.array(w), input_dim=10, output_dim=4))
    np.testing.assert_array_equal(got, want)
    data = _rand(8, 2, 3, 5)
    got, want = _both(lambda mx: mx.nd.pick(
        mx.nd.array(data), mx.nd.array(idx), axis=-1, mode=mode,
        keepdims=keepdims))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("impl,causal,seg", [
    ("auto", True, False), ("dense", False, False), ("flash", True, True),
])
def test_flash_attention_op_matches(impl, causal, seg):
    rs = np.random.RandomState(9)
    q, k, v = (rs.randn(2, 12, 2, 8).astype(np.float32) for _ in range(3))
    ids = np.array([[1] * 5 + [2] * 5 + [0] * 2] * 2, np.int32)

    def run(mx):
        args = [mx.nd.array(x) for x in (q, k, v)]
        if seg:
            args.append(mx.nd.array(ids))
        return mx.nd._contrib_flash_attention(*args, causal=causal,
                                              impl=impl)
    got, want = _both(run)
    live = ids > 0 if seg else np.ones((2, 12), bool)
    np.testing.assert_allclose(got[live], want[live], rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("impl", ["dense", "auto"])
def test_decode_attention_op_matches(impl):
    rs = np.random.RandomState(12)
    B, T, H, D = 3, 40, 2, 8
    q = rs.randn(B, 1, H, D).astype(np.float32)
    k, v = (rs.randn(B, T, H, D).astype(np.float32) for _ in range(2))
    lengths = np.array([1, 17, 40], np.int32)

    def run(mx):
        return mx.nd._contrib_decode_attention(
            mx.nd.array(q), mx.nd.array(k), mx.nd.array(v),
            mx.nd.array(lengths), impl=impl, block_k=64)
    got, want = _both(run)
    assert got.shape == want.shape == (B, 1, H, D)
    np.testing.assert_allclose(got, want, **TOL)
    with pytest.raises(ValueError, match="auto|flash|dense"):
        tmx.nd._contrib_decode_attention(
            tmx.nd.array(q), tmx.nd.array(k), tmx.nd.array(v),
            tmx.nd.array(lengths), impl="ring")


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("impl", ["ring", "ulysses"])
def test_sequence_parallel_impls_raise(impl, causal):
    """``impl='ring'|'ulysses'`` without an ``sp`` mesh (none, or a
    world of one rank) runs local attention, as the JAX op does; only a
    segment plane with them raises."""
    rs = np.random.RandomState(4)
    q, k, v = (rs.randn(2, 12, 4, 8).astype(np.float32) for _ in range(3))

    def run(mx):
        return mx.nd._contrib_flash_attention(
            *[mx.nd.array(a) for a in (q, k, v)], impl=impl, causal=causal)
    got, want = _both(run)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    from mxnet_tpu_torch import parallel as tpar
    with tpar.use_mesh(tpar.create_mesh({"sp": 1})):
        np.testing.assert_allclose(run(tmx).asnumpy(), want, rtol=2e-5,
                                   atol=2e-5)
    x = tmx.nd.ones((1, 4, 2, 8))
    with pytest.raises(ValueError, match="segment_ids"):
        tmx.nd._contrib_flash_attention(x, x, x, tmx.nd.ones((1, 4)),
                                        impl=impl)


def test_op_attribute_checks_match_jax_registry():
    from mxnet_tpu.ops import registry as jreg
    from mxnet_tpu_torch.ops import registry as treg
    # every attribute of these ops is declared alike; the attention op's
    # TPU tile sizes are accepted and unused (the CUDA kernels pick their
    # own)
    unported = {}
    for name in ("FullyConnected", "LayerNorm", "Embedding", "pick",
                 "Reshape", "_contrib_flash_attention",
                 "_contrib_decode_attention", "softmax", "mean"):
        jdef = jreg.get_op(name).defaults
        skip = unported.get(name, set())
        assert skip <= set(jdef)
        assert treg.get_op(name).defaults == {
            k: v for k, v in jdef.items() if k not in skip}
        assert treg.get_op(name).arg_names == jreg.get_op(name).arg_names
    with pytest.raises(MXNetError, match="outside valid range"):
        tmx.nd.Embedding(tmx.nd.ones((2,)), tmx.nd.ones((3, 2)),
                         input_dim=-1, output_dim=2)
    with pytest.raises(MXNetError, match="not registered"):
        treg.get_op("NoSuchOp")
    op = treg.get_op("FullyConnected")
    assert op.resolve_arg_names({"no_bias": "True"}) == ["data", "weight"]


# ---------------------------------------------------------------------------
# autograd
# ---------------------------------------------------------------------------

def _grad_run(mx, req, head_grad):
    x = mx.nd.array(_rand(10, 3, 4))
    w = mx.nd.array(_rand(11, 4))
    x.attach_grad(grad_req=req)
    w.attach_grad()
    for _ in range(2):                          # 'add' accumulates
        with mx.autograd.record():
            y = mx.nd.log_softmax(x * w + x * x, axis=1)
        if head_grad:
            y.backward(mx.nd.array(_rand(12, 3, 4)))
        else:
            y.backward()                        # non-scalar: ones
    return x.grad.asnumpy(), w.grad.asnumpy()


@pytest.mark.parametrize("req,head_grad", [("write", False), ("add", True)])
def test_backward_grad_req_matches(req, head_grad):
    (jx, jw), (tx, tw) = (_grad_run(mx, req, head_grad)
                          for mx in (jmx, tmx))
    np.testing.assert_allclose(tx, jx, **TOL)
    np.testing.assert_allclose(tw, jw, **TOL)


def test_autograd_grad_and_scopes_match():
    def run(mx):
        x = mx.nd.array(_rand(13, 5))
        x.attach_grad()
        with mx.autograd.record():
            assert mx.autograd.is_recording() and mx.autograd.is_training()
            y = (x * x * x).sum()
            with mx.autograd.pause():
                assert not mx.autograd.is_recording()
        with mx.autograd.predict_mode():
            assert not mx.autograd.is_training()
        return mx.autograd.grad(y, [x])[0]
    got, want = _both(run)
    np.testing.assert_allclose(got, want, **TOL)


def test_no_graph_outside_record():
    w = tmx.nd.ones((3, 3))
    w.attach_grad()
    y = w * 2 + 1
    assert not y._data.requires_grad            # nothing recorded
    with pytest.raises(MXNetError, match="no ops were recorded"):
        y.backward()
    with tmx.autograd.record():
        z = (w * 2).sum()
    assert z._data.requires_grad
    z.backward()
    np.testing.assert_array_equal(w.grad.asnumpy(), np.full((3, 3), 2.0))


# ---------------------------------------------------------------------------
# Gluon: MeshMultiHeadAttention (mirrors tests/test_attention_surface.py)
# ---------------------------------------------------------------------------

def _weights(block):
    return {k: p.data().asnumpy()
            for k, p in block._collect_params_with_prefix().items()}


@pytest.mark.parametrize("causal,use_bias", [(True, True), (False, False)])
def test_mesh_attention_block_forward_and_grads_match(causal, use_bias):
    x = _rand(14, 2, 10, 16)
    jnet = jmx.gluon.contrib.nn.MeshMultiHeadAttention(
        16, 4, causal=causal, use_bias=use_bias)
    jnet.initialize(jmx.init.Xavier())
    jnet(jmx.nd.array(x))                       # deferred init
    tnet = tmx.gluon.contrib.nn.MeshMultiHeadAttention(
        16, 4, causal=causal, use_bias=use_bias)
    tnet.initialize(tmx.init.Xavier())
    params_from_numpy(tnet, _weights(jnet))
    # the JAX block's parameter names, name for name
    strip = lambda n: n.split("_", 1)[1]        # noqa: E731
    assert sorted(map(strip, tnet.collect_params().keys())) == \
        sorted(map(strip, jnet.collect_params().keys()))
    grads = []
    for mx, net in ((jmx, jnet), (tmx, tnet)):
        with mx.autograd.record():
            y = net(mx.nd.array(x))
            loss = (y ** 2).sum()
        loss.backward()
        grads.append({k: p.grad().asnumpy() for k, p in
                      net._collect_params_with_prefix().items()})
        grads[-1]["out"] = y.asnumpy()
    for key in grads[0]:
        np.testing.assert_allclose(grads[1][key], grads[0][key], rtol=1e-5,
                                   atol=1e-5, err_msg=key)
    g = tnet.collect_params()[tnet.prefix + "query_weight"].grad()
    assert float(np.abs(g.asnumpy()).sum()) > 0


# ---------------------------------------------------------------------------
# the tiny decoder LM: the user script, written once against a package
# ---------------------------------------------------------------------------

def lm_classes(mx):
    """The pre-LN decoder LM of serving.ToyDecoderLM, composed from the
    package's own Gluon blocks."""
    nn = mx.gluon.nn

    class DecoderLayer(mx.gluon.HybridBlock):
        def __init__(self, units, heads, d_ff, impl, **kwargs):
            super().__init__(**kwargs)
            with self.name_scope():
                self.ln1 = nn.LayerNorm()
                self.attn = mx.gluon.contrib.nn.MeshMultiHeadAttention(
                    units, heads, causal=True, use_bias=False, impl=impl)
                self.ln2 = nn.LayerNorm()
                self.ffn1 = nn.Dense(d_ff, activation="relu", use_bias=False,
                                     flatten=False)
                self.ffn2 = nn.Dense(units, use_bias=False, flatten=False)

        def hybrid_forward(self, F, x):
            h = x + self.attn(self.ln1(x))
            return h + self.ffn2(self.ffn1(self.ln2(h)))

    class DecoderLM(mx.gluon.HybridBlock):
        def __init__(self, vocab, units, heads, layers, d_ff, max_len,
                     impl="auto", **kwargs):
            super().__init__(**kwargs)
            with self.name_scope():
                self.embed = nn.Embedding(vocab, units)
                self.pos = nn.Embedding(max_len, units)
                self.layers = nn.HybridSequential()
                with self.layers.name_scope():
                    for _ in range(layers):
                        self.layers.add(DecoderLayer(units, heads, d_ff,
                                                     impl))
                self.ln_f = nn.LayerNorm()
                self.head = nn.Dense(vocab, use_bias=False, flatten=False)

        def hybrid_forward(self, F, tokens, positions):
            h = self.embed(tokens) + self.pos(positions)
            return self.head(self.ln_f(self.layers(h)))

    return DecoderLM


TINY = dict(vocab=64, units=32, heads=2, layers=2, d_ff=64, max_len=48)


def _batch(seed, B=3, T=40):
    seq = np.random.RandomState(seed).randint(0, TINY["vocab"],
                                              size=(B, T + 1))
    return (seq[:, :T].astype(np.float32), seq[:, 1:].astype(np.float32),
            np.arange(T, dtype=np.float32))


def _jax_lm():
    # fixed weights: Adam divides by sqrt(v) + eps, so where a gradient is
    # near eps one ulp between the packages moves an update by up to the
    # learning rate; over fresh random weights each run, that put one
    # element past the tolerance now and then (MXNET_TEST_SEED=1164404816).
    # The JAX package's initializers draw from numpy's global generator.
    np.random.seed(0)
    net = lm_classes(jmx)(**TINY)
    net.initialize(jmx.init.Xavier())
    tokens, _, positions = _batch(0)
    net(jmx.nd.array(tokens), jmx.nd.array(positions))   # deferred init
    return net


def _train(mx, net, optimizer, opts, steps=3):
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    trainer = mx.gluon.Trainer(net.collect_params(), optimizer, opts)
    tokens, labels, positions = _batch(1)
    losses = []
    for _ in range(steps):
        with mx.autograd.record():
            logits = net(mx.nd.array(tokens), mx.nd.array(positions))
            loss = loss_fn(logits, mx.nd.array(labels))
        loss.backward()
        trainer.step(tokens.shape[0])
        losses.append(loss.asnumpy())
    return np.stack(losses), _weights(net)


@pytest.mark.parametrize("optimizer,opts", [
    ("adam", {"learning_rate": 1e-3}),
    ("sgd", {"learning_rate": 0.5, "momentum": 0.9}),
], ids=["adam", "sgd_momentum"])
def test_tiny_lm_trainer_steps_match_jax(optimizer, opts):
    jnet = _jax_lm()
    start = _weights(jnet)
    tnet = lm_classes(tmx)(**TINY)
    tnet.initialize(tmx.init.Xavier())
    params_from_numpy(tnet, start)
    jl, jw = _train(jmx, jnet, optimizer, opts)
    tl, tw = _train(tmx, tnet, optimizer, opts)
    assert jl.shape == (3, 3)
    np.testing.assert_allclose(tl, jl, **STEP_TOL)
    assert sorted(tw) == sorted(jw)
    for key in jw:
        np.testing.assert_allclose(tw[key], jw[key], err_msg=key,
                                   **STEP_TOL)
    assert np.abs(tw["head.weight"] - start["head.weight"]).max() > 1e-4


def test_tiny_lm_logits_equal_toy_decoder_prefill():
    """The Gluon LM is ToyDecoderLM.prefill's function: under mapped
    weights (Dense weights transposed) their logits agree."""
    from mxnet_tpu_torch.serving import ToyDecoderLM
    jnet = _jax_lm()
    w = _weights(jnet)
    tnet = lm_classes(tmx)(**TINY)
    params_from_numpy(tnet, w)
    model = ToyDecoderLM(vocab=TINY["vocab"], n_layers=TINY["layers"],
                         n_heads=TINY["heads"],
                         head_dim=TINY["units"] // TINY["heads"],
                         d_ff=TINY["d_ff"], max_len=TINY["max_len"])
    flat = {"embed": w["embed.weight"], "pos": w["pos.weight"],
            "out_g": w["ln_f.gamma"], "out_b": w["ln_f.beta"],
            "wout": w["head.weight"].T}
    for i in range(TINY["layers"]):
        p = "layers.%d." % i
        flat.update({
            "l%d.att_g" % i: w[p + "ln1.gamma"],
            "l%d.att_b" % i: w[p + "ln1.beta"],
            "l%d.wq" % i: w[p + "attn.query_proj.weight"].T,
            "l%d.wk" % i: w[p + "attn.key_proj.weight"].T,
            "l%d.wv" % i: w[p + "attn.value_proj.weight"].T,
            "l%d.wo" % i: w[p + "attn.out_proj.weight"].T,
            "l%d.ffn_g" % i: w[p + "ln2.gamma"],
            "l%d.ffn_b" % i: w[p + "ln2.beta"],
            "l%d.w1" % i: w[p + "ffn1.weight"].T,
            "l%d.w2" % i: w[p + "ffn2.weight"].T,
        })
    params = {k: torch.from_numpy(np.array(v))
              for k, v in flat.items()}
    tokens, _, positions = _batch(2)
    want, _, _ = model.prefill(params, torch.from_numpy(tokens).long())
    got = tnet(tmx.nd.array(tokens), tmx.nd.array(positions)).asnumpy()
    np.testing.assert_allclose(got, want.numpy(), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# deferred init, initializers, Trainer rules, conversion
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("flatten", [True, False])
def test_deferred_shapes_match_jax(flatten):
    x = _rand(15, 2, 3, 5)
    shapes = []
    for mx in (jmx, tmx):
        net = mx.gluon.nn.HybridSequential()
        with net.name_scope():
            net.add(mx.gluon.nn.Dense(8, flatten=flatten),
                    mx.gluon.nn.LayerNorm())
        net.initialize()
        assert net[0].weight.shape == (8, 0)
        net(mx.nd.array(x))
        shapes.append({k: p.shape for k, p in
                       net._collect_params_with_prefix().items()})
    assert shapes[1] == shapes[0]


def test_deferred_parameter_access_raises_before_forward():
    net = tmx.gluon.nn.Dense(4)
    net.initialize()
    with pytest.raises(tmx.gluon.DeferredInitializationError):
        net.weight.data()
    with pytest.raises(RuntimeError, match="not been initialized"):
        tmx.gluon.nn.Dense(4, in_units=3).weight.data()


def test_initializers_use_seeded_generators():
    def draw(seed):
        tmx.random.seed(seed)
        net = tmx.gluon.nn.Dense(64, in_units=32)
        net.initialize(tmx.init.Xavier())
        return net.weight.data().asnumpy(), net.bias.data().asnumpy()
    (w1, b1), (w2, _), (w3, _) = draw(5), draw(5), draw(6)
    np.testing.assert_array_equal(w1, w2)
    assert not np.array_equal(w1, w3)
    bound = np.sqrt(3.0 / ((32 + 64) / 2.0))      # MXNet's Xavier defaults
    assert np.abs(w1).max() <= bound and np.abs(w1).max() > 0.9 * bound
    assert not b1.any()
    arr = tmx.nd.zeros((2, 3))
    for init, want in ((tmx.init.One(), 1.0), (tmx.init.Constant(2.5), 2.5),
                       (tmx.init.Zero(), 0.0)):
        init("x_weight", arr)
        assert (arr.asnumpy() == want).all()
    tmx.init.Normal(0.5)("x_weight", arr)
    tmx.init.Uniform(0.1)("x_weight", arr)
    assert np.abs(arr.asnumpy()).max() <= 0.1


def test_trainer_stale_gradient_and_grad_req_add(monkeypatch):
    net = tmx.gluon.nn.Dense(2, in_units=3)
    net.initialize()
    trainer = tmx.gluon.Trainer(net.collect_params(), "sgd",
                                {"learning_rate": 0.1})
    with pytest.raises(UserWarning, match="has not been updated"):
        trainer.step(1)
    trainer.step(1, ignore_stale_grad=True)     # skips, changes nothing
    x = tmx.nd.ones((1, 3))
    net.weight.grad_req = "add"
    for _ in range(2):
        with tmx.autograd.record():
            y = net(x).sum()
        y.backward()
    np.testing.assert_array_equal(net.weight.grad().asnumpy(),
                                  np.full((2, 3), 2.0))
    w0 = net.weight.data().asnumpy()
    trainer.step(2)
    np.testing.assert_allclose(net.weight.data().asnumpy(),
                               w0 - 0.1 * 2.0 / 2, rtol=1e-6)
    assert trainer.learning_rate == 0.1
    trainer.set_learning_rate(0.2)
    assert trainer.optimizer.lr == 0.2
    # a dist store outside a launched world is one worker: its sum is the
    # identity, and the step equals the store-free one bit for bit
    nets = [tmx.gluon.nn.Dense(2, in_units=3) for _ in range(2)]
    trainers = []
    for net_, kv in zip(nets, ("device", "dist_sync")):
        net_.initialize()
        net_.weight.set_data(tmx.nd.array(np.arange(6.0).reshape(2, 3)))
        trainers.append(tmx.gluon.Trainer(net_.collect_params(), "sgd",
                                          {"learning_rate": 0.1,
                                           "momentum": 0.9}, kvstore=kv))
        for _ in range(2):
            with tmx.autograd.record():
                y = (net_(tmx.nd.array(np.ones((2, 3)) * 0.5)) ** 2).sum()
            y.backward()
            trainers[-1].step(2)
    assert trainers[0]._kvstore is None
    assert trainers[1]._kvstore.type == "dist_sync"
    assert trainers[1]._kvstore.num_workers == 1
    np.testing.assert_array_equal(nets[1].weight.data().asnumpy(),
                                  nets[0].weight.data().asnumpy())
    # contexts on distinct torch devices are the in-process mesh: the
    # parameter is one master, replicated over it
    cpu_device = tmx.Context.torch_device
    monkeypatch.setattr(tmx.Context, "torch_device", lambda self: (
        torch.device("cpu", self.device_id) if self.device_type == "cpu"
        else cpu_device(self)))
    apart = tmx.gluon.nn.Dense(2, in_units=3)
    apart.initialize(ctx=[tmx.cpu(0), tmx.cpu(1)])
    mesh = apart.weight.mesh
    assert mesh is not None and mesh.devices == (torch.device("cpu", 0),
                                                 torch.device("cpu", 1))
    assert len(apart.weight.list_data()) == 1
    assert apart.weight.list_ctx() == [tmx.cpu(0), tmx.cpu(1)]


def test_l2_loss_matches_jax():
    pred, label = _rand(16, 4, 3), _rand(17, 4, 3)
    got, want = _both(lambda mx: mx.gluon.loss.L2Loss()(
        mx.nd.array(pred), mx.nd.array(label)))
    np.testing.assert_allclose(got, want, **TOL)


def test_params_from_numpy_rejects_mismatches():
    net = lm_classes(tmx)(**TINY)
    net.initialize()
    good = _weights(_jax_lm())
    missing = dict(good)
    missing.pop("head.weight")
    with pytest.raises(MXNetError, match="missing"):
        params_from_numpy(net, missing)
    with pytest.raises(MXNetError, match="extra"):
        params_from_numpy(net, dict(good, **{"head.bias": np.zeros(3)}))
    bad = dict(good, **{"embed.weight": np.zeros((3, 3), np.float32)})
    with pytest.raises(MXNetError, match="shape"):
        params_from_numpy(net, bad)


# ---------------------------------------------------------------------------
# hybridize, and the device default
# ---------------------------------------------------------------------------

def test_hybridize_raises_until_symbol_layer_is_ported():
    """The Symbol/cached_op layer is ported, so hybridize() no longer
    raises (the name is this test's first form): the hybridized block
    gives the JAX block's output, through one CachedOp, and
    ``hybridize(active=False)`` goes back to the imperative path."""
    x = _rand(16, 2, 10, 16)
    jnet = jmx.gluon.contrib.nn.MeshMultiHeadAttention(16, 2, causal=True)
    jnet.initialize(jmx.init.Xavier())
    want = jnet(jmx.nd.array(x)).asnumpy()
    tnet = tmx.gluon.contrib.nn.MeshMultiHeadAttention(16, 2, causal=True)
    tnet.initialize()
    params_from_numpy(tnet, _weights(jnet))
    tnet.hybridize()
    got = tnet(tmx.nd.array(x)).asnumpy()
    assert tnet._cached_op is not None
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    tnet.hybridize(active=False)
    assert tnet._cached_op is None
    np.testing.assert_allclose(tnet(tmx.nd.array(x)).asnumpy(), want,
                               rtol=1e-5, atol=1e-5)
    assert tnet._cached_op is None


def test_default_context_raises_without_cuda(monkeypatch):
    monkeypatch.delenv("MXNET_DEFAULT_CONTEXT")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(MXNetError, match="no CUDA device"):
        tmx.current_context()
    with pytest.raises(MXNetError, match="no CUDA device"):
        tmx.nd.zeros((2,))
    with pytest.raises(MXNetError, match="no CUDA device"):
        tmx.gpu(0).torch_device()
    with tmx.cpu():
        assert tmx.nd.zeros((2,)).context == tmx.cpu()
    assert tmx.nd.zeros((2,), ctx=tmx.cpu()).context == tmx.cpu()
    monkeypatch.setenv("MXNET_DEFAULT_CONTEXT", "cpu")
    assert tmx.current_context() == tmx.cpu()
