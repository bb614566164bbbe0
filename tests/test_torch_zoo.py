"""Port parity: the Gluon vision surface against the JAX package, on the
CPU — the ops ``Concat``, ``Pad``, ``clip``, ``Deconvolution`` and
``Dropout``, the layers over them (``Dropout``, the transposed
convolutions, ``ReflectionPad2D``, contrib ``Concurrent`` /
``HybridConcurrent`` / ``Identity``), and every model-zoo family.

The same numpy inputs and weights go through both packages (weights by
structural name with ``gluon.convert.params_from_numpy``); the port runs
on the CPU by ``MXNET_DEFAULT_CONTEXT=cpu``. Tolerances:

- one op, forward and gradient: rtol = 1e-5, atol = 1e-6 (for
  Deconvolution, whose sums reach magnitude 28, 1e-6 of the largest
  entry);
- a zoo net's hybridized logits: rtol = atol = 1e-5 (ROADMAP rule 5),
  from weights drawn so that every layer's activations stay of order
  one (He-scaled convolutions, BatchNorm statistics near 1).

Train-mode Dropout cannot match JAX's masks (``jax.random`` and
``torch.Generator`` differ). It is held to the formula (the output is
``x * mask / (1 - p)`` for the mask it drew, and JAX's expression on
that mask gives the same array), to the statistics (the kept fraction
within 5 binomial standard deviations, the ``axes`` broadcast shape),
to its gradient (``mask / (1 - p)``) and to its seed (two draws from
one seed are bit-identical). Predict mode is the identity in both.
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.gluon.convert import params_from_numpy

TOL = dict(rtol=1e-5, atol=1e-6)
LOGIT_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _port_on_cpu(monkeypatch):
    monkeypatch.setenv("MXNET_DEFAULT_CONTEXT", "cpu")


@pytest.fixture(autouse=True)
def _reseed():
    """Tests here reseed the port's generators; later ones start from
    the default seed again."""
    yield
    tmx.random.seed(0)


@pytest.fixture(autouse=True)
def _fresh_names():
    """Blocks take their names from fresh counters, so the process-wide
    ones (which tests in other files read) do not move."""
    from mxnet_tpu.name import NameManager as JaxNames
    from mxnet_tpu_torch.name import NameManager as PortNames
    with JaxNames(), PortNames():
        yield


def _rand(seed, *shape, scale=1.0):
    return (scale * np.random.RandomState(seed).randn(*shape)) \
        .astype(np.float32)


# ---------------------------------------------------------------------------
# the registry entries
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["Concat", "Pad", "clip", "Deconvolution",
                                  "Dropout"])
def test_op_registry_entries_match_jax(name):
    from mxnet_tpu.ops import registry as jreg
    from mxnet_tpu_torch.ops import registry as treg
    j, t = jreg.get_op(name), treg.get_op(name)
    assert t.defaults == j.defaults
    assert t.arg_names == j.arg_names
    assert t.needs_rng == j.needs_rng
    assert t.mutable_inputs == j.mutable_inputs
    assert t.key_var_num_args == j.key_var_num_args
    assert t.attr_docs == j.attr_docs
    assert t.attr_ranges == j.attr_ranges
    for attrs in ({}, {"no_bias": False}, {"num_args": 3}):
        assert t.resolve_arg_names(attrs) == j.resolve_arg_names(attrs)
    for alias in {"Concat": ["concat"], "Pad": ["pad"]}.get(name, []):
        assert treg.get_op(alias) is t


# ---------------------------------------------------------------------------
# one op, forward and gradient
# ---------------------------------------------------------------------------

def _op_run(mx, op, arrays, kw, head):
    """The op's output and the gradient of ``sum(out * head)`` with
    respect to each input."""
    nds = [mx.nd.array(a) for a in arrays]
    for a in nds:
        a.attach_grad()
    with mx.autograd.record():
        out = getattr(mx.nd, op)(*nds, **kw)
        loss = (out * mx.nd.array(head)).sum()
    loss.backward()
    return [out.asnumpy()] + [a.grad.asnumpy() for a in nds]


OPS = {
    "concat_dim1": ("Concat", [(2, 3, 4), (2, 1, 4), (2, 5, 4)],
                    dict(dim=1)),
    "concat_last": ("concat", [(3, 2), (3, 4)], dict(dim=-1)),
    "pad_constant": ("Pad", [(2, 3, 5, 6)],
                     dict(mode="constant", constant_value=1.5,
                          pad_width=(0, 0, 0, 0, 1, 2, 3, 0))),
    "pad_edge": ("Pad", [(2, 3, 5, 6)],
                 dict(mode="edge", pad_width=(0, 0, 1, 0, 2, 3, 1, 1))),
    "pad_reflect": ("Pad", [(2, 3, 5, 6)],
                    dict(mode="reflect", pad_width=(0, 0, 0, 0, 2, 4, 3, 1))),
    "pad_reflect_5d": ("Pad", [(1, 2, 3, 4, 5)],
                       dict(mode="reflect",
                            pad_width=(0, 0, 0, 0, 1, 1, 2, 0, 0, 3))),
    "clip": ("clip", [(4, 7)], dict(a_min=-0.5, a_max=0.8)),
}


@pytest.mark.parametrize("case", sorted(OPS))
def test_shape_ops_match_jax(case):
    op, shapes, kw = OPS[case]
    arrays = [_rand(10 + i, *s) for i, s in enumerate(shapes)]
    want_out = getattr(jmx.nd, op)(*[jmx.nd.array(a) for a in arrays],
                                   **kw).asnumpy()
    head = _rand(20, *want_out.shape)
    want = _op_run(jmx, op, arrays, kw, head)
    got = _op_run(tmx, op, arrays, kw, head)
    assert got[0].shape == want[0].shape
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **TOL)


DECONV = {
    "1d": ((2, 4, 7), (4, 3, 3), dict(kernel=(3,), num_filter=3,
                                      stride=(2,), pad=(1,), adj=(1,))),
    "2d": ((2, 3, 5, 6), (3, 4, 3, 3), dict(kernel=(3, 3), num_filter=4)),
    "2d_stride_pad_adj_bias": ((2, 3, 5, 4), (3, 2, 4, 3),
                               dict(kernel=(4, 3), num_filter=2,
                                    stride=(2, 3), pad=(1, 1), adj=(1, 2),
                                    no_bias=False)),
    "2d_dilate_groups": ((1, 4, 6, 5), (4, 3, 3, 3),
                         dict(kernel=(3, 3), num_filter=6, num_group=2,
                              dilate=(2, 1), pad=(2, 1), no_bias=False)),
    "3d": ((1, 2, 3, 4, 5), (2, 3, 2, 3, 2),
           dict(kernel=(2, 3, 2), num_filter=3, stride=(2, 1, 2),
                adj=(1, 0, 0))),
}


@pytest.mark.parametrize("case", sorted(DECONV))
def test_deconvolution_matches_jax(case):
    """Forward and gradients; the output size is JAX's lhs-dilated
    ``(n-1)*stride - 2*pad + dilate*(k-1) + adj + 1``."""
    xs, ws, kw = DECONV[case]
    arrays = [_rand(30, *xs), _rand(31, *ws)]
    if not kw.get("no_bias", True):
        arrays.append(_rand(32, kw["num_filter"]))
    want_out = jmx.nd.Deconvolution(*[jmx.nd.array(a) for a in arrays],
                                    **kw).asnumpy()
    size = tuple((n - 1) * s - 2 * p + d * (k - 1) + a + 1
                 for n, k, s, p, d, a in zip(
                     xs[2:], kw["kernel"],
                     kw.get("stride", (1,) * 3), kw.get("pad", (0,) * 3),
                     kw.get("dilate", (1,) * 3), kw.get("adj", (0,) * 3)))
    assert want_out.shape == (xs[0], kw["num_filter"]) + size
    head = _rand(33, *want_out.shape)
    want = _op_run(jmx, "Deconvolution", arrays, kw, head)
    got = _op_run(tmx, "Deconvolution", arrays, kw, head)
    assert got[0].shape == want[0].shape
    for g, w in zip(got, want):
        # sums of up to 48 products reach magnitude 28 here: the atol
        # scales with the largest entry (an ulp of 28 is 1.9e-6)
        np.testing.assert_allclose(g, w, rtol=TOL["rtol"],
                                   atol=TOL["atol"] * max(
                                       1.0, float(np.abs(w).max())))


@pytest.mark.parametrize("mode", ["training", "always"])
def test_dropout_predict_mode(mode):
    """Outside training, ``mode="training"`` is the identity in both
    packages and draws nothing; ``mode="always"`` draws."""
    x = _rand(40, 6, 50)
    outs = [mx.nd.Dropout(mx.nd.array(x), p=0.4, mode=mode).asnumpy()
            for mx in (jmx, tmx)]
    if mode == "training":
        np.testing.assert_array_equal(outs[1], x)
        np.testing.assert_array_equal(outs[0], x)
    else:
        for out in outs:
            kept = out != 0
            assert 0 < kept.mean() < 1
            np.testing.assert_allclose(out[kept], x[kept] / 0.6, **TOL)


def _port_dropout(x, seed, **kw):
    """Train-mode Dropout of ``x`` from ``seed``, and the mask it drew
    (the same draw applied to ones)."""
    tmx.random.seed(seed)
    with tmx.autograd.train_mode():
        y = tmx.nd.Dropout(tmx.nd.array(x), **kw).asnumpy()
    tmx.random.seed(seed)
    with tmx.autograd.train_mode():
        ones = tmx.nd.Dropout(tmx.nd.ones(x.shape), **kw).asnumpy()
    keep = 1.0 - kw.get("p", 0.5)
    return y, (ones * keep != 0).astype(np.float32)


def test_dropout_train_formula_matches_jax_expression():
    import jax.numpy as jnp
    p = 0.3
    x = _rand(41, 8, 64, 32)
    y, mask = _port_dropout(x, 5, p=p)
    keep = 1.0 - p
    np.testing.assert_array_equal(y, x * mask / keep)
    # the JAX package's train-mode body: data * mask / keep
    want = np.asarray(jnp.asarray(x) * jnp.asarray(mask) / keep)
    np.testing.assert_allclose(y, want, **TOL)
    again, _ = _port_dropout(x, 5, p=p)
    np.testing.assert_array_equal(again, y)            # one seed, one draw
    other, _ = _port_dropout(x, 6, p=p)
    assert not np.array_equal(other, y)


@pytest.mark.parametrize("p", [0.1, 0.5, 0.8])
def test_dropout_keep_fraction_within_binomial_bound(p):
    n = 200000
    _, mask = _port_dropout(np.ones((n,), np.float32), 7, p=p)
    keep = 1.0 - p
    sigma = np.sqrt(n * keep * (1 - keep))
    assert abs(mask.sum() - n * keep) <= 5 * sigma


def test_dropout_axes_broadcast_one_mask():
    x = _rand(42, 4, 6, 9, 10)
    y, mask = _port_dropout(x, 8, p=0.5, axes=(2, 3))
    per_map = mask.reshape(4, 6, -1)
    assert np.all(per_map == per_map[:, :, :1])      # one value per map
    assert 0 < per_map[:, :, 0].mean() < 1
    np.testing.assert_array_equal(y, x * mask / 0.5)
    # the JAX package draws a mask of the same broadcast shape
    with jmx.autograd.train_mode():
        jy = jmx.nd.Dropout(jmx.nd.array(x), p=0.5, axes=(2, 3)).asnumpy()
    jmap = (jy != 0).reshape(4, 6, -1)
    assert np.all(jmap == jmap[:, :, :1])


def test_dropout_gradient_is_mask_over_keep():
    p = 0.25
    x = _rand(43, 16, 40)
    _, mask = _port_dropout(x, 9, p=p)
    tmx.random.seed(9)
    xt = tmx.nd.array(x)
    xt.attach_grad()
    with tmx.autograd.record():
        y = tmx.nd.Dropout(xt, p=p)
    y.backward()
    np.testing.assert_allclose(xt.grad.asnumpy(), mask / (1 - p), **TOL)


# ---------------------------------------------------------------------------
# the layers
# ---------------------------------------------------------------------------

def _concurrent(mx, hybrid):
    nn, cnn = mx.gluon.nn, mx.gluon.contrib.nn
    block = (cnn.HybridConcurrent if hybrid else cnn.Concurrent)(axis=1)
    with block.name_scope():
        block.add(nn.Conv2D(3, 1), cnn.Identity(),
                  nn.Conv2D(2, 3, padding=1))
    return block


@pytest.mark.parametrize("hybrid", [False, True])
def test_concurrent_blocks_match_jax(hybrid):
    x = _rand(50, 2, 4, 6, 6)
    nets = [_concurrent(mx, hybrid) for mx in (jmx, tmx)]
    nets[0].initialize(jmx.init.Xavier())
    want = nets[0](jmx.nd.array(x)).asnumpy()
    nets[1].initialize()
    params_from_numpy(nets[1], {
        k: p.data().asnumpy()
        for k, p in nets[0]._collect_params_with_prefix().items()})
    if hybrid:
        nets[1].hybridize()
    got = nets[1](tmx.nd.array(x)).asnumpy()
    assert got.shape == (2, 3 + 4 + 2, 6, 6)
    np.testing.assert_allclose(got, want, **TOL)


TRANSPOSE = {
    "1d": ("Conv1DTranspose", (2, 3, 7),
           dict(channels=4, kernel_size=3, strides=2, padding=1,
                output_padding=1)),
    "2d": ("Conv2DTranspose", (2, 3, 5, 6),
           dict(channels=4, kernel_size=(4, 3), strides=(2, 1),
                padding=(1, 0), groups=1, activation="relu")),
    "2d_groups_nobias": ("Conv2DTranspose", (1, 4, 5, 5),
                         dict(channels=6, kernel_size=3, strides=2,
                              groups=2, use_bias=False, dilation=2)),
    "3d": ("Conv3DTranspose", (1, 2, 3, 4, 4),
           dict(channels=3, kernel_size=2, strides=2)),
}


@pytest.mark.parametrize("case", sorted(TRANSPOSE))
def test_conv_transpose_layers_match_jax(case):
    """The deferred weight ``(in_channels, channels / groups, *k)``
    resolves from the input, as in JAX; then the outputs agree."""
    cls, xs, kw = TRANSPOSE[case]
    x = _rand(51, *xs)
    layers = [getattr(mx.gluon.nn, cls)(**kw) for mx in (jmx, tmx)]
    layers[0].initialize(jmx.init.Xavier())
    want = layers[0](jmx.nd.array(x)).asnumpy()
    layers[1].initialize()
    layers[1].hybridize()
    layers[1](tmx.nd.array(x))
    assert layers[1].weight.shape == layers[0].weight.shape
    assert layers[1].weight.shape[:2] == (xs[1], kw["channels"]
                                          // kw.get("groups", 1))
    params_from_numpy(layers[1], {
        k: p.data().asnumpy()
        for k, p in layers[0]._collect_params_with_prefix().items()})
    np.testing.assert_allclose(layers[1](tmx.nd.array(x)).asnumpy(), want,
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("padding", [2, (0, 0, 0, 0, 1, 3, 2, 0)])
def test_reflection_pad_and_dropout_layers_match_jax(padding):
    x = _rand(52, 2, 3, 5, 6)
    outs = []
    for mx in (jmx, tmx):
        net = mx.gluon.nn.HybridSequential()
        with net.name_scope():
            net.add(mx.gluon.nn.ReflectionPad2D(padding),
                    mx.gluon.nn.Dropout(0.5), mx.gluon.nn.Dropout(0.0))
        net.initialize()
        net.hybridize()
        outs.append(net(mx.nd.array(x)).asnumpy())
    np.testing.assert_array_equal(outs[1], outs[0])


def test_dropout_layer_repr_and_rate_zero_copy():
    layers = [mx.gluon.nn.Dropout(0.3, axes=(1,)) for mx in (jmx, tmx)]
    assert repr(layers[1]) == repr(layers[0])
    zero = tmx.gluon.nn.Dropout(0.0)
    x = tmx.nd.array(_rand(53, 3, 4))
    with tmx.autograd.record():
        y = zero(x)
    assert y is not x and np.array_equal(y.asnumpy(), x.asnumpy())


# ---------------------------------------------------------------------------
# the model zoo
# ---------------------------------------------------------------------------

JAX_NAMES = sorted(k for k in [
    "vgg11", "vgg13", "vgg16", "vgg19", "vgg11_bn", "vgg13_bn", "vgg16_bn",
    "vgg19_bn", "alexnet", "densenet121", "densenet161", "densenet169",
    "densenet201", "squeezenet1.0", "squeezenet1.1", "inceptionv3",
    "mobilenet1.0", "mobilenet0.75", "mobilenet0.5", "mobilenet0.25",
    "mobilenetv2_1.0", "mobilenetv2_0.75", "mobilenetv2_0.5",
    "mobilenetv2_0.25"])


def test_get_model_accepts_every_jax_name():
    """The JAX factory's table (read from its error message) and the
    port's are the same names."""
    msgs = []
    for mx in (jmx, tmx):
        with pytest.raises(ValueError) as err:
            mx.gluon.model_zoo.vision.get_model("no_such_net")
        msgs.append(sorted(str(err.value).split("\n\t")[1:]))
    assert msgs[1] == msgs[0]
    assert set(JAX_NAMES) <= set(msgs[1])


@pytest.mark.parametrize("name", JAX_NAMES)
def test_zoo_structure_matches_jax(name):
    """Every family's block tree: JAX's structural parameter names and
    declared shapes (0 where deferred); ``pretrained=True`` without a
    local file raises."""
    nets = [mx.gluon.model_zoo.vision.get_model(name, classes=7)
            for mx in (jmx, tmx)]
    j, t = ({k: p.shape for k, p in n._collect_params_with_prefix().items()}
            for n in nets)
    assert t == j
    assert type(nets[1]).__name__ == type(nets[0]).__name__


def _he_weights(tree, seed):
    """Weights that keep activations of order one through a deep net:
    He-scaled conv / dense weights, small biases, BatchNorm statistics
    and affine terms near (0, 1)."""
    rs = np.random.RandomState(seed)
    out = {}
    for k, v in sorted(tree.items()):
        shape = v.shape
        if k.endswith("weight"):
            fan_in = int(np.prod(shape[1:]))
            w = rs.randn(*shape) * np.sqrt(2.0 / fan_in)
        elif k.endswith(("gamma", "running_var")):
            w = rs.uniform(0.8, 1.2, shape)
        else:                               # bias, beta, running_mean
            w = rs.randn(*shape) * 0.05
        out[k] = w.astype(np.float32)
    return out


ZOO = {
    "alexnet": 64, "vgg11": 32, "vgg11_bn": 32, "squeezenet1.0": 48,
    "squeezenet1.1": 48, "mobilenet0.25": 32, "mobilenetv2_0.25": 32,
    # fixed final pools: AvgPool2D(7) after 224x224, AvgPool2D(8) after
    # 299x299
    "densenet121": 224, "inceptionv3": 299,
}


@pytest.mark.parametrize("name", sorted(ZOO))
def test_zoo_hybridized_logits_match_jax(name):
    """Each family's smallest variant: JAX's weights carried across by
    ``params_from_numpy``; the port's hybridized logits (train-mode
    Dropout layers are the identity in predict mode) equal JAX's."""
    px = ZOO[name]
    x = _rand(60, 1, 3, px, px)
    jnet = jmx.gluon.model_zoo.vision.get_model(name, classes=10)
    jnet.initialize(jmx.init.Xavier())
    jnet.hybridize()
    jnet(jmx.nd.array(x))
    weights = _he_weights({k: p.data().asnumpy() for k, p
                           in jnet._collect_params_with_prefix().items()},
                          seed=61)
    for k, p in jnet._collect_params_with_prefix().items():
        p.set_data(jmx.nd.array(weights[k]))
    want = jnet(jmx.nd.array(x)).asnumpy()
    assert 0.1 < np.abs(want).max() < 1e3
    tnet = tmx.gluon.model_zoo.vision.get_model(name, classes=10)
    tnet.initialize()
    params_from_numpy(tnet, weights)
    tnet.hybridize()
    got = tnet(tmx.nd.array(x)).asnumpy()
    assert got.shape == want.shape == (1, 10)
    np.testing.assert_allclose(got, want, **LOGIT_TOL)


def test_pretrained_reads_a_local_file_only(tmp_path):
    """``pretrained=True`` reads ``<root>/<name>*.params`` (a file the
    JAX package's ``save_parameters`` wrote) and raises without one."""
    with pytest.raises(tmx.MXNetError, match="pretrained"):
        tmx.gluon.model_zoo.vision.get_model("squeezenet1.1",
                                             pretrained=True,
                                             root=str(tmp_path))
    jnet = jmx.gluon.model_zoo.vision.squeezenet1_1(classes=5)
    jnet.initialize(jmx.init.Xavier())
    x = _rand(62, 1, 3, 32, 32)
    want = jnet(jmx.nd.array(x)).asnumpy()
    jnet.save_parameters(str(tmp_path / "squeezenet1.1-0000.params"))
    tnet = tmx.gluon.model_zoo.vision.get_model(
        "squeezenet1.1", pretrained=True, root=str(tmp_path), classes=5)
    np.testing.assert_allclose(tnet(tmx.nd.array(x)).asnumpy(), want,
                               **LOGIT_TOL)
    # No ctx: the weights land on the current context (gpu(0) unless the
    # caller scopes another), not on a fixed cpu(); cpu(1) tells them apart.
    with tmx.Context("cpu", 1):
        scoped = tmx.gluon.model_zoo.vision.get_model(
            "squeezenet1.1", pretrained=True, root=str(tmp_path), classes=5)
        assert tmx.current_context() == tmx.Context("cpu", 1)
        for p in scoped.collect_params().values():
            assert p.list_ctx() == [tmx.current_context()], p.name
    assert tmx.gluon.model_zoo.model_store.get_model_file(
        "squeezenet1.1", root=str(tmp_path)).endswith(".params")
