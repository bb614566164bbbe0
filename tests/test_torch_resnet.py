"""Port parity: the ops, layers and model zoo behind ``entry()`` —
Convolution, BatchNorm, Pooling, the conv/pool/BatchNorm Gluon layers
and the ResNets — against the JAX package, on the CPU.

The same numpy inputs and weights go through both packages (weights by
structural name with ``gluon.convert.params_from_numpy``); the port runs
on the CPU by ``MXNET_DEFAULT_CONTEXT=cpu``. Tolerances:

- one op: rtol = 1e-5, atol = 1e-6 (the same formula in another
  summation order);
- ResNet-50 at ``entry()``'s config (classes 10, batch 2, 32x32, eval):
  the port's logits, hybridized and through ``build_graph_callable``,
  within rtol = atol = 1e-5 of JAX's ``build_graph_callable`` output
  (ROADMAP rule 5, logits), and their error against a float64 run of
  the same net at most twice the JAX package's own;
- one hybridized ResNet-18 training call (batch 2, 64x64): logits and
  moving statistics within rtol = atol = 1e-5, every gradient within
  1e-4 of the largest magnitude of that gradient (CPU convolutions of
  two libraries, 20 BatchNorm backward passes in fp32; 2.8e-5 seen).
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.gluon.convert import params_from_numpy

TOL = dict(rtol=1e-5, atol=1e-6)
LOGIT_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_REL = 1e-4


@pytest.fixture(autouse=True)
def _port_on_cpu(monkeypatch):
    monkeypatch.setenv("MXNET_DEFAULT_CONTEXT", "cpu")


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


def _weights(block):
    return {k: p.data().asnumpy()
            for k, p in block._collect_params_with_prefix().items()}


# ---------------------------------------------------------------------------
# the registry entries
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["Convolution", "BatchNorm", "Pooling",
                                  "Flatten"])
def test_op_registry_entries_match_jax(name):
    from mxnet_tpu.ops import registry as jreg
    from mxnet_tpu_torch.ops import registry as treg
    j, t = jreg.get_op(name), treg.get_op(name)
    assert t.defaults == j.defaults
    assert t.arg_names == j.arg_names
    assert t.mutable_inputs == j.mutable_inputs
    assert t.needs_rng == j.needs_rng
    assert t.attr_docs == j.attr_docs
    assert t.attr_ranges == j.attr_ranges
    for attrs in ({}, {"no_bias": True}, {"output_mean_var": True}):
        assert t.resolve_arg_names(attrs) == j.resolve_arg_names(attrs)
        assert t.resolve_num_outputs(treg.normalize_attrs(t, attrs)) == \
            j.resolve_num_outputs(jreg.normalize_attrs(j, attrs))
    with pytest.raises(tmx.MXNetError, match="outside valid range"):
        tmx.nd.BatchNorm(*[tmx.nd.ones((2, 3))] + [tmx.nd.ones((3,))] * 4,
                         momentum=1.5)


# ---------------------------------------------------------------------------
# one op
# ---------------------------------------------------------------------------

CONV = {
    "1d": ((2, 4, 11), (6, 4, 3), dict(kernel=(3,), stride=(2,), pad=(1,))),
    "2d_groups_dilate": ((2, 4, 9, 9), (6, 2, 3, 3),
                         dict(kernel=(3, 3), stride=(2, 1), pad=(1, 2),
                              dilate=(1, 2), num_group=2)),
    "2d_no_bias": ((2, 3, 8, 8), (5, 3, 1, 1),
                   dict(kernel=(1, 1), no_bias=True)),
    "3d": ((1, 2, 5, 6, 7), (3, 2, 2, 3, 3),
           dict(kernel=(2, 3, 3), stride=(1, 2, 2), pad=(0, 1, 1))),
}


@pytest.mark.parametrize("case", sorted(CONV))
def test_convolution_matches_jax(case):
    xs, ws, kw = CONV[case]
    x, w, b = _rand(1, *xs), _rand(2, *ws), _rand(3, ws[0])
    outs = []
    for mx in (jmx, tmx):
        args = [mx.nd.array(x), mx.nd.array(w)]
        if not kw.get("no_bias"):
            args.append(mx.nd.array(b))
        outs.append(mx.nd.Convolution(*args, num_filter=ws[0],
                                      **kw).asnumpy())
    assert outs[1].shape == outs[0].shape
    np.testing.assert_allclose(outs[1], outs[0], **TOL)


BN = {
    "eval": (False, dict(fix_gamma=False)),
    "eval_fix_gamma": (False, dict()),
    "train": (True, dict(fix_gamma=False, momentum=0.8)),
    "train_fix_gamma_mean_var": (True, dict(output_mean_var=True)),
    "train_global_stats": (True, dict(fix_gamma=False,
                                      use_global_stats=True)),
    "train_axis_last": (True, dict(fix_gamma=False, axis=-1, eps=1e-5)),
}


def _bn_run(mx, train, kw, x, params, head):
    data = mx.nd.array(x)
    data.attach_grad()
    arrs = [mx.nd.array(a) for a in params]    # gamma, beta, the stats
    for a in arrs[:2]:
        a.attach_grad()
    with mx.autograd.record(train_mode=train):
        outs = mx.nd.BatchNorm(data, *arrs, **kw)
        outs = outs if isinstance(outs, list) else [outs]
        loss = (outs[0] * mx.nd.array(head)).sum()
    loss.backward()
    res = {"out%d" % i: o.asnumpy() for i, o in enumerate(outs)}
    res.update(moving_mean=arrs[2].asnumpy(), moving_var=arrs[3].asnumpy(),
               d_data=data.grad.asnumpy(), d_gamma=arrs[0].grad.asnumpy(),
               d_beta=arrs[1].grad.asnumpy())
    return res


@pytest.mark.parametrize("case", sorted(BN))
def test_batchnorm_matches_jax(case):
    """Outputs, the written-back moving statistics and the gradients
    (JAX: its hand-written VJP; the port: ``_BNTrain.backward``)."""
    train, kw = BN[case]
    axis = kw.get("axis", 1)
    x = _rand(4, 3, 4, 5, 6, scale=2.0) + 3.0     # a large-mean channel
    c = x.shape[axis]
    rs = np.random.RandomState(5)
    params = [p.astype(np.float32) for p in (
        rs.uniform(0.5, 1.5, c), rs.randn(c), rs.randn(c) + 3.0,
        rs.uniform(0.5, 2.0, c))]
    head = _rand(6, *x.shape)
    want = _bn_run(jmx, train, kw, x, params, head)
    got = _bn_run(tmx, train, kw, x, params, head)
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-5,
                                   atol=1e-5, err_msg=key)
    if train and not kw.get("use_global_stats"):
        assert not np.allclose(got["moving_mean"], params[2])


POOL = {
    "max_valid": dict(pool_type="max", kernel=(3, 3), stride=(2, 2),
                      pad=(1, 1)),
    "max_full": dict(pool_type="max", kernel=(3, 3), stride=(2, 2),
                     pooling_convention="full"),
    "avg_valid": dict(pool_type="avg", kernel=(3, 3), stride=(2, 2),
                      pad=(1, 1)),
    "avg_excl_pad": dict(pool_type="avg", kernel=(3, 3), stride=(2, 2),
                         pad=(1, 1), count_include_pad=False),
    "avg_full": dict(pool_type="avg", kernel=(2, 2), stride=(2, 2),
                     pad=(1, 1), pooling_convention="full"),
    "avg_full_excl_pad": dict(pool_type="avg", kernel=(2, 2), stride=(2, 2),
                              pad=(1, 1), pooling_convention="full",
                              count_include_pad=False),
    "sum": dict(pool_type="sum", kernel=(3, 2), stride=(1, 2), pad=(1, 0)),
    "lp": dict(pool_type="lp", kernel=(3, 3), stride=(2, 2), p_value=3),
    "global_avg": dict(pool_type="avg", global_pool=True),
    "global_max": dict(pool_type="max", global_pool=True, kernel=(2, 2)),
    "max_1d": dict(pool_type="max", kernel=(3,), stride=(2,), pad=(1,)),
    "avg_3d_full": dict(pool_type="avg", kernel=(2, 2, 2), stride=(2, 2, 2),
                        pooling_convention="full",
                        count_include_pad=False),
}


@pytest.mark.parametrize("case", sorted(POOL))
def test_pooling_matches_jax(case):
    kw = POOL[case]
    shape = {1: (2, 3, 11), 2: (2, 3, 9, 9), 3: (1, 2, 5, 7, 6)}[
        len(kw.get("kernel", (0, 0)))]
    x = _rand(7, *shape)
    got, want = [mx.nd.Pooling(mx.nd.array(x), **kw).asnumpy()
                 for mx in (tmx, jmx)]
    assert got.shape == want.shape
    # a "full" window wholly in the padding divides 0 by 0 in both
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, **TOL)


# ---------------------------------------------------------------------------
# layers: deferred shapes, imperative and hybridized
# ---------------------------------------------------------------------------

def _conv_bn_net(mx):
    nn = mx.gluon.nn
    net = nn.HybridSequential()
    with net.name_scope():
        net.add(nn.Conv2D(8, 3, padding=1, groups=2), nn.BatchNorm(),
                nn.Activation("relu"), nn.MaxPool2D(2, ceil_mode=True),
                nn.Conv2D(4, (1, 3)), nn.BatchNorm(scale=False),
                nn.AvgPool2D(2, 1, 1, count_include_pad=False),
                nn.GlobalMaxPool2D(), nn.Flatten(), nn.Dense(3))
    return net


@pytest.mark.parametrize("hybridize", [False, True])
def test_deferred_shapes_and_outputs_match_jax(hybridize):
    """``in_channels=0`` convolutions and BatchNorms resolve to JAX's
    shapes through shape inference over the traced graph, whether the
    first call is eager or hybridized; the outputs then agree."""
    x = _rand(8, 2, 4, 7, 7)
    jnet = _conv_bn_net(jmx)
    jnet.initialize(jmx.init.Xavier())
    want = jnet(jmx.nd.array(x)).asnumpy()
    tnet = _conv_bn_net(tmx)
    tnet.initialize(tmx.init.Xavier())
    assert tnet[0].weight.shape == (8, 0, 3, 3)
    assert tnet[1].running_mean.shape == (0,)
    if hybridize:
        tnet.hybridize()
    tnet(tmx.nd.array(x))
    shapes = lambda n: {k: p.shape for k, p in        # noqa: E731
                        n._collect_params_with_prefix().items()}
    assert shapes(tnet) == shapes(jnet)
    params_from_numpy(tnet, _weights(jnet))
    np.testing.assert_allclose(tnet(tmx.nd.array(x)).asnumpy(), want,
                               **TOL)
    assert (tnet._cached_op is not None) == hybridize


# ---------------------------------------------------------------------------
# the model zoo
# ---------------------------------------------------------------------------

NAMES = ["resnet%d_v%d" % (d, v) for v in (1, 2)
         for d in (18, 34, 50, 101, 152)]


@pytest.mark.parametrize("name", NAMES)
def test_model_zoo_structure_matches_jax(name):
    """Every ResNet's block tree: the same structural parameter names
    and declared shapes (0 where deferred) as the JAX package's."""
    nets = [mx.gluon.model_zoo.vision.get_model(name, classes=7)
            for mx in (jmx, tmx)]
    j, t = ({k: p.shape for k, p in n._collect_params_with_prefix().items()}
            for n in nets)
    assert t == j
    with pytest.raises(tmx.MXNetError, match="pretrained"):
        tmx.gluon.model_zoo.vision.get_model(name, pretrained=True)


def test_model_zoo_rejects_unknown_names():
    with pytest.raises(ValueError, match="not supported"):
        tmx.gluon.model_zoo.vision.get_model("vgg17")


def test_resnet18_v2_forward_matches_jax():
    """The v2 family: pre-activation blocks, a BatchNorm without scale or
    center in front, Flatten before the classifier."""
    x = _rand(9, 2, 3, 32, 32)
    jnet = jmx.gluon.model_zoo.vision.resnet18_v2(classes=10)
    jnet.initialize(jmx.init.Xavier())
    want = jnet(jmx.nd.array(x)).asnumpy()
    tnet = tmx.gluon.model_zoo.vision.resnet18_v2(classes=10)
    tnet.initialize()
    params_from_numpy(tnet, _weights(jnet))
    tnet.hybridize()
    np.testing.assert_allclose(tnet(tmx.nd.array(x)).asnumpy(), want,
                               **LOGIT_TOL)


# ---------------------------------------------------------------------------
# entry()'s config: ResNet-50 v1, classes 10, batch 2, 32x32
# ---------------------------------------------------------------------------

def _perturb_norms(weights, seed):
    """Random BatchNorm statistics and affine terms, so that the eval
    path's per-channel FMA is not the identity of a fresh net."""
    rs = np.random.RandomState(seed)
    out = dict(weights)
    for k, v in weights.items():
        n = v.shape
        if k.endswith("gamma") or k.endswith("running_var"):
            out[k] = rs.uniform(0.8, 1.2, n).astype(np.float32)
        elif k.endswith("beta") or k.endswith("running_mean"):
            out[k] = (0.1 * rs.randn(*n)).astype(np.float32)
    return out


def _f64_forward(block, x, w, prefix=""):
    """The same net in float64 with plain torch calls, walked over the
    port's block tree (the reference both packages are held to)."""
    from mxnet_tpu_torch.gluon import nn
    from mxnet_tpu_torch.gluon.model_zoo.vision import resnet
    dot = prefix + "." if prefix else ""
    p = lambda name: torch.tensor(w[dot + name], dtype=torch.float64)  # noqa: E731,E501
    if isinstance(block, nn.Conv2D):
        kw = block._kwargs
        return F.conv2d(x, p("weight"), stride=kw["stride"],
                        padding=kw["pad"])
    if isinstance(block, nn.BatchNorm):
        shape = (1, -1, 1, 1)
        return (x - p("running_mean").reshape(shape)) / torch.sqrt(
            p("running_var").reshape(shape) + block._kwargs["eps"]) \
            * p("gamma").reshape(shape) + p("beta").reshape(shape)
    if isinstance(block, nn.Activation):
        return torch.relu(x)
    if isinstance(block, nn.MaxPool2D):
        return F.max_pool2d(x, 3, 2, 1)
    if isinstance(block, nn.GlobalAvgPool2D):
        return x.mean(dim=(2, 3), keepdim=True)
    if isinstance(block, nn.Dense):
        return F.linear(x.reshape(x.shape[0], -1), p("weight"), p("bias"))
    if isinstance(block, nn.HybridSequential):
        for name, child in block._children.items():
            x = _f64_forward(child, x, w, dot + name)
        return x
    if isinstance(block, resnet.BottleneckV1):
        out = _f64_forward(block.body, x, w, dot + "body")
        if block.downsample is not None:
            x = _f64_forward(block.downsample, x, w, dot + "downsample")
        return torch.relu(out + x)
    if isinstance(block, resnet.ResNetV1):
        x = _f64_forward(block.features, x, w, dot + "features")
        return _f64_forward(block.output, x, w, dot + "output")
    raise TypeError(type(block))


def _entry_lines(mx, image):
    """The five lines of ``entry()`` (__graft_entry__.py), run against
    package ``mx``; returns the net and the traced plan."""
    from importlib import import_module
    vision = import_module(mx.__name__ + ".gluon.model_zoo.vision")
    build_graph_callable = import_module(
        mx.__name__ + ".cached_op").build_graph_callable
    sym_mod = import_module(mx.__name__ + ".symbol")
    net = vision.resnet50_v1(classes=10)
    net.initialize(mx.init.Xavier())
    x_nd = mx.nd.zeros((2, 3, image, image))
    net(x_nd)
    out = net(sym_mod.var("data"))
    return net, build_graph_callable(out)


def _plan_logits(net, plan, x, array):
    fn, arg_names, aux_names, _n_rng, _n_out = plan
    params = {p.name: p for p in net.collect_params().values()}
    vals = [x if n == "data" else params[n].data()._data for n in arg_names]
    vals += [params[n].data()._data for n in aux_names]
    return np.asarray(array(fn({"__train__": False}, *vals)[0]))


def test_entry_config_matches_jax_and_float64():
    image = 32
    np.random.seed(0)          # the JAX package's Xavier draws from numpy
    jnet, jplan = _entry_lines(jmx, image)
    tnet, tplan = _entry_lines(tmx, image)
    assert len(tplan[1]) == len(jplan[1]) == 194      # 193 params + data
    assert len(tplan[2]) == len(jplan[2]) == 106      # 53 BatchNorms x 2
    assert tplan[3:] == jplan[3:] == (0, 1)
    weights = _perturb_norms(_weights(jnet), seed=10)
    for k, p in jnet._collect_params_with_prefix().items():
        p.set_data(jmx.nd.array(weights[k]))
    params_from_numpy(tnet, weights)
    x = _rand(11, 2, 3, image, image)
    want = _plan_logits(jnet, jplan, jmx.nd.array(x)._data, np.asarray)
    got_plan = _plan_logits(tnet, tplan, torch.from_numpy(x),
                            lambda t: t.detach().numpy())
    tnet.hybridize()
    got_hyb = tnet(tmx.nd.array(x)).asnumpy()
    assert tnet._cached_op is not None
    ref = _f64_forward(tnet, torch.from_numpy(x).double(), weights).numpy()
    for got in (got_plan, got_hyb):
        assert got.shape == (2, 10) and np.isfinite(got).all()
        np.testing.assert_allclose(got, want, **LOGIT_TOL)
        assert np.abs(got - ref).max() <= 2 * np.abs(want - ref).max()


# ---------------------------------------------------------------------------
# one training call: ResNet-18 v1 hybridized under record()
# ---------------------------------------------------------------------------

def _train_call(mx, net, x, head):
    net.hybridize()
    with mx.autograd.record():
        y = net(mx.nd.array(x))
        loss = (y * mx.nd.array(head)).sum()
    loss.backward()
    table = net._collect_params_with_prefix()
    res = {"logits": y.asnumpy()}
    for k, p in table.items():
        if p.grad_req == "null":
            res[k] = p.data().asnumpy()        # the moving statistics
        else:
            res["grad:" + k] = p.grad().asnumpy()
    return res


def test_resnet18_training_call_matches_jax():
    """Logits, the moving statistics written back by every BatchNorm
    (``momentum*old + (1-momentum)*batch``) and every gradient of one
    hybridized training call, against JAX's CachedOp under record()
    (its backward is ``jax.vjp`` of the traced graph). 64x64: at 32x32
    the last stage is 1x1, so its BatchNorms normalize two values a
    channel, which amplifies rounding: there the JAX package's own
    logits differ from a float64 run by up to 1.7e-2, as much as the
    port's (at 64x64 both by about 1e-5)."""
    x = _rand(12, 2, 3, 64, 64)
    head = _rand(13, 2, 10)
    jnet = jmx.gluon.model_zoo.vision.resnet18_v1(classes=10)
    jnet.initialize(jmx.init.Xavier())
    jnet(jmx.nd.array(x))
    weights = _perturb_norms(_weights(jnet), seed=14)
    for k, p in jnet._collect_params_with_prefix().items():
        p.set_data(jmx.nd.array(weights[k]))
    tnet = tmx.gluon.model_zoo.vision.resnet18_v1(classes=10)
    tnet.initialize()
    params_from_numpy(tnet, weights)
    want = _train_call(jmx, jnet, x, head)
    got = _train_call(tmx, tnet, x, head)
    assert sorted(got) == sorted(want)
    n_stats = n_grads = 0
    for key, w in want.items():
        if key.startswith("grad:"):
            n_grads += 1
            assert np.abs(w).max() > 0, key
            np.testing.assert_allclose(
                got[key], w, rtol=0, atol=GRAD_REL * np.abs(w).max(),
                err_msg=key)
        else:
            n_stats += key != "logits"
            np.testing.assert_allclose(got[key], w, **LOGIT_TOL,
                                       err_msg=key)
            if key != "logits":
                assert not np.allclose(got[key], weights[key]), key
    assert (n_stats, n_grads) == (2 * 20, 62)
