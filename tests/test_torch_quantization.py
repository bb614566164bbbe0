"""The port's int8 quantization (``mxnet_tpu_torch.ops.quantization``, the
nine ``_contrib_quantize*``/``_contrib_quantized_*`` ops, and
``mxnet_tpu_torch.contrib.quantization``) against the JAX package's, on
the CPU, from numpy inputs with a seed:

- each op through ``mx.nd`` in both packages: integer outputs
  identical, float outputs and ranges at rtol 1e-5, atol 1e-6;
- the int8 products exact in int32 where an fp32 product is not (sums
  past 2^24, ResNet's K = 3 x 3 x 512), against numpy int64;
- ``quantize_model`` (naive calibration) on a small conv + FC net: the
  same rewritten graph, node ops in order, and the same ranges;
- ranges ride as tensors: a captured graph serves new range values by
  replay, with no recapture (the JAX package's
  ``test_ranges_are_traced_not_static``)."""
import importlib

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

tco = importlib.import_module("mxnet_tpu_torch.cached_op")
tq = importlib.import_module("mxnet_tpu_torch.ops.quantization")

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


def _i8(rs, *shape):
    return rs.randint(-127, 128, shape).astype(np.int8)


def _f32(*values):
    return [np.float32(v) for v in values]


def _cases(rs):
    """op name -> [(numpy inputs, attrs)]."""
    x = rs.uniform(-3, 3, (4, 37)).astype(np.float32)
    acc = rs.randint(-2 ** 20, 2 ** 20, (4, 37)).astype(np.int32)
    r = _f32(-1.7, 2.3)
    fc = _f32(-1.1, 1.2, -0.3, 0.2, -0.05, 0.04)
    xc = _i8(rs, 2, 6, 9, 9)
    pool_x = _i8(rs, 2, 3, 8, 8)
    return {
        "_contrib_quantize": [([x] + r, {})],
        "_contrib_quantize_v2": [
            ([x], {}),
            ([x], {"min_calib_range": -1.3, "max_calib_range": 2.1})],
        "_contrib_dequantize": [([_i8(rs, 4, 37)] + r, {})],
        "_contrib_requantize": [
            ([acc] + r, {}),
            ([acc] + r, {"min_calib_range": -0.7, "max_calib_range": 0.9})],
        "_contrib_quantized_fully_connected": [
            ([_i8(rs, 5, 37), _i8(rs, 9, 37), _i8(rs, 9)] + fc,
             {"num_hidden": 9}),
            ([_i8(rs, 3, 4, 10), _i8(rs, 6, 40)] + fc[:4],
             {"num_hidden": 6, "no_bias": True}),
            ([_i8(rs, 3, 4, 10), _i8(rs, 6, 10)] + fc[:4],
             {"num_hidden": 6, "no_bias": True, "flatten": False})],
        "_contrib_quantized_conv": [
            ([xc, _i8(rs, 8, 6, 3, 3)] + fc[:4],
             {"kernel": (3, 3), "num_filter": 8, "pad": (1, 1)}),
            ([xc, _i8(rs, 8, 3, 3, 3), _i8(rs, 8)] + fc,
             {"kernel": (3, 3), "stride": (2, 1), "pad": (1, 2),
              "dilate": (1, 2), "num_group": 2, "num_filter": 8,
              "no_bias": False}),
            ([_i8(rs, 2, 4, 11), _i8(rs, 5, 4, 3)] + fc[:4],
             {"kernel": (3,), "stride": (2,), "num_filter": 5})],
        "_contrib_quantized_pooling": [
            ([pool_x] + r, {"kernel": (2, 2), "stride": (2, 2),
                            "pool_type": "max"}),
            ([pool_x] + r, {"kernel": (3, 3), "stride": (2, 2),
                            "pad": (1, 1), "pool_type": "avg"}),
            ([pool_x] + r, {"global_pool": True, "pool_type": "avg",
                            "kernel": (1, 1)})],
        "_contrib_quantized_flatten": [([_i8(rs, 2, 3, 4, 5)] + r, {})],
        "_contrib_quantized_concat": [
            ([_i8(rs, 2, 3, 4), _i8(rs, 2, 5, 4)]
             + _f32(-0.5, -2.0) + _f32(0.7, 1.5),
             {"num_args": 2, "dim": 1})],
    }


def _run(mx, name, arrays, attrs):
    ins = [mx.nd.array(a, dtype=a.dtype) for a in arrays]
    out = getattr(mx.nd, name)(*ins, **attrs)
    outs = out if isinstance(out, (list, tuple)) else [out]
    return [o.asnumpy() for o in outs]


def _bias_ties(name, arrays, attrs):
    """Per output channel, whether the bias's value in accumulator units
    (``b_real / acc_unit``, IEEE float32 division, as the port and the
    JAX op's own eager arithmetic take it) is an exact .5 tie: the one
    place where the JAX op, jitted, can round one level the other way
    (XLA need not divide exactly)."""
    if name not in ("_contrib_quantized_fully_connected",
                    "_contrib_quantized_conv") or len(arrays) != 9:
        return None
    d_min, d_max, w_min, w_max, b_min, b_max = (torch.tensor(v)
                                                for v in arrays[3:])
    acc_unit = tq._scale_of(d_min, d_max) * tq._scale_of(w_min, w_max)
    val = (torch.from_numpy(arrays[2]).to(torch.float32)
           * tq._scale_of(b_min, b_max) / acc_unit).numpy()
    return val - np.floor(val) == 0.5


@pytest.mark.parametrize("name", sorted(_cases(np.random.RandomState(0))))
def test_each_op_matches_jax(name):
    """Integer outputs identical, except by one level in an output
    channel whose bias is an exact float32 rounding tie in accumulator
    units (``_bias_ties``); float outputs and ranges at rtol 1e-5, atol
    1e-6."""
    for arrays, attrs in _cases(np.random.RandomState(7))[name]:
        got = _run(tmx, name, arrays, attrs)
        want = _run(jmx, name, arrays, attrs)
        assert len(got) == len(want), name
        for i, (g, w) in enumerate(zip(got, want)):
            assert g.shape == w.shape and g.dtype == w.dtype, \
                (name, attrs, g.shape, w.shape, g.dtype, w.dtype)
            if not np.issubdtype(w.dtype, np.integer):
                np.testing.assert_allclose(g, w, err_msg=name, **TOL)
                continue
            off = g != w
            ties = _bias_ties(name, arrays, attrs) if i == 0 else None
            if off.any() and ties is not None:
                axis = 1 if name == "_contrib_quantized_conv" else -1
                chan = np.moveaxis(off, axis, -1).reshape(
                    -1, off.shape[axis]).any(axis=0)
                assert ties[chan].all(), (name, np.where(chan & ~ties))
                assert np.abs(g.astype(np.int64)[off]
                              - w.astype(np.int64)[off]).max() == 1
                continue
            np.testing.assert_array_equal(g, w, err_msg=name)


def _opcheck_args(name, rs):
    r = [torch.tensor(v) for v in _f32(-1.1, 1.2, -0.3, 0.2, -0.05, 0.04)]
    x = torch.from_numpy(rs.uniform(-2, 2, (4, 12)).astype(np.float32))
    q = torch.from_numpy(_i8(rs, 4, 12))
    if name == "quantize":
        return [(x, r[0], r[1])]
    if name == "quantize_v2":
        return [(x, None, None), (x, -1.5, 1.7)]
    if name == "dequantize":
        return [(q, r[0], r[1])]
    if name == "requantize":
        acc = torch.from_numpy(rs.randint(-2 ** 20, 2 ** 20, (4, 12)).astype(
            np.int32))
        return [(acc, r[0], r[1], None, None), (acc, r[0], r[1], -0.7, 0.9)]
    w, b = torch.from_numpy(_i8(rs, 8, 12)), torch.from_numpy(_i8(rs, 8))
    if name == "quantized_fully_connected":
        return [(q, w, b, *r, True), (q, w, None, *r[:4], None, None, True)]
    xc = torch.from_numpy(_i8(rs, 2, 4, 7, 7))
    wc = torch.from_numpy(_i8(rs, 6, 2, 3, 3))
    return [(xc, wc, torch.from_numpy(_i8(rs, 6)), *r, [3, 3], [2, 1],
             [1, 2], [1, 0], 2),
            (xc, wc[:, :1].repeat(1, 4, 1, 1).contiguous(), None, *r[:4],
             None, None, [3, 3], [1, 1], [1, 1], [1, 1], 1)]


@pytest.mark.parametrize("name", sorted(n.split("::")[1] for n in tq.OPS))
def test_opcheck(name):
    """``torch.library.opcheck`` on each quantized op: schema, the fake
    implementation's shapes and dtypes against the op's, AOT dispatch."""
    op = tq.OPS["mxnet_tpu_torch::" + name]
    for args in _opcheck_args(name, np.random.RandomState(len(name))):
        result = torch.library.opcheck(op, args)
        assert set(result.values()) == {"SUCCESS"}, result


def test_contrib_short_names_reach_the_quantized_ops():
    rs = np.random.RandomState(1)
    x = rs.uniform(-2, 2, (3, 5)).astype(np.float32)
    q, lo, hi = tmx.nd.contrib.quantize_v2(tmx.nd.array(x))
    back = tmx.nd.contrib.dequantize(q, lo, hi).asnumpy()
    assert q.dtype == np.int8
    assert np.max(np.abs(back - x)) <= float(hi.asnumpy()) / 127 / 2 + 1e-6
    assert tmx.sym.contrib.quantized_conv.__name__ \
        == "_contrib_quantized_conv"


def test_int8_products_are_exact_past_two_to_the_24():
    """At ResNet's K = 3 x 3 x 512 = 4608, an int8 product's sums reach
    4608 x 127^2 ~ 7.4e7 > 2^24: the port's int32 accumulation equals
    numpy's int64 sum exactly (an fp32 product would round), through
    the padding of rows (m <= 16), K and N."""
    rs = np.random.RandomState(3)
    a = np.full((5, 4608), 127, np.int8)
    a[1:4] = _i8(rs, 3, 4608)
    a[4, 0] = 2                # an odd sum past 2^24: no fp32 holds it
    w = np.full((3, 4608), 127, np.int8)
    w[1:] = _i8(rs, 2, 4608)
    got = tq._int8_matmul(torch.from_numpy(a), torch.from_numpy(w))
    want = a.astype(np.int64) @ w.astype(np.int64).T
    assert got.dtype == torch.int32 and tuple(got.shape) == (5, 3)
    assert want[0, 0] == 4608 * 127 ** 2 > 2 ** 24
    np.testing.assert_array_equal(got.numpy(), want)
    assert want[4, 0] % 2 == 1 and int(np.float32(want[4, 0])) != want[4, 0]
    # and the convolution: 3 x 3 x 512 windows of a constant image
    x = np.full((1, 512, 4, 4), 127, np.int8)
    k = np.full((2, 512, 3, 3), 127, np.int8)
    z = [torch.tensor(v) for v in _f32(-1, 1, -1, 1)]
    acc = tq._quantized_conv({"kernel": (3, 3), "no_bias": True},
                             torch.from_numpy(x), torch.from_numpy(k), *z)[0]
    assert acc.dtype == torch.int32
    np.testing.assert_array_equal(acc.numpy(),
                                  np.full((1, 2, 2, 2), 4608 * 127 ** 2))


def _conv_fc_net(mx):
    data = mx.sym.var("data")
    h = mx.sym.Convolution(data, kernel=(3, 3), num_filter=4, pad=(1, 1),
                           name="conv1")
    h = mx.sym.Activation(h, act_type="relu")
    h = mx.sym.Pooling(h, kernel=(2, 2), stride=(2, 2), pool_type="max")
    h = mx.sym.Flatten(h)
    h = mx.sym.FullyConnected(h, num_hidden=6, name="fc1")
    h = mx.sym.Activation(h, act_type="relu")
    out = mx.sym.FullyConnected(h, num_hidden=3, name="fc2")
    return mx.sym.SoftmaxOutput(out, mx.sym.var("softmax_label"),
                                name="softmax")


def _net_params(seed=0):
    rs = np.random.RandomState(seed)
    shapes = {"conv1_weight": (4, 2, 3, 3), "conv1_bias": (4,),
              "fc1_weight": (6, 64), "fc1_bias": (6,),
              "fc2_weight": (3, 6), "fc2_bias": (3,)}
    return {n: (rs.randn(*s) * 0.4).astype(np.float32)
            for n, s in shapes.items()}, \
        [rs.randn(4, 2, 8, 8).astype(np.float32) for _ in range(3)]


class _Batches:
    def __init__(self, mx, xs):
        self._batches = [type("B", (), {"data": [mx.nd.array(x)]})()
                         for x in xs]
        self.resets = 0

    def __iter__(self):
        return iter(self._batches)

    def reset(self):
        self.resets += 1


def _ops_in_order(sym):
    return [(n.name, n.op.name) for n in sym._topo_nodes()
            if not n.is_variable()]


@pytest.mark.parametrize("excluded", [(), ("fc2",)], ids=["all", "fc2_out"])
def test_quantize_model_matches_jax(excluded):
    params, xs = _net_params()
    res = {}
    for mx in (tmx, jmx):
        nd_params = {n: mx.nd.array(v) for n, v in params.items()}
        calib = _Batches(mx, xs)
        qsym, qargs, qaux = mx.contrib.quantization.quantize_model(
            _conv_fc_net(mx), nd_params, {}, calib_mode="naive",
            calib_data=calib, num_calib_batches=2,
            excluded_sym_names=excluded)
        ranges = mx.contrib.quantization.calibrate_ranges(
            _conv_fc_net(mx), nd_params, {}, calib, num_calib_batches=2)
        res[mx] = (qsym, qargs, ranges, calib.resets)
    (tsym, targs, tr, tresets), (jsym, jargs, jr, jresets) = \
        res[tmx], res[jmx]
    assert _ops_in_order(tsym) == _ops_in_order(jsym)
    assert tsym.list_arguments() == jsym.list_arguments()
    assert sorted(targs) == sorted(jargs) == sorted(params)
    assert tresets == jresets == 2
    assert sorted(tr) == sorted(jr) == ["conv1", "fc1", "fc2"]
    for n in jr:
        np.testing.assert_allclose(tr[n], jr[n], err_msg=n, **TOL)
    # the requantize nodes carry the calibrated ranges
    for sym, want in ((tsym, tr), (jsym, jr)):
        req = {n.name: n.attrs for n in sym._topo_nodes()
               if not n.is_variable()
               and n.op.name == "_contrib_requantize"}
        names = sorted(set(want) - set(excluded))
        assert sorted(req) == [n + "_requantize" for n in names]
        for n in names:
            got = (float(req[n + "_requantize"]["min_calib_range"]),
                   float(req[n + "_requantize"]["max_calib_range"]))
            np.testing.assert_allclose(got, want[n], **TOL)
    x = xs[0]
    outs = []
    for mx, (sym, args) in ((tmx, (tsym, targs)), (jmx, (jsym, jargs))):
        ex = sym.bind(mx.cpu(), dict(args, data=mx.nd.array(x),
                                     softmax_label=mx.nd.zeros((4,))))
        outs.append(ex.forward()[0].asnumpy())
    np.testing.assert_allclose(outs[0], outs[1], rtol=1e-4, atol=1e-5)


def test_quantize_model_refusals_match_jax():
    params, xs = _net_params(1)
    for mx in (tmx, jmx):
        args = {n: mx.nd.array(v) for n, v in params.items()}
        sym = _conv_fc_net(mx)
        with pytest.raises(mx.base.MXNetError, match="int8 only"):
            mx.contrib.quantization.quantize_model(
                sym, args, {}, quantized_dtype="uint8",
                calib_data=_Batches(mx, xs))
        with pytest.raises(mx.base.MXNetError, match="entropy"):
            mx.contrib.quantization.quantize_model(
                sym, args, {}, calib_mode="entropy",
                calib_data=_Batches(mx, xs))
        with pytest.raises(mx.base.MXNetError, match="requires calib_data"):
            mx.contrib.quantization.quantize_model(sym, args, {})


def _standin():
    """A CUDA capture's contract on the CPU: one call now, the output
    buffers kept, each replay writes the body's result into them."""
    def capture(body, device, pool):
        out = body()

        def replay():
            for o, r in zip(out, body()):
                o.copy_(r)
        return replay, out, {}
    return capture


def test_new_range_values_replay_without_a_recapture():
    """quantize -> dequantize with the range as data inputs of one
    captured graph: each new range replays it (no recapture), and the
    range takes effect each call, as in the JAX package's one trace."""
    x = np.random.RandomState(5).uniform(-2, 2, (4, 8)).astype(np.float32)
    outs = {}
    for mx in (tmx, jmx):
        d, lo, hi = mx.sym.var("data"), mx.sym.var("lo"), mx.sym.var("hi")
        q = mx.sym._contrib_quantize(d, lo, hi)
        sym = mx.sym._contrib_dequantize(q[0], q[1], q[2])
        outs[mx] = []
        if mx is tmx:
            op = tco.CachedOp(sym, data_indices=[0, 1, 2])
            op.graphs = tco._Graphs("cpu", capture=_standin())
        for r in (0.5, 1.0, 2.0, 3.7):
            ins = [mx.nd.array(x), mx.nd.array([-r]), mx.nd.array([r])]
            if mx is tmx:
                outs[mx].append(op(*ins).asnumpy())
            else:
                outs[mx].append(mx.nd._contrib_dequantize(
                    *mx.nd._contrib_quantize(*ins)).asnumpy())
    st = op.stats()
    assert st["captures"] == 1 and st["recaptures"] == 0 \
        and st["replays"] == 4
    for got, want in zip(outs[tmx], outs[jmx]):
        np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(np.max(np.abs(outs[tmx][0])), 0.5, atol=1e-6)
    assert np.max(np.abs(outs[tmx][3] - x)) <= 3.7 / 127 / 2 + 1e-6
