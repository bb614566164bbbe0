"""The port's operator registry and the surfaces over it, against the JAX
package's, on the CPU:

- every JAX op name is registered in the port with equal ``arg_names``,
  ``defaults``, ``num_outputs``, canonical name (its aliases),
  ``key_var_num_args``, ``needs_rng`` and ``mutable_inputs``, or is
  listed in ``UNPORTED`` with the ROADMAP queue A order step that brings
  it (the list must shrink: a listed name the port registers fails);
- the public names of ``mx.nd``, ``mx.sym``, ``nd.contrib`` and
  ``sym.contrib`` and the methods of ``NDArray`` and ``Symbol`` the same
  way;
- the methods and functions this slice added, and ``nd.contrib``'s and
  ``sym.contrib``'s ``foreach``/``while_loop``/``cond``, held to the JAX
  package on small inputs and graphs;
- every op that ``chip_smoke.py`` phase 21 sweeps on the card has a case
  there, and each case runs on the CPU at toy size with its gradient."""
import importlib.util
import pathlib

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu.ops as jops
import mxnet_tpu_torch as tmx
import mxnet_tpu_torch.ops as tops

ROOT = pathlib.Path(__file__).resolve().parents[1]
TOL = dict(rtol=1e-5, atol=1e-6)


# the names order step 5 (sparse storage) registered
STEP5 = {"_square_sum", "_contrib_getnnz", "_contrib_SparseEmbedding",
         "cast_storage", "_sparse_retain"}
# and the first half of order step 6 (the rank mesh)
STEP6 = {"_contrib_SyncBatchNorm"}
# and the deploy path's int8 ops (order step 7's format-3 artifacts)
# order step 8's execution part: the control-flow ops and Custom
CONTROL = {"_foreach", "_while_loop", "_cond", "Custom"}
QUANT = {"_contrib_quantize", "_contrib_quantize_v2", "_contrib_dequantize",
         "_contrib_requantize", "_contrib_quantized_fully_connected",
         "_contrib_quantized_conv", "_contrib_quantized_pooling",
         "_contrib_quantized_flatten", "_contrib_quantized_concat"}

# order step 8's breadth, parts 1-3: the spatial, image, detection,
# deformable and dgl names
STEP8 = {
    "_contrib_edge_id", "_image_normalize", "_image_resize",
    "_image_to_tensor", "_image_totensor", "GridGenerator",
    "BilinearSampler", "SpatialTransformer", "Correlation",
    "MultiBoxDetection", "MultiBoxPrior", "MultiBoxTarget", "ROIAlign",
    "ROIPooling", "_contrib_MultiBoxDetection", "_contrib_MultiBoxPrior",
    "_contrib_MultiBoxTarget", "_contrib_ROIAlign",
    "_contrib_bipartite_matching", "_contrib_box_iou",
    "_contrib_box_nms", "_contrib_box_non_maximum_suppression",
    "MultiProposal", "Proposal", "_contrib_DeformableConvolution",
    "_contrib_DeformablePSROIPooling", "_contrib_MultiProposal",
    "_contrib_PSROIPooling", "_contrib_Proposal", "_contrib_count_sketch",
    "_contrib_dgl_adjacency",
    "_contrib_dgl_csr_neighbor_non_uniform_sample",
    "_contrib_dgl_csr_neighbor_uniform_sample",
    "_contrib_dgl_graph_compact", "_contrib_dgl_subgraph"}
# the dgl ops run on the host (OpDef host_code): phase 30 (e) holds them
# on the card's path and tests/test_torch_dgl.py against the JAX package
DGL = {n for n in STEP8 if n.startswith("_contrib_dgl_")}

# every JAX op name is registered now
UNPORTED = {}

# registered in both with a documented difference
DIFFERS = {}

# the names of this slice (ROADMAP queue A order step 3), by module
SLICE = {
    "elemwise": 70, "reduce": 13, "matrix": 10, "indexing": 10,
    "init_ops": 6, "nn": 16, "linalg": 32, "extra": 22,
}

# public names of mx.nd / mx.sym that wait for a later step: none now
NS_UNPORTED = {}

CONTRIB_UNPORTED = {}


@pytest.fixture(autouse=True)
def _port_on_cpu(monkeypatch):
    monkeypatch.setenv("MXNET_DEFAULT_CONTEXT", "cpu")


@pytest.fixture(autouse=True)
def _fresh_names():
    from mxnet_tpu.name import NameManager as JaxNames
    from mxnet_tpu_torch.name import NameManager as PortNames
    with JaxNames(), PortNames():
        yield


def _nout(op):
    return "variadic" if callable(op.num_outputs) else op.num_outputs


@pytest.mark.parametrize("name", jops.list_ops())
def test_every_jax_op_is_registered_alike_or_listed(name):
    j = jops.get_op(name)
    t = tops.find_op(name)
    if name in UNPORTED:
        assert t is None, "%s is ported now: take it off UNPORTED" % name
        return
    assert t is not None, name
    skip = DIFFERS.get(name, ())
    for field in ("arg_names", "defaults", "mutable_inputs", "needs_rng",
                  "key_var_num_args", "name"):
        if field not in skip:
            assert getattr(t, field) == getattr(j, field), (name, field)
    assert _nout(t) == _nout(j), name
    if name not in _EARLIER or name == "_zeros":
        # the order maps a stub's trailing positional attributes
        # (nd._ones((2, 3)): shape)
        assert list(t.defaults) == list(j.defaults), name
    assert (t.arg_names_fn is None) == (j.arg_names_fn is None), name
    if callable(j.num_outputs):
        for attrs in ({}, {"num_outputs": 3}, {"ret_typ": "both"},
                      {"sections": 2}, {"indices": (1, 4)},
                      {"num_weights": 2}):
            na = jops.normalize_attrs(j, attrs)
            try:
                want = j.resolve_num_outputs(na)
            except (KeyError, TypeError, ValueError, jmx.base.MXNetError):
                # Custom's count is its registered prop's (no op_type
                # here): tests/test_torch_custom_op.py holds it
                continue
            assert t.resolve_num_outputs(tops.normalize_attrs(t, attrs)) \
                == want, (name, attrs)


def test_the_port_registers_328_of_382_names_and_nothing_of_its_own():
    """328 names through order step 3; order step 5 added five, order
    step 6 one, the int8 deploy path nine, order step 8's execution
    part four (347) and its breadth the last 35: all 382."""
    jax_names, port_names = set(jops.list_ops()), set(tops.list_ops())
    assert port_names == jax_names and len(jax_names) == 382
    assert len(port_names - STEP5 - STEP6 - QUANT - CONTROL - STEP8) == 328
    assert len(STEP8) == 35 and not UNPORTED


def test_the_slice_registers_179_names_by_module():
    """The names this slice added, by the JAX module that registers
    them (the ``_v1`` names sit in the JAX package's extra.py; the port
    registers them in its nn.py, beside the ops they rename)."""
    added = set(tops.list_ops()) - _EARLIER - STEP5 - STEP6 - QUANT \
        - CONTROL - STEP8
    counts = {}
    for name in added:
        mod = jops.get_op(name).forward.__module__.rsplit(".", 1)[-1]
        if name.endswith("_v1"):
            mod = "nn"
        counts[mod] = counts.get(mod, 0) + 1
    assert len(_EARLIER) == 149 and _EARLIER <= set(tops.list_ops())
    assert counts == SLICE and len(added) == 179


def _public(obj):
    return {n for n in dir(obj) if not n.startswith("_")}


@pytest.mark.parametrize("ns", ["nd", "sym", "nd.op", "sym.op"])
def test_namespace_names(ns):
    def get(pkg):
        obj = pkg
        for part in ns.split("."):
            obj = getattr(obj, part)
        return obj
    want, got = _public(get(jmx)), _public(get(tmx))
    missing = want - got - set(NS_UNPORTED)
    assert not missing, sorted(missing)
    for name in NS_UNPORTED:
        if name in want:
            assert name not in got, \
                "%s is ported now: take it off NS_UNPORTED" % name


@pytest.mark.parametrize("ns", ["nd", "sym"])
def test_contrib_namespace_names(ns):
    want = _public(getattr(jmx, ns).contrib)
    got = _public(getattr(tmx, ns).contrib)
    missing = want - got - set(CONTRIB_UNPORTED) - {"annotations",
                                                    "MXNetError"}
    assert not missing, sorted(missing)
    for name in CONTRIB_UNPORTED:
        assert name not in got, \
            "%s is ported now: take it off CONTRIB_UNPORTED" % name


@pytest.mark.parametrize("cls", ["NDArray", "Symbol"])
def test_every_method_of_the_jax_class_exists(cls):
    want = _public(getattr(jmx.nd if cls == "NDArray" else jmx.sym, cls))
    got = _public(getattr(tmx.nd if cls == "NDArray" else tmx.sym, cls))
    assert not (want - got), sorted(want - got)


@pytest.mark.parametrize("stype", ["csr", "row_sparse"])
def test_sparse_storage_casts_like_jax(stype):
    """``tostype`` to a sparse storage type and back, and the sparse
    names of ``mx.nd``, against the JAX package (order step 5)."""
    x = np.array([[0, 1.5, 0], [0, 0, 0], [2, 0, -1]], np.float32)
    got, want = (mx.nd.array(x).tostype(stype) for mx in (tmx, jmx))
    assert got.stype == want.stype == stype
    np.testing.assert_array_equal(got.indices.asnumpy(),
                                  want.indices.asnumpy())
    np.testing.assert_array_equal(got.tostype("default").asnumpy(), x)
    assert isinstance(got, getattr(tmx.nd, type(want).__name__))
    dense = tmx.nd.array(x)
    assert dense.stype == "default" and dense.tostype("default") is dense


def _sym_control_flow(mx):
    """sym.contrib's foreach, while_loop and cond in one bound graph,
    with the gradient of a loss over all their outputs."""
    d, s, w = mx.sym.var("d"), mx.sym.var("s"), mx.sym.var("w")
    outs, final = mx.sym.contrib.foreach(
        lambda x, st: (x * st, st + x * w), d, s)
    wl_out, wl_vars = mx.sym.contrib.while_loop(
        lambda i, v: i < 3, lambda i, v: (v * 2, [i + 1, v * 2]),
        [mx.sym.zeros((1,)), final], max_iterations=5)
    pick = mx.sym.contrib.cond(mx.sym.sum(final) > 0, lambda: final * 3,
                               lambda: final - 1)
    loss = mx.sym.sum(outs) + mx.sym.sum(wl_out) + mx.sym.sum(wl_vars[1]) \
        + mx.sym.sum(pick)
    g = mx.sym.Group([outs, final, wl_out, wl_vars[1], pick, loss])
    vals = {"d": _x(8, (4, 3)), "s": _x(9, (3,)), "w": _x(10, (3,))}
    ex = g.bind(mx.cpu(), {k: mx.nd.array(v) for k, v in vals.items()},
                args_grad={k: mx.nd.zeros(v.shape) for k, v in vals.items()})
    outs = [o.asnumpy() for o in ex.forward(is_train=True)]
    ex.backward([mx.nd.zeros(o.shape) for o in outs[:-1]]
                + [mx.nd.ones(outs[-1].shape)])
    return outs + [ex.grad_dict[k].asnumpy() for k in sorted(vals)]


def test_symbolic_control_flow_matches_jax():
    """sym.contrib.foreach/while_loop/cond build the control-flow nodes
    (they raised until order step 8's execution part): values and
    gradients equal the JAX package's."""
    for g, w in zip(_sym_control_flow(tmx), _sym_control_flow(jmx)):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, **TOL)


# ---------------------------------------------------------------------------
# the slice's methods and functions against the JAX package
# ---------------------------------------------------------------------------

def _x(seed=0, shape=(3, 4, 5)):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


METHODS = [
    ("argmax", (), {"axis": 1}), ("argmin", (), {"axis": -1}),
    ("argsort", (), {"is_ascend": False}), ("broadcast_to", ((2, 3, 4, 5),),
                                            {}),
    ("ceil", (), {}), ("floor", (), {}), ("round", (), {}),
    ("flatten", (), {}), ("nansum", (), {"axis": 0}),
    ("norm", (), {"axis": 2}), ("prod", (), {"axis": 1}),
    ("repeat", (2,), {"axis": 1}), ("sigmoid", (), {}), ("sign", (), {}),
    ("tanh", (), {}), ("slice", ((0, 1), (2, 4)), {}),
    ("sort", (), {"axis": 1}), ("squeeze", (), {}),
    ("tile", ((1, 2, 1),), {}), ("topk", (), {"k": 2, "ret_typ": "both"}),
    ("split", (5,), {"axis": 2}), ("one_hot", (6,), {}),
    ("pad", ("constant", (0, 0, 0, 0, 1, 2)), {}),
]


@pytest.mark.parametrize("name,args,kwargs", METHODS)
def test_ndarray_methods_match_jax(name, args, kwargs):
    x = _x(1)
    if name == "one_hot":
        x = np.array([[0, 2, 5], [1, 1, 3]], np.float32)
    if name == "squeeze":
        x = x[:, :1]

    def run(mx):
        out = getattr(mx.nd.array(x), name)(*args, **kwargs)
        outs = out if isinstance(out, (list, tuple)) else [out]
        return [o.asnumpy() for o in outs]
    for g, w in zip(run(tmx), run(jmx)):
        assert g.shape == w.shape and g.dtype == w.dtype, name
        np.testing.assert_allclose(g, w, **TOL)


def test_ndarray_binary_methods_and_handles_match_jax():
    x, y = _x(2), _x(3, (3, 4, 5))

    def run(mx):
        a, b = mx.nd.array(x), mx.nd.array(y)
        return [a.reshape_like(b.reshape(3, 20)), a.broadcast_like(b),
                a.take(mx.nd.array([2, 0]), axis=1), a[0].dot(b[0].T),
                a % 0.7, 2.5 % (a.abs() + 0.5), a % (b.abs() + 0.5),
                a.as_nd_ndarray()]
    for g, w in zip(run(tmx), run(jmx)):
        np.testing.assert_allclose(g.asnumpy(), w.asnumpy(), **TOL)
    a = tmx.nd.array(x)
    assert a.handle is a._data
    a.wait_to_write()
    back = torch.utils.dlpack.from_dlpack(a.to_dlpack_for_read())
    np.testing.assert_array_equal(back.numpy(), x)


FUNCS = [
    ("arange", (2, 11, 1.5), {"repeat": 2}), ("linspace", (0, 1, 7), {}),
    ("eye", (4, 5, 1), {}), ("empty", ((2, 3),), {}),
]


@pytest.mark.parametrize("name,args,kwargs", FUNCS)
def test_nd_creation_functions_match_jax(name, args, kwargs):
    got = getattr(tmx.nd, name)(*args, **kwargs)
    want = getattr(jmx.nd, name)(*args, **kwargs)
    if name == "empty":
        assert got.shape == want.shape
        return
    np.testing.assert_allclose(got.asnumpy(), want.asnumpy(), **TOL)
    assert got.dtype == want.dtype


@pytest.mark.parametrize("name", [
    "add", "subtract", "multiply", "divide", "modulo", "power", "maximum",
    "minimum", "hypot", "equal", "not_equal", "greater", "greater_equal",
    "lesser", "lesser_equal", "logical_and", "logical_or", "logical_xor",
    "true_divide"])
def test_nd_binary_functions_match_jax(name):
    x, y = np.abs(_x(4)) + 0.5, np.abs(_x(5)) + 0.5
    x[0, 0] = y[0, 0]

    def run(mx):
        f = getattr(mx.nd, name)
        a, b = mx.nd.array(x), mx.nd.array(y)
        return [f(a, b), f(a, 1.5), f(1.5, b)]
    for g, w in zip(run(tmx), run(jmx)):
        np.testing.assert_allclose(g.asnumpy(), w.asnumpy(), **TOL)
    tmx.nd.waitall()


def test_moveaxis_matches_jax():
    x = _x(6, (2, 3, 4, 5))
    for src, dst in ((0, -1), ((0, 1), (2, 3)), (3, 1)):
        np.testing.assert_array_equal(
            tmx.nd.moveaxis(tmx.nd.array(x), src, dst).asnumpy(),
            jmx.nd.moveaxis(jmx.nd.array(x), src, dst).asnumpy())


def test_contrib_short_names_reach_the_contrib_ops():
    x = _x(7, (4, 6))
    for ns in (tmx.nd.contrib, tmx.nd.contrib):
        np.testing.assert_allclose(
            ns.div_sqrt_dim(tmx.nd.array(x)).asnumpy(),
            jmx.nd.contrib.div_sqrt_dim(jmx.nd.array(x)).asnumpy(), **TOL)
    got = tmx.nd.contrib.boolean_mask(tmx.nd.array(x),
                                      tmx.nd.array([0., 1., 1., 0.]))
    want = jmx.nd.contrib.boolean_mask(jmx.nd.array(x),
                                       jmx.nd.array([0., 1., 1., 0.]))
    np.testing.assert_array_equal(got.asnumpy(), want.asnumpy())
    assert tmx.sym.contrib.ctc_loss.__name__ == "_contrib_ctc_loss"


def _control_flow(mx):
    """foreach (a running sum with an output a step), while_loop (a
    doubling counter) and cond, with the gradient of a loss over all."""
    data = mx.nd.array(_x(8, (4, 3)))
    state = mx.nd.array(_x(9, (3,)))
    data.attach_grad()
    state.attach_grad()
    with mx.autograd.record():
        outs, final = mx.nd.contrib.foreach(
            lambda d, s: (d * s, s + d), data, state)
        wl_out, wl_vars = mx.nd.contrib.while_loop(
            lambda i, v: i < 3, lambda i, v: (v * 2, (i + 1, v * 2)),
            (mx.nd.array([0.]), final), max_iterations=5)
        pick = mx.nd.contrib.cond(final.sum() > 0, lambda: final * 3,
                                  lambda: final - 1)
        loss = outs.sum() + wl_out.sum() + wl_vars[1].sum() + pick.sum()
    loss.backward()
    return [outs, final, wl_out, wl_vars[0], wl_vars[1], pick, loss,
            data.grad, state.grad]


def test_nd_contrib_control_flow_matches_jax():
    for g, w in zip(_control_flow(tmx), _control_flow(jmx)):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.asnumpy(), w.asnumpy(), **TOL)


def _graph(mx):
    """A small graph through the slice's Symbol methods."""
    a = mx.sym.var("a", attr={"mood": "calm"})
    b = mx.sym.var("b")
    h = a.transpose((0, 2, 1)).flatten().expand_dims(1).slice_axis(2, 1, 7)
    out = mx.sym.FullyConnected(h.reshape((0, -1)), num_hidden=3,
                                no_bias=True, name="fc")
    return mx.sym.Group([out.dot(b, transpose_b=True), h]), a, out


def test_symbol_methods_match_jax():
    x, w, y = _x(10, (2, 4, 3)), _x(11, (3, 6)), _x(12, (5, 3))
    res = {}
    for mx in (tmx, jmx):
        g, a, fc = _graph(mx)
        ex = g.bind(mx.cpu(), {"a": mx.nd.array(x), "fc_weight":
                               mx.nd.array(w), "b": mx.nd.array(y)},
                    grad_req="null")
        res[mx] = ([o.asnumpy() for o in ex.forward()],
                   a.attr("mood"), a.list_attr(), fc.attr("num_hidden"),
                   fc.list_attr(), sorted(fc.get_children().list_outputs()),
                   a.get_children(), sorted(g.list_attr(recursive=True)))
    got, want = res[tmx], res[jmx]
    for g, w in zip(got[0], want[0]):
        np.testing.assert_allclose(g, w, **TOL)
    assert got[1:] == want[1:]


def test_sym_functions_match_jax():
    def run(mx):
        s = mx.sym
        a = s.var("a")
        g = s.Group([s.ones((2, 3)) + s.full((2, 3), 2.5), s.arange(1, 7, 2),
                     s.pow(a, 2), s.maximum(a, 0.5), s.minimum(a, a * 2),
                     s.hypot(a, a + 1), a % 0.7,
                     s.op.broadcast_add(a, s.zeros((2, 3)))])
        ex = g.bind(mx.cpu(), {"a": mx.nd.array(_x(13, (2, 3)))},
                    grad_req="null")
        return [o.asnumpy() for o in ex.forward()]
    for g, w in zip(run(tmx), run(jmx)):
        np.testing.assert_allclose(g, w, **TOL)


# ---------------------------------------------------------------------------
# chip_smoke.py phase 21's sweep table
# ---------------------------------------------------------------------------

def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_phase_21_sweeps_every_op_of_the_slice_and_each_case_runs():
    cs = _chip_smoke()
    swept = cs.ops_swept(tops)
    names = {n for ns in swept.values() for n in ns}
    # the int8 ops are the deploy path's: phase 28 (d) holds them on the
    # card and tests/test_torch_quantization.py against the JAX package;
    # Custom runs user Python: phase 29 (c) holds it on the card and
    # tests/test_torch_custom_op.py against the JAX package; the dgl ops
    # are host ops (DGL)
    slice_names = set(tops.list_ops()) - _EARLIER - QUANT - {"Custom"} \
        - DGL
    assert slice_names <= names, sorted(slice_names - names)
    assert STEP5 | STEP6 <= names
    rs = np.random.RandomState(0)
    cases = cs.ops_cases(rs, act=(2, 16, 12), spd=(2, 6), heads=2, vocab=40,
                         seq=8, width=12)
    assert set(swept) <= set(cases), sorted(set(swept) - set(cases))
    cpu = torch.device("cpu")
    for name in sorted(swept):
        for arrays, attrs, opts in cases[name]:
            grad = opts.get("grad", True)
            leaves = cs.op_leaves(arrays, cpu, grad)
            outs = cs.op_outputs(tops, name, leaves, attrs, cpu)
            assert outs, name
            if grad:
                grads = cs.op_grads(outs, leaves, [
                    torch.ones_like(o) if o.requires_grad else None
                    for o in outs])
                assert len(grads) == sum(
                    1 for a in arrays
                    if np.issubdtype(np.asarray(a).dtype, np.floating)), name


# the 149 op names the port registered before this slice
_EARLIER = {
    "Activation", "BatchNorm", "Cast", "Concat", "Convolution",
    "Deconvolution", "Dropout", "Embedding", "Flatten", "FullyConnected",
    "InstanceNorm", "LayerNorm", "LeakyReLU", "Pad", "Pooling", "RNN",
    "Reshape", "SequenceLast", "SequenceMask", "SequenceReverse",
    "SliceChannel", "Softmax", "SoftmaxOutput", "SwapAxis", "_add",
    "_contrib_adamw_update", "_contrib_decode_attention",
    "_contrib_flash_attention", "_contrib_group_adagrad_update",
    "_contrib_mp_adamw_update", "_copy", "_div", "_div_scalar",
    "_equal_scalar", "_greater_equal_scalar", "_greater_scalar",
    "_lesser_equal_scalar", "_lesser_scalar", "_maximum", "_minus",
    "_minus_scalar", "_mul", "_mul_scalar", "_not_equal_scalar", "_plus",
    "_plus_scalar", "_pow", "_power", "_power_scalar", "_random_exponential",
    "_random_gamma", "_random_generalized_negative_binomial",
    "_random_negative_binomial", "_random_normal", "_random_poisson",
    "_random_randint", "_random_uniform", "_rdiv_scalar", "_rminus_scalar",
    "_rpower_scalar", "_sample_exponential", "_sample_gamma",
    "_sample_generalized_negative_binomial", "_sample_multinomial",
    "_sample_negative_binomial", "_sample_normal", "_sample_poisson",
    "_sample_uniform", "_shuffle", "_sparse_adagrad_update", "_sub", "_zeros",
    "abs", "adagrad_update", "adam_update", "broadcast_add", "broadcast_div",
    "broadcast_equal", "broadcast_greater", "broadcast_greater_equal",
    "broadcast_lesser", "broadcast_lesser_equal", "broadcast_maximum",
    "broadcast_minus", "broadcast_mul", "broadcast_not_equal",
    "broadcast_plus", "broadcast_power", "broadcast_sub", "cast",
    "choose_element_0index", "clip", "concat", "dot", "elemwise_add",
    "elemwise_div", "elemwise_mul", "elemwise_sub", "exp", "expand_dims",
    "flatten", "flip", "ftml_update", "ftrl_update", "gather_nd", "log",
    "log_softmax", "max", "mean", "min", "mp_sgd_mom_update", "mp_sgd_update",
    "multi_mp_sgd_mom_update", "multi_mp_sgd_update", "multi_sgd_mom_update",
    "multi_sgd_update", "multinomial", "nag_mom_update", "negative", "norm",
    "ones_like", "pad", "pick", "relu", "reshape", "reshape_like", "reverse",
    "rmsprop_update", "rmspropalex_update", "sgd_mom_update", "sgd_update",
    "shuffle", "sigmoid", "signsgd_update", "signum_update", "slice_axis",
    "softmax", "softsign", "split", "sqrt", "square", "stack", "sum",
    "swapaxes", "tanh", "tile", "transpose", "where", "zeros_like",
}
