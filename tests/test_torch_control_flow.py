"""The port's control flow (``ops/control_flow.py``, ``sym.contrib``'s
``foreach``/``while_loop``/``cond``, ``nd.contrib``'s imperative forms)
against the JAX package's, on the CPU.

Every case of ``tests/test_control_flow.py`` runs in both packages with
the same inputs (numpy, from a seed): values and gradients at
``rtol=1e-5, atol=1e-6``. Added: the ``cond`` gradient where the untaken
branch is ``sqrt(0)`` (finite, the taken branch's alone), the masked
``while_loop``'s gradient (the port KEEPS the JAX package's masked-scan
gradient: NaN where a masked step's body has no finite derivative), a
``cond`` nested in a ``while_loop`` (a prompt, then doubling), the JSON
of each op loaded across the packages both ways, a plan drawing inside a
loop body (no predict graph; draws held by statistics), and BASELINE
config 3's LSTM LM written with ``foreach`` at toy width against the JAX
package: logits and every parameter's gradient."""
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
import mxnet_tpu_torch.cached_op as tco

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


def _np(x):
    if isinstance(x, (list, tuple)):
        return [_np(v) for v in x]
    return x.asnumpy() if hasattr(x, "asnumpy") else np.asarray(x)


def _flat(x):
    if isinstance(x, (list, tuple)):
        return [a for v in x for a in _flat(v)]
    return [x]


def _same(case, tol=TOL):
    """``case(mx)`` in both packages: the same arrays, shapes and values."""
    got, want = _flat(_np(case(tmx))), _flat(_np(case(jmx)))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, **tol)
    return got


# ---------------------------------------------------------------------------
# tests/test_control_flow.py, case by case in both packages
# ---------------------------------------------------------------------------

def _imp_cumsum(mx):
    data = mx.nd.array(np.arange(12).reshape(4, 3))

    def body(x, s):
        out = x + s
        return out, out
    return mx.nd.contrib.foreach(body, data, mx.nd.zeros((3,)))


def _imp_multi(mx):
    a = mx.nd.array(np.arange(6).reshape(3, 2))
    b = mx.nd.array(np.ones((3, 2)))

    def body(xs, states):
        x, y = xs
        u, v = states
        return [x + u, y * v], [x + u, y * v]
    return mx.nd.contrib.foreach(body, [a, b],
                                 [mx.nd.zeros((2,)), mx.nd.ones((2,))])


def _imp_grad(mx):
    data = mx.nd.array(np.arange(1, 7, dtype=np.float32).reshape(3, 2))
    w = mx.nd.array(np.array([2.0, 3.0], np.float32))
    w.attach_grad()
    with mx.autograd.record():
        outs, final = mx.nd.contrib.foreach(
            lambda x, s: (x * w + s, x * w + s), data, mx.nd.zeros((2,)))
        loss = final.sum()
    loss.backward()
    return outs, final, w.grad


def _imp_while(mx):
    return mx.nd.contrib.while_loop(
        lambda i, s: i < 5, lambda i, s: (s + i, [i + 1, s + i]),
        [mx.nd.array([0.0]), mx.nd.array([0.0])], max_iterations=8)


def _imp_cond(mx):
    x, y = mx.nd.array([3.0]), mx.nd.array([4.0])
    return [mx.nd.contrib.cond(x < y, lambda: x * 2, lambda: y * 2),
            mx.nd.contrib.cond(x > y, lambda: x * 2, lambda: y * 2)]


def _sym_cumsum(mx):
    outs, final = mx.sym.contrib.foreach(
        lambda x, s: (x + s, x + s), mx.sym.var("data"), mx.sym.var("init"))
    ex = mx.sym.Group([outs, final]).bind(
        mx.cpu(), {"data": mx.nd.array(np.arange(12).reshape(4, 3)),
                   "init": mx.nd.zeros((3,))})
    return ex.forward()


def _sym_free_grad(mx):
    w = mx.sym.var("w")
    outs, final = mx.sym.contrib.foreach(
        lambda x, s: (x * w + s, x * w + s), mx.sym.var("data"),
        mx.sym.var("init"))
    xv = np.arange(1, 7, dtype=np.float32).reshape(3, 2)
    ex = mx.sym.sum(final).bind(
        mx.cpu(), {"data": mx.nd.array(xv), "init": mx.nd.zeros((2,)),
                   "w": mx.nd.array([2.0, 3.0])},
        args_grad={"w": mx.nd.zeros((2,))})
    out = ex.forward(is_train=True)
    ex.backward()
    return out, ex.grad_dict["w"]


def _sym_rnn(mx):
    T, B, I, H = 5, 2, 3, 4
    wx, wh = mx.sym.var("wx"), mx.sym.var("wh")

    def step(x, h):
        h2 = mx.sym.tanh(mx.sym.dot(x, wx) + mx.sym.dot(h, wh))
        return h2, h2
    outs, _ = mx.sym.contrib.foreach(step, mx.sym.var("data"),
                                     mx.sym.var("h0"))
    rng = np.random.RandomState(0)
    vals = {"data": rng.randn(T, B, I).astype(np.float32),
            "h0": np.zeros((B, H), np.float32),
            "wx": rng.randn(I, H).astype(np.float32) * 0.5,
            "wh": rng.randn(H, H).astype(np.float32) * 0.5}
    ex = outs.bind(mx.cpu(), {k: mx.nd.array(v) for k, v in vals.items()})
    got = ex.forward()[0].asnumpy()
    h = vals["h0"]
    for t in range(T):
        h = np.tanh(vals["data"][t] @ vals["wx"] + h @ vals["wh"])
        np.testing.assert_allclose(got[t], h, rtol=1e-4, atol=1e-5)
    return got


def _sym_while(mx):
    outs, finals = mx.sym.contrib.while_loop(
        lambda i, s: i < 5, lambda i, s: (s + i, [i + 1, s + i]),
        [mx.sym.var("i0"), mx.sym.var("s0")], max_iterations=8)
    ex = mx.sym.Group([outs] + finals).bind(
        mx.cpu(), {"i0": mx.nd.array([0.0]), "s0": mx.nd.array([0.0])})
    return ex.forward()


def _sym_cond(mx):
    a, b = mx.sym.var("a"), mx.sym.var("b")
    out = mx.sym.contrib.cond(mx.sym.sum(a) < mx.sym.sum(b),
                              lambda: a * 2, lambda: b * 3)
    res = []
    for av, bv in (([1.0, 2.0], [5.0, 5.0]), ([9.0, 9.0], [1.0, 1.0])):
        ex = out.bind(mx.cpu(), {"a": mx.nd.array(av),
                                 "b": mx.nd.array(bv)})
        res.append(ex.forward()[0])
    return res


def _sym_json(mx):
    outs, final = mx.sym.contrib.foreach(
        lambda x, s: (x + s, x + s), mx.sym.var("data"), mx.sym.var("init"))
    g2 = mx.sym.load_json(mx.sym.Group([outs, final]).tojson())
    ex = g2.bind(mx.cpu(), {
        "data": mx.nd.array(np.arange(6, dtype=np.float32).reshape(3, 2)),
        "init": mx.nd.zeros((2,))})
    return ex.forward()


def _rng_while(mx):
    outs, finals = mx.sym.contrib.while_loop(
        lambda i: mx.sym.sum(mx.sym.Dropout(i, p=0.0)) < 3,
        lambda i: (mx.sym.Dropout(i, p=0.0), [i + 1]),
        [mx.sym.var("i0")], max_iterations=5)
    ex = mx.sym.Group([outs] + finals).bind(mx.cpu(),
                                            {"i0": mx.nd.array([0.0])})
    return ex.forward()


def _rng_cond(mx):
    a = mx.sym.var("a")
    out = mx.sym.contrib.cond(mx.sym.sum(mx.sym.Dropout(a, p=0.0)) > 0,
                              lambda: a * 2, lambda: a * 3)
    return out.bind(mx.cpu(), {"a": mx.nd.array([1.0])}).forward()


JAX_CASES = {
    "imperative_foreach_cumsum_states": _imp_cumsum,
    "imperative_foreach_multi_data_multi_state": _imp_multi,
    "imperative_foreach_grad_flows": _imp_grad,
    "imperative_while_loop_accumulate_until": _imp_while,
    "imperative_cond_branches": _imp_cond,
    "symbolic_foreach_cumsum_matches_imperative": _sym_cumsum,
    "symbolic_foreach_free_variable_and_grad": _sym_free_grad,
    "symbolic_foreach_rnn_style_scan": _sym_rnn,
    "symbolic_while_loop_matches_imperative": _sym_while,
    "symbolic_cond_both_branches_compile_one_runs": _sym_cond,
    "serialization_foreach_json_roundtrip": _sym_json,
    "rng_dropout_in_while_cond_and_body": _rng_while,
    "rng_dropout_in_cond_pred": _rng_cond,
}


@pytest.mark.parametrize("name", sorted(JAX_CASES))
def test_case_of_the_jax_suite_matches_jax(name):
    _same(JAX_CASES[name])


def test_imperative_while_loop_zero_steps_raises_in_both():
    for mx in (tmx, jmx):
        with pytest.raises(mx.base.MXNetError, match="zero steps"):
            mx.nd.contrib.while_loop(
                lambda i: i < 0, lambda i: (i, [i + 1]),
                [mx.nd.array([5.0])], max_iterations=3)


def test_values_of_the_jax_suite_hold():
    """The JAX suite's literal values, on the port."""
    o, f = _sym_cumsum(tmx)
    want = np.cumsum(np.arange(12).reshape(4, 3), axis=0)
    np.testing.assert_allclose(o.asnumpy(), want)
    np.testing.assert_allclose(f.asnumpy(), want[-1])
    o, i_f, s_f = _sym_while(tmx)
    np.testing.assert_allclose(o.asnumpy().ravel(), [0, 1, 3, 6, 10, 0, 0, 0])
    assert float(i_f.asnumpy()[0]) == 5.0 and float(s_f.asnumpy()[0]) == 10.0
    _, i_f = _rng_while(tmx)
    assert float(i_f.asnumpy()[0]) == 3.0
    assert float(_rng_cond(tmx)[0].asnumpy()[0]) == 2.0
    _, grad = _sym_free_grad(tmx)
    np.testing.assert_allclose(
        grad.asnumpy(), np.arange(1, 7, dtype=np.float32).reshape(3, 2)
        .sum(0))


# ---------------------------------------------------------------------------
# gradients at the edges, nesting, JSON across the packages
# ---------------------------------------------------------------------------

def _cond_sqrt0(mx):
    x = mx.sym.var("x")
    c = mx.sym.contrib.cond(mx.sym.sum(x) > 0, lambda: mx.sym.sqrt(x),
                            lambda: x * 0)
    ex = mx.sym.sum(c).bind(mx.cpu(), {"x": mx.nd.zeros((2,))},
                            args_grad={"x": mx.nd.zeros((2,))})
    out = ex.forward(is_train=True)
    ex.backward()
    return out, ex.grad_dict["x"]


def test_cond_gradient_is_the_taken_branch_alone():
    """At x = [0, 0] the untaken branch is sqrt(0): the JAX package's
    lax.cond gives [0, 0]; the port's selected VJPs give the same,
    finite (a plain torch.where over both branches gives NaN)."""
    got = _same(_cond_sqrt0)
    np.testing.assert_array_equal(got[1], [0.0, 0.0])
    x = tmx.nd.zeros((2,))
    x.attach_grad()
    with tmx.autograd.record():
        y = tmx.nd.where(x.sum() > 0, x.sqrt(), x * 0).sum()
    y.backward()
    assert np.isnan(x.grad.asnumpy()).all()


def test_cond_gradients_both_ways_match_jax():
    def case(mx):
        a, w = mx.sym.var("a"), mx.sym.var("w")
        out = mx.sym.contrib.cond(mx.sym.sum(a) > 0,
                                  lambda: mx.sym.tanh(a * w),
                                  lambda: a * a + w)
        res = []
        for sign in (1.0, -1.0):
            av = sign * (np.abs(np.random.RandomState(3).randn(4)) + 0.1)
            vals = {"a": av.astype(np.float32),
                    "w": np.random.RandomState(4).randn(4).astype(np.float32)}
            ex = mx.sym.sum(out).bind(
                mx.cpu(), {k: mx.nd.array(v) for k, v in vals.items()},
                args_grad={k: mx.nd.zeros((4,)) for k in vals})
            res.append(ex.forward(is_train=True)[0])
            ex.backward()
            res += [ex.grad_dict["a"], ex.grad_dict["w"]]
        return res
    _same(case)


def _masked_tail(mx):
    s = mx.sym.var("s")
    outs, _ = mx.sym.contrib.while_loop(
        lambda s: s < 2.5, lambda s: (mx.sym.sqrt(3 - s), [s + 1]),
        [s], max_iterations=5)
    ex = mx.sym.sum(outs).bind(mx.cpu(), {"s": mx.nd.zeros((1,))},
                               args_grad={"s": mx.nd.zeros((1,))})
    out = ex.forward(is_train=True)
    ex.backward()
    return out, ex.grad_dict["s"]


def test_while_loop_masked_tail_gradient_is_kept():
    """KEEP: the port runs the JAX package's masked scan and has its
    gradient. The two masked steps evaluate sqrt(3 - 3) = sqrt(0), whose
    derivative is infinite, and a zero gradient times it is NaN: the
    value is 4.146264 and the gradient NaN in both packages."""
    got, want = _np(_masked_tail(tmx)), _np(_masked_tail(jmx))
    np.testing.assert_allclose(got[0], want[0], **TOL)
    np.testing.assert_allclose(got[0], [4.146264], rtol=1e-6)
    assert np.isnan(got[1]).all() and np.isnan(want[1]).all()


def _nested(mx):
    """while_loop over (i, prev): the token is the prompt's while i < 3,
    then the previous token doubled, by a cond in the body; 6 live steps
    of 8."""
    prompt = mx.sym.var("prompt")

    def body(i, prev):
        tok = mx.sym.contrib.cond(
            i < 3, lambda: mx.sym.take(prompt, i), lambda: prev * 2)
        return tok, [i + 1, tok]
    outs, _ = mx.sym.contrib.while_loop(
        lambda i, prev: i < mx.sym.var("n_steps"), body,
        [mx.sym.var("i0"), mx.sym.var("p0")], max_iterations=8)
    ex = outs.bind(mx.cpu(), {"prompt": mx.nd.array([5.0, 6.0, 7.0]),
                              "n_steps": mx.nd.array([6.0]),
                              "i0": mx.nd.zeros((1,)),
                              "p0": mx.nd.zeros((1,))})
    return ex.forward()


def test_cond_nested_in_while_loop_gives_the_probe():
    got = _same(_nested)
    np.testing.assert_array_equal(got[0].ravel(),
                                  [5, 6, 7, 14, 28, 56, 0, 0])


def _graphs(mx):
    """One graph per op: foreach with a free weight, while_loop with a
    free bound, cond with a free branch input."""
    w = mx.sym.var("w")
    fe, _ = mx.sym.contrib.foreach(
        lambda x, s: (mx.sym.tanh(x * w + s), mx.sym.tanh(x * w + s)),
        mx.sym.var("d"), mx.sym.var("s"))
    wl, _ = mx.sym.contrib.while_loop(
        lambda i, v: i < mx.sym.var("n"),
        lambda i, v: (v * w, [i + 1, v * w + 1]),
        [mx.sym.var("i"), mx.sym.var("s")], max_iterations=4)
    cd = mx.sym.contrib.cond(mx.sym.sum(mx.sym.var("s")) > 0,
                             lambda: mx.sym.var("s") * w,
                             lambda: mx.sym.var("s") - w)
    return {"_foreach": fe, "_while_loop": wl, "_cond": cd}


_VALS = {"d": np.random.RandomState(5).randn(3, 4).astype(np.float32),
         "s": np.random.RandomState(6).randn(4).astype(np.float32),
         "w": np.random.RandomState(7).randn(4).astype(np.float32),
         "i": np.zeros((1,), np.float32), "n": np.array([2.0], np.float32)}


def _run(mx, sym):
    args = {n: mx.nd.array(_VALS[n]) for n in sym.list_arguments()}
    return sym.bind(mx.cpu(), args).forward()[0].asnumpy()


@pytest.mark.parametrize("op", ["_foreach", "_while_loop", "_cond"])
@pytest.mark.parametrize("way", ["jax_to_port", "port_to_jax"])
def test_json_loads_across_the_packages(op, way):
    src, dst = (jmx, tmx) if way == "jax_to_port" else (tmx, jmx)
    sym = _graphs(src)[op]
    text = sym.tojson()
    assert "__subgraph__:" in text
    loaded = dst.sym.load_json(text)
    assert [n["op"] for n in __import__("json").loads(loaded.tojson())[
        "nodes"]].count(op) == 1
    np.testing.assert_allclose(_run(dst, loaded), _run(src, sym), **TOL)


# ---------------------------------------------------------------------------
# random draws in a loop body
# ---------------------------------------------------------------------------

def _standin(body, device, pool):
    out = body()

    def replay():
        for o, r in zip(out, body()):
            o.copy_(r)
    return replay, out, {}


def test_dropout_always_in_a_loop_body_takes_no_predict_graph():
    """A body that draws in predict mode (``Dropout(mode="always")``)
    makes the node draw: the executor's predict run goes op by op,
    counted as ``eager_rng``, and each step draws anew (held by
    statistics: the kept share near 1 - p, the steps' masks differ)."""
    w = tmx.sym.var("w")
    outs, _ = tmx.sym.contrib.foreach(
        lambda x, s: (tmx.sym.Dropout(x * w, p=0.5, mode="always"), s),
        tmx.sym.var("d"), tmx.sym.var("s"))
    node_op = tmx.ops.get_op("_foreach")
    attrs = tmx.ops.normalize_attrs(node_op, outs.list_attr())
    assert node_op.draws_in(attrs, False)
    ex = outs.bind(tmx.cpu(), {"d": tmx.nd.ones((6, 4000)),
                               "s": tmx.nd.zeros((1,)),
                               "w": tmx.nd.ones((4000,))})
    ex.graphs = tco._Graphs("cpu", capture=_standin)
    a = ex.forward()[0].asnumpy()
    b = ex.forward()[0].asnumpy()
    st = ex.stats()
    assert st["eager_rng"] == 2 and st["captures"] == 0
    kept = (a != 0).mean()
    assert abs(kept - 0.5) < 0.02, kept
    assert set(np.unique(a)) <= {0.0, 2.0}
    assert not np.array_equal(a[0], a[1])       # steps draw anew
    assert not np.array_equal(a, b)             # so do calls
    # a body without a draw keeps the graph
    plain, _ = tmx.sym.contrib.foreach(lambda x, s: (x * w, s),
                                       tmx.sym.var("d"), tmx.sym.var("s"))
    ex = plain.bind(tmx.cpu(), {"d": tmx.nd.ones((2, 3)),
                                "s": tmx.nd.zeros((1,)),
                                "w": tmx.nd.ones((3,))})
    ex.graphs = tco._Graphs("cpu", capture=_standin)
    ex.forward()
    ex.forward()
    assert ex.stats()["captures"] == 1 and ex.stats()["replays"] == 2


def test_body_with_auxiliary_states_raises():
    with pytest.raises(tmx.MXNetError, match="auxiliary"):
        tmx.sym.contrib.foreach(
            lambda x, s: (tmx.sym.BatchNorm(x, name="bn"), s),
            tmx.sym.var("d"), tmx.sym.var("s"))


# ---------------------------------------------------------------------------
# BASELINE config 3's LM written with foreach, at toy width
# ---------------------------------------------------------------------------

LM_V, LM_H, LM_LAYERS, LM_B = 50, 8, 2, 3


def lm_foreach_sym(mx, seq_len):
    """Config 3's LM (Embedding, 2 x LSTMCell, FC, SoftmaxOutput with
    ignore_label 0) with its time loop as ONE foreach node: the cells are
    called once in the body, so the parameters bind by the unrolled LM's
    names."""
    data = mx.sym.var("data")
    label = mx.sym.var("softmax_label")
    embed = mx.sym.Embedding(data=data, input_dim=LM_V, output_dim=LM_H,
                             name="embed")
    cell = mx.rnn.SequentialRNNCell()
    for i in range(LM_LAYERS):
        cell.add(mx.rnn.LSTMCell(num_hidden=LM_H, prefix="lstm_l%d_" % i))
    steps = mx.sym.SwapAxis(embed, dim1=0, dim2=1)          # (T, B, E)
    first = mx.sym.Reshape(mx.sym.slice_axis(steps, axis=0, begin=0, end=1),
                           shape=(-3, -1))
    outs, _ = mx.sym.contrib.foreach(
        lambda x, states: cell(x, states), steps,
        cell.begin_state(x=first), name="lstm_foreach")
    outs = mx.sym.SwapAxis(outs, dim1=0, dim2=1)            # (B, T, H)
    pred = mx.sym.FullyConnected(mx.sym.Reshape(outs, shape=(-1, LM_H)),
                                 num_hidden=LM_V, name="pred")
    return mx.sym.SoftmaxOutput(data=pred,
                                label=mx.sym.Reshape(label, shape=(-1,)),
                                name="softmax", use_ignore=True,
                                ignore_label=0)


def _lm_shapes(seq_len):
    """The LM's argument shapes: the port infers the cells' weights
    through the foreach node's subgraph; the JAX package is given them."""
    sym = lm_foreach_sym(tmx, seq_len)
    shapes, _, _ = sym.infer_shape(data=(LM_B, seq_len),
                                   softmax_label=(LM_B, seq_len))
    return dict(zip(sym.list_arguments(), shapes))


def test_shapes_of_loop_body_parameters_are_inferred():
    shapes = _lm_shapes(5)
    assert shapes["lstm_l0_i2h_weight"] == (4 * LM_H, LM_H)
    assert shapes["lstm_l1_h2h_bias"] == (4 * LM_H,)
    assert shapes["pred_weight"] == (LM_V, LM_H)
    jsym = lm_foreach_sym(jmx, 5)
    got = jsym.infer_shape(**shapes)[1]
    assert got == lm_foreach_sym(tmx, 5).infer_shape(**shapes)[1]


def _lm_params(seq_len):
    rs = np.random.RandomState(11)
    shapes = _lm_shapes(seq_len)
    vals = {}
    for n, s in shapes.items():
        if n == "data":
            vals[n] = rs.randint(0, LM_V, s).astype(np.float32)
        elif n == "softmax_label":
            lab = rs.randint(1, LM_V, s).astype(np.float32)
            lab[:, -2:] = 0                          # padded tails
            vals[n] = lab
        else:
            vals[n] = (rs.randn(*s) * 0.3).astype(np.float32)
    return vals


def _lm_run(mx, seq_len, vals):
    sym = lm_foreach_sym(mx, seq_len)
    params = [n for n in sym.list_arguments()
              if n not in ("data", "softmax_label")]
    ex = sym.bind(mx.cpu(), {k: mx.nd.array(v) for k, v in vals.items()},
                  args_grad={n: mx.nd.zeros(vals[n].shape) for n in params})
    probs = ex.forward(is_train=True)[0].asnumpy()
    ex.backward()
    grads = {n: ex.grad_dict[n].asnumpy() for n in params}
    logits = sym.get_internals()["pred_output"].bind(
        mx.cpu(), {k: mx.nd.array(v) for k, v in vals.items()
                   if k != "softmax_label"}).forward()[0].asnumpy()
    return sorted(params), logits, probs, grads


@pytest.mark.parametrize("bucket", [5, 10])
def test_foreach_lm_logits_and_gradients_match_jax(bucket):
    vals = _lm_params(bucket)
    tp, tl, tprob, tg = _lm_run(tmx, bucket, vals)
    jp, jl, jprob, jg = _lm_run(jmx, bucket, vals)
    assert tp == jp and "lstm_l1_h2h_weight" in tp and len(tp) == 11
    np.testing.assert_allclose(tl, jl, **TOL)
    np.testing.assert_allclose(tprob, jprob, **TOL)
    for n in tp:
        np.testing.assert_allclose(tg[n], jg[n], rtol=1e-5, atol=1e-6,
                                   err_msg=n)


def test_foreach_lm_equals_the_unrolled_lm():
    """The foreach LM and phase 19's unrolled LM (cell.unroll) from the
    same weights: the same probabilities and gradients."""
    vals = _lm_params(5)
    _, _, probs, grads = _lm_run(tmx, 5, vals)
    label = tmx.sym.var("softmax_label")
    cell = tmx.rnn.SequentialRNNCell()
    for i in range(LM_LAYERS):
        cell.add(tmx.rnn.LSTMCell(num_hidden=LM_H, prefix="lstm_l%d_" % i))
    embed = tmx.sym.Embedding(data=tmx.sym.var("data"), input_dim=LM_V,
                              output_dim=LM_H, name="embed")
    outs, _ = cell.unroll(5, inputs=embed, merge_outputs=True)
    pred = tmx.sym.FullyConnected(tmx.sym.Reshape(outs, shape=(-1, LM_H)),
                                  num_hidden=LM_V, name="pred")
    sym = tmx.sym.SoftmaxOutput(
        data=pred, label=tmx.sym.Reshape(label, shape=(-1,)),
        name="softmax", use_ignore=True, ignore_label=0)
    ex = sym.bind(tmx.cpu(), {k: tmx.nd.array(v) for k, v in vals.items()},
                  args_grad={n: tmx.nd.zeros(vals[n].shape) for n in grads})
    np.testing.assert_allclose(ex.forward(is_train=True)[0].asnumpy(),
                               probs, **TOL)
    ex.backward()
    for n in grads:
        np.testing.assert_allclose(ex.grad_dict[n].asnumpy(), grads[n],
                                   rtol=1e-5, atol=1e-6, err_msg=n)


def test_gluon_hybrid_forward_reaches_both_forms():
    """``F.contrib.foreach`` is ``nd.contrib``'s when the block runs
    eagerly and ``sym.contrib``'s when hybridized: the same outputs, the
    Dense weight a free input of the node with its gradient."""
    class Net(tmx.gluon.HybridBlock):
        def __init__(self):
            super().__init__()
            self.dense = tmx.gluon.nn.Dense(3, in_units=3, prefix="d_")

        def hybrid_forward(self, F, x, s):
            outs, last = F.contrib.foreach(
                lambda t, st: (F.tanh(self.dense(t) + st),
                               F.tanh(self.dense(t) + st)), x, s)
            return outs + F.broadcast_add(last, F.zeros((1, 3)))

    x = tmx.nd.array(np.random.RandomState(2).randn(4, 2, 3)
                     .astype(np.float32))
    s = tmx.nd.zeros((2, 3))
    net = Net()
    net.initialize(tmx.init.Xavier())
    res = []
    for hybrid in (False, True):
        if hybrid:
            net.hybridize()
        with tmx.autograd.record():
            y = net(x, s)
            loss = (y * y).sum()
        loss.backward()
        res.append((y.asnumpy(), net.dense.weight.grad().asnumpy().copy()))
    np.testing.assert_allclose(res[1][0], res[0][0], **TOL)
    np.testing.assert_allclose(res[1][1], res[0][1], **TOL)
