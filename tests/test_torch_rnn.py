"""Port parity: the RNN path (the ``RNN`` op, ``mx.rnn``'s symbolic cells,
``gluon.rnn``'s cells and layers) against ``mxnet_tpu``, on the CPU.

The same numpy-seeded inputs and parameters go through both packages.
The ``RNN`` op's outputs are held to the JAX op's within ``TOL`` and its
gradients (of a sum of squares of every output) to ``jax.vjp``'s within
``GRAD_TOL``: both run the same fp32 products and gate arithmetic, in
another summation order (a ``lax.scan`` body against torch's loop), and
the gradients accumulate over T steps and two layers. The symbolic and
Gluon cells, which compose registered ops, are held to the same
tolerances; the fused cell equals the unrolled stack as in
``tests/test_rnn.py``, and the synthetic-corpus LM converges through
``BucketingModule`` as there.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu.ops.registry import get_op as jax_op
from mxnet_tpu_torch.ops.registry import get_op as port_op
from mxnet_tpu_torch.ops.rnn_op import param_size

TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(autouse=True)
def _port_on_cpu(monkeypatch):
    monkeypatch.setenv("MXNET_DEFAULT_CONTEXT", "cpu")
    monkeypatch.setenv("MXNET_DATA_PIPELINE", "0")


@pytest.fixture(autouse=True)
def _fresh_names():
    from mxnet_tpu.name import NameManager as JaxNames
    from mxnet_tpu_torch.name import NameManager as PortNames
    with JaxNames(), PortNames():
        yield


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), **tol)


# ---------------------------------------------------------------------------
# the RNN op
# ---------------------------------------------------------------------------

def _op_inputs(mode, L, bi, T=5, N=3, I=4, H=6, seed=0):
    rng = np.random.RandomState(seed)
    D = 2 if bi else 1
    ins = [rng.randn(T, N, I).astype(np.float32),
           (rng.randn(param_size(mode, L, bi, I, H)) * 0.3)
           .astype(np.float32),
           rng.randn(L * D, N, H).astype(np.float32)]
    if mode == "lstm":
        ins.append(rng.randn(L * D, N, H).astype(np.float32))
    attrs = dict(state_size=H, num_layers=L, bidirectional=bi, mode=mode,
                 state_outputs=True, p=0.0)
    return attrs, ins


@pytest.mark.parametrize("bi", [False, True], ids=["uni", "bi"])
@pytest.mark.parametrize("layers", [1, 2])
@pytest.mark.parametrize("mode", ["lstm", "gru", "rnn_tanh", "rnn_relu"])
def test_rnn_op_matches_jax(mode, layers, bi):
    import torch
    attrs, ins = _op_inputs(mode, layers, bi)

    def jloss(*a):
        outs = jax_op("RNN").forward(dict(attrs), *a)
        return sum(jnp.sum(o * o) for o in outs), outs
    (_, jouts), jgrads = jax.value_and_grad(
        jloss, argnums=tuple(range(len(ins))), has_aux=True)(
        *[jnp.asarray(a) for a in ins])
    leaves = [torch.tensor(a, requires_grad=True) for a in ins]
    touts = port_op("RNN").forward(dict(attrs), *leaves)
    assert len(touts) == len(jouts) == (3 if mode == "lstm" else 2)
    for j, t in zip(jouts, touts):
        assert tuple(t.shape) == j.shape
        _close(t.detach().numpy(), j)
    sum((o * o).sum() for o in touts).backward()
    for j, t in zip(jgrads, leaves):
        _close(t.grad.numpy(), j, GRAD_TOL)


def test_rnn_op_single_output_and_param_views():
    import torch
    attrs, ins = _op_inputs("lstm", 2, False)
    attrs["state_outputs"] = False
    params = torch.tensor(ins[1], requires_grad=True)
    outs = port_op("RNN").forward(
        dict(attrs), torch.tensor(ins[0]), params, torch.tensor(ins[2]),
        torch.tensor(ins[3]))
    assert len(outs) == 1 and tuple(outs[0].shape) == (5, 3, 6)
    outs[0].sum().backward()
    # the weights are views of the flat vector: one gradient tensor
    assert params.grad.shape == params.shape
    assert float(params.grad.abs().sum()) > 0


def test_rnn_op_dropout_only_between_layers_in_training():
    import torch
    attrs, ins = _op_inputs("lstm", 2, False)
    plain = port_op("RNN").forward(dict(attrs),
                                   *[torch.tensor(a) for a in ins])
    dropped = dict(attrs, p=0.5)
    predict = port_op("RNN").forward(dict(dropped, __train__=False),
                                     *[torch.tensor(a) for a in ins])
    for a, b in zip(plain, predict):
        assert torch.equal(a, b)
    gen = torch.Generator().manual_seed(3)
    train = port_op("RNN").forward(dict(dropped, __train__=True),
                                   *[torch.tensor(a) for a in ins], rng=gen)
    assert not torch.equal(plain[0], train[0])
    # the first layer's states never see the mask
    assert torch.equal(plain[1][0], train[1][0])
    assert torch.equal(plain[2][0], train[2][0])
    op = port_op("RNN")
    assert op.draws_in(dict(dropped), True)
    assert not op.draws_in(dict(dropped), False)
    assert not op.draws_in(dict(dropped, num_layers=1), True)


def test_rnn_op_registration_matches_jax():
    j, t = jax_op("RNN"), port_op("RNN")
    assert t.defaults == j.defaults
    assert t.arg_names == j.arg_names
    for attrs in ({"mode": "lstm"}, {"mode": "gru"}):
        assert t.resolve_arg_names(attrs) == j.resolve_arg_names(attrs)


# ---------------------------------------------------------------------------
# symbolic cells (mx.rnn)
# ---------------------------------------------------------------------------

def _run_symbol(mx, group, args):
    """Forward in training mode and the gradient of every output's sum of
    squares (head gradients 2*out), as numpy."""
    ctx = mx.cpu()
    nd_args = {k: mx.nd.array(v) for k, v in args.items()}
    grads = {k: mx.nd.zeros(v.shape) for k, v in args.items()}
    ex = group.bind(ctx, nd_args, args_grad=grads)
    outs = [o.asnumpy() for o in ex.forward(is_train=True)]
    ex.backward(out_grads=[mx.nd.array(2 * o) for o in outs])
    return outs, {k: g.asnumpy() for k, g in ex.grad_dict.items()
                  if g is not None}


def _symbolic_case(mx, kind):
    """One cell configuration of ``kind``, unrolled over a (B, T, I)
    input; returns (Group of outputs + final states, T)."""
    T, H = 4, 5
    data = mx.sym.var("data")
    rnn = mx.rnn
    if kind == "rnn":
        cell = rnn.RNNCell(H, prefix="rnn_")
    elif kind == "lstm":
        cell = rnn.LSTMCell(H, prefix="lstm_")
    elif kind == "gru":
        cell = rnn.GRUCell(H, prefix="gru_")
    elif kind == "stack":
        cell = rnn.SequentialRNNCell()
        cell.add(rnn.LSTMCell(H, prefix="lstm_l0_"))
        cell.add(rnn.LSTMCell(H, prefix="lstm_l1_"))
    elif kind == "bidirectional":
        cell = rnn.BidirectionalCell(rnn.GRUCell(H, prefix="l_"),
                                     rnn.GRUCell(H, prefix="r_"))
    elif kind == "residual":
        cell = rnn.ResidualCell(rnn.RNNCell(3, prefix="res_"))
    elif kind == "modifiers":
        cell = rnn.SequentialRNNCell()
        cell.add(rnn.ZoneoutCell(rnn.LSTMCell(H, prefix="z_"),
                                 zoneout_outputs=0.3, zoneout_states=0.2))
        cell.add(rnn.DropoutCell(0.4))
    elif kind == "fused_lstm":
        cell = rnn.FusedRNNCell(H, num_layers=2, mode="lstm",
                                prefix="f_", get_next_state=True)
    elif kind == "fused_gru_bi":
        cell = rnn.FusedRNNCell(H, num_layers=1, mode="gru",
                                bidirectional=True, prefix="g_",
                                get_next_state=True)
    else:
        raise ValueError(kind)
    outs, states = cell.unroll(T, data, layout="NTC", merge_outputs=True)
    return mx.sym.Group([outs] + list(states)), T


SYMBOLIC = ["rnn", "lstm", "gru", "stack", "bidirectional", "residual",
            "fused_lstm", "fused_gru_bi"]


@pytest.mark.parametrize("kind", SYMBOLIC)
def test_symbolic_cell_unroll_matches_jax(kind):
    B, I = 2, 3
    jgroup, T = _symbolic_case(jmx, kind)
    tgroup, _ = _symbolic_case(tmx, kind)
    assert tgroup.list_arguments() == jgroup.list_arguments()
    assert tgroup.list_outputs() == jgroup.list_outputs()
    shapes, _, _ = jgroup.infer_shape(data=(B, T, I))
    tshapes, _, _ = tgroup.infer_shape(data=(B, T, I))
    assert [tuple(s) for s in tshapes] == [tuple(s) for s in shapes]
    rng = np.random.RandomState(1)
    args = {n: (rng.randn(*s) * 0.4).astype(np.float32)
            for n, s in zip(jgroup.list_arguments(), shapes)}
    jouts, jgrads = _run_symbol(jmx, jgroup, args)
    touts, tgrads = _run_symbol(tmx, tgroup, args)
    for j, t in zip(jouts, touts):
        _close(t, j)
    assert set(tgrads) == set(jgrads)
    for name in jgrads:
        _close(tgrads[name], jgrads[name], GRAD_TOL)


def test_modifier_cells_in_predict_mode_match_jax():
    """Zoneout and Dropout draw only in training: in predict mode both
    packages give the plain cell's outputs."""
    B, I = 2, 3
    jgroup, T = _symbolic_case(jmx, "modifiers")
    tgroup, _ = _symbolic_case(tmx, "modifiers")
    shapes, _, _ = jgroup.infer_shape(data=(B, T, I))
    rng = np.random.RandomState(2)
    args = {n: (rng.randn(*s) * 0.4).astype(np.float32)
            for n, s in zip(jgroup.list_arguments(), shapes)}
    outs = []
    for mx, group in ((jmx, jgroup), (tmx, tgroup)):
        ex = group.bind(mx.cpu(), {k: mx.nd.array(v)
                                   for k, v in args.items()})
        outs.append([o.asnumpy() for o in ex.forward(is_train=False)])
    for j, t in zip(*outs):
        _close(t, j)


def test_fused_matches_unfused_lstm():
    """FusedRNNCell (the RNN op) == the explicit LSTMCell unroll
    (tests/test_rnn.py::test_fused_matches_unfused_lstm in the port)."""
    mx = tmx
    T, B, I, H = 4, 2, 3, 5
    rng = np.random.RandomState(3)
    x = rng.randn(B, T, I).astype(np.float32)
    wi = rng.randn(4 * H, I).astype(np.float32) * 0.3
    wh = rng.randn(4 * H, H).astype(np.float32) * 0.3
    bi = rng.randn(4 * H).astype(np.float32) * 0.1
    bh = rng.randn(4 * H).astype(np.float32) * 0.1
    data = mx.sym.var("data")
    fused = mx.rnn.FusedRNNCell(H, mode="lstm", prefix="fused_")
    f_out, _ = fused.unroll(T, data, layout="NTC", merge_outputs=True)
    pvec = np.concatenate([wi.ravel(), wh.ravel(), bi, bh])
    got = f_out.bind(mx.cpu(), {"data": mx.nd.array(x),
                                "fused_parameters": mx.nd.array(pvec)}) \
        .forward()[0].asnumpy()
    cell = mx.rnn.LSTMCell(H, forget_bias=0.0, prefix="ref_")
    r_out, _ = cell.unroll(T, data, layout="NTC", merge_outputs=True)
    want = r_out.bind(mx.cpu(), {"data": mx.nd.array(x),
                                 "ref_i2h_weight": mx.nd.array(wi),
                                 "ref_h2h_weight": mx.nd.array(wh),
                                 "ref_i2h_bias": mx.nd.array(bi),
                                 "ref_h2h_bias": mx.nd.array(bh)}) \
        .forward()[0].asnumpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("cell_fn, want", [
    (lambda mx: mx.rnn.FusedRNNCell(8, mode="lstm", prefix="f_"),
     (1, 4, 8)),
    (lambda mx: mx.rnn.LSTMCell(6, prefix="s_"), (4, 6))],
    ids=["fused", "step"])
def test_begin_state_batch_axis(cell_fn, want):
    """batch_size lands on the N axis of each state's layout, as in
    tests/test_rnn.py::TestBeginState; the states are ``_zeros`` ops."""
    states = cell_fn(tmx).begin_state(func=tmx.sym.zeros, batch_size=4)
    shapes = tmx.sym.Group(states).infer_shape()[1]
    assert all(tuple(s) == want for s in shapes), shapes
    ex = tmx.sym.Group(states).bind(tmx.cpu(), {})
    assert all(float(o.asnumpy().sum()) == 0 for o in ex.forward())


def test_unroll_length_one_tnc():
    cell = tmx.rnn.RNNCell(4, prefix="u1_")
    outs, _ = cell.unroll(1, tmx.sym.var("data"), layout="TNC",
                          merge_outputs=True)
    rng = np.random.RandomState(0)
    args = {"data": tmx.nd.array(rng.randn(1, 3, 2).astype(np.float32)),
            "u1_i2h_weight": tmx.nd.array(
                rng.randn(4, 2).astype(np.float32)),
            "u1_i2h_bias": tmx.nd.zeros((4,)),
            "u1_h2h_weight": tmx.nd.array(
                rng.randn(4, 4).astype(np.float32)),
            "u1_h2h_bias": tmx.nd.zeros((4,))}
    assert outs.bind(tmx.cpu(), args).forward()[0].shape == (1, 3, 4)


# ---------------------------------------------------------------------------
# Gluon cells and layers (gluon.rnn)
# ---------------------------------------------------------------------------

def _gluon_case(mx, kind):
    g = mx.gluon.rnn
    if kind == "rnn_cell":
        return g.RNNCell(5, input_size=3, activation="relu")
    if kind == "lstm_cell":
        return g.LSTMCell(5, input_size=3)
    if kind == "gru_cell":
        return g.GRUCell(5, input_size=3)
    if kind == "sequential":
        s = g.HybridSequentialRNNCell()
        s.add(g.LSTMCell(5, input_size=3))
        s.add(g.ResidualCell(g.GRUCell(5, input_size=5)))
        return s
    if kind == "bidirectional":
        return g.BidirectionalCell(g.LSTMCell(4, input_size=3),
                                   g.GRUCell(4, input_size=3))
    raise ValueError(kind)


def _params_of(block):
    return {k: p.data().asnumpy()
            for k, p in block._collect_params_with_prefix().items()}


@pytest.mark.parametrize("kind", ["rnn_cell", "lstm_cell", "gru_cell",
                                  "sequential", "bidirectional"])
def test_gluon_cell_unroll_matches_jax(kind):
    from mxnet_tpu_torch.gluon.convert import params_from_numpy
    T, B, I = 4, 2, 3
    jcell, tcell = _gluon_case(jmx, kind), _gluon_case(tmx, kind)
    jcell.initialize(jmx.init.Xavier())
    tcell.initialize()
    params_from_numpy(tcell, _params_of(jcell))
    x = np.random.RandomState(5).randn(B, T, I).astype(np.float32)
    jo, js = jcell.unroll(T, jmx.nd.array(x), layout="NTC",
                          merge_outputs=True)
    to, ts = tcell.unroll(T, tmx.nd.array(x), layout="NTC",
                          merge_outputs=True)
    _close(to.asnumpy(), jo.asnumpy())
    assert len(ts) == len(js)
    for j, t in zip(js, ts):
        _close(t.asnumpy(), j.asnumpy())
    # masked variable-length unroll (SequenceMask / SequenceLast, and
    # SequenceReverse in the bidirectional cell)
    valid = np.array([4, 2], np.float32)
    jo, js = jcell.unroll(T, jmx.nd.array(x), layout="NTC",
                          merge_outputs=True,
                          valid_length=jmx.nd.array(valid))
    to, ts = tcell.unroll(T, tmx.nd.array(x), layout="NTC",
                          merge_outputs=True,
                          valid_length=tmx.nd.array(valid))
    _close(to.asnumpy(), jo.asnumpy())
    for j, t in zip(js, ts):
        _close(t.asnumpy(), j.asnumpy())


@pytest.mark.parametrize("layer_fn, n_states", [
    (lambda g: g.LSTM(6, num_layers=2, input_size=4), 2),
    (lambda g: g.GRU(6, bidirectional=True, input_size=4), 1),
    (lambda g: g.RNN(6, activation="tanh", layout="NTC", input_size=4), 1),
    (lambda g: g.LSTM(6, num_layers=2, bidirectional=True, layout="NTC",
                      input_size=4), 2)],
    ids=["lstm2", "gru_bi", "rnn_ntc", "lstm2_bi_ntc"])
def test_gluon_layer_matches_jax(layer_fn, n_states):
    import torch
    from mxnet_tpu_torch.gluon.convert import params_from_numpy
    jl, tl = layer_fn(jmx.gluon.rnn), layer_fn(tmx.gluon.rnn)
    jl.initialize(jmx.init.Xavier())
    tl.initialize()
    params_from_numpy(tl, _params_of(jl))
    rng = np.random.RandomState(6)
    # batch 3, 5 steps, 4 features, in the layer's layout
    x = rng.randn(*((3, 5, 4) if jl._layout == "NTC" else (5, 3, 4))) \
        .astype(np.float32)
    states = [rng.randn(*s["shape"]).astype(np.float32)
              for s in jl.state_info(3)]
    assert len(states) == n_states
    jo, js = jl(jmx.nd.array(x), [jmx.nd.array(s) for s in states])
    with tmx.autograd.record():
        to, ts = tl(tmx.nd.array(x), [tmx.nd.array(s) for s in states])
        loss = (to * to).sum()
    _close(to.asnumpy(), jo.asnumpy())
    for j, t in zip(js, ts):
        _close(t.asnumpy(), j.asnumpy())
    loss.backward()

    def jloss(flat):
        params = dict(zip(names, flat))
        for k, v in params.items():
            jtable[k].set_data(jmx.nd.array(np.asarray(v)))
        with jmx.autograd.record():
            out = jl(jmx.nd.array(x), [jmx.nd.array(s) for s in states])[0]
            l = (out * out).sum()
        l.backward()
        return {k: jtable[k].grad().asnumpy() for k in names}
    jtable = jl._collect_params_with_prefix()
    names = sorted(jtable)
    jg = jloss([jtable[k].data().asnumpy() for k in names])
    ttable = tl._collect_params_with_prefix()
    for k in names:
        _close(ttable[k].grad().asnumpy(), jg[k], GRAD_TOL)
    assert isinstance(ttable[names[0]].grad()._data, torch.Tensor)


def test_gluon_layer_deferred_and_default_states():
    layer = tmx.gluon.rnn.LSTM(hidden_size=16, num_layers=2)
    layer.initialize()
    x = tmx.nd.array(np.random.RandomState(0).randn(5, 3, 8))
    assert layer(x).shape == (5, 3, 16)
    out, states = layer(x, layer.begin_state(batch_size=3))
    assert out.shape == (5, 3, 16)
    assert [s.shape for s in states] == [(2, 3, 16), (2, 3, 16)]
    assert layer.l0_i2h_weight.shape == (64, 8)
    assert repr(layer) == "LSTM(8 -> 16, TNC, num_layers=2)"


def test_hybridized_lm_runs_the_rnn_op_in_its_graph():
    """An LM block (Embedding -> LSTM -> Dense) hybridized: the traced
    graph holds one RNN node, and its logits equal the eager call's."""
    mx = tmx

    class LM(mx.gluon.HybridBlock):
        def __init__(self, **kw):
            super().__init__(**kw)
            with self.name_scope():
                self.embed = mx.gluon.nn.Embedding(20, 8)
                self.lstm = mx.gluon.rnn.LSTM(8, num_layers=2,
                                              layout="NTC", input_size=8)
                self.out = mx.gluon.nn.Dense(20, flatten=False)

        def hybrid_forward(self, F, x, h, c):
            y, st = self.lstm(self.embed(x), [h, c])
            return self.out(y), st[0], st[1]
    net = LM()
    net.initialize(mx.init.Xavier())
    rng = np.random.RandomState(4)
    x = mx.nd.array(rng.randint(0, 20, (3, 5)))
    h, c = mx.nd.zeros((2, 3, 8)), mx.nd.zeros((2, 3, 8))
    eager = [o.asnumpy() for o in net(x, h, c)]
    net.hybridize()
    hybrid = [o.asnumpy() for o in net(x, h, c)]
    graph = net._cached_graph[1]
    assert sum(1 for n in graph._topo_nodes()
               if n.op is not None and n.op.name == "RNN") == 1
    for e, g in zip(eager, hybrid):
        _close(g, e)


def test_hybridized_layer_without_input_size_names_the_weight():
    """Inside a hybridized block a recurrent layer's input width cannot be
    inferred backward through the flat vector's concat: the error names
    the weight to give ``input_size`` for."""
    mx = tmx

    class LM(mx.gluon.HybridBlock):
        def __init__(self, **kw):
            super().__init__(**kw)
            with self.name_scope():
                self.embed = mx.gluon.nn.Embedding(20, 8)
                self.lstm = mx.gluon.rnn.LSTM(8, layout="NTC")

        def hybrid_forward(self, F, x, h, c):
            return self.lstm(self.embed(x), [h, c])[0]
    net = LM()
    net.initialize()
    net.hybridize()
    with pytest.raises(ValueError, match="l0_i2h_weight"):
        net(mx.nd.ones((3, 5)), mx.nd.zeros((1, 3, 8)),
            mx.nd.zeros((1, 3, 8)))


# ---------------------------------------------------------------------------
# the synthetic-corpus convergence (tests/test_rnn.py::TestPTBStyleConvergence)
# ---------------------------------------------------------------------------

def test_lstm_lm_learns_synthetic_corpus():
    mx = tmx
    V, E, H, B = 16, 12, 24, 8
    rng = np.random.RandomState(7)
    sents = []
    for _ in range(96):
        start = rng.randint(1, V)
        length = rng.randint(4, 12)
        sents.append([(start + k) % (V - 1) + 1 for k in range(length)])
    it = mx.rnn.BucketSentenceIter(sents, batch_size=B, buckets=[4, 8, 12],
                                   invalid_label=0)

    def sym_gen(seq_len):
        data = mx.sym.var("data")
        label = mx.sym.var("softmax_label")
        embed = mx.sym.Embedding(data, input_dim=V, output_dim=E,
                                 name="embed")
        stack = mx.rnn.SequentialRNNCell()
        stack.add(mx.rnn.LSTMCell(H, prefix="lstm_l0_"))
        outputs, _ = stack.unroll(seq_len, embed, layout="NTC",
                                  merge_outputs=True)
        pred = mx.sym.Reshape(outputs, shape=(-1, H))
        pred = mx.sym.FullyConnected(pred, num_hidden=V, name="pred")
        label_f = mx.sym.Reshape(label, shape=(-1,))
        pred = mx.sym.SoftmaxOutput(pred, label_f, name="softmax",
                                    use_ignore=True, ignore_label=0)
        return pred, ("data",), ("softmax_label",)

    mod = mx.mod.BucketingModule(sym_gen,
                                 default_bucket_key=it.default_bucket_key)
    mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
    mod.init_params(mx.init.Xavier())
    mod.init_optimizer(optimizer="adam",
                       optimizer_params={"learning_rate": 0.01})
    ppl = mx.metric.Perplexity(ignore_label=0)
    first = last = None
    for _ in range(8):
        it.reset()
        ppl.reset()
        for batch in it:
            mod.forward(batch, is_train=True)
            mod.update_metric(ppl, batch.label)
            mod.backward()
            mod.update()
        val = ppl.get()[1]
        first = val if first is None else first
        last = val
    assert last < first * 0.5, (first, last)
    assert last < 4.0, last
