"""Port parity: ``gluon.contrib.rnn`` (the nine convolutional RNN/LSTM/GRU
cells, ``LSTMPCell``, ``VariationalDropoutCell``) against ``mxnet_tpu``
on the CPU.

The JAX cell is initialized, its parameters load into the port's cell by
structural name (``gluon.convert.params_from_numpy``), and the same
numpy-seeded sequence unrolls through both: outputs and states within
``TOL``, the gradients of a sum of squares of every output (each
parameter's and the input's) within ``GRAD_TOL`` (rule 5's tolerances
for the RNN path: the same fp32 convolutions and gate arithmetic in
another summation order, accumulated over T steps).
``VariationalDropoutCell`` at drop 0 equals JAX's; at drop > 0 its mask
is one across the steps of an unroll, scaled by 1/(1-p), and a new one
after ``reset()``; inside a hybridized block it is one ``Dropout`` node
of the traced graph, drawn anew at each call.
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon.convert import params_from_numpy

TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
B, T, C, HC = 2, 3, 2, 3
SPATIAL = {1: (6,), 2: (5, 5), 3: (3, 4, 3)}


@pytest.fixture(autouse=True)
def _port_on_cpu(monkeypatch):
    monkeypatch.setenv("MXNET_DEFAULT_CONTEXT", "cpu")


@pytest.fixture(autouse=True)
def _fresh_names():
    from mxnet_tpu.name import NameManager as JaxNames
    from mxnet_tpu_torch.name import NameManager as PortNames
    with JaxNames(), PortNames():
        yield


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), **tol)


def _params_of(block):
    return {k: p.data().asnumpy()
            for k, p in block._collect_params_with_prefix().items()}


def _grads_of(block):
    return {k: p.grad().asnumpy()
            for k, p in block._collect_params_with_prefix().items()}


def _run(mx, cell, x, T):
    """Unroll ``cell`` over ``x`` (NTC) under record; returns outputs,
    states, the parameter gradients and the input's gradient of the
    sum of squares of every output and state."""
    data = mx.nd.array(x)
    data.attach_grad()
    with mx.autograd.record():
        outs, states = cell.unroll(T, data, layout="NTC",
                                   merge_outputs=True)
        loss = (outs * outs).sum()
        for s in states:
            loss = loss + (s * s).sum()
    loss.backward()
    return (outs.asnumpy(), [s.asnumpy() for s in states],
            _grads_of(cell), data.grad.asnumpy())


def _pair(make, x, T=T):
    jcell, tcell = make(jmx), make(tmx)
    jcell.initialize(jmx.init.Xavier())
    tcell.initialize()
    params_from_numpy(tcell, _params_of(jcell))
    return _run(jmx, jcell, x, T), _run(tmx, tcell, x, T)


def _check(jres, tres):
    (jo, js, jg, jx), (to, ts, tg, tx) = jres, tres
    _close(to, jo)
    assert len(ts) == len(js)
    for j, t in zip(js, ts):
        _close(t, j)
    assert sorted(tg) == sorted(jg)
    for name in jg:
        _close(tg[name], jg[name], GRAD_TOL)
    _close(tx, jx, GRAD_TOL)


@pytest.mark.parametrize("dims", [1, 2, 3])
@pytest.mark.parametrize("kind", ["RNN", "LSTM", "GRU"])
def test_conv_cell_matches_jax(kind, dims):
    name = "Conv%dD%sCell" % (dims, kind)
    shape = (C,) + SPATIAL[dims]

    def make(mx):
        cls = getattr(mx.gluon.contrib.rnn, name)
        return cls(shape, HC, i2h_kernel=3, h2h_kernel=3, i2h_pad=1)
    rng = np.random.RandomState(dims * 10 + len(kind))
    x = rng.randn(B, T, *shape).astype(np.float32)
    jres, tres = _pair(make, x)
    assert tres[0].shape == (B, T, HC) + SPATIAL[dims]
    assert len(tres[1]) == (2 if kind == "LSTM" else 1)
    _check(jres, tres)


def test_conv_cell_geometry_matches_jax():
    """No i2h padding, a dilated h2h: the state shrinks to the i2h
    convolution's output and keeps it."""
    def make(mx):
        return mx.gluon.contrib.rnn.Conv2DGRUCell(
            (C, 7, 6), HC, i2h_kernel=(3, 2), h2h_kernel=3,
            i2h_dilate=(1, 2), h2h_dilate=2, activation="relu")
    x = np.random.RandomState(3).randn(B, T, C, 7, 6).astype(np.float32)
    jres, tres = _pair(make, x)
    assert tres[1][0].shape == (B, HC, 5, 4)
    _check(jres, tres)


def test_conv_cell_validation_and_state_info():
    crnn = tmx.gluon.contrib.rnn
    with pytest.raises(MXNetError, match="channel-first NCHW"):
        crnn.Conv2DLSTMCell((C, 5, 5), HC, 3, 3, conv_layout="NHWC")
    with pytest.raises(MXNetError, match="must be odd"):
        crnn.Conv2DLSTMCell((C, 5, 5), HC, 3, 4)
    with pytest.raises(MXNetError, match="must have 3 elements"):
        crnn.Conv3DRNNCell((C, 3, 3, 3), HC, (3, 3), 3)
    cell = crnn.Conv2DLSTMCell((C, 5, 5), HC, 3, 3, i2h_pad=1)
    jcell = jmx.gluon.contrib.rnn.Conv2DLSTMCell((C, 5, 5), HC, 3, 3,
                                                 i2h_pad=1)
    assert cell.state_info(4) == jcell.state_info(4)
    assert type(cell).__name__ == "Conv2DLSTMCell"
    assert cell.prefix.startswith("convlstm")


def test_lstmp_cell_matches_jax():
    def make(mx):
        return mx.gluon.contrib.rnn.LSTMPCell(6, 4, input_size=5)
    x = np.random.RandomState(4).randn(B, 4, 5).astype(np.float32)
    jres, tres = _pair(make, x, T=4)
    assert tres[0].shape == (B, 4, 4)
    assert [s.shape for s in tres[1]] == [(B, 4), (B, 6)]
    _check(jres, tres)


def test_lstmp_deferred_input_width_loads_from_jax():
    jcell = jmx.gluon.contrib.rnn.LSTMPCell(6, 4)
    jcell.initialize(jmx.init.Xavier())
    jcell(jmx.nd.ones((B, 5)), jcell.begin_state(B))
    tcell = tmx.gluon.contrib.rnn.LSTMPCell(6, 4)
    params_from_numpy(tcell, _params_of(jcell))
    assert tcell.i2h_weight.shape == (24, 5)


def _vardrop(mx, p_in=0., p_state=0., p_out=0.):
    g = mx.gluon.contrib.rnn
    return g.VariationalDropoutCell(g.LSTMPCell(6, 4, input_size=5),
                                    drop_inputs=p_in, drop_states=p_state,
                                    drop_outputs=p_out)


def test_variational_dropout_at_zero_matches_jax():
    x = np.random.RandomState(5).randn(B, 4, 5).astype(np.float32)
    jres, tres = _pair(_vardrop, x, T=4)
    _check(jres, tres)
    cell = _vardrop(tmx)
    assert repr(cell) == repr(_vardrop(jmx))
    assert cell.prefix.endswith("vardrop")


def test_variational_dropout_mask_is_one_per_unroll():
    p = 0.4
    cell = _vardrop(tmx, p_in=p, p_state=p, p_out=p)
    cell.initialize()
    x = tmx.nd.ones((8, 6, 5))
    with tmx.autograd.record():
        outs, _ = cell.unroll(6, x, layout="NTC", merge_outputs=True)
    masks = [cell.drop_inputs_mask.asnumpy(), cell.drop_states_mask.asnumpy(),
             cell.drop_outputs_mask.asnumpy()]
    for m in masks:
        # scaled by 1/(1-p) where kept
        kept = m != 0
        np.testing.assert_allclose(m[kept], 1 / (1 - p), rtol=1e-6)
        assert 0 < (m == 0).sum() < m.size
    # one output mask for all six steps. A sample whose five inputs all
    # drop has every gate at its zero bias, so its outputs are exactly 0
    # whatever the output mask: the mask shows in the other samples
    outs = outs.asnumpy()
    live = np.abs(outs).sum(axis=(1, 2)) > 0
    assert live.any()
    for t in range(6):
        np.testing.assert_array_equal(outs[live, t] == 0,
                                      masks[2][live] == 0)
    cell.reset()
    assert cell.drop_inputs_mask is None
    with tmx.autograd.record():
        cell.unroll(6, x, layout="NTC", merge_outputs=True)
    assert not np.array_equal(cell.drop_outputs_mask.asnumpy(), masks[2])
    # predict mode: the masks are ones
    cell.unroll(6, x, layout="NTC", merge_outputs=True)
    np.testing.assert_array_equal(cell.drop_outputs_mask.asnumpy(), 1.0)


class _VarDropLM(tmx.gluon.HybridBlock):
    def __init__(self, T, **kwargs):
        super().__init__(**kwargs)
        self._T = T
        with self.name_scope():
            self.cell = _vardrop(tmx, p_in=0.5, p_state=0.5, p_out=0.5)

    def hybrid_forward(self, F, x, r0, c0):
        outs, _ = self.cell.unroll(self._T, x, begin_state=[r0, c0],
                                   layout="NTC", merge_outputs=True)
        return outs, self.cell.drop_outputs_mask


def test_variational_dropout_hybridized_one_node_per_mask():
    net = _VarDropLM(5)
    net.initialize()
    net.hybridize()
    x = tmx.nd.ones((8, 5, 5))
    states = net.cell.begin_state(batch_size=8)
    with tmx.autograd.record():
        outs1, mask1 = net(x, *states)
    with tmx.autograd.record():
        outs2, mask2 = net(x, *states)
    graph = net._cached_graph[1]
    dropouts = [n for n in graph._topo_nodes()
                if n.op is not None and n.op.name == "Dropout"]
    assert len(dropouts) == 3          # inputs, states, outputs
    # a sample whose five inputs all drop has every gate at its zero
    # bias, so its outputs are exactly 0 whatever the output mask: the
    # shared mask shows in the other samples' outputs, at every step
    outs = outs1.asnumpy()
    live = np.abs(outs).sum(axis=(1, 2)) > 0
    assert live.any()
    for t in range(5):
        np.testing.assert_array_equal(outs[live, t] == 0,
                                      mask1.asnumpy()[live] == 0)
    assert not np.array_equal(mask1.asnumpy(), mask2.asnumpy())
