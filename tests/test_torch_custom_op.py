"""The port's ``Custom`` ops (``mxnet_tpu_torch/operator.py``) against the
JAX package's, on the CPU.

The 6 cases of ``tests/test_custom_op.py`` run in both packages with the
same ops registered in each. Added: the auxiliary-state raise, the
callbacks' order on one worker thread, where ``in_data`` lives (the
port's difference: NDArrays on the op's own device, the caller's
tensors themselves, where the JAX package hands host copies), the
registry's output counts from the registered prop, an error in user code
reaching the caller, and a ``Custom`` node in ``Module.fit``: one
``fused_step_fallbacks`` a step, the losses and weights of a
``SoftmaxOutput`` twin, and a hybridized block holding it run op by op
(``eager_host``), never captured."""
import threading

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
import mxnet_tpu_torch.cached_op as tco
from mxnet_tpu_torch import fused_step, profiler

TOL = dict(rtol=1e-5, atol=1e-6)
CALLS = []          # (package, callback, thread id) in call order


@pytest.fixture(autouse=True)
def _port_on_cpu(monkeypatch):
    monkeypatch.setenv("MXNET_DEFAULT_CONTEXT", "cpu")


@pytest.fixture(autouse=True)
def _fresh_names():
    from mxnet_tpu.name import NameManager as JaxNames
    from mxnet_tpu_torch.name import NameManager as PortNames
    with JaxNames(), PortNames():
        yield


def _register(mx):
    """test_custom_op.py's ``sqr`` and ``twosum``, the softmax loss of
    chip_smoke.py phase 29 (c), and a prop with an auxiliary state, in
    package ``mx``."""
    tag = mx.__name__

    @mx.operator.register("sqr")
    class SqrProp(mx.operator.CustomOpProp):
        def __init__(self):
            super().__init__(need_top_grad=True)

        def list_arguments(self):
            return ["data"]

        def list_outputs(self):
            return ["output"]

        def infer_shape(self, in_shape):
            return in_shape, [in_shape[0]], []

        def create_operator(self, ctx, shapes, dtypes):
            return Sqr()

    class Sqr(mx.operator.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            CALLS.append((tag, "forward", threading.get_ident(),
                          in_data[0]))
            self.assign(out_data[0], req[0], in_data[0] * in_data[0])

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            CALLS.append((tag, "backward", threading.get_ident(), None))
            self.assign(in_grad[0], req[0], 2.0 * in_data[0] * out_grad[0])

    @mx.operator.register("twosum")
    class TwoSumProp(mx.operator.CustomOpProp):
        def list_arguments(self):
            return ["a", "b"]

        def list_outputs(self):
            return ["sum", "diff"]

        def infer_shape(self, in_shape):
            return in_shape, [in_shape[0], in_shape[0]], []

        def create_operator(self, ctx, shapes, dtypes):
            return TwoSum()

    class TwoSum(mx.operator.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            a, b = in_data
            self.assign(out_data[0], req[0], a + b)
            self.assign(out_data[1], req[1], a - b)

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            gs, gd = out_grad
            self.assign(in_grad[0], req[0], gs + gd)
            self.assign(in_grad[1], req[1], gs - gd)

    @mx.operator.register("softmax_ce")
    class SoftmaxProp(mx.operator.CustomOpProp):
        """The softmax over the last axis; its backward y - onehot(label)
        with label 0 ignored, as SoftmaxOutput(use_ignore, ignore_label=0)
        computes it."""

        def __init__(self):
            super().__init__(need_top_grad=False)

        def list_arguments(self):
            return ["data", "label"]

        def infer_shape(self, in_shape):
            return in_shape, [in_shape[0]], []

        def create_operator(self, ctx, shapes, dtypes):
            return Softmax()

    class Softmax(mx.operator.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            x = in_data[0]
            e = mx.nd.exp(x - mx.nd.max(x, axis=1, keepdims=True))
            self.assign(out_data[0], req[0],
                        e / mx.nd.sum(e, axis=1, keepdims=True))

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            y, label = out_data[0], in_data[1]
            onehot = mx.nd.one_hot(label, y.shape[1])
            keep = mx.nd.expand_dims(label != 0, axis=1)
            self.assign(in_grad[0], req[0], (y - onehot) * keep)
            self.assign(in_grad[1], req[1], mx.nd.zeros(label.shape))

    @mx.operator.register("with_aux")
    class AuxProp(mx.operator.CustomOpProp):
        def list_auxiliary_states(self):
            return ["count"]

        def create_operator(self, ctx, shapes, dtypes):
            return Sqr()

    @mx.operator.register("broken")
    class BrokenProp(mx.operator.CustomOpProp):
        def create_operator(self, ctx, shapes, dtypes):
            return Broken()

    class Broken(mx.operator.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            raise ValueError("the user's forward failed")


_register(tmx)
_register(jmx)


def _same(case):
    for g, w in zip(case(tmx), case(jmx)):
        np.testing.assert_allclose(g, w, **TOL)


# ---------------------------------------------------------------------------
# tests/test_custom_op.py, case by case in both packages
# ---------------------------------------------------------------------------

def _forward(mx):
    return [mx.nd.Custom(mx.nd.array([1.0, 2.0, 3.0]),
                         op_type="sqr").asnumpy()]


def _backward(mx):
    x = mx.nd.array([1.0, 2.0, 3.0])
    x.attach_grad()
    with mx.autograd.record():
        y = mx.nd.Custom(x, op_type="sqr")
        loss = y.sum()
    loss.backward()
    return [y.asnumpy(), x.grad.asnumpy()]


def _multi_io(mx):
    a, b = mx.nd.array([3.0, 5.0]), mx.nd.array([1.0, 2.0])
    a.attach_grad()
    b.attach_grad()
    with mx.autograd.record():
        s, d = mx.nd.Custom(a, b, op_type="twosum")
        loss = (s * 2.0 + d).sum()
    loss.backward()
    return [s.asnumpy(), d.asnumpy(), a.grad.asnumpy(), b.grad.asnumpy()]


def _symbolic(mx):
    y = mx.sym.Custom(mx.sym.var("data"), op_type="sqr", name="sqr0")
    ex = mx.sym.sum(y).bind(mx.cpu(), {"data": mx.nd.array([2.0, -3.0])},
                            args_grad={"data": mx.nd.zeros((2,))})
    out = ex.forward(is_train=True)[0].asnumpy()
    ex.backward()
    return [out, ex.grad_dict["data"].asnumpy()]


def _hybrid(mx):
    class Net(mx.gluon.HybridBlock):
        def __init__(self):
            super().__init__()
            self.dense = mx.gluon.nn.Dense(4, in_units=3)

        def hybrid_forward(self, F, x):
            return F.Custom(self.dense(x), op_type="sqr")

    net = Net()
    net.initialize()
    net.dense.weight.set_data(mx.nd.array(
        np.random.RandomState(1).randn(4, 3).astype(np.float32)))
    x = mx.nd.array(np.random.RandomState(0).randn(2, 3).astype(np.float32))
    eager = net(x).asnumpy()
    net.hybridize()
    hybrid = net(x).asnumpy()
    np.testing.assert_allclose(eager, hybrid, **TOL)
    assert (hybrid >= 0).all()
    return [eager, hybrid]


JAX_CASES = {"eager_forward": _forward, "eager_backward": _backward,
             "eager_multi_io": _multi_io,
             "symbolic_bind_forward_backward": _symbolic,
             "hybridized_gluon_block": _hybrid}


@pytest.mark.parametrize("name", sorted(JAX_CASES))
def test_case_of_the_jax_suite_matches_jax(name):
    _same(JAX_CASES[name])


def test_values_of_the_jax_suite_hold():
    np.testing.assert_allclose(_forward(tmx)[0], [1.0, 4.0, 9.0])
    np.testing.assert_allclose(_backward(tmx)[1], [2.0, 4.0, 6.0])
    s, d, ga, gb = _multi_io(tmx)
    np.testing.assert_allclose([s, d, ga, gb], [[4, 7], [2, 3], [3, 3],
                                                [1, 1]])
    out, g = _symbolic(tmx)
    assert float(out) == 13.0
    np.testing.assert_allclose(g, [4.0, -6.0])


@pytest.mark.parametrize("mx", [tmx, jmx], ids=["port", "jax"])
def test_unregistered_raises(mx):
    with pytest.raises(mx.base.MXNetError, match="not registered"):
        mx.nd.Custom(mx.nd.ones((2,)), op_type="no_such_op")


# ---------------------------------------------------------------------------
# added cases
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mx", [tmx, jmx], ids=["port", "jax"])
def test_auxiliary_states_raise(mx):
    with pytest.raises(mx.base.MXNetError, match="auxiliary states"):
        mx.nd.Custom(mx.nd.ones((2,)), op_type="with_aux")


def test_error_in_user_code_reaches_the_caller():
    with pytest.raises(ValueError, match="the user's forward failed"):
        tmx.nd.Custom(tmx.nd.ones((2,)), op_type="broken")


def test_callbacks_run_in_order_on_one_worker_thread():
    """Forwards and backwards of several ops and calls run on ONE thread
    that is not the caller's, in the order the caller needs them."""
    del CALLS[:]
    xs = [tmx.nd.array([float(i + 1)]) for i in range(3)]
    for x in xs:
        x.attach_grad()
    with tmx.autograd.record():
        ys = [tmx.nd.Custom(x, op_type="sqr") for x in xs]
        loss = ys[0] + ys[1] * ys[2]
    loss.backward()
    calls = [c for c in CALLS if c[0] == "mxnet_tpu_torch"]
    assert [c[1] for c in calls] == ["forward"] * 3 + ["backward"] * 3
    assert len({c[2] for c in calls}) == 1
    assert calls[0][2] != threading.get_ident()
    np.testing.assert_allclose([x.grad.asnumpy()[0] for x in xs],
                               [2.0, 2 * 2 * 9, 2 * 3 * 4])


def test_in_data_is_the_callers_array_on_its_device():
    """The port hands the user the op's inputs on their own device, with
    no host copy (MXNet 1.5's custom-inl.h); the JAX package hands host
    NDArrays (its XLA program cannot call Python on the TPU)."""
    del CALLS[:]
    x = tmx.nd.array([1.0, 2.0])
    tmx.nd.Custom(x, op_type="sqr")
    in_data = CALLS[-1][3]
    assert in_data.context == x.context
    assert in_data._data.data_ptr() == x._data.data_ptr()
    jx = jmx.nd.array([1.0, 2.0])
    jmx.nd.Custom(jx, op_type="sqr")
    assert CALLS[-1][3].context == jmx.cpu()


def test_output_counts_and_arguments_come_from_the_prop():
    for mx in (tmx, jmx):
        op = mx.ops.get_op("Custom")
        attrs = mx.ops.normalize_attrs(op, {"op_type": "twosum"})
        assert op.resolve_num_outputs(attrs) == 2
        assert op.resolve_arg_names(attrs) == ["a", "b"]
    assert tmx.ops.get_op("Custom").runs_host_code({})
    sym = tmx.sym.Custom(tmx.sym.var("a"), tmx.sym.var("b"),
                         op_type="twosum")
    assert sym.infer_shape(a=(2, 3), b=(2, 3))[1] == [(2, 3), (2, 3)]


def _standin(body, device, pool):
    out = body()

    def replay():
        for o, r in zip(out, body()):
            o.copy_(r)
    return replay, out, {}


def test_hybridized_block_with_custom_is_never_captured():
    class Net(tmx.gluon.HybridBlock):
        def __init__(self):
            super().__init__()
            self.dense = tmx.gluon.nn.Dense(4, in_units=3)

        def hybrid_forward(self, F, x):
            return F.Custom(self.dense(x), op_type="sqr")

    net = Net()
    net.initialize()
    net.hybridize()
    x = tmx.nd.ones((2, 3))
    net(x)
    op = net._cached_op
    op.graphs = tco._Graphs("cpu", capture=_standin)
    for _ in range(3):
        net(x)
    st = op.stats()
    assert st["captures"] == 0 and st["replays"] == 0
    assert st["eager_host"] == 3


LM_V, LM_E, LM_T, LM_B = 20, 6, 4, 5


def _loss_sym(mx, custom):
    data = mx.sym.var("data")
    label = mx.sym.var("softmax_label")
    emb = mx.sym.Embedding(data, input_dim=LM_V, output_dim=LM_E,
                           name="embed")
    pred = mx.sym.FullyConnected(mx.sym.Reshape(emb, shape=(-1, LM_E)),
                                 num_hidden=LM_V, name="pred")
    label = mx.sym.Reshape(label, shape=(-1,))
    if custom:
        return mx.sym.Custom(pred, label, op_type="softmax_ce",
                             name="softmax")
    return mx.sym.SoftmaxOutput(pred, label, use_ignore=True, ignore_label=0,
                                name="softmax")


def _fit(custom, steps=4):
    rs = np.random.RandomState(3)
    x = rs.randint(0, LM_V, (steps * LM_B, LM_T)).astype(np.float32)
    y = rs.randint(0, LM_V, (steps * LM_B, LM_T)).astype(np.float32)
    it = tmx.io.NDArrayIter(x, y, batch_size=LM_B, shuffle=False,
                            label_name="softmax_label")
    mod = tmx.mod.Module(_loss_sym(tmx, custom), context=tmx.cpu())
    mod.bind(it.provide_data, it.provide_label)
    init = np.random.RandomState(4)
    mod.init_params(arg_params={
        "embed_weight": tmx.nd.array(init.randn(LM_V, LM_E)
                                     .astype(np.float32)),
        "pred_weight": tmx.nd.array(init.randn(LM_V, LM_E)
                                    .astype(np.float32) * 0.3),
        "pred_bias": tmx.nd.zeros((LM_V,))})
    losses = []

    def ce(label, pred):
        lab = label.ravel().astype(int)
        p = pred[np.arange(len(lab)), lab]
        keep = lab != 0
        losses.append(float(-np.log(p[keep]).mean()))
        return losses[-1]
    before = profiler.counters().get("fused_step_fallbacks", 0)
    mod.fit(it, num_epoch=1, optimizer="sgd",
            optimizer_params=dict(learning_rate=0.1),
            eval_metric=tmx.metric.CustomMetric(ce))
    fallbacks = profiler.counters().get("fused_step_fallbacks", 0) - before
    args, _ = mod.get_params()
    return losses, {k: v.asnumpy() for k, v in args.items()}, fallbacks, mod


def test_custom_loss_in_module_fit_is_a_counted_fallback():
    """A Custom softmax loss in Module.fit: each step falls back from the
    fused step to the eager one (one ``fused_step_fallbacks`` a step), and
    the losses and weights equal a SoftmaxOutput twin's on the fused
    step."""
    fused_step.set_graph_factory(lambda: tco._Graphs("cpu",
                                                     capture=_standin))
    try:
        c_loss, c_args, c_fb, c_mod = _fit(True)
        s_loss, s_args, s_fb, s_mod = _fit(False)
    finally:
        fused_step.set_graph_factory(None)
    assert c_fb == 4 and s_fb == 0
    assert c_mod._fused is None and s_mod._fused.stats()["captures"] == 1
    np.testing.assert_allclose(c_loss, s_loss, rtol=1e-5)
    for k in s_args:
        np.testing.assert_allclose(c_args[k], s_args[k], rtol=1e-5,
                                   atol=1e-6, err_msg=k)


def test_custom_on_meta_tensors_gives_the_signature():
    out = tmx.ops.get_op("Custom").forward(
        {"op_type": "twosum", "__train__": False},
        torch.empty((2, 3), device="meta"), torch.empty((2, 3),
                                                        device="meta"))
    assert [tuple(o.shape) for o in out] == [(2, 3), (2, 3)]
