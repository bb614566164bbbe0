"""Port parity: ``ctx_group`` / ``group2ctx`` placement
(``mxnet_tpu_torch.placement``) against ``mxnet_tpu.placement``, on the
CPU — the four tests of ``tests/test_placement.py`` with the groups on
``cpu(0)`` and ``cpu(1)``. Both are the host for torch, so what the CPU
can check is the segment structure (two segments, one context each),
the op-by-op run across them (``Executor.stats()["grouped"]``), the
numbers against the JAX package's grouped run (whose two CPU devices
are distinct) and against the ungrouped run, and training through
``Module``. That the tensors really cross between the host and the card
is checked on the H100 (``chip_smoke.py`` phase 16).

Tolerances: outputs rtol = 1e-5, atol = 1e-6; gradients rtol = 1e-4,
atol = 1e-6 (the JAX test's).
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)


@pytest.fixture(autouse=True)
def _port_on_cpu(monkeypatch):
    monkeypatch.setenv("MXNET_DEFAULT_CONTEXT", "cpu")


@pytest.fixture(autouse=True)
def _reseed():
    """Tests here reseed the port's generators; later ones start from
    the default seed again."""
    yield
    tmx.random.seed(0)


def _two_group_net(mx, dropout=False):
    data = mx.sym.var("data")
    with mx.AttrScope(ctx_group="dev1"):
        h = mx.sym.FullyConnected(data, num_hidden=16, name="fc1")
        h = mx.sym.Activation(h, act_type="relu", name="relu1")
        if dropout:
            h = mx.sym.Dropout(h, p=0.5, name="drop1")
    with mx.AttrScope(ctx_group="dev2"):
        h = mx.sym.FullyConnected(h, num_hidden=4, name="fc2")
        out = mx.sym.SoftmaxOutput(h, mx.sym.var("label"), name="softmax")
    return out


def _bind(mx, sym, group2ctx):
    rs = np.random.RandomState(3)
    shapes = dict(zip(sym.list_arguments(),
                      sym.infer_shape(data=(8, 10), label=(8,))[0]))
    args = {n: mx.nd.array(rs.randn(*shapes[n]).astype(np.float32) * 0.1)
            for n in sym.list_arguments()}
    args["label"] = mx.nd.array(rs.randint(0, 4, (8,)).astype(np.float32))
    grads = {n: mx.nd.zeros(shapes[n]) for n in shapes
             if n not in ("data", "label")}
    reqs = {n: ("write" if n in grads else "null") for n in shapes}
    return sym.bind(mx.cpu(), args, args_grad=grads, grad_req=reqs,
                    group2ctx=group2ctx)


def _segments(ex):
    """``[(context, [op names])]``: the plan's contiguous runs of ops on
    one context."""
    segs = []
    for ctx, name in zip(ex._op_ctxs, ex._plan_names):
        if not segs or segs[-1][0] != ctx:
            segs.append((ctx, []))
        segs[-1][1].append(name)
    return segs


def _run(ex):
    ex.forward(is_train=True)
    ex.backward()
    return {"out": ex.outputs[0].asnumpy(),
            **{n: ex.grad_dict[n].asnumpy()
               for n in ("fc1_weight", "fc1_bias", "fc2_weight",
                         "fc2_bias")}}


def test_group2ctx_parity_and_placement():
    """Two segments, one per group, in plan order; a training step
    equals the ungrouped one and the JAX package's grouped one."""
    g2c = {"dev1": tmx.cpu(0), "dev2": tmx.cpu(1)}
    sym = _two_group_net(tmx)
    ex_grp = _bind(tmx, sym, g2c)
    assert ex_grp._op_ctxs is not None, "placement should activate"
    assert _segments(ex_grp) == [(tmx.cpu(0), ["fc1", "relu1"]),
                                 (tmx.cpu(1), ["fc2", "softmax"])]
    assert ex_grp._op_devices == [torch.device("cpu")] * 4
    ex_ref = _bind(tmx, sym, None)
    assert ex_ref._op_ctxs is None
    got, ref = _run(ex_grp), _run(ex_ref)

    jsym = _two_group_net(jmx)
    jex = _bind(jmx, jsym, {"dev1": jmx.cpu(0), "dev2": jmx.cpu(1)})
    assert jex._grouped is not None and len(jex._grouped.segments) == 2
    want = _run(jex)
    for key in want:
        tol = TOL if key == "out" else GRAD_TOL
        np.testing.assert_allclose(got[key], want[key], err_msg=key, **tol)
        np.testing.assert_allclose(got[key], ref[key], err_msg=key, **tol)
    # each argument and its gradient sit on their first consumer's
    # device (both segments are the host here)
    for name in ("fc1_weight", "fc2_weight"):
        assert ex_grp.arg_dict[name]._data.device == torch.device("cpu")
    assert ex_grp.grad_dict["fc1_weight"]._data.device == torch.device("cpu")


def test_grouped_executor_runs_op_by_op():
    """Never a CUDA graph: even with a holder that serves the host, a
    grouped predict run goes op by op and counts as ``grouped``; the
    ungrouped one replays."""
    sym = _two_group_net(tmx)
    ex = _bind(tmx, sym, {"dev1": tmx.cpu(0), "dev2": tmx.cpu(1)})
    ref = _bind(tmx, sym, None)

    def standin(body, device, pool):
        out = body()

        def replay():
            for o, r in zip(out, body()):
                o.copy_(r)
        return replay, out, {}
    from mxnet_tpu_torch import cached_op as tco
    for e in (ex, ref):
        e.graphs = tco._Graphs("cpu", capture=standin)
        for _ in range(2):
            e.forward()
    np.testing.assert_allclose(ex.outputs[0].asnumpy(),
                               ref.outputs[0].asnumpy(), **TOL)
    assert ex.stats() == dict(captures=0, replays=0, recaptures=0,
                              signatures=0, eager_rng=0, eager_host=0, grouped=2)
    assert ref.stats()["replays"] == 2


def test_group2ctx_module_and_eval():
    """Training through ``Module(group2ctxs=...)`` (a list of one
    mapping, the reference's one per replica), the JAX test's data and
    epochs: accuracy above 0.8, as the JAX package's."""
    sym = _two_group_net(tmx)
    mod = tmx.mod.Module(sym, data_names=("data",), label_names=("label",),
                         context=tmx.cpu(),
                         group2ctxs=[{"dev1": tmx.cpu(0),
                                      "dev2": [tmx.cpu(1), tmx.cpu(2)]}])
    rng = np.random.RandomState(11)
    X = rng.randn(64, 10).astype(np.float32)
    w = rng.randn(10, 4)
    y = np.argmax(X @ w, axis=1).astype(np.float32)
    it = tmx.io.NDArrayIter(X, y, batch_size=16, label_name="label")
    np.random.seed(5)
    mod.fit(it, num_epoch=10, optimizer="sgd",
            optimizer_params={"learning_rate": 0.2},
            initializer=tmx.init.Xavier(rnd_type="uniform", magnitude=2))
    assert [ctx for ctx, _ in _segments(mod._exec)] == [tmx.cpu(0),
                                                        tmx.cpu(1)]
    it.reset()
    score = dict(mod.score(it, "acc"))
    assert score["accuracy"] > 0.8, score
    assert mod._exec.stats()["grouped"] == 64 // 16


def test_group2ctx_ignored_without_groups():
    data = tmx.sym.var("data")
    out = tmx.sym.FullyConnected(data, num_hidden=4, name="fc")
    ex = out.bind(tmx.cpu(), {
        "data": tmx.nd.zeros((2, 3)),
        "fc_weight": tmx.nd.zeros((4, 3)),
        "fc_bias": tmx.nd.zeros((4,))},
        group2ctx={"dev1": tmx.cpu(1)})
    assert ex._op_ctxs is None
    assert ex.forward()[0].shape == (2, 4)


def test_grouped_dropout_draws_from_its_segment_device():
    """A Dropout in the dev1 segment draws from that device's generator:
    a training step is reproducible from ``mx.random.seed``, and
    predict mode draws nothing (the ungrouped net without Dropout gives
    the same output)."""
    sym = _two_group_net(tmx, dropout=True)
    g2c = {"dev1": tmx.cpu(0), "dev2": tmx.cpu(1)}
    runs = []
    for _ in range(2):
        tmx.random.seed(4)
        runs.append(_run(_bind(tmx, sym, g2c)))
    for key in runs[0]:
        np.testing.assert_array_equal(runs[1][key], runs[0][key])
    ex = _bind(tmx, sym, g2c)
    ref = _bind(tmx, _two_group_net(tmx), None)
    np.testing.assert_allclose(ex.forward()[0].asnumpy(),
                               ref.forward()[0].asnumpy(), **TOL)
    assert ex.stats() == dict(captures=0, replays=0, recaptures=0,
                              signatures=0, eager_rng=0, eager_host=0, grouped=1)
