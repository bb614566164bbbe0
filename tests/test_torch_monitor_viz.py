"""The port's ``mx.monitor`` and ``mx.viz`` against the JAX package's, on
the CPU: ``tests/test_aux_subsystems.py``'s three monitor cases in both
packages, ``print_summary``'s text equal to the JAX package's for the
same symbol, and ``plot_network``'s DOT source equal to it (where
``graphviz`` is installed; the port imports it inside ``plot_network``
alone)."""
import contextlib
import io
import sys

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx


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


def _mlp_args(mx):
    rng = np.random.RandomState(0)
    return {"data": mx.nd.array(rng.randn(3, 5).astype(np.float32)),
            "fc1_weight": mx.nd.array(rng.randn(4, 5).astype(np.float32)),
            "fc1_bias": mx.nd.zeros((4,)),
            "fc2_weight": mx.nd.array(rng.randn(2, 4).astype(np.float32)),
            "fc2_bias": mx.nd.zeros((2,))}


def _mlp(mx):
    data = mx.sym.var("data")
    h = mx.sym.Activation(mx.sym.FullyConnected(data, num_hidden=4,
                                                name="fc1"),
                          act_type="relu", name="act1")
    return mx.sym.FullyConnected(h, num_hidden=2, name="fc2")


def _stats(stats):
    return {n: v for _, n, v in stats}


def _monitor_all(mx):
    ex = _mlp(mx).bind(mx.cpu(), _mlp_args(mx))
    mon = mx.monitor.Monitor(interval=1, pattern=".*")
    mon.install(ex, monitor_all=True)
    mon.tic()
    ex.forward()
    _ = ex.outputs[0].asnumpy()
    return _stats(mon.toc())


def test_monitor_all_taps_intermediate_ops_as_jax():
    got, want = _monitor_all(tmx), _monitor_all(jmx)
    assert any("fc1" in n for n in got) and any("act1" in n for n in got)
    assert sorted(got) == sorted(want)
    for n in got:
        np.testing.assert_allclose(float(got[n]), float(want[n]),
                                   rtol=1e-5, err_msg=n)


def test_monitor_without_all_still_outputs_as_jax():
    seen = {}
    for mx in (tmx, jmx):
        data = mx.sym.var("data")
        out = mx.sym.FullyConnected(data, num_hidden=2, name="fc")
        ex = out.bind(mx.cpu(), {"data": mx.nd.ones((2, 3)),
                                 "fc_weight": mx.nd.ones((2, 3)),
                                 "fc_bias": mx.nd.zeros((2,))})
        names = []
        ex.set_monitor_callback(lambda n, a: names.append(n))
        ex.forward()
        seen[mx] = names
    assert seen[tmx] and seen[tmx] == seen[jmx]


def _module_monitor(mx):
    from importlib import import_module
    io_mod = import_module(mx.__name__ + ".io.io")
    data = mx.sym.var("data")
    lbl = mx.sym.var("softmax_label")
    out = mx.sym.SoftmaxOutput(
        mx.sym.FullyConnected(data, num_hidden=2, name="mfc"), lbl)
    mod = mx.mod.Module(out, context=mx.cpu())
    mod.bind([io_mod.DataDesc("data", (4, 3))],
             [io_mod.DataDesc("softmax_label", (4,))])
    mod.init_params(arg_params={"mfc_weight": mx.nd.array(
        np.random.RandomState(2).randn(2, 3).astype(np.float32)),
        "mfc_bias": mx.nd.zeros((2,))})
    mod.init_optimizer()
    mon = mx.monitor.Monitor(interval=1, pattern=".*", monitor_all=True)
    mod.install_monitor(mon)
    mon.tic()
    batch = io_mod.DataBatch([mx.nd.ones((4, 3))],
                             [mx.nd.array([0, 1, 0, 1])])
    mod.forward(batch, is_train=True)
    _ = mod.get_outputs()[0].asnumpy()
    return _stats(mon.toc())


def test_monitor_all_through_module_training_as_jax():
    got, want = _module_monitor(tmx), _module_monitor(jmx)
    assert any("mfc" in n for n in got)
    assert sorted(got) == sorted(want)


def test_monitor_taps_a_foreach_node_and_its_step_falls_back():
    """A Module over a foreach graph: the monitor sees the control-flow
    node's outputs, and the monitored step is the eager one, counted."""
    from mxnet_tpu_torch import profiler
    from mxnet_tpu_torch.io.io import DataDesc, DataBatch
    data = tmx.sym.var("data")

    def step(x, s):
        h = tmx.sym.tanh(tmx.sym.FullyConnected(x, num_hidden=3,
                                                name="cell") + s)
        return h, h
    outs, _ = tmx.sym.contrib.foreach(
        step, tmx.sym.SwapAxis(data, dim1=0, dim2=1), tmx.sym.zeros((4, 3)),
        name="loop")
    out = tmx.sym.MakeLoss(tmx.sym.sum(outs))
    mod = tmx.mod.Module(out, context=tmx.cpu(), label_names=[])
    mod.bind([DataDesc("data", (4, 5, 3))])
    mod.init_params(tmx.init.Xavier())
    mod.init_optimizer()
    mon = tmx.monitor.Monitor(1, pattern=".*", monitor_all=True)
    mod.install_monitor(mon)
    before = profiler.counters().get("fused_step_fallbacks", 0)
    mon.tic()
    mod.forward(DataBatch([tmx.nd.ones((4, 5, 3))], []), is_train=True)
    mod.backward()
    mod.update()
    names = [n for _, n, _ in mon.toc()]
    assert "loop_output0" in names and "loop_output1" in names
    assert profiler.counters().get("fused_step_fallbacks", 0) - before == 1


def _summary(mx, sym, shape):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        total = mx.viz.print_summary(sym, shape=shape)
    return buf.getvalue(), total


def _conv_net(mx):
    data = mx.sym.var("data")
    c = mx.sym.Convolution(data, num_filter=4, kernel=(3, 3), name="conv")
    b = mx.sym.BatchNorm(c, name="bn")
    p = mx.sym.Pooling(mx.sym.Activation(b, act_type="relu", name="relu"),
                       pool_type="max", kernel=(2, 2), stride=(2, 2),
                       name="pool")
    f = mx.sym.FullyConnected(mx.sym.Flatten(p, name="flat"),
                              num_hidden=10, name="fc")
    return mx.sym.SoftmaxOutput(f, name="softmax")


@pytest.mark.parametrize("shape", [None, {"data": (2, 3, 8, 8),
                                          "softmax_label": (2,)}],
                         ids=["no_shape", "with_shape"])
def test_print_summary_text_equals_jax(shape):
    got = _summary(tmx, _conv_net(tmx), shape)
    want = _summary(jmx, _conv_net(jmx), shape)
    assert got == want
    if shape:
        # conv 4 x 3 x 3 x 3 + 4, bn 4 + 4, fc 10 x 36 + 10
        assert got[1] == 490


def test_print_summary_of_a_foreach_graph_equals_jax():
    def lm(mx):
        w = mx.sym.var("w")
        outs, _ = mx.sym.contrib.foreach(
            lambda x, s: (mx.sym.tanh(x * w + s), mx.sym.tanh(x * w + s)),
            mx.sym.var("data"), mx.sym.var("init"), name="loop")
        return mx.sym.FullyConnected(outs, num_hidden=3, name="fc")
    shape = {"data": (4, 2, 3), "init": (2, 3), "w": (3,)}
    assert _summary(tmx, lm(tmx), shape) == _summary(jmx, lm(jmx), shape)


def test_plot_network_dot_equals_jax():
    pytest.importorskip("graphviz")
    shape = {"data": (2, 3, 8, 8), "softmax_label": (2,)}
    got = tmx.viz.plot_network(_conv_net(tmx), shape=shape)
    want = jmx.viz.plot_network(_conv_net(jmx), shape=shape)
    assert got.source == want.source
    assert "conv" in got.source


def test_visualization_imports_no_graphviz():
    """graphviz is imported by plot_network alone: the card's host has
    none."""
    import subprocess
    code = ("import sys; sys.modules['graphviz'] = None; "
            "import mxnet_tpu_torch as mx; "
            "print(mx.viz.print_summary(mx.sym.var('x')))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env={"MXNET_DEFAULT_CONTEXT": "cpu",
                                         "PATH": "/usr/bin:/bin"},
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "Total params: 0" in out.stdout
