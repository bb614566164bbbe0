"""Port parity: the fused train step (``mxnet_tpu_torch/fused_step.py``)
against the eager loop and against ``mxnet_tpu``, on the CPU.

``tests/test_fused_step.py``'s cases run on the port through a stand-in
CUDA capture (``fused_step.set_graph_factory`` with ``cached_op._Graphs
("cpu", capture=...)``: the body runs at capture and again at each
replay, as ``tests/test_torch_cached_op.py`` drives the CachedOp), so
the graph bookkeeping is checked here and the arithmetic bit for bit:

- fused == eager exactly (rtol 0), parameters and optimizer states, for
  SGD-momentum, Adam, AdaGrad and RMSProp, on the Module and the Trainer
  paths;
- one capture across an LR schedule (the scalars ride the staged
  buffer), the guard's skip inside the step, the disabled knob, the
  fallback matrix counted, frozen parameters, an observer between
  backward and update, the fit loop, a failed capture raising;
- the port's fused Module step against the JAX package's fused step
  from the same parameters and batch, within ``TOL`` (fp32 sums in
  another order over 5 steps).
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import autograd, fault, fused_step, gluon, profiler
from mxnet_tpu_torch import cached_op as tco

TOL = dict(rtol=1e-5, atol=1e-6)


def _standin(fail=False):
    def capture(body, device, pool):
        if fail:
            raise RuntimeError("capture failed")
        out = body()

        def replay():
            for o, r in zip(out, body()):
                o.copy_(r)
        return replay, out, {}
    return capture


@pytest.fixture(autouse=True)
def _setup(monkeypatch):
    monkeypatch.setenv("MXNET_DEFAULT_CONTEXT", "cpu")
    monkeypatch.setenv("MXNET_DATA_PIPELINE", "0")
    fused_step.set_graph_factory(
        lambda: tco._Graphs("cpu", capture=_standin()))
    yield
    fused_step.set_graph_factory(None)
    fault.reset()
    jmx.fault.reset()


@pytest.fixture(autouse=True)
def _fresh_names():
    from mxnet_tpu.name import NameManager as JaxNames
    from mxnet_tpu_torch.name import NameManager as PortNames
    with JaxNames(), PortNames():
        yield


def _mlp_sym(mx):
    data = mx.sym.var("data")
    x = mx.sym.FullyConnected(data, num_hidden=16, name="fc1")
    x = mx.sym.Activation(x, act_type="relu", name="relu1")
    x = mx.sym.FullyConnected(x, num_hidden=4, name="fc2")
    return mx.sym.SoftmaxOutput(x, mx.sym.var("softmax_label"),
                                name="softmax")


def _batch(mx, seed=3):
    rng = np.random.RandomState(seed)
    x = rng.uniform(0, 1, (8, 10)).astype(np.float32)
    y = rng.randint(0, 4, (8,)).astype(np.float32)
    return mx.io.DataBatch(data=[mx.nd.array(x)], label=[mx.nd.array(y)])


def _module(mx, optimizer, opt_params, fused, monkeypatch, seed=11,
            fixed=None, **opt_kw):
    monkeypatch.setenv("MXNET_FUSED_STEP", "1" if fused else "0")
    rng = np.random.RandomState(seed)
    mod = mx.module.Module(_mlp_sym(mx), context=mx.cpu(),
                           fixed_param_names=fixed)
    mod.bind(data_shapes=[("data", (8, 10))],
             label_shapes=[("softmax_label", (8,))])
    mod.init_params(initializer=mx.init.Xavier())
    args, _ = mod.get_params()
    mod.set_params({k: mx.nd.array(rng.uniform(-0.1, 0.1, v.shape)
                                   .astype(np.float32))
                    for k, v in sorted(args.items())}, {})
    mod.init_optimizer(optimizer=optimizer, optimizer_params=opt_params,
                       **opt_kw)
    return mod


def _flat(state):
    """One parameter's state as a flat list of NDArrays (either
    package's)."""
    if state is None:
        return []
    if isinstance(state, (tuple, list)):
        return [a for s in state for a in _flat(s)]
    return [state]


def _run(mod, steps, batch):
    for _ in range(steps):
        mod.forward_backward(batch)
        mod.update()
    args, _ = mod.get_params()
    states = {i: [h.asnumpy().copy()
                  for h in _flat(mod._updater.states[i])]
              for i in sorted(mod._updater.states)}
    return {k: v.asnumpy().copy() for k, v in args.items()}, states


OPTIMIZERS = [
    ("sgd", {"learning_rate": 0.05, "momentum": 0.9}),
    ("adam", {"learning_rate": 0.01}),
    ("adagrad", {"learning_rate": 0.05}),
    ("rmsprop", {"learning_rate": 0.01}),
]


@pytest.mark.parametrize("opt,params", OPTIMIZERS,
                         ids=[o for o, _ in OPTIMIZERS])
def test_fused_bitexact_parity(opt, params, monkeypatch):
    batch = _batch(tmx)
    args_e, states_e = _run(_module(tmx, opt, params, False, monkeypatch),
                            5, batch)
    mod_f = _module(tmx, opt, params, True, monkeypatch)
    args_f, states_f = _run(mod_f, 5, batch)
    assert mod_f._fused.dispatch_count == 5
    assert mod_f._fused.stats() == dict(captures=1, replays=5, recaptures=0,
                                        signatures=1, dispatches=5)
    for k in args_e:
        np.testing.assert_array_equal(args_e[k], args_f[k], err_msg=k)
    assert sorted(states_e) == sorted(states_f)
    for i in states_e:
        for a, b in zip(states_e[i], states_f[i]):
            np.testing.assert_array_equal(a, b, err_msg="state %d" % i)


@pytest.mark.parametrize("opt,params", OPTIMIZERS,
                         ids=[o for o, _ in OPTIMIZERS])
def test_fused_module_matches_jax(opt, params, monkeypatch):
    """Five fused steps of the port against five of the JAX package's,
    from the same parameters and batch."""
    args_j, states_j = _run(_module(jmx, opt, params, True, monkeypatch),
                            5, _batch(jmx))
    args_t, states_t = _run(_module(tmx, opt, params, True, monkeypatch),
                            5, _batch(tmx))
    for k in args_j:
        np.testing.assert_allclose(args_t[k], args_j[k], err_msg=k, **TOL)
    for i in states_j:
        for a, b in zip(states_t[i], states_j[i]):
            np.testing.assert_allclose(a, b, err_msg="state %d" % i, **TOL)


def test_fused_one_capture_across_lr_schedule(monkeypatch):
    """A schedule tick changes the lr every step: the scalars ride the
    staged buffer, so the graph is captured once and replayed."""
    before = profiler.counters()
    sched = tmx.lr_scheduler.FactorScheduler(step=1, factor=0.5)
    mod = _module(tmx, "sgd", {"learning_rate": 0.05, "momentum": 0.9,
                               "lr_scheduler": sched}, True, monkeypatch)
    eager = _module(tmx, "sgd", {
        "learning_rate": 0.05, "momentum": 0.9,
        "lr_scheduler": tmx.lr_scheduler.FactorScheduler(step=1,
                                                         factor=0.5)},
        False, monkeypatch)
    monkeypatch.setenv("MXNET_FUSED_STEP", "1")
    args_f, _ = _run(mod, 5, _batch(tmx))
    monkeypatch.setenv("MXNET_FUSED_STEP", "0")
    args_e, _ = _run(eager, 5, _batch(tmx))
    for k in args_e:
        np.testing.assert_array_equal(args_e[k], args_f[k], err_msg=k)
    assert mod._fused.stats()["captures"] == 1
    assert mod._fused.stats()["recaptures"] == 0
    assert mod._fused._trace_count == 1
    after = profiler.counters()

    def delta(name):
        return after.get(name, 0) - before.get(name, 0)
    assert delta("fused_step_cache_misses") == 1
    assert delta("fused_step_cache_hits") == 4
    assert delta("fused_step_dispatches") == 5


def test_fused_guard_skip_step_in_program(monkeypatch):
    mod = _module(tmx, "sgd", {"learning_rate": 0.05, "momentum": 0.9},
                  True, monkeypatch)
    n_params = len(mod._param_names)
    # grad-site visits go per parameter: step 2 spans visits P+1..2P
    fault.set_plan("grad:step=%d:nan:count=%d" % (n_params + 1, n_params))
    batch = _batch(tmx)
    snaps = []
    for _ in range(3):
        mod.forward_backward(batch)
        mod.update()
        args, _ = mod.get_params()
        snaps.append({k: v.asnumpy().copy() for k, v in args.items()})
    assert mod._fused.dispatch_count == 3
    for k in snaps[0]:
        np.testing.assert_array_equal(snaps[0][k], snaps[1][k], err_msg=k)
    assert any(not np.array_equal(snaps[1][k], snaps[2][k])
               for k in snaps[1])
    st = fault.stats()
    assert st["skipped_steps"] == 1
    assert st["injected"]["grad"] == n_params
    assert mod._fused.stats()["captures"] == 1


def test_fused_guard_matches_eager_guard(monkeypatch):
    batch = _batch(tmx)
    results = []
    for fused in (False, True):
        mod = _module(tmx, "sgd", {"learning_rate": 0.05, "momentum": 0.9},
                      fused, monkeypatch)
        fault.set_plan("grad:step=2:nan")
        results.append(_run(mod, 3, batch))
        assert fault.stats()["skipped_steps"] == 1
        fault.reset()
    (args_e, states_e), (args_f, states_f) = results
    for k in args_e:
        np.testing.assert_array_equal(args_e[k], args_f[k], err_msg=k)
    for i in states_e:
        for a, b in zip(states_e[i], states_f[i]):
            np.testing.assert_array_equal(a, b)


def test_fused_disabled_by_env(monkeypatch):
    mod = _module(tmx, "sgd", {"learning_rate": 0.05}, False, monkeypatch)
    _run(mod, 2, _batch(tmx))
    assert mod._fused is None


def test_fused_fallback_nonfusable_optimizer(monkeypatch):
    before = profiler.counters().get("fused_step_fallbacks", 0)
    mod = _module(tmx, "adadelta", {}, True, monkeypatch)
    args0, _ = _run(mod, 0, _batch(tmx))
    args2, _ = _run(mod, 2, _batch(tmx))
    assert mod._fused is False
    assert profiler.counters().get("fused_step_fallbacks", 0) == before + 1
    assert any(not np.array_equal(args0[k], args2[k]) for k in args0)


@pytest.mark.parametrize("case", ["monitor", "inputs_need_grad",
                                  "grad_req_add"])
def test_fallback_matrix_runs_eager_counted(case, monkeypatch):
    """The Module-path fallback matrix: each step runs the eager path
    and is counted, with the eager path's numbers."""
    monkeypatch.setenv("MXNET_FUSED_STEP", "1")
    mod = tmx.module.Module(_mlp_sym(tmx), context=tmx.cpu())
    mod.bind(data_shapes=[("data", (8, 10))],
             label_shapes=[("softmax_label", (8,))],
             inputs_need_grad=case == "inputs_need_grad",
             grad_req="add" if case == "grad_req_add" else "write")
    mod.init_params(initializer=tmx.init.Xavier())
    mod.init_optimizer(optimizer="sgd",
                       optimizer_params={"learning_rate": 0.05})
    if case == "monitor":
        mod.install_monitor(_Mon())
    before = profiler.counters().get("fused_step_fallbacks", 0)
    _run(mod, 2, _batch(tmx))
    assert profiler.counters().get("fused_step_fallbacks", 0) == before + 2
    assert mod._fused is None


class _Mon:
    """The minimal Monitor protocol: install a per-output callback."""

    def install(self, exe):
        exe.set_monitor_callback(lambda name, arr: None)


def test_trainer_fused_matches_eager(monkeypatch):
    rng = np.random.RandomState(5)
    x = tmx.nd.array(rng.uniform(-1, 1, (5, 6)).astype(np.float32))

    def run(fused):
        monkeypatch.setenv("MXNET_FUSED_STEP", "1" if fused else "0")
        net = gluon.nn.Dense(4, in_units=6)
        net.initialize(tmx.init.Xavier())
        params = net.collect_params()
        for i, p in enumerate(params.values()):
            p.set_data(tmx.nd.array(np.random.RandomState(20 + i).uniform(
                -0.2, 0.2, p.shape).astype(np.float32)))
        trainer = gluon.Trainer(params, "adam", {"learning_rate": 0.01})
        for _ in range(5):
            with autograd.record():
                out = net(x)
                loss = (out * out).sum()
            loss.backward()
            trainer.step(5)
        return [p.data().asnumpy().copy() for p in params.values()], \
            trainer

    eager, _ = run(False)
    fused, trainer = run(True)
    fu = trainer._fused_updater
    assert fu.dispatch_count == 5
    assert fu.stats() == dict(captures=1, replays=5, recaptures=0,
                              signatures=1, dispatches=5)
    for i, (a, b) in enumerate(zip(eager, fused)):
        np.testing.assert_array_equal(a, b, err_msg="param %d" % i)


def test_trainer_capture_failure_raises(monkeypatch):
    monkeypatch.setenv("MXNET_FUSED_STEP", "1")
    fused_step.set_graph_factory(
        lambda: tco._Graphs("cpu", capture=_standin(fail=True)))
    net = gluon.nn.Dense(2, in_units=3)
    net.initialize(tmx.init.Xavier())
    trainer = gluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": 0.1})
    with autograd.record():
        loss = net(tmx.nd.ones((2, 3))).sum()
    loss.backward()
    w0 = net.weight.data().asnumpy().copy()
    with pytest.raises(RuntimeError, match="capture failed"):
        trainer.step(2)
    np.testing.assert_array_equal(net.weight.data().asnumpy(), w0)


def test_fused_with_frozen_params(monkeypatch):
    batch = _batch(tmx)
    results = []
    for fused in (False, True):
        mod = _module(tmx, "sgd", {"learning_rate": 0.05, "momentum": 0.9},
                      fused, monkeypatch, fixed=["fc1_weight", "fc1_bias"])
        results.append(_run(mod, 3, batch))
        if fused:
            assert mod._fused.dispatch_count == 3
    (args_e, _), (args_f, _) = results
    for k in args_e:
        np.testing.assert_array_equal(args_e[k], args_f[k], err_msg=k)
    w0 = np.random.RandomState(11).uniform(-0.1, 0.1,
                                           args_f["fc1_bias"].shape)
    np.testing.assert_array_equal(args_f["fc1_bias"], w0.astype(np.float32))


def test_fused_observer_materializes_eager(monkeypatch):
    batch = _batch(tmx)
    mods = [_module(tmx, "sgd", {"learning_rate": 0.05}, f, monkeypatch)
            for f in (False, True)]
    for mod in mods:
        mod.forward(batch, is_train=True)
        mod.backward()
        assert mod.get_outputs()[0].shape == (8, 4)
        mod.update()
    a, b = (m.get_params()[0] for m in mods)
    for k in a:
        np.testing.assert_array_equal(a[k].asnumpy(), b[k].asnumpy())


def test_fused_fit_loop(monkeypatch):
    monkeypatch.setenv("MXNET_FUSED_STEP", "1")
    rng = np.random.RandomState(9)
    n = 64
    x = rng.uniform(0, 1, (n, 10)).astype(np.float32)
    w = rng.uniform(-1, 1, (10, 4)).astype(np.float32)
    y = np.argmax(x @ w, axis=1).astype(np.float32)
    it = tmx.io.NDArrayIter(x, y, batch_size=8, label_name="softmax_label")
    mod = tmx.module.Module(_mlp_sym(tmx), context=tmx.cpu())
    mod.fit(it, optimizer="sgd",
            optimizer_params={"learning_rate": 0.3, "momentum": 0.9},
            num_epoch=5)
    assert mod._fused.dispatch_count == 5 * (n // 8)
    assert mod._fused.stats()["captures"] == 1
    assert mod.score(it, "acc")[0][1] > 0.5
