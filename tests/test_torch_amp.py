"""Port parity: AMP (``mxnet_tpu_torch/amp.py``), the multi-precision
fused update and the loss-scale slot of the fused step, against
``mxnet_tpu`` on the CPU (``tests/test_amp.py``'s cases).

- the policy: resolution order, the ``MXNET_AMP_RULES`` grammar, the
  manifest record, per-parameter casts, all compared with the JAX
  package's answers;
- ``_run_amp``'s MLP (bfloat16 policy, hybridized, ``multi_precision``)
  for sgd, sgd-momentum and adam: within the port, the fused update
  (through a stand-in capture) equals the eager loop bit for bit,
  weights and fp32 masters, on ONE capture; against JAX, the fp32
  masters after 5 steps agree within ``MASTER_TOL``. The first bfloat16
  forward is identical in both packages, but XLA's CPU backward
  accumulates its bfloat16 reductions otherwise than torch (the bias
  gradient, a batch sum, lands up to 4.6 bfloat16 steps apart), and
  over 5 steps the masters then differ by at most 5.7e-4 (measured on
  the CPU: 1.5e-4 sgd, 5.7e-4 sgd-momentum, 2.5e-4 adam), held to
  1e-3;
- the cross-policy checkpoint resume and ``seed_masters``;
- a planned grad poison under ``scale_backoff``: the update skipped
  inside the step, the loss scale halved, no recapture;
- the loss-scale trajectory in diagnose.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import autograd, fault, fused_step, gluon, profiler
from mxnet_tpu_torch import cached_op as tco
from mxnet_tpu_torch.amp import DtypePolicy, parse_rules

MASTER_TOL = dict(rtol=0, atol=1e-3)


def _standin(body, device, pool):
    out = body()

    def replay():
        for o, r in zip(out, body()):
            o.copy_(r)
    return replay, out, {}


@pytest.fixture(autouse=True)
def _setup(monkeypatch):
    monkeypatch.setenv("MXNET_DEFAULT_CONTEXT", "cpu")
    fused_step.set_graph_factory(lambda: tco._Graphs("cpu",
                                                     capture=_standin))
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


# ---------------------------------------------------------------------------
# the policy
# ---------------------------------------------------------------------------

NAMES = ["fc1_weight", "bn0_gamma", "bn0_running_mean", "fc2_weight",
         "fc2_bias", "layernorm0_beta", "embed_weight", "dense3_weight"]


@pytest.mark.parametrize("compute,rules", [
    ("bfloat16", {"fc1": "float32"}),
    ("bfloat16", {"weight": "float32", "fc1_weight": "bfloat16"}),
    ("float16", {}),
    ("float32", {"fc2": "bfloat16"})])
def test_policy_resolution_matches_jax(compute, rules):
    from mxnet_tpu.amp import DtypePolicy as JaxPolicy
    jp, tp = JaxPolicy(compute, rules), DtypePolicy(compute, rules)
    assert [tp.resolve(n) for n in NAMES] == [jp.resolve(n) for n in NAMES]
    assert tp.is_mixed() == jp.is_mixed()
    assert tp.describe() == jp.describe()
    again = DtypePolicy.from_describe(jp.describe())
    assert again.compute == compute and again.rules == rules
    assert DtypePolicy.from_describe(None) is None


def test_parse_rules_and_env(monkeypatch):
    from mxnet_tpu.amp import parse_rules as j_parse
    spec = " fc1=float32 , embed=bfloat16 "
    assert parse_rules(spec) == j_parse(spec) == {"fc1": "float32",
                                                 "embed": "bfloat16"}
    for bad in ("fc1:float32", "fc1=int8"):
        with pytest.raises(tmx.MXNetError):
            parse_rules(bad)
    monkeypatch.setenv("MXNET_AMP_POLICY", "")
    assert DtypePolicy.from_env() is None
    monkeypatch.setenv("MXNET_AMP_POLICY", "bfloat16")
    monkeypatch.setenv("MXNET_AMP_RULES", "fc1=float32")
    pol = DtypePolicy.from_env()
    assert pol.compute == "bfloat16" and pol.resolve("fc1_weight") == \
        "float32"


def _mlp(mx):
    net = mx.gluon.nn.HybridSequential()
    net.add(mx.gluon.nn.Dense(16, activation="relu", in_units=6))
    net.add(mx.gluon.nn.Dense(4, in_units=16))
    net.initialize(mx.init.Xavier())
    return net


def test_policy_apply_casts_per_param():
    dts = []
    for mx in (jmx, tmx):
        net = _mlp(mx)
        first = list(net.collect_params().values())[0].name
        DtypePolicy("bfloat16", rules={first.rsplit("_", 1)[0]:
                                       "float32"}).apply(net) \
            if mx is tmx else jmx.amp.DtypePolicy(
                "bfloat16", rules={first.rsplit("_", 1)[0]:
                                   "float32"}).apply(net)
        dts.append([str(p.data().dtype)
                    for p in net.collect_params().values()])
    assert dts[0] == dts[1] == ["float32", "float32", "bfloat16",
                                "bfloat16"]


def test_cast_params_module_form():
    params = {"fc_weight": tmx.nd.ones((2, 2)),
              "bn_gamma": tmx.nd.ones((2,))}
    out = DtypePolicy("bfloat16").cast_params(params)
    assert str(out["fc_weight"].dtype) == "bfloat16"
    assert out["bn_gamma"] is params["bn_gamma"]


# ---------------------------------------------------------------------------
# the multi-precision fused update
# ---------------------------------------------------------------------------

def _amp_batch(seed=3):
    rng = np.random.RandomState(seed)
    return (rng.uniform(-1, 1, (8, 6)).astype(np.float32),
            rng.randint(0, 4, (8,)).astype(np.float32))


def _run_amp(mx, optimizer, opt_params, fused, monkeypatch, steps=5):
    monkeypatch.setenv("MXNET_FUSED_STEP", "1" if fused else "0")
    x, y = _amp_batch()
    net = _mlp(mx)
    params = net.collect_params()
    for i, p in enumerate(params.values()):
        p.set_data(mx.nd.array(np.random.RandomState(20 + i).uniform(
            -0.2, 0.2, p.shape).astype(np.float32)))
    mx.amp.DtypePolicy("bfloat16").apply(net)
    net.hybridize()
    trainer = mx.gluon.Trainer(params, optimizer,
                               dict(opt_params, multi_precision=True))
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    xb = mx.nd.array(x).astype("bfloat16")
    yb = mx.nd.array(y)
    for _ in range(steps):
        with mx.autograd.record():
            loss = loss_fn(net(xb).astype("float32"), yb)
        loss.backward()
        trainer.step(len(x))
    weights = [p.data().astype("float32").asnumpy()
               for p in params.values()]
    masters = [m.asnumpy() for _, m in sorted(
        mx.amp.master_params(trainer).items(),
        key=lambda kv: list(params.keys()).index(kv[0]))]
    return weights, masters, trainer


AMP_OPTIMIZERS = [
    ("sgd", {"learning_rate": 0.1}),
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9}),
    ("adam", {"learning_rate": 0.01}),
]
_AMP_IDS = ["sgd", "sgd-momentum", "adam"]


@pytest.mark.parametrize("opt,params", AMP_OPTIMIZERS, ids=_AMP_IDS)
def test_amp_fused_bitexact_with_eager(opt, params, monkeypatch):
    w_e, m_e, _ = _run_amp(tmx, opt, params, False, monkeypatch)
    before = profiler.counters().get("fused_step_fallbacks", 0)
    w_f, m_f, trainer = _run_amp(tmx, opt, params, True, monkeypatch)
    assert profiler.counters().get("fused_step_fallbacks", 0) == before
    fu = trainer._fused_updater
    assert fu.dispatch_count == 5
    assert fu.stats()["captures"] == 1 and fu.stats()["recaptures"] == 0
    assert len(m_e) == len(m_f) == 4
    for a, b in zip(m_e, m_f):
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    for a, b in zip(w_e, w_f):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("opt,params", AMP_OPTIMIZERS, ids=_AMP_IDS)
def test_amp_masters_match_jax(opt, params, monkeypatch):
    _, m_j, _ = _run_amp(jmx, opt, params, True, monkeypatch)
    w_t, m_t, trainer = _run_amp(tmx, opt, params, True, monkeypatch)
    assert len(m_j) == len(m_t) == 4
    for a, b in zip(m_t, m_j):
        np.testing.assert_allclose(a, b, **MASTER_TOL)
    # each bf16 weight is exactly the bf16 cast of its own master
    for p, m in zip(trainer._params, m_t):
        assert torch.equal(p.data()._data,
                           torch.from_numpy(m).to(torch.bfloat16))


def test_amp_weights_track_masters():
    opt = tmx.optimizer.create("sgd", learning_rate=0.1, momentum=0.9,
                               multi_precision=True)
    w = tmx.nd.array(np.linspace(-1, 1, 8).astype(np.float32)) \
        .astype("bfloat16")
    state = opt.create_state_multi_precision(0, w)
    master = opt.master_from_state(w, state)
    assert master is not None and str(master.dtype) == "float32"
    np.testing.assert_array_equal(
        w.astype("float32").asnumpy(),
        master.astype("bfloat16").astype("float32").asnumpy())


# ---------------------------------------------------------------------------
# checkpoint: the policy in the manifest, cross-policy resume
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_cross_policy_resume(writer, tmp_path, monkeypatch):
    """An AMP checkpoint (fp32 masters + the policy in the manifest
    meta), written by either package, resumes in the port under fp32 as
    its exact masters and under the manifest's bfloat16 policy as their
    casts; seed_masters makes a fresh Trainer's masters bit-identical."""
    mx = jmx if writer == "jax" else tmx
    _, _, trainer = _run_amp(mx, "sgd", {"learning_rate": 0.1,
                                         "momentum": 0.9}, True,
                             monkeypatch, steps=3)
    params = list(trainer._params)
    masters = mx.amp.master_params(trainer)
    arg = {p.name: p.data() for p in params}
    arg.update(masters)
    prefix = str(tmp_path / "amp")
    mx.checkpoint.save_arrays(
        prefix, 0, mx.checkpoint.snapshot_params(arg),
        meta={"dtype_policy": mx.amp.DtypePolicy("bfloat16").describe()})
    want = {n: m.asnumpy() for n, m in masters.items()}

    from mxnet_tpu_torch import checkpoint
    saved = checkpoint.saved_dtype_policy(prefix, 0)
    assert saved is not None and saved.compute == "bfloat16"
    a32, _ = checkpoint.restore_params(prefix, 0,
                                       policy=DtypePolicy("float32"))
    for name, m in want.items():
        assert str(a32[name].dtype) == "float32"
        np.testing.assert_array_equal(a32[name].asnumpy(), m)
    ab, _ = checkpoint.restore_params(prefix, 0, policy="manifest")
    for name, m in want.items():
        assert str(ab[name].dtype) == "bfloat16"
        assert torch.equal(ab[name]._data,
                           torch.from_numpy(m).to(torch.bfloat16))

    raw, _ = checkpoint.restore_params(prefix, 0)
    net2 = _mlp(tmx)
    params2 = list(net2.collect_params().values())
    for p2, p in zip(params2, params):
        p2.set_data(raw[p.name].astype("float32"))
    DtypePolicy("bfloat16").apply(net2)
    trainer2 = gluon.Trainer(net2.collect_params(), "sgd",
                             {"learning_rate": 0.1, "momentum": 0.9,
                              "multi_precision": True})
    seeded = tmx.amp.seed_masters(
        trainer2, {p2.name: raw[p.name] for p2, p in zip(params2, params)})
    assert seeded == len(params)
    m2 = tmx.amp.master_params(trainer2)
    for p2, p in zip(params2, params):
        np.testing.assert_array_equal(m2[p2.name].asnumpy(), want[p.name])


# ---------------------------------------------------------------------------
# the guard under AMP
# ---------------------------------------------------------------------------

def test_amp_poison_backoff_in_program_no_recapture(monkeypatch):
    monkeypatch.setenv("MXNET_FUSED_STEP", "1")
    monkeypatch.setenv("MXNET_NONFINITE_GUARD", "scale_backoff")
    x, y = _amp_batch()
    net = _mlp(tmx)
    DtypePolicy("bfloat16").apply(net)
    net.hybridize()
    params = net.collect_params()
    n_params = len(list(params.values()))
    trainer = gluon.Trainer(params, "sgd",
                            {"learning_rate": 0.1, "momentum": 0.9,
                             "multi_precision": True})
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    fault.set_plan("grad:step=%d:nan:count=%d"
                   % (2 * n_params + 1, n_params))
    scale0 = fault.loss_scale()
    assert scale0 == 2.0 ** 15
    xb = tmx.nd.array(x).astype("bfloat16")
    yb = tmx.nd.array(y)
    snaps = []
    for _ in range(5):
        with autograd.record():
            loss = loss_fn(net(xb).astype("float32"), yb) \
                * fault.loss_scale()
        loss.backward()
        trainer.step(len(x))
        snaps.append([p.data().astype("float32").asnumpy()
                      for p in params.values()])
    st = fault.stats()
    assert st["skipped_steps"] == 1
    assert st["injected"]["grad"] == n_params
    assert fault.loss_scale() == scale0 / 2.0
    for a, b in zip(snaps[1], snaps[2]):
        np.testing.assert_array_equal(a, b)
    assert any(not np.array_equal(a, b) for a, b in zip(snaps[2], snaps[3]))
    fu = trainer._fused_updater
    assert fu.dispatch_count == 5
    assert fu.stats()["captures"] == 1 and fu.stats()["recaptures"] == 0


def test_loss_scale_trajectory_matches_jax(tmp_path, monkeypatch):
    """Every scale change is one loss_scale telemetry record, as in the
    JAX package, and diagnose renders the trajectory."""
    from mxnet_tpu_torch import telemetry
    from mxnet_tpu_torch.tools import diagnose
    monkeypatch.setenv("MXNET_NONFINITE_GUARD", "scale_backoff")
    monkeypatch.setenv("MXNET_LOSS_SCALE_WINDOW", "2")
    trajs = []
    for mx, tel in ((jmx, jmx.telemetry), (tmx, telemetry)):
        mx.fault.reset()
        sink = str(tmp_path / ("%s.jsonl" % mx.__name__))
        tel.start(sink)
        for ok in (False, False, True, True, True):
            mx.fault.fused_step_guard(ok)
        tel.stop()
        trajs.append(diagnose.read_telemetry(sink)["loss_scale"])
    strip = [[{k: r[k] for k in ("prev", "scale", "cause")} for r in t]
             for t in trajs]
    assert strip[0] == strip[1]
    assert [r["cause"] for r in strip[1]] == ["backoff", "backoff",
                                              "regrow"]
    text = diagnose.format_telemetry(diagnose.read_telemetry(
        str(tmp_path / "mxnet_tpu_torch.jsonl")))
    assert "----------Loss Scale----------" in text
    assert "2 backoff(s), 1 regrow(s)" in text
