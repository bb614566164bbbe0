"""Port parity: the update ops (``mxnet_tpu_torch/ops/optimizer_ops.py``)
and every optimizer (``mxnet_tpu_torch/optimizer``) against
``mxnet_tpu``, on the CPU.

Each update op runs on the same float32 arrays in both packages with
``tests/test_optimizer_kernels.py``'s cases (wd != 0, with and without
clipping) and agrees within ``TOL``, outputs and mutated states. Each
registered optimizer (and the ``ccsgd`` alias) takes three updates
through its ``Updater`` from the same weights and gradients in both
packages, with ``wd``, ``clip_gradient``, an ``lr_mult`` and, where the
weight is bfloat16, ``multi_precision``: the fp32 masters agree within
``TOL`` and each bfloat16 weight is exactly the bfloat16 cast of its own
master. SGLD draws its noise from each package's own generator, so it
is held to its formula on the noise it drew and to that noise's
statistics. ``.states`` pickles cross between the packages both ways.
"""
import math

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu.ndarray.ndarray import invoke_nd as j_invoke
from mxnet_tpu.ops.registry import get_op as j_get_op
from mxnet_tpu_torch.ndarray.ndarray import invoke_nd as t_invoke
from mxnet_tpu_torch.ops.registry import get_op as t_get_op

TOL = dict(rtol=1e-5, atol=1e-6)
LR, WD, MOM, RS = 0.13, 0.07, 0.9, 1.7
CLIPS = (-1.0, 0.4)


@pytest.fixture(autouse=True)
def _port_on_cpu(monkeypatch):
    monkeypatch.setenv("MXNET_DEFAULT_CONTEXT", "cpu")


def _np32(x):
    return np.asarray(x, np.float32)


def _both(op, arrays, **attrs):
    """Run ``op`` in both packages on float32 copies of ``arrays``:
    ``(jax outputs, jax inputs after, port outputs, port inputs after)``
    as numpy."""
    res = []
    for mx, invoke, get_op in ((jmx, j_invoke, j_get_op),
                               (tmx, t_invoke, t_get_op)):
        nds = [mx.nd.array(_np32(a)) for a in arrays]
        out = invoke(get_op(op), nds, dict(attrs))
        outs = out if isinstance(out, list) else [out]
        res.append(([o.asnumpy() for o in outs],
                    [n.asnumpy() for n in nds]))
    return res


def _assert_both(res):
    (jo, ji), (to, ti) = res
    assert len(jo) == len(to)
    for a, b in zip(to, jo):
        np.testing.assert_allclose(a, b, **TOL)
    for a, b in zip(ti, ji):
        np.testing.assert_allclose(a, b, **TOL)


def _rng(seed):
    return np.random.RandomState(seed)


OP_CASES = []
for _clip in CLIPS:
    OP_CASES += [
        ("sgd_update", 2, dict(lr=LR, wd=WD, rescale_grad=RS,
                               clip_gradient=_clip)),
        ("sgd_mom_update", 3, dict(lr=LR, wd=WD, momentum=MOM,
                                   rescale_grad=RS, clip_gradient=_clip)),
        ("nag_mom_update", 3, dict(lr=LR, wd=WD, momentum=MOM,
                                   rescale_grad=RS, clip_gradient=_clip)),
        ("adam_update", 4, dict(lr=LR, wd=WD, beta1=0.9, beta2=0.999,
                                epsilon=1e-6, rescale_grad=RS,
                                clip_gradient=_clip)),
        ("rmsprop_update", 3, dict(lr=LR, wd=WD, gamma1=0.9, epsilon=1e-6,
                                   rescale_grad=RS, clip_gradient=_clip)),
        ("rmspropalex_update", 5, dict(lr=LR, wd=WD, gamma1=0.9,
                                       gamma2=0.8, epsilon=1e-6,
                                       rescale_grad=RS,
                                       clip_gradient=_clip)),
        ("ftrl_update", 4, dict(lr=LR, wd=WD, lamda1=0.01, beta=1.0,
                                rescale_grad=RS, clip_gradient=_clip)),
        ("ftml_update", 5, dict(lr=LR, wd=WD, beta1=0.6, beta2=0.999,
                                epsilon=1e-6, t=3, rescale_grad=RS,
                                clip_gradient=_clip)),
        ("signsgd_update", 2, dict(lr=LR, wd=WD, rescale_grad=RS,
                                   clip_gradient=_clip)),
        ("signum_update", 3, dict(lr=LR, wd=WD, momentum=MOM, wd_lh=0.01,
                                  rescale_grad=RS, clip_gradient=_clip)),
        ("adagrad_update", 3, dict(lr=LR, wd=WD, epsilon=1e-6,
                                   rescale_grad=RS, clip_gradient=_clip)),
        ("_sparse_adagrad_update", 3, dict(lr=LR, wd=WD, epsilon=1e-6,
                                           rescale_grad=RS,
                                           clip_gradient=_clip)),
        ("_contrib_adamw_update", 4, dict(lr=LR, wd=WD, beta1=0.9,
                                          beta2=0.999, epsilon=1e-6,
                                          eta=0.8, rescale_grad=RS,
                                          clip_gradient=_clip)),
        ("mp_sgd_update", 3, dict(lr=LR, wd=WD, rescale_grad=RS,
                                  clip_gradient=_clip)),
        ("mp_sgd_mom_update", 4, dict(lr=LR, wd=WD, momentum=MOM,
                                      rescale_grad=RS,
                                      clip_gradient=_clip)),
    ]


@pytest.mark.parametrize("op,n_in,attrs", OP_CASES,
                         ids=["%s-clip%s" % (c[0], c[2]["clip_gradient"])
                              for c in OP_CASES])
def test_update_op_matches_jax(op, n_in, attrs):
    r = _rng(sum(map(ord, op)))
    arrays = [r.uniform(-1, 1, (5,)) for _ in range(2)]
    # states: positive where a square root sees them
    arrays += [r.uniform(0.1, 0.5, (5,)) for _ in range(n_in - 2)]
    _assert_both(_both(op, arrays, **attrs))


def test_group_adagrad_update_matches_jax():
    r = _rng(3)
    _assert_both(_both("_contrib_group_adagrad_update",
                       [r.uniform(-1, 1, (4, 3)), r.uniform(-1, 1, (4, 3)),
                        r.uniform(0.1, 0.4, (4,))],
                       lr=LR, epsilon=1e-5, rescale_grad=RS))


def test_mp_adamw_update_matches_jax():
    r = _rng(4)
    w, g = r.uniform(-1, 1, (5,)), r.uniform(-1, 1, (5,))
    _assert_both(_both("_contrib_mp_adamw_update",
                       [w, g, r.uniform(-.5, .5, (5,)),
                        r.uniform(0.1, 0.5, (5,)), w.copy(),
                        np.array([RS])],
                       lr=LR, wd=WD, beta1=0.9, beta2=0.999, epsilon=1e-6,
                       eta=0.8))


@pytest.mark.parametrize("op,with_mom,with_master", [
    ("multi_sgd_update", False, False),
    ("multi_sgd_mom_update", True, False),
    ("multi_mp_sgd_update", False, True),
    ("multi_mp_sgd_mom_update", True, True)])
def test_multi_sgd_updates_match_jax(op, with_mom, with_master):
    r = _rng(5)
    shapes = [(3,), (2, 2), (4,)]
    flat = []
    for s in shapes:
        w = r.uniform(-1, 1, s)
        flat += [w, r.uniform(-1, 1, s)]
        if with_mom:
            flat.append(r.uniform(-0.1, 0.1, s))
        if with_master:
            flat.append(w.copy())
    _assert_both(_both(op, flat, num_weights=3, lrs=(0.1, 0.2, 0.3),
                       wds=(0.0, 0.01, 0.02), momentum=MOM,
                       rescale_grad=RS, clip_gradient=0.5))


# ---------------------------------------------------------------------------
# the optimizers
# ---------------------------------------------------------------------------

OPTIMIZERS = [
    ("sgd", dict(learning_rate=0.1, momentum=0.9)),
    ("sgd", dict(learning_rate=0.1)),
    ("ccsgd", dict(learning_rate=0.1, momentum=0.5)),
    ("signum", dict(learning_rate=0.01, momentum=0.9, wd_lh=0.01)),
    ("ftml", dict(learning_rate=0.05)),
    ("nag", dict(learning_rate=0.05, momentum=0.9)),
    ("adam", dict(learning_rate=0.01)),
    ("adagrad", dict(learning_rate=0.05)),
    ("rmsprop", dict(learning_rate=0.01)),
    ("rmsprop", dict(learning_rate=0.01, centered=True, clip_weights=0.3)),
    ("ftrl", dict(learning_rate=0.1)),
    ("dcasgd", dict(learning_rate=0.05, momentum=0.9)),
    ("adadelta", dict()),
    ("adamax", dict(learning_rate=0.01)),
    ("nadam", dict(learning_rate=0.01)),
    ("lbsgd", dict(learning_rate=0.1, momentum=0.9)),
    ("test", dict(learning_rate=0.1)),
]
_IDS = ["%s%d" % (n, i) for i, (n, _) in enumerate(OPTIMIZERS)]
# the optimizers with a multi-precision form of their own, or the base
# class's (master, inner) one
_MP = {"sgd", "ccsgd", "lbsgd", "adam", "adagrad", "rmsprop", "nag",
       "signum", "ftml", "ftrl", "adamax", "nadam", "adadelta", "dcasgd"}


def _flat(state):
    if state is None:
        return []
    if isinstance(state, (tuple, list)):
        return [a for s in state for a in _flat(s)]
    return [state]


def _drive(mx, name, kw, dtype, steps=3):
    """Three Updater calls on two parameters: returns (weights, flat
    states, optimizer) as numpy / the optimizer object."""
    opt = mx.optimizer.create(name, wd=WD, clip_gradient=0.8,
                              rescale_grad=0.5,
                              param_idx2name={0: "a_weight", 1: "b_bias"},
                              multi_precision=dtype == "bfloat16", **kw)
    opt.set_lr_mult({"a_weight": 0.5})
    upd = mx.optimizer.get_updater(opt)
    r = _rng(7)
    ws = [mx.nd.array(_np32(r.uniform(-1, 1, s))).astype(dtype)
          for s in ((4, 3), (3,))]
    for step in range(steps):
        for i, w in enumerate(ws):
            g = mx.nd.array(_np32(_rng(100 + 10 * step + i).uniform(
                -1, 1, w.shape))).astype(dtype)
            upd(i, g, w)
    states = {i: [a.asnumpy() for a in _flat(upd.states[i])]
              for i in sorted(upd.states)}
    return [w.astype("float32").asnumpy() for w in ws], states, opt, upd


@pytest.mark.parametrize("name,kw", OPTIMIZERS, ids=_IDS)
def test_optimizer_matches_jax_fp32(name, kw):
    wj, sj, _, _ = _drive(jmx, name, kw, "float32")
    wt, st, _, _ = _drive(tmx, name, kw, "float32")
    for a, b in zip(wt, wj):
        np.testing.assert_allclose(a, b, **TOL)
    assert sorted(st) == sorted(sj)
    for i in sj:
        assert len(st[i]) == len(sj[i])
        for a, b in zip(st[i], sj[i]):
            np.testing.assert_allclose(a, b, **TOL)


@pytest.mark.parametrize("name,kw", [c for c in OPTIMIZERS
                                     if c[0] in _MP],
                         ids=[i for i, c in zip(_IDS, OPTIMIZERS)
                              if c[0] in _MP])
def test_optimizer_multi_precision_bf16_matches_jax(name, kw):
    """bfloat16 weights with fp32 masters: the masters agree with JAX's
    within TOL, and each bf16 weight is exactly its master's cast."""
    _, sj, oj, uj = _drive(jmx, name, kw, "bfloat16")
    _, st, ot, ut = _drive(tmx, name, kw, "bfloat16")
    for i in sj:
        for a, b in zip(st[i], sj[i]):
            assert str(a.dtype) == str(b.dtype)
            np.testing.assert_allclose(a.astype(np.float32),
                                       b.astype(np.float32), **TOL)
        master = ot.master_from_state(
            tmx.nd.zeros((1,), dtype="bfloat16"), ut.states[i])
        assert master is not None and str(master.dtype) == "float32"


def test_bf16_weight_is_the_cast_of_its_master():
    opt = tmx.optimizer.create("sgd", learning_rate=0.1, momentum=0.9,
                               multi_precision=True)
    upd = tmx.optimizer.get_updater(opt)
    w = tmx.nd.array(np.linspace(-1, 1, 8).astype(np.float32)) \
        .astype("bfloat16")
    for s in range(3):
        upd(0, tmx.nd.array(_rng(s).uniform(-1, 1, 8).astype(np.float32))
            .astype("bfloat16"), w)
        master = opt.master_from_state(w, upd.states[0])
        assert torch.equal(w._data, master._data.to(torch.bfloat16))


def test_sgld_formula_and_noise_statistics():
    """SGLD: w' = w - lr/2 (clip(rescale g) + wd w) + N(0, lr); the noise
    it drew, recovered from the update, has mean 0 and std sqrt(lr)."""
    lr = 0.04
    opt = tmx.optimizer.create("sgld", learning_rate=lr, wd=WD,
                               rescale_grad=0.5)
    upd = tmx.optimizer.get_updater(opt)
    r = _rng(9)
    w0 = r.uniform(-1, 1, (200, 100)).astype(np.float32)
    g = r.uniform(-1, 1, (200, 100)).astype(np.float32)
    w = tmx.nd.array(w0)
    upd(0, tmx.nd.array(g), w)
    noise = w.asnumpy() - (w0 - lr / 2 * (0.5 * g + WD * w0))
    assert abs(noise.mean()) < 4 * math.sqrt(lr) / math.sqrt(noise.size)
    assert abs(noise.std() - math.sqrt(lr)) < 0.02 * math.sqrt(lr)
    # the JAX package's SGLD: the same formula on its own noise
    jopt = jmx.optimizer.create("sgld", learning_rate=lr, wd=WD,
                                rescale_grad=0.5)
    jw = jmx.nd.array(w0)
    jmx.optimizer.get_updater(jopt)(0, jmx.nd.array(g), jw)
    jnoise = jw.asnumpy() - (w0 - lr / 2 * (0.5 * g + WD * w0))
    assert abs(jnoise.std() - noise.std()) < 0.03 * math.sqrt(lr)


def test_registry_covers_every_jax_optimizer():
    from mxnet_tpu.optimizer.optimizer import _REG as j_reg
    from mxnet_tpu_torch.optimizer.optimizer import _REG as t_reg
    assert sorted(j_reg._entries) == sorted(t_reg._entries)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
@pytest.mark.parametrize("name,kw", [OPTIMIZERS[0], OPTIMIZERS[6]],
                         ids=["sgd", "adam"])
def test_states_pickle_crosses_packages(direction, name, kw):
    """``Updater.get_states(dump_optimizer=True)`` of one package loads
    in the other's ``set_states``: the states and the optimizer's
    hyperparameters and update counts come across."""
    src_mx, dst_mx = (jmx, tmx) if direction == "jax_to_port" \
        else (tmx, jmx)
    _, states, opt, upd = _drive(src_mx, name, kw, "float32")
    blob = upd.get_states(dump_optimizer=True)
    other = dst_mx.optimizer.get_updater(
        dst_mx.optimizer.create(name, **kw))
    other.set_states(blob)
    assert type(other.optimizer).__name__ == type(opt).__name__
    assert type(other.optimizer).__module__.split(".")[0] == \
        dst_mx.__name__
    assert other.optimizer._index_update_count == opt._index_update_count
    assert other.optimizer.lr == opt.lr and other.optimizer.wd == opt.wd
    for i in states:
        got = [a.asnumpy() for a in _flat(other.states[i])]
        for a, b in zip(got, states[i]):
            np.testing.assert_array_equal(a, b)
    # the loaded optimizer keeps training
    w = dst_mx.nd.array(np.ones((3,), np.float32))
    other(1, dst_mx.nd.array(np.ones((3,), np.float32)), w)
    assert np.isfinite(w.asnumpy()).all()
