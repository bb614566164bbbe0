"""The attention kernels as ``torch.library`` ops
(``mxnet_tpu_torch::flash_fwd``, ``::flash_bwd_dkdv``, ``::flash_bwd_dq``,
``::flash_decode``, ``::flash_decode_q8``), on the CPU:

- ``torch.library.opcheck`` on each op (schema, autograd registration,
  the fake implementation against the CPU one, AOT dispatch);
- ``flash_attention`` through the op, forward and gradients, against the
  JAX package's ``flash_attention`` with its Pallas kernels in interpret
  mode (rtol = atol = 2e-5, ROADMAP rule 5): causal, non-causal, with a
  segment plane (pad rows carry a zero cotangent, as a masked loss puts
  it, and are left out of the forward comparison), and bfloat16 at
  ``BF16_TOL``; each call is seen to reach the op;
- ``_contrib_flash_attention`` and ``_contrib_decode_attention`` infer
  their shapes on ``meta`` tensors through the ops' fake
  implementations, equal to the JAX package's ``infer_shape``.

Inputs come from numpy with a seed. The ops' CUDA implementations launch
the kernels, which run only on a card: chip_smoke.py holds them there."""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

jfa = importlib.import_module("mxnet_tpu.parallel.flash_attention")
tfa = importlib.import_module("mxnet_tpu_torch.parallel.flash_attention")

TOL = dict(rtol=2e-5, atol=2e-5)
BF16_TOL = dict(rtol=8e-3, atol=1e-5)


@pytest.fixture(autouse=True)
def _port_on_cpu(monkeypatch):
    monkeypatch.setenv("MXNET_DEFAULT_CONTEXT", "cpu")


def _t(x, grad=False):
    return torch.from_numpy(np.asarray(x)).requires_grad_(grad)


def _opcheck_args(name, rs):
    B, T, H, D = 2, 24, 2, 8

    def f(*shape, grad=False):
        return _t(rs.randn(*shape).astype(np.float32), grad)
    seg = np.ones((B, T), np.int32)
    seg[0, 10:] = 2
    seg[1, 20:] = 0
    seg = torch.from_numpy(seg)
    q, k, v = (f(B, T, H, D, grad=True) for _ in range(3))
    lse = f(B, H, T)
    if name == "flash_fwd":
        return [(q, k, v, None, 0.3, True, None),
                (q, k, v, seg, 0.3, False, torch.bfloat16)]
    if name in ("flash_bwd_dkdv", "flash_bwd_dq"):
        q, k, v, do = (f(B, T, H, D) for _ in range(4))
        return [(q, k, v, do, lse, f(B, H, T), seg, 0.35, True)]
    lens = torch.tensor([5, T], dtype=torch.int32)
    q1 = f(B, 1, H, D)
    if name == "flash_decode":
        return [(q1, f(B, T, H, D), f(B, T, H, D), lens, 0.35)]
    k8, v8 = (torch.from_numpy(rs.randint(-127, 128, (B, T, H, D)).astype(
        np.int8)) for _ in range(2))
    return [(q1, k8, v8, f(B, T).abs(), f(B, T).abs(), lens, 0.35)]


@pytest.mark.parametrize("name", ["flash_fwd", "flash_bwd_dkdv",
                                  "flash_bwd_dq", "flash_decode",
                                  "flash_decode_q8"])
def test_opcheck(name):
    op = tfa.OPS["mxnet_tpu_torch::" + name]
    rs = np.random.RandomState(len(name))
    for args in _opcheck_args(name, rs):
        result = torch.library.opcheck(op, args)
        assert set(result.values()) == {"SUCCESS"}, result


class _OpSpy(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.names = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.namespace == "mxnet_tpu_torch":
            self.names.append(func.name())
        return func(*args, **(kwargs or {}))


CASES = {
    # name: (B, T, H, D, causal, segmented)
    "causal": (2, 64, 2, 16, True, False),
    "full": (2, 48, 2, 8, False, False),
    "segments": (2, 96, 2, 16, True, True),
}


def _case_inputs(case, seed):
    B, T, H, D, _causal, segmented = case
    rs = np.random.RandomState(seed)
    q, k, v, g = (rs.randn(B, T, H, D).astype(np.float32) for _ in range(4))
    seg = None
    if segmented:
        seg = np.zeros((B, T), np.int32)
        for b in range(B):
            cut = rs.randint(8, T // 2)
            seg[b, :cut] = 1
            seg[b, cut:T - 7 - b] = 2          # a pad tail of 7 + b
        g[seg == 0] = 0.0                       # the masked loss
    return q, k, v, g, seg


def _jax_pallas(q, k, v, g, seg, causal, dtype=jnp.float32):
    segj = None if seg is None else jnp.asarray(seg)

    def f(a, b, c):
        return jfa.flash_attention(a, b, c, causal=causal,
                                   force_pallas=True, block_q=128,
                                   block_k=128, segment_ids=segj)
    out, vjp = jax.vjp(f, *(jnp.asarray(x, dtype) for x in (q, k, v)))
    return [np.asarray(jnp.asarray(x, jnp.float32))
            for x in [out] + list(vjp(jnp.asarray(g, dtype)))]


def _port(q, k, v, g, seg, causal, dtype=torch.float32):
    leaves = [_t(x).to(dtype).requires_grad_(True) for x in (q, k, v)]
    with _OpSpy() as spy:
        out = tfa.flash_attention(
            *leaves, causal=causal,
            segment_ids=None if seg is None else _t(seg))
        out.backward(_t(g).to(dtype))
    assert spy.names == ["mxnet_tpu_torch::flash_fwd",
                         "mxnet_tpu_torch::flash_bwd_dkdv",
                         "mxnet_tpu_torch::flash_bwd_dq"], spy.names
    assert out.dtype == dtype and all(x.grad.dtype == dtype for x in leaves)
    return [x.detach().to(torch.float32).numpy()
            for x in [out] + [x.grad for x in leaves]]


@pytest.mark.parametrize("name", sorted(CASES))
def test_flash_attention_through_the_op_matches_jax_pallas(name):
    case = CASES[name]
    q, k, v, g, seg = _case_inputs(case, seed=len(name) + 40)
    got = _port(q, k, v, g, seg, case[4])
    want = _jax_pallas(q, k, v, g, seg, case[4])
    live = np.ones(q.shape[:2], bool) if seg is None else seg > 0
    np.testing.assert_allclose(got[0][live], want[0][live], err_msg="o",
                               **TOL)
    for which, a, b in zip("qkv", got[1:], want[1:]):
        np.testing.assert_allclose(a, b, err_msg="d" + which, **TOL)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_bf16_flash_attention_through_the_op_matches_jax_pallas(causal):
    """bfloat16 inputs and cotangent: the casts around the op, float32
    inside, bfloat16 out, against the Pallas kernels on the same
    bfloat16 inputs at ``BF16_TOL``."""
    q, k, v, g, _ = _case_inputs((1, 64, 2, 32, causal, False), seed=9)
    got = _port(q, k, v, g, None, causal, dtype=torch.bfloat16)
    want = _jax_pallas(q, k, v, g, None, causal, dtype=jnp.bfloat16)
    for which, a, b in zip(["o", "dq", "dk", "dv"], got, want):
        np.testing.assert_allclose(a, b, err_msg=which, **BF16_TOL)


def _attention_syms(mx, segmented):
    q, k, v = mx.sym.var("q"), mx.sym.var("k"), mx.sym.var("v")
    args = [q, k, v] + ([mx.sym.var("seg")] if segmented else [])
    att = mx.sym._contrib_flash_attention(*args, causal=True)
    dec = mx.sym._contrib_decode_attention(
        mx.sym.var("q1"), k, v, mx.sym.var("lengths"))
    return att, dec


@pytest.mark.parametrize("segmented", [False, True], ids=["plain", "seg"])
def test_attention_ops_infer_shapes_on_meta_tensors(segmented):
    """Shape inference runs each op's body on ``meta`` tensors, which
    reach the ops' fake implementations: the shapes equal the JAX
    package's ``infer_shape``, and the ops infer shapes on ``meta``
    tensors when invoked directly."""
    B, T, H, D = 3, 20, 4, 8
    shapes = dict(q=(B, T, H, D), k=(B, T, H, D), v=(B, T, H, D),
                  q1=(B, 1, H, D), lengths=(B,))
    if segmented:
        shapes["seg"] = (B, T)
    for i in range(2):
        got_sym = _attention_syms(tmx, segmented)[i]
        want_sym = _attention_syms(jmx, segmented)[i]
        feed = {n: shapes[n] for n in got_sym.list_arguments()}
        got = got_sym.infer_shape(**feed)
        want = want_sym.infer_shape(**feed)
        assert [list(map(tuple, s)) for s in got] \
            == [list(map(tuple, s)) for s in want]
        assert tuple(got[1][0]) == feed["q" if i == 0 else "q1"]
    m = torch.empty(B, T, H, D, device="meta")
    att = tmx.ops.get_op("_contrib_flash_attention")
    outs, _ = tmx.ops.invoke(att, [m, m, m], {"causal": True})
    assert outs[0].device.type == "meta" and outs[0].shape == m.shape
    dec = tmx.ops.get_op("_contrib_decode_attention")
    outs, _ = tmx.ops.invoke(dec, [m[:, :1], m, m, torch.empty(
        B, device="meta")], {})
    assert outs[0].device.type == "meta" and outs[0].shape == (B, 1, H, D)
