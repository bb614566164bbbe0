"""Port parity: the flash-attention backward of mxnet_tpu_torch against the
JAX package's, on the CPU.

The same numpy inputs and cotangents go through ``jax.vjp`` of the JAX
``flash_attention(force_pallas=True)`` (its backward kernels
``_bwd_dkdv_kernel``/``_bwd_dq_kernel`` in Pallas interpret mode) and
``jax.grad`` of ``_jnp_reference``, and through the port's op
``mxnet_tpu_torch::flash_fwd`` on a CPU tensor, whose autograd calls the
backward ops' plain implementations (the LSE-recompute arithmetic of
``flash_bwd_dkdv.cu`` and ``flash_bwd_dq.cu``), called directly and
through ``flash_attention``, which reaches the same op. Tolerance
rtol = atol = 2e-5 (interpret-mode Pallas, ROADMAP rule 5). Packed
batches put a zero cotangent on the pad rows (segment id 0), as a masked
loss does: the rows that attend to nothing have tile-dependent weights
in the JAX kernels.

The CUDA kernels run only on a card: chip_smoke.py holds them to these
plain versions there. Here the precision of their route is held: every
contraction of the backward, and S and P V of the forward (P V summed
per walked tile, as the forward kernel sums it), taken in TF32 parts,
rounded bit by bit as the kernels round them (3xTF32: hi*hi + hi*lo +
lo*hi), stays within the card's tolerance of the plain fp32 versions, and
one TF32 pass does not."""
import importlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu_torch import MXNetError

jfa = importlib.import_module("mxnet_tpu.parallel.flash_attention")
tfa = importlib.import_module("mxnet_tpu_torch.parallel.flash_attention")

TOL = dict(rtol=2e-5, atol=2e-5)
# chip_smoke.py's tolerances against the plain versions: BWD_TOL for the
# backward kernels, TOL (here FWD_TOL) for the forward kernel
BWD_TOL = dict(rtol=1e-4, atol=1e-4)
FWD_TOL = dict(rtol=1e-5, atol=1e-5)

CASES = {
    # name: (B, Tq, Tk, H, D, causal, segmented)
    "causal": (2, 64, 64, 2, 16, True, False),
    "full": (2, 48, 48, 2, 8, False, False),
    "ragged_T200": (1, 200, 200, 2, 16, True, False),
    "cross_Tq_ne_Tk": (2, 40, 72, 2, 8, False, False),
    "causal_Tq_lt_Tk": (1, 24, 40, 2, 8, True, False),
    "segments": (2, 96, 96, 2, 16, True, True),
}


def _inputs(case, seed):
    B, Tq, Tk, H, D, causal, segmented = case
    rs = np.random.RandomState(seed)
    q = rs.randn(B, Tq, H, D).astype(np.float32)
    k = rs.randn(B, Tk, H, D).astype(np.float32)
    v = rs.randn(B, Tk, H, D).astype(np.float32)
    g = rs.randn(B, Tq, H, D).astype(np.float32)
    seg = None
    if segmented:
        seg = np.zeros((B, Tq), np.int32)
        for b in range(B):
            cut = rs.randint(8, Tq // 2)
            seg[b, :cut] = 1
            seg[b, cut:Tq - 7 - b] = 2          # a pad tail of 7 + b
        g[seg == 0] = 0.0                       # the masked loss
    return q, k, v, g, seg


def _jax_grads(q, k, v, g, seg, causal, pallas):
    segj = None if seg is None else jnp.asarray(seg)
    D = q.shape[-1]

    def f(a, b, c):
        if pallas:
            return jfa.flash_attention(a, b, c, causal=causal,
                                       force_pallas=True, block_q=128,
                                       block_k=128, segment_ids=segj)
        return jfa._jnp_reference(a, b, c, 1.0 / np.sqrt(D), causal,
                                  segment_ids=segj)
    _, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return [np.asarray(x) for x in vjp(jnp.asarray(g))]


def _torch_grads(q, k, v, g, seg, causal, via_function):
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    segt = None if seg is None else torch.from_numpy(seg)
    if via_function:
        out, _lse = torch.ops.mxnet_tpu_torch.flash_fwd(
            *leaves, None if segt is None else segt.to(torch.int32),
            q.shape[-1] ** -0.5, causal, None)
    else:
        out = tfa.flash_attention(*leaves, causal=causal, segment_ids=segt)
    out.backward(torch.from_numpy(g))
    return [x.grad.numpy() for x in leaves]


@pytest.mark.parametrize("name", sorted(CASES))
def test_lse_recompute_backward_matches_jax_pallas(name):
    """The port's op on the CPU, the plain backward kernels under its
    autograd, against the Pallas backward kernels in interpret mode, and against jax.grad of
    the jnp reference."""
    case = CASES[name]
    q, k, v, g, seg = _inputs(case, seed=len(name))
    got = _torch_grads(q, k, v, g, seg, case[5], via_function=True)
    pallas = _jax_grads(q, k, v, g, seg, case[5], pallas=True)
    dense = _jax_grads(q, k, v, g, seg, case[5], pallas=False)
    for which, a, b, c in zip("qkv", got, pallas, dense):
        np.testing.assert_allclose(a, b, err_msg="d" + which, **TOL)
        np.testing.assert_allclose(a, c, err_msg="d" + which, **TOL)


@pytest.mark.parametrize("name", ["causal", "cross_Tq_ne_Tk", "segments"])
def test_flash_attention_cpu_gradient_matches_jax(name):
    """On a CPU tensor flash_attention is differentiable through the
    op's autograd and the backward ops' plain versions."""
    case = CASES[name]
    q, k, v, g, seg = _inputs(case, seed=len(name) + 1)
    got = _torch_grads(q, k, v, g, seg, case[5], via_function=False)
    want = _jax_grads(q, k, v, g, seg, case[5], pallas=False)
    for which, a, b in zip("qkv", got, want):
        np.testing.assert_allclose(a, b, err_msg="d" + which, **TOL)


def test_plain_kernel_versions_match_function_outputs():
    """The plain dK/dV and dQ versions, called the way the kernels are
    (lse and D laid out (B, H, Tq)), give the op's gradients; the
    forward's LSE is the log-sum-exp of the masked scores."""
    q, k, v, g, seg = _inputs(CASES["segments"], seed=3)
    qt, kt, vt, gt = (torch.from_numpy(x) for x in (q, k, v, g))
    segt = torch.from_numpy(seg)
    scale = q.shape[-1] ** -0.5
    o, lse = tfa._torch_fwd_lse(qt, kt, vt, segt, scale, True)
    assert lse.shape == (q.shape[0], q.shape[2], q.shape[1])
    dcap = torch.sum(gt * o, dim=-1).permute(0, 2, 1)
    dk, dv = tfa._torch_bwd_dkdv(qt, kt, vt, gt, lse, dcap, segt, scale,
                                 True)
    dq = tfa._torch_bwd_dq(qt, kt, vt, gt, lse, dcap, segt, scale, True)
    want = _torch_grads(q, k, v, g, seg, True, via_function=True)
    for a, b in zip((dq, dk, dv), want):
        np.testing.assert_array_equal(a.numpy(), b)
    # pad rows attend to nothing: their probabilities are exact zeros
    p = tfa._torch_bwd_p(qt, kt, lse, segt, scale, True)
    assert float(p.permute(0, 2, 1, 3)[segt == 0].abs().max()) == 0.0


def test_segment_ids_get_no_gradient_and_launch_counts_stay():
    tfa.reset_launches()
    q, k, v, g, seg = _inputs(CASES["segments"], seed=4)
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    segt = torch.from_numpy(seg.astype(np.float32)).requires_grad_(True)
    out = tfa.flash_attention(*leaves, causal=True, scale=0.25,
                              segment_ids=segt)
    out.backward(torch.from_numpy(g))
    assert segt.grad is None
    assert all(x.grad is not None for x in leaves)
    assert set(tfa.launches) == {"flash_fwd", "flash_decode",
                                 "flash_decode_q8", "flash_bwd_dkdv",
                                 "flash_bwd_dq"}
    assert all(n == 0 for n in tfa.launches.values())


def test_backward_kernel_wrapper_checks_before_launch():
    """The CUDA wrapper refuses what the kernels do not take, before it
    builds or launches anything."""
    q = torch.zeros(1, 4, 1, 8)
    lse = torch.zeros(1, 1, 4)
    with pytest.raises(MXNetError, match="float32"):
        tfa._check_cuda("flash_bwd_dq", q.device, q=q.double())
    with pytest.raises(MXNetError, match="head_dim"):
        big = torch.zeros(1, 4, 1, 136)
        tfa._bwd_cuda("flash_bwd_dq", big, big, big, big, lse, lse, None,
                      1.0, True)
    with pytest.raises(ValueError, match="do not match"):
        tfa._bwd_cuda("flash_bwd_dkdv", q, q, q, q, lse[:, :, :3],
                      lse, None, 1.0, True)


def _tf32(x):
    """float32 rounded to TF32 (10 mantissa bits), to nearest with ties
    away from zero: ``cvt.rna.tf32.f32``, and the kernels' ``to_tf32``
    (``(bits + 0x1000) & 0xffffe000``)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _mm_tf32(a, b, passes):
    """``a @ b`` from TF32 parts, summed in float32: ``hi*hi + hi*lo +
    lo*hi`` with ``hi = tf32(x)``, ``lo = tf32(x - hi)`` (passes=3, the
    kernels' 3xTF32), or ``hi*hi`` alone (passes=1)."""
    ah, bh = _tf32(a), _tf32(b)
    out = ah @ bh
    if passes == 3:
        al, bl = _tf32(a - ah), _tf32(b - bh)
        out = out + (ah @ bl + al @ bh)
    return out


def _tf32_backward(q, k, v, do, lse, dcap, scale, passes):
    """The backward kernels' arithmetic (causal, no segments) with its
    five contractions S, dP, dV, dK and dQ in TF32 parts: ``(dk, dv,
    dq)``."""
    qh, kh, vh, doh = (x.permute(0, 2, 1, 3) for x in (q, k, v, do))
    s = _mm_tf32(qh, kh.transpose(-1, -2), passes) * scale
    live = tfa._live_pairs(q.shape[1], k.shape[1], True, None, q.device)
    p = torch.where(live, torch.exp(s - lse[..., None]), 0.0)
    dp = _mm_tf32(doh, vh.transpose(-1, -2), passes)
    ds = p * (dp - dcap[..., None]) * scale
    dv = _mm_tf32(p.transpose(-1, -2), doh, passes)
    dk = _mm_tf32(ds.transpose(-1, -2), qh, passes)
    dq = _mm_tf32(ds, kh, passes)
    return tuple(x.permute(0, 2, 1, 3) for x in (dk, dv, dq))


def test_tf32_rounding_is_to_nearest_ties_away():
    one = 1.0
    x = torch.tensor([one + 2.0 ** -11, -(one + 2.0 ** -11),
                      one + 2.0 ** -12, one + 3 * 2.0 ** -12,
                      one + 2.0 ** -10, 0.0, 2.0 ** -130])
    want = torch.tensor([one + 2.0 ** -10, -(one + 2.0 ** -10), one,
                         one + 2.0 ** -10, one + 2.0 ** -10, 0.0,
                         2.0 ** -130])
    assert torch.equal(_tf32(x), want)


@pytest.mark.parametrize("passes", [3, 1])
def test_tf32_parts_hold_the_backward_to_fp32(passes):
    """At B1 H2 T1024 D64 causal, the backward with every contraction in
    3xTF32 stays within BWD_TOL of the plain fp32 dK/dV and dQ versions
    (the scratch emulation that chose the route read ~1e-6); with one
    TF32 pass it is ~1e-3 off and fails it."""
    B, T, H, D = 1, 1024, 2, 64
    rs = np.random.RandomState(41)
    q, k, v, do = (torch.from_numpy(rs.randn(B, T, H, D).astype(np.float32))
                   for _ in range(4))
    scale = D ** -0.5
    o, lse = tfa._torch_fwd_lse(q, k, v, None, scale, True)
    dcap = torch.sum(do * o, dim=-1).permute(0, 2, 1)
    args = (q, k, v, do, lse, dcap, None, scale, True)
    want = tfa._torch_bwd_dkdv(*args) + (tfa._torch_bwd_dq(*args),)
    got = _tf32_backward(q, k, v, do, lse, dcap, scale, passes)
    errs = [float((a - b).abs().max()) for a, b in zip(got, want)]
    within = [bool(torch.allclose(a, b, **BWD_TOL))
              for a, b in zip(got, want)]
    if passes == 3:
        assert all(within), errs
        assert max(errs) < 1e-5, errs
    else:
        assert not any(within), errs
        assert min(errs) > 5e-4, errs


def _tf32_forward(q, k, v, scale, passes, walk=32):
    """The forward kernel's arithmetic (causal, no segments) with S and
    P V in TF32 parts: each walked tile of ``walk`` keys has its P V
    summed on its own and added to the running O rescaled by alpha, as
    the kernel's online softmax does. ``(o (B, Tq, H, D), lse (B, H,
    Tq))``."""
    qh, kh, vh = (x.permute(0, 2, 1, 3) for x in (q, k, v))
    Tq, Tk = q.shape[1], k.shape[1]
    s = _mm_tf32(qh, kh.transpose(-1, -2), passes) * scale
    live = tfa._live_pairs(Tq, Tk, True, None, q.device)
    s = torch.where(live, s, tfa._NEG)
    m = torch.full(s.shape[:-1], -math.inf)
    l = torch.zeros(s.shape[:-1])
    acc = torch.zeros(qh.shape)
    for k0 in range(0, Tk, walk):
        tile = s[..., k0:k0 + walk]
        mnew = torch.maximum(m, tile.amax(-1))
        alpha = torch.exp(m - mnew)
        p = torch.exp(tile - mnew[..., None])
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + _mm_tf32(
            p, vh[..., k0:k0 + walk, :], passes)
        m = mnew
    o = acc / l.clamp_min(1e-30)[..., None]
    return o.permute(0, 2, 1, 3), m + torch.log(l.clamp_min(1e-30))


@pytest.mark.parametrize("passes", [3, 1])
def test_tf32_parts_hold_the_forward_to_fp32(passes):
    """At B1 H2 T1024 D64 causal, the forward with S and P V in 3xTF32,
    summed per walked tile, stays within FWD_TOL of the plain fp32
    version's O and LSE; with one TF32 pass both are ~1e-3 off and fail
    it."""
    B, T, H, D = 1, 1024, 2, 64
    rs = np.random.RandomState(42)
    q, k, v = (torch.from_numpy(rs.randn(B, T, H, D).astype(np.float32))
               for _ in range(3))
    scale = D ** -0.5
    want = tfa._torch_fwd_lse(q, k, v, None, scale, True)
    got = _tf32_forward(q, k, v, scale, passes)
    errs = [float((a - b).abs().max()) for a, b in zip(got, want)]
    within = [bool(torch.allclose(a, b, **FWD_TOL))
              for a, b in zip(got, want)]
    if passes == 3:
        assert all(within), errs
        assert max(errs) < 5e-6, errs
    else:
        assert not any(within), errs
        assert min(errs) > 1e-4, errs


@pytest.mark.parametrize("name", ["causal", "full"])
def test_bf16_gradients_match_jax_pallas(name):
    """bfloat16 q/k/v and cotangent: the port's backward (the plain
    kernel versions under op ``flash_fwd``, what a CPU tensor runs) takes D
    in float32 from the rounded bfloat16 output, computes in float32 and
    returns bfloat16 gradients, as ``jax.vjp`` of the Pallas kernels
    does on the same bfloat16 inputs. Each gradient is within 2e-5 of
    JAX's, except where the two float32 results straddle a bfloat16
    rounding boundary: there the port's float32 value (before its cast)
    lies within 2e-5 of the midpoint between the two bfloat16 values,
    so the two agree within 2e-5 in float32 and the cast split them."""
    B, Tq, Tk, H, D, causal, _ = CASES[name]
    q, k, v, g, _ = _inputs(CASES[name], seed=len(name) + 7)
    leaves = [torch.from_numpy(x).to(torch.bfloat16).requires_grad_(True)
              for x in (q, k, v)]
    out = tfa.flash_attention(*leaves, causal=causal)
    assert out.dtype == torch.bfloat16
    gt = torch.from_numpy(g).to(torch.bfloat16)
    out.backward(gt)
    got = [x.grad for x in leaves]
    assert all(x.dtype == torch.bfloat16 for x in got)

    # the same backward before the final cast, from the rounded output
    scale = D ** -0.5
    q32, k32, v32, g32 = (x.detach().to(torch.float32)
                          for x in leaves + [gt])
    _, lse = tfa._torch_fwd_lse(q32, k32, v32, None, scale, causal)
    dcap = torch.sum(g32 * out.detach().to(torch.float32), dim=-1) \
        .permute(0, 2, 1)
    args = (q32, k32, v32, g32, lse, dcap, None, scale, causal)
    dk32, dv32 = tfa._torch_bwd_dkdv(*args)
    pre = [tfa._torch_bwd_dq(*args), dk32, dv32]

    def f(a, b, c):
        return jfa.flash_attention(a, b, c, causal=causal,
                                   force_pallas=True, block_q=128,
                                   block_k=128)
    _, vjp = jax.vjp(f, *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)))
    want = vjp(jnp.asarray(g, jnp.bfloat16))
    for which, a, a32, b in zip("qkv", got, pre, want):
        assert b.dtype == jnp.bfloat16
        a = a.to(torch.float32).numpy()
        b = np.asarray(b, np.float32)
        a32 = a32.numpy()
        assert np.array_equal(a, a32.astype(np.float32).astype(
            jnp.bfloat16).astype(np.float32))
        split = np.abs(a - b) > 2e-5
        mid = (a + b) / 2
        assert np.all(np.abs(a32[split] - mid[split]) <= 2e-5), \
            "d" + which
        assert split.mean() < 1e-3, "d" + which
