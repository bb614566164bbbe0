"""Port parity: mxnet_tpu_torch.parallel.flash_attention against the JAX
package's flash attention, on the CPU.

The same numpy inputs go through the JAX function (its jnp composition,
and the Pallas kernels in interpret mode) and through the port's plain
PyTorch version, which is what the port's wrappers run on a CPU tensor.
fp32 tolerances: rtol=1e-5, atol=1e-6 against jnp (both are the same
formula; only summation order differs), rtol=atol=2e-5 against
interpret-mode Pallas (blocked online softmax, as tests/
test_flash_attention.py already holds it). Rows that attend to no key at
all (segment id 0) hold unspecified values in every version and are
left out of the comparison.

The CUDA kernels themselves run only on a card: chip_smoke.py holds them
to the plain version there, at the serving shapes."""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from mxnet_tpu_torch import MXNetError

# the modules themselves (mxnet_tpu.parallel exports a same-named function)
jfa = importlib.import_module("mxnet_tpu.parallel.flash_attention")
tfa = importlib.import_module("mxnet_tpu_torch.parallel.flash_attention")

JNP_TOL = dict(rtol=1e-5, atol=1e-6)
PALLAS_TOL = dict(rtol=2e-5, atol=2e-5)


def _qkv(seed, B, Tq, Tk, H, D):
    rs = np.random.RandomState(seed)
    q = rs.randn(B, Tq, H, D).astype(np.float32)
    k = rs.randn(B, Tk, H, D).astype(np.float32)
    v = rs.randn(B, Tk, H, D).astype(np.float32)
    return q, k, v


def _segments(seed, B, T):
    """Packed-row segment ids: 1-based runs, a zero (pad) tail."""
    rs = np.random.RandomState(seed)
    seg = np.zeros((B, T), np.int32)
    for b in range(B):
        pos, sid = 0, 1
        end = T - rs.randint(0, T // 4)
        while pos < end:
            n = min(rs.randint(1, T // 2), end - pos)
            seg[b, pos:pos + n] = sid
            pos, sid = pos + n, sid + 1
    return seg


def _t(x):
    return torch.from_numpy(np.asarray(x))


CASES = [
    # (B, Tq, Tk, H, D, causal, segments)
    (2, 64, 64, 2, 16, True, False),
    (1, 100, 100, 2, 8, True, False),       # ragged T, D = 8
    (2, 37, 53, 3, 16, False, False),       # cross-length, non-causal
    (2, 96, 96, 2, 16, False, True),        # packed segments
    (1, 130, 130, 2, 16, True, True),       # causal + segments, ragged
]


@pytest.mark.parametrize("case", CASES,
                         ids=["causal", "ragged_d8", "cross", "seg",
                              "causal_seg"])
def test_flash_attention_matches_jax(case):
    B, Tq, Tk, H, D, causal, segmented = case
    q, k, v = _qkv(sum(case[:5]), B, Tq, Tk, H, D)
    seg = _segments(7, B, Tq) if segmented else None
    got = tfa.flash_attention(_t(q), _t(k), _t(v), causal=causal,
                              segment_ids=None if seg is None
                              else _t(seg)).numpy()
    want = np.asarray(jfa.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        segment_ids=None if seg is None else jnp.asarray(seg)))
    live = np.ones((B, Tq), bool) if seg is None else seg > 0
    np.testing.assert_allclose(got[live], want[live], **JNP_TOL)
    pallas = np.asarray(jfa.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        segment_ids=None if seg is None else jnp.asarray(seg),
        force_pallas=True))
    np.testing.assert_allclose(got[live], pallas[live], **PALLAS_TOL)


@pytest.mark.parametrize("T,D", [(48, 16), (128, 8), (200, 16)])
def test_flash_decode_matches_jax(T, D):
    B, H = 3, 2
    rs = np.random.RandomState(T + D)
    q = rs.randn(B, 1, H, D).astype(np.float32)
    k = rs.randn(B, T, H, D).astype(np.float32)
    v = rs.randn(B, T, H, D).astype(np.float32)
    lengths = rs.randint(1, T + 1, size=B).astype(np.int32)
    lengths[0] = 1                            # a single live key
    got = tfa.flash_decode(_t(q), _t(k), _t(v), _t(lengths)).numpy()
    want = np.asarray(jfa.flash_decode(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v),
                                       jnp.asarray(lengths)))
    np.testing.assert_allclose(got, want, **JNP_TOL)
    bk = 64 if T % 64 == 0 else 16            # the kernel's block must
    pallas = np.asarray(jfa.flash_decode(     # tile T
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(lengths), force_pallas=True, block_k=bk))
    np.testing.assert_allclose(got, pallas, **PALLAS_TOL)


def test_flash_decode_q8_plain_matches_jax():
    rs = np.random.RandomState(5)
    B, T, H, D = 2, 64, 2, 8
    q = rs.randn(B, 1, H, D).astype(np.float32)
    k = rs.randint(-127, 128, size=(B, T, H, D)).astype(np.int8)
    v = rs.randint(-127, 128, size=(B, T, H, D)).astype(np.int8)
    ks = rs.uniform(0.005, 0.02, size=(B, T)).astype(np.float32)
    vs = rs.uniform(0.005, 0.02, size=(B, T)).astype(np.float32)
    lengths = np.asarray([37, 64], np.int32)
    got = tfa.flash_decode(_t(q), _t(k), _t(v), _t(lengths),
                           k_scale=_t(ks), v_scale=_t(vs)).numpy()
    want = np.asarray(jfa.flash_decode(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(lengths), k_scale=jnp.asarray(ks),
        v_scale=jnp.asarray(vs)))
    np.testing.assert_allclose(got, want, **JNP_TOL)
    with pytest.raises(ValueError, match="BOTH"):
        tfa.flash_decode(_t(q), _t(k), _t(v), _t(lengths), k_scale=_t(ks))


def test_same_value_errors_as_jax():
    q, k, v = (_t(x) for x in _qkv(0, 1, 4, 6, 2, 8))
    with pytest.raises(ValueError, match="self-attention"):
        tfa.flash_attention(q, k, v,
                            segment_ids=torch.ones((1, 4), dtype=torch.int32))
    with pytest.raises(ValueError, match="single query"):
        tfa.flash_decode(q, k, v, torch.ones(1, dtype=torch.int32))
    with pytest.raises(ValueError, match="impl"):
        tfa.flash_attention(q, q, q, impl="fast")


class _OpSpy(TorchDispatchMode):
    """Records the ``mxnet_tpu_torch`` ops dispatched inside, with their
    arguments."""

    def __init__(self):
        super().__init__()
        self.calls = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.namespace == "mxnet_tpu_torch":
            self.calls.append((func.name(), args))
        return func(*args, **(kwargs or {}))


def test_wrappers_route_by_device():
    """Outside ``impl="plain"`` both wrappers call the ``mxnet_tpu_torch``
    ops on every device: a CPU tensor takes an op's plain implementation,
    a ``meta`` tensor its fake one (shapes only), a CUDA tensor its
    kernel (each op has an implementation for exactly those devices);
    ``impl="plain"`` calls no op, and ``impl`` takes nothing else.
    Launch counts move only on the kernel route."""
    tfa.reset_launches()
    q, k, v = (_t(x) for x in _qkv(1, 1, 8, 8, 2, 8))
    s = torch.ones(1, 8)
    k8, v8 = k.to(torch.int8), v.to(torch.int8)
    lens = torch.full((1,), 8)
    for impl, want in ((None, ["flash_fwd", "flash_decode",
                               "flash_decode_q8"]), ("plain", [])):
        with _OpSpy() as spy:
            tfa.flash_attention(q, k, v, causal=True, impl=impl)
            tfa.flash_decode(q[:, :1], k, v, lens, impl=impl)
            tfa.flash_decode(q[:, :1], k8, v8, lens, k_scale=s, v_scale=s,
                             impl=impl)
        assert [n for n, _ in spy.calls] \
            == ["mxnet_tpu_torch::" + n for n in want]
    with pytest.raises(ValueError, match="impl"):
        tfa.flash_decode(q[:, :1], k, v, lens, impl="kernel")
    m = torch.empty(2, 16, 3, 8, device="meta")
    assert tfa.flash_attention(m, m, m, causal=True).shape == m.shape
    assert tfa.flash_decode(m[:, :1], m, m, torch.ones(
        2, dtype=torch.int32, device="meta")).shape == (2, 1, 3, 8)
    for name in tfa.OPS:
        for key, has in (("CPU", True), ("CUDA", True), ("Meta", True),
                         ("XLA", False), ("MPS", False)):
            assert torch._C._dispatch_has_kernel_for_dispatch_key(
                name, key) is has, (name, key)
    assert tfa.launches == {"flash_fwd": 0, "flash_decode": 0,
                            "flash_decode_q8": 0, "flash_bwd_dkdv": 0,
                            "flash_bwd_dq": 0}


def test_q8_decode_routes_int8_cache_to_its_kernel(monkeypatch):
    """A quantized call reaches op ``flash_decode_q8`` with the int8
    cache and its (B, T) scales as given, and the op's CUDA
    implementation hands them on to ``_decode_q8_cuda`` the same way:
    nothing is dequantized in torch first, and the fp32 kernel is not
    called."""
    calls = []
    monkeypatch.setattr(tfa, "_decode_q8_cuda",
                        lambda *a: calls.append(a) or a[0])
    monkeypatch.setattr(tfa, "_decode_cuda", lambda *a: pytest.fail(
        "the fp32 decode kernel was called for an int8 cache"))
    B, T, H, D = 2, 16, 3, 8
    q = torch.zeros(B, 1, H, D)
    k = torch.ones(B, T, H, D, dtype=torch.int8)
    v = torch.full((B, T, H, D), 2, dtype=torch.int8)
    ks, vs = torch.full((B, T), 0.5), torch.full((B, T), 0.25)
    lens = torch.tensor([3, 16], dtype=torch.int32)
    with _OpSpy() as spy:
        tfa.flash_decode(q, k, v, lens, k_scale=ks, v_scale=vs)
    ((name, op_args),) = spy.calls
    assert name == "mxnet_tpu_torch::flash_decode_q8"
    tfa._flash_decode_q8_kernel(*op_args)
    for args in (op_args, calls[0]):
        assert args[0] is q and args[1] is k and args[2] is v
        assert args[1].dtype == args[2].dtype == torch.int8
        assert args[3] is ks and args[4] is vs
        assert tuple(args[3].shape) == tuple(args[4].shape) == (B, T)
        assert args[5] is lens and args[6] == pytest.approx(D ** -0.5)


@pytest.mark.parametrize("case,exc,match", [
    ("float_cache", MXNetError, "int8 cache"),
    ("int8_query", MXNetError, "float32"),
    ("float64_scale", MXNetError, "float32"),
    ("scale_per_head", ValueError, "k_scale shape"),
    ("cache_shape", ValueError, "v shape"),
    ("cache_device", MXNetError, "k is on meta"),
    ("head_dim_256", MXNetError, "head_dim <= 128"),
])
def test_q8_kernel_wrapper_checks_inputs_before_launch(case, exc, match):
    """``_decode_q8_cuda`` takes an int8 (B, T, H, D) cache with float32
    (B, T) scales on q's device and D <= 128, and raises on anything
    else before it builds or launches the kernel."""
    B, T, H, D = 2, 16, 3, 256 if case == "head_dim_256" else 8
    q = torch.zeros(B, 1, H, D)
    k = torch.zeros(B, T, H, D, dtype=torch.int8)
    v = torch.zeros(B, T, H, D, dtype=torch.int8)
    ks, vs = torch.ones(B, T), torch.ones(B, T)
    if case == "float_cache":
        k = k.float()
    elif case == "int8_query":
        q = q.to(torch.int8)
    elif case == "float64_scale":
        vs = vs.double()
    elif case == "scale_per_head":
        ks = torch.ones(B * H, T)
    elif case == "cache_shape":
        v = v[:, :, :2]
    elif case == "cache_device":
        k = k.to("meta")
    before = dict(tfa.launches)
    with pytest.raises(exc, match=match):
        tfa._decode_q8_cuda(q, k, v, ks, vs, torch.full((B,), T), 0.5)
    assert tfa.launches == before


def _q8_inputs(seed, B, T, H, D):
    """tests/test_kv_int8.py's int8 decode inputs."""
    rs = np.random.RandomState(seed)
    q = rs.randn(B, 1, H, D).astype(np.float32)
    k = rs.randint(-127, 128, size=(B, T, H, D)).astype(np.int8)
    v = rs.randint(-127, 128, size=(B, T, H, D)).astype(np.int8)
    ks = rs.uniform(0.005, 0.02, size=(B, T)).astype(np.float32)
    vs = rs.uniform(0.005, 0.02, size=(B, T)).astype(np.float32)
    return q, k, v, ks, vs


def _q8_against_pallas(q, k, v, ks, vs, lengths):
    got = tfa.flash_decode(_t(q), _t(k), _t(v), _t(lengths),
                           k_scale=_t(ks), v_scale=_t(vs)).numpy()
    want = np.asarray(jfa.flash_decode(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(lengths), k_scale=jnp.asarray(ks),
        v_scale=jnp.asarray(vs), force_pallas=True, block_k=64))
    # the JAX test's tolerance for the q8 Pallas kernel
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)


def test_q8_plain_matches_jax_q8_pallas_kernel():
    """The plain int8 decode against ``_decode_kernel_q8`` in interpret
    mode, at tests/test_kv_int8.py's inputs."""
    q, k, v, ks, vs = _q8_inputs(5, 2, 128, 2, 8)
    _q8_against_pallas(q, k, v, ks, vs, np.asarray([37, 128], np.int32))


def test_q8_plain_matches_jax_q8_pallas_kernel_on_pool_pages():
    """The same on a cache the way the int8 pool builds it: each row's
    fp32 K/V quantized page by page (page size 16) by
    ``scatter_prefill_q8``, the raw int8 pages gathered, and each page's
    scale repeated over its slots."""
    from mxnet_tpu_torch.serving import kvcache
    B, T, H, D, S = 2, 128, 2, 8, 16
    M = T // S
    rs = np.random.RandomState(11)
    q = rs.randn(B, 1, H, D).astype(np.float32)
    lengths = np.asarray([53, 128], np.int32)
    table = torch.arange(1, B * M + 1).reshape(B, M)
    caches = []
    for _ in range(2):
        seq = torch.from_numpy(rs.randn(B, T, H, D).astype(np.float32))
        pages = torch.zeros(1, B * M + 1, S, H, D, dtype=torch.int8)
        scales = torch.zeros(1, B * M + 1)
        for b in range(B):
            kvcache.scatter_prefill_q8(pages, scales, table[b], seq[b][None],
                                       int(lengths[b]))
        raw = kvcache.gather_pages(pages, table)[0]
        expanded = torch.repeat_interleave(scales[:, table], S, dim=-1)[0]
        assert raw.dtype == torch.int8 and expanded.shape == (B, T)
        caches.append((raw.numpy(), expanded.numpy()))
    (k, ks), (v, vs) = caches
    _q8_against_pallas(q, k, v, ks, vs, lengths)


# ---------------------------------------------------------------------------
# bfloat16 inputs: the kernels' contract (float32 inside, the output in
# the input dtype), held to the Pallas kernels in interpret mode
# ---------------------------------------------------------------------------

def _bf16(x):
    return torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_bf16_flash_attention_matches_pallas(causal):
    """bfloat16 q/k/v (B1 T64 H2 D32): the port computes in float32 and
    returns bfloat16, within 2e-5 of the Pallas kernel, which casts its
    bfloat16 tiles to float32 the same way."""
    q, k, v = _qkv(11, 1, 64, 64, 2, 32)
    got = tfa.flash_attention(_bf16(q), _bf16(k), _bf16(v), causal=causal)
    assert got.dtype == torch.bfloat16
    want = jfa.flash_attention(*(jnp.asarray(x, jnp.bfloat16)
                                 for x in (q, k, v)), causal=causal,
                               force_pallas=True)
    assert want.dtype == jnp.bfloat16
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=0, atol=2e-5)


@pytest.mark.parametrize("quant", [False, True], ids=["fp", "q8"])
def test_bf16_flash_decode_matches_pallas(quant):
    """A bfloat16 query (and cache, or an int8 cache with float32
    scales): float32 inside, the output bfloat16, within 2e-5 of the
    Pallas decode kernels."""
    rs = np.random.RandomState(21)
    B, T, H, D = 2, 128, 2, 32
    q = rs.randn(B, 1, H, D).astype(np.float32)
    lengths = np.asarray([37, 128], np.int32)
    if quant:
        k = rs.randint(-127, 128, size=(B, T, H, D)).astype(np.int8)
        v = rs.randint(-127, 128, size=(B, T, H, D)).astype(np.int8)
        ks = rs.uniform(0.005, 0.02, size=(B, T)).astype(np.float32)
        vs = rs.uniform(0.005, 0.02, size=(B, T)).astype(np.float32)
        got = tfa.flash_decode(_bf16(q), _t(k), _t(v), _t(lengths),
                               k_scale=_t(ks), v_scale=_t(vs))
        want = jfa.flash_decode(
            jnp.asarray(q, jnp.bfloat16), jnp.asarray(k), jnp.asarray(v),
            jnp.asarray(lengths), k_scale=jnp.asarray(ks),
            v_scale=jnp.asarray(vs), force_pallas=True, block_k=64)
    else:
        k = rs.randn(B, T, H, D).astype(np.float32)
        v = rs.randn(B, T, H, D).astype(np.float32)
        got = tfa.flash_decode(_bf16(q), _bf16(k), _bf16(v), _t(lengths))
        want = jfa.flash_decode(*(jnp.asarray(x, jnp.bfloat16)
                                  for x in (q, k, v)),
                                jnp.asarray(lengths), force_pallas=True,
                                block_k=64)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=0, atol=2e-5)
