"""Port parity: mxnet_tpu_torch.serving.kvcache against the JAX
package's paged KV pool, on the CPU.

- gathers and scatters are pure indexing: bit-equal to JAX on the same
  page arrays;
- the q8 gather is int8 x scale: bit-equal; the q8 scatters quantize,
  so their int8 bodies may differ by one rounding step and their scales
  agree to float32 rounding;
- ``PrefixIndex.digests`` is SHA-1 over int32 tokens: byte-equal;
- pool accounting (allocation order, refcounts, COW, quotas, cold
  eviction, the kv_evict fault site) follows the same call sequence to
  the same counters."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu import fault as jfault
from mxnet_tpu.serving import kvcache as jkv
from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch import fault as tfault
from mxnet_tpu_torch.serving import kvcache as tkv

L, P, S, H, D = 2, 8, 4, 2, 8


@pytest.fixture(autouse=True)
def _clean_faults():
    jfault.reset()
    tfault.reset()
    yield
    jfault.reset()
    tfault.reset()


def _pages(seed, dtype=np.float32):
    rs = np.random.RandomState(seed)
    if dtype == np.int8:
        return rs.randint(-127, 128, size=(L, P, S, H, D)).astype(np.int8)
    return rs.randn(L, P, S, H, D).astype(np.float32)


def _both(x):
    """(jax array, torch tensor) of one numpy array, no shared memory."""
    return jnp.asarray(x), torch.from_numpy(np.array(x))


def test_gather_pages_bit_equal():
    jp, tp = _both(_pages(0))
    table = np.asarray([[1, 3, 0], [2, 2, 5]], np.int32)
    want = np.asarray(jkv.gather_pages(jp, jnp.asarray(table)))
    got = tkv.gather_pages(tp, torch.from_numpy(table)).numpy()
    assert got.shape == (L, 2, 3 * S, H, D)
    np.testing.assert_array_equal(got, want)


def test_scatter_token_bit_equal_in_place():
    jp, tp = _both(_pages(1))
    table = np.asarray([[1, 3], [2, 5], [0, 0]], np.int32)   # row 2 idle
    positions = np.asarray([5, 2, 0], np.int32)
    new = np.random.RandomState(2).randn(L, 3, H, D).astype(np.float32)
    new[:, 2] = 0.0                 # the idle row's write hits dump page
    want = np.asarray(jkv.scatter_token(jp, jnp.asarray(table),
                                        jnp.asarray(positions),
                                        jnp.asarray(new)))
    out = tkv.scatter_token(tp, torch.from_numpy(table),
                            torch.from_numpy(positions),
                            torch.from_numpy(new))
    assert out is tp                               # updated in place
    np.testing.assert_array_equal(tp.numpy(), want)


def test_scatter_prefill_bit_equal_padding_to_dump_page():
    jp, tp = _both(_pages(3))
    table = np.asarray([4, 1, 6], np.int32)
    seq = np.random.RandomState(4).randn(L, 12, H, D).astype(np.float32)
    want = np.asarray(jkv.scatter_prefill(jp, jnp.asarray(table),
                                          jnp.asarray(seq), 9))
    tkv.scatter_prefill(tp, torch.from_numpy(table),
                        torch.from_numpy(seq), 9)
    got = tp.numpy()
    # the dump page takes the rung padding: any of the padded rows may
    # win the duplicate writes there, in either package
    np.testing.assert_array_equal(got[:, 1:], want[:, 1:])


def test_gather_pages_q8_bit_equal():
    jp, tp = _both(_pages(5, np.int8))
    scales = np.random.RandomState(6).uniform(
        0.005, 0.02, size=(L, P)).astype(np.float32)
    js, ts = _both(scales)
    table = np.asarray([[1, 2], [7, 0]], np.int32)
    want = np.asarray(jkv.gather_pages_q8(jp, js, jnp.asarray(table)))
    got = tkv.gather_pages_q8(tp, ts, torch.from_numpy(table)).numpy()
    np.testing.assert_array_equal(got, want)


def _assert_q8_close(tpages, tscales, jpages, jscales):
    np.testing.assert_allclose(tscales.numpy(), np.asarray(jscales),
                               rtol=1e-6, atol=0)
    diff = np.abs(tpages.numpy().astype(np.int32)
                  - np.asarray(jpages).astype(np.int32))
    assert diff.max() <= 1                      # one rounding step


def test_scatter_token_q8_fresh_page_and_growth_match_jax():
    pages = _pages(7, np.int8)
    scales = np.random.RandomState(8).uniform(
        0.001, 0.03, size=(L, P)).astype(np.float32)
    jp, tp = _both(pages)
    js, ts = _both(scales)
    table = np.asarray([[2, 3], [4, 5]], np.int32)
    rs = np.random.RandomState(9)
    # row 0 lands on a page's FIRST slot (fresh scale, zeroed body);
    # row 1 mid-page (monotone growth + requantize)
    for step, positions in enumerate(([4, 6], [5, 7])):
        new = (rs.randn(L, 2, H, D) * (1 + step)).astype(np.float32)
        jp, js = jkv.scatter_token_q8(jp, js, jnp.asarray(table),
                                      jnp.asarray(positions, np.int32),
                                      jnp.asarray(new))
        tkv.scatter_token_q8(tp, ts, torch.from_numpy(table),
                             torch.tensor(positions), torch.from_numpy(new))
        _assert_q8_close(tp, ts, jp, js)


def test_scatter_prefill_q8_matches_jax():
    jp, tp = _both(np.zeros((L, P, S, H, D), np.int8))
    js, ts = _both(np.zeros((L, P), np.float32))
    table = np.asarray([1, 2, 3, 0], np.int32)
    seq = np.random.RandomState(10).randn(L, 12, H, D).astype(np.float32)
    seq[:, 10:] = 1e6               # padding must not inflate a scale
    jp, js = jkv.scatter_prefill_q8(jp, js, jnp.asarray(table),
                                    jnp.asarray(seq), 10)
    tkv.scatter_prefill_q8(tp, ts, torch.from_numpy(table),
                           torch.from_numpy(seq), 10)
    tpn, jpn = tp.numpy().copy(), np.asarray(jp).copy()
    tpn[:, 0] = jpn[:, 0] = 0       # dump page: duplicate-write order
    tsn, jsn = ts.numpy().copy(), np.asarray(js).copy()
    tsn[:, 0] = jsn[:, 0] = 0
    _assert_q8_close(torch.from_numpy(tpn), torch.from_numpy(tsn), jpn, jsn)
    assert np.all(tsn[:, 1:4] > 0) and np.all(tsn[:, 4:] == 0)


@pytest.mark.parametrize("ns", [("model", 1), ("grp", 3), "x"])
def test_prefix_digests_byte_equal(ns):
    tokens = np.random.RandomState(11).randint(0, 50000, size=37)
    assert tkv.PrefixIndex(8).digests(ns, tokens) \
        == jkv.PrefixIndex(8).digests(ns, tokens)


def _pools():
    return (jkv.KVCachePool(2, 2, 8, page_size=4, n_pages=8),
            tkv.KVCachePool(2, 2, 8, page_size=4, n_pages=8,
                            device="cpu"))


def test_pool_accounting_matches_jax():
    """Allocation order, refcounts, COW release, kv_evict accounting and
    the counters — one call sequence on both pools."""
    for pool in _pools():
        assert pool.usable_pages == 7
        assert pool.pages_for(4) == 1 and pool.pages_for(5) == 2
    outs = []
    for pool in _pools():
        a = pool.alloc(3)
        b = pool.alloc(4)
        none = pool.alloc(1)
        pool.retain(a[:1])
        dropped = pool.free(a)             # a[0] is only a ref drop
        pool.cow_release(a[0])
        p2 = pool.alloc(2)
        pool.free(b)
        outs.append((a, b, none, dropped, p2, pool.ref(a[0]),
                     pool.stats()))
    assert outs[0] == outs[1]
    assert outs[1][0] == [1, 2, 3]                  # lowest-first


def test_kv_evict_fault_counted_never_leaks():
    for fmod, pool in zip((jfault, tfault), _pools()):
        pages = pool.alloc(3)
        fmod.set_plan("kv_evict:step=2:raise")
        try:
            assert pool.free(pages) == 3
            assert fmod.stats()["injected"].get("kv_evict") == 1
        finally:
            fmod.set_plan(None)
        assert pool.stats()["free"] == 7


def test_quota_and_cold_prefix_eviction_match_jax():
    outs = []
    for pool in _pools():
        own = pool.attach("m", quota=5)
        other = pool.attach("m")              # uniquified name
        pages = pool.alloc(4, owner=own)
        denied = pool.alloc(2, owner=own)     # 4 + 2 > quota 5
        pool.prefix_insert(("m", 1), list(range(12)), pages[:3])
        pool.free(pages)                      # the index keeps 3 pages
        hit = pool.prefix_lookup(("m", 1), list(range(13)))
        pool.free(hit[0])
        big = pool.alloc(6, owner=other)      # evicts cold prefixes
        outs.append((own, other, pages, denied, hit, big, pool.stats(),
                     pool.prefix_stats()))
    assert outs[0] == outs[1]
    assert outs[1][1] == "m-2" and outs[1][3] is None


def test_pool_dtypes(monkeypatch):
    pool = tkv.KVCachePool(2, 2, 8, page_size=4, n_pages=8, device="cpu")
    assert not pool.quantized and pool.k.dtype == torch.float32
    assert pool.k_scale is None
    monkeypatch.setenv("MXNET_KV_DTYPE", "int8")
    pool = tkv.KVCachePool(2, 2, 8, page_size=4, n_pages=8, device="cpu")
    assert pool.quantized and pool.k.dtype == torch.int8
    assert pool.k_scale.shape == (2, 8) and pool.stats()["dtype"] == "int8"
    assert pool.token_bytes == 2 * 2 * 2 * 8
    monkeypatch.setenv("MXNET_KV_DTYPE", "int7")
    with pytest.raises(MXNetError, match="MXNET_KV_DTYPE"):
        tkv.KVCachePool(2, 2, 8, page_size=4, n_pages=8, device="cpu")
    monkeypatch.delenv("MXNET_KV_DTYPE")
    pool = tkv.KVCachePool(2, 2, 8, page_size=4, n_pages=8,
                           dtype="bfloat16", device="cpu")
    assert pool.k.dtype == torch.bfloat16
    with pytest.raises(MXNetError, match="dump page"):
        tkv.KVCachePool(2, 2, 8, page_size=4, n_pages=1, device="cpu")


def test_pool_defaults_to_cuda_and_never_falls_back(monkeypatch):
    monkeypatch.delenv("MXNET_DEFAULT_CONTEXT", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(MXNetError, match="device='cpu'"):
        tkv.KVCachePool(2, 2, 8, page_size=4, n_pages=8)


def test_copy_page_carries_q8_scales(monkeypatch):
    monkeypatch.setenv("MXNET_KV_DTYPE", "int8")
    pool = tkv.KVCachePool(L, H, D, page_size=S, n_pages=P, device="cpu")
    pool.k.copy_(torch.from_numpy(_pages(12, np.int8)))
    pool.k_scale.uniform_(0.004, 0.02)
    before_k, before_s = pool.k.clone(), pool.k_scale.clone()
    pool.copy_page(2, 5)
    assert torch.equal(pool.k[:, 5], before_k[:, 2])
    assert torch.equal(pool.k_scale[:, 5], before_s[:, 2])
    keep = [i for i in range(P) if i != 5]
    assert torch.equal(pool.k[:, keep], before_k[:, keep])
