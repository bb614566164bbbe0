"""Port parity: the decode server's fixed program set
(mxnet_tpu_torch.serving.decode, ``_Programs``) and the graph-safe step
bodies it captures, against the JAX package's programs, on the CPU.

On a CUDA device each program of the set is a CUDA graph; a graph reads
its inputs from static device buffers, so nothing in a body may read a
value on the host. Here:

- the bodies take device tensors where the JAX programs take traced
  values: ``scatter_prefill`` with a 0-d ``n_valid``, ``copy_page`` from
  index buffers, the prefill's argmax row by a device gather, the whole
  decode step over tensor inputs; each matches the JAX program on the
  same numpy inputs (fp32 copies bit-equal, logits-derived tokens
  equal; int8 within one rounding step, as tests/test_torch_kvcache.py);
- the program set's bookkeeping runs on the CPU through a stand-in for
  the CUDA capture (the body runs again at each replay): captures per
  (site, rung, generation), replays, a generation captured at its first
  use and dropped when its last request finishes, and the launch counts
  a replay adds — with greedy streams token-identical to the JAX
  server's."""
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu import compile_watch
from mxnet_tpu import fault as jfault
from mxnet_tpu import serving as jserving
from mxnet_tpu.serving import kvcache as jkv
from mxnet_tpu_torch import fault as tfault
from mxnet_tpu_torch import serving as tserving
from mxnet_tpu_torch.parallel import flash_attention as tfa
from mxnet_tpu_torch.serving import decode as tdecode
from mxnet_tpu_torch.serving import kvcache as tkv

CPU = torch.device("cpu")
# fp32 against jnp (ROADMAP rule 5)
TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True)
def _clean_state():
    jfault.reset()
    tfault.reset()
    compile_watch.disable()
    yield
    jfault.reset()
    tfault.reset()
    compile_watch.disable()


def _models(n_layers=2, seed=3):
    kw = dict(vocab=32, n_layers=n_layers, n_heads=2, head_dim=8,
              max_len=128)
    jm = jserving.ToyDecoderLM(**kw)
    jp = jm.init_params(seed=seed)
    tm = tserving.ToyDecoderLM(**kw)
    tp = tserving.params_from_numpy(
        {k: np.asarray(v) for k, v in jp.items()}, "cpu", model=tm)
    return jm, jp, tm, tp


def _servers(jm, jp, tm, tp, **kw):
    kw.setdefault("start", False)
    return (jserving.DecodeServer(jm, jp, **kw),
            tserving.DecodeServer(tm, tp, device="cpu", **kw))


def _pool_arrays(srv):
    pool = srv._pool
    out = [pool.k.numpy().copy(), pool.v.numpy().copy()]
    if pool.quantized:
        out += [pool.k_scale.numpy().copy(), pool.v_scale.numpy().copy()]
    return out


def _fill_pool(jsrv, tsrv, seed):
    """The same random pool contents in both servers."""
    rs = np.random.RandomState(seed)
    pool = tsrv._pool
    if pool.quantized:
        k = rs.randint(-127, 128, size=tuple(pool.k.shape)).astype(np.int8)
        v = rs.randint(-127, 128, size=tuple(pool.v.shape)).astype(np.int8)
        ks = rs.uniform(0.005, 0.02, size=tuple(pool.k_scale.shape))
        vs = rs.uniform(0.005, 0.02, size=tuple(pool.v_scale.shape))
        arrays = [k, v, ks.astype(np.float32), vs.astype(np.float32)]
        planes = [pool.k, pool.v, pool.k_scale, pool.v_scale]
        jsrv._pool.k, jsrv._pool.v = map(jnp.asarray,
                                                     arrays[:2])
        jsrv._pool.k_scale, jsrv._pool.v_scale = map(jnp.asarray,
                                                       arrays[2:])
    else:
        arrays = [rs.randn(*pool.k.shape).astype(np.float32)
                  for _ in range(2)]
        planes = [pool.k, pool.v]
        jsrv._pool.k, jsrv._pool.v = map(jnp.asarray, arrays)
    for plane, arr in zip(planes, arrays):
        plane.copy_(torch.from_numpy(arr))
    return arrays


def _jax_pool(jsrv, quantized):
    pool = jsrv._pool
    planes = [pool.k, pool.v]
    if quantized:
        planes += [pool.k_scale, pool.v_scale]
    return planes


def _assert_pools(got, want, quantized):
    if not quantized:
        for g, w in zip(got, want):
            np.testing.assert_allclose(g[:, 1:], np.asarray(w)[:, 1:],
                                       **TOL)
        return
    for g, w in zip(got[:2], want[:2]):
        diff = np.abs(g[:, 1:].astype(np.int32)
                      - np.asarray(w)[:, 1:].astype(np.int32))
        assert diff.max() <= 1                  # one rounding step
    for g, w in zip(got[2:], want[2:]):
        np.testing.assert_allclose(g[:, 1:], np.asarray(w)[:, 1:],
                                   rtol=1e-6, atol=0)


# ---------------------------------------------------------------------------
# the graph-safe bodies against the JAX programs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_valid", [1, 9, 12])
def test_scatter_prefill_device_n_valid_matches_jax(n_valid):
    rs = np.random.RandomState(n_valid)
    pages = rs.randn(2, 8, 4, 2, 8).astype(np.float32)
    table = np.asarray([4, 1, 6], np.int64)
    seq = rs.randn(2, 12, 2, 8).astype(np.float32)
    want = np.asarray(jkv.scatter_prefill(
        jnp.asarray(pages), jnp.asarray(table), jnp.asarray(seq), n_valid))
    tp = torch.from_numpy(pages.copy())
    tkv.scatter_prefill(tp, torch.from_numpy(table), torch.from_numpy(seq),
                        torch.tensor(n_valid))
    # page 0 takes the rung padding (duplicate writes, either order)
    np.testing.assert_array_equal(tp.numpy()[:, 1:], want[:, 1:])


def test_scatter_prefill_q8_device_n_valid_matches_jax():
    table = np.asarray([1, 2, 3, 0], np.int64)
    seq = np.random.RandomState(10).randn(2, 12, 2, 8).astype(np.float32)
    seq[:, 10:] = 1e6               # padding must not inflate a scale
    jp, js = jkv.scatter_prefill_q8(
        jnp.zeros((2, 8, 4, 2, 8), jnp.int8), jnp.zeros((2, 8)),
        jnp.asarray(table), jnp.asarray(seq), 10)
    tp = torch.zeros((2, 8, 4, 2, 8), dtype=torch.int8)
    ts = torch.zeros((2, 8))
    tkv.scatter_prefill_q8(tp, ts, torch.from_numpy(table),
                           torch.from_numpy(seq), torch.tensor(10))
    diff = np.abs(tp.numpy()[:, 1:].astype(np.int32)
                  - np.asarray(jp)[:, 1:].astype(np.int32))
    assert diff.max() <= 1
    np.testing.assert_allclose(ts.numpy()[:, 1:], np.asarray(js)[:, 1:],
                               rtol=1e-6, atol=0)


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_copy_page_from_index_buffers_matches_jax(dtype, monkeypatch):
    monkeypatch.setenv("MXNET_KV_DTYPE", dtype)
    jm, jp, tm, tp = _models()
    js, ts = _servers(jm, jp, tm, tp, seq_ladder=[16], max_new_tokens=4,
                      window=2, page_size=4, pool_pages=8,
                      prefix_cache=True)
    try:
        quant = dtype == "int8"
        _fill_pool(js, ts, seed=5)
        src, dst = torch.tensor([3]), torch.tensor([6])
        ts._pool.copy_page(src, dst)
        if quant:
            want = js._cow_fn_q8(*_jax_pool(js, True), 3, 6)
        else:
            want = js._cow_fn(*_jax_pool(js, False), 3, 6)
        for got, w in zip(_pool_arrays(ts), want):
            np.testing.assert_array_equal(got, np.asarray(w))
    finally:
        js.stop()
        ts.stop()


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_prefill_step_device_inputs_match_jax(dtype, monkeypatch):
    """The prefill body on device tensors (``n_valid`` 0-d, the argmax
    row by a device gather) against the JAX prefill program."""
    monkeypatch.setenv("MXNET_KV_DTYPE", dtype)
    jm, jp, tm, tp = _models()
    js, ts = _servers(jm, jp, tm, tp, seq_ladder=[16], max_new_tokens=8,
                      window=2, page_size=4, pool_pages=16)
    try:
        quant = dtype == "int8"
        _fill_pool(js, ts, seed=6)
        rs = np.random.RandomState(7)
        for n_valid in (1, 11, 16):
            tokens = np.zeros((1, 16), np.int64)
            tokens[0, :n_valid] = rs.randint(0, 32, size=n_valid)
            table = np.zeros((ts._max_pages,), np.int64)
            table[:4] = [5, 2, 9, 7]
            fn = js._prefill_fn_q8 if quant else js._prefill_fn
            jout = fn(js._params.tree, jnp.asarray(tokens, jnp.int32),
                      jnp.asarray(n_valid, jnp.int32),
                      jnp.asarray(table, jnp.int32),
                      *_jax_pool(js, quant))
            tok = ts._prefill_step(ts._params.tree, torch.from_numpy(tokens),
                                   torch.tensor(n_valid),
                                   torch.from_numpy(table))
            assert tok.dim() == 0
            assert int(tok) == int(jout[0])
            _assert_pools(_pool_arrays(ts), jout[1:], quant)
            # the JAX pool carries the update into the next round
            if quant:
                (js._pool.k, js._pool.v, js._pool.k_scale,
                 js._pool.v_scale) = jout[1:]
            else:
                js._pool.k, js._pool.v = jout[1:]
    finally:
        js.stop()
        ts.stop()


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_decode_step_device_inputs_match_jax(dtype, monkeypatch):
    monkeypatch.setenv("MXNET_KV_DTYPE", dtype)
    jm, jp, tm, tp = _models()
    js, ts = _servers(jm, jp, tm, tp, seq_ladder=[16], max_new_tokens=8,
                      window=3, page_size=4, pool_pages=16)
    try:
        quant = dtype == "int8"
        _fill_pool(js, ts, seed=8)
        tokens = np.asarray([4, 17, 0], np.int64)
        positions = np.asarray([9, 2, 0], np.int64)
        tables = np.zeros((3, ts._max_pages), np.int64)
        tables[0, :3] = [3, 8, 1]
        tables[1, :1] = [6]                # row 2 idle: the dump page
        fn = js._decode_fn_q8 if quant else js._decode_fn
        jout = fn(js._params.tree, jnp.asarray(tokens, jnp.int32),
                  jnp.asarray(positions, jnp.int32),
                  jnp.asarray(tables, jnp.int32), *_jax_pool(js, quant))
        got = ts._decode_step(ts._params.tree, torch.from_numpy(tokens),
                              torch.from_numpy(positions),
                              torch.from_numpy(tables))
        assert got.tolist() == np.asarray(jout[0]).tolist()
        _assert_pools(_pool_arrays(ts), jout[1:], quant)
    finally:
        js.stop()
        ts.stop()


# ---------------------------------------------------------------------------
# launch accounting under capture
# ---------------------------------------------------------------------------

def test_recording_launches_is_per_thread_and_replays_add():
    tfa.reset_launches()
    other = []
    with tfa.recording_launches() as held:
        tfa._count("flash_decode")
        tfa._count("flash_decode")
        tfa._count("flash_fwd")
        t = threading.Thread(target=lambda: tfa._count("flash_decode"))
        t.start()
        t.join()
        other.append(tfa.launches["flash_decode"])
    assert held["flash_decode"] == 2 and held["flash_fwd"] == 1
    assert other == [1]                     # another thread counts as usual
    assert tfa.launches["flash_fwd"] == 0   # the capture ran nothing
    tfa.add_launches(held, times=3)
    assert tfa.launches["flash_decode"] == 1 + 6
    assert tfa.launches["flash_fwd"] == 3
    tfa.reset_launches()


# ---------------------------------------------------------------------------
# the program set's bookkeeping, through a stand-in capture
# ---------------------------------------------------------------------------

# the launches the stand-in says each captured program holds
HELD = {"flash_fwd": 2, "flash_decode": 2}


def _standin(body, device, pool):
    """A CUDA capture's contract on the CPU: one call now, the output
    tensor kept, each replay writes its result into that tensor."""
    out = body()

    def replay():
        res = body()
        if out is not None:
            out.copy_(res)
    # the prefill and step bodies each run 2 layers of attention
    held = dict.fromkeys(tfa.launches, 0)
    if out is not None:
        held["flash_decode" if out.dim() else "flash_fwd"] = 2
    return replay, out, held


def _graphed(srv):
    srv._programs = tdecode._Programs(CPU, capture=_standin)
    return srv


def _drain(srv, *reqs, limit=500):
    n = 0
    while not all(r.done() for r in reqs):
        srv._tick()
        n += 1
        assert n < limit, "scheduler made no progress"


def test_program_set_streams_match_jax_and_count_replays():
    jm, jp, tm, tp = _models()
    js, ts = _servers(jm, jp, tm, tp, seq_ladder=[8, 16],
                      max_new_tokens=6, window=3, page_size=4,
                      pool_pages=32, prefix_cache=True)
    _graphed(ts)
    # the third re-sends the first, two full pages: its re-fed last
    # token's write copies the shared page (the cow program)
    prompts = [np.arange(1, 9), np.asarray([3, 9, 4, 1, 7, 2, 6, 5, 11]),
               np.arange(1, 9), np.asarray([30])]
    try:
        assert ts.warmup() == 1 + 2 + 1
        g = ts.stats()["graphs"]
        assert g["captures"] == {"step": 1, "prefill": 2, "cow": 1}
        assert g["generations"] == [1] and g["after_warmup"] == 0
        tfa.reset_launches()
        out = {}
        for name, srv in (("jax", js), ("port", ts)):
            reqs = [srv.submit(p, max_new_tokens=6) for p in prompts]
            _drain(srv, *reqs)
            out[name] = [[int(t) for t in r.result(timeout=1)]
                         for r in reqs]
        assert out["port"] == out["jax"]
        st = ts.stats()
        g = st["graphs"]
        assert g["captures"] == {"step": 1, "prefill": 2, "cow": 1}
        assert g["after_warmup"] == 0 and g["recaptures"] == 0
        assert g["replays"]["step"] == st["decode_steps"]
        assert g["replays"]["prefill"] == st["prefill_steps"]
        assert g["replays"]["cow"] == st["prefix"]["cow_splits"] >= 1
        # every replay adds the launches its program holds
        assert tfa.launches["flash_decode"] == 2 * st["decode_steps"]
        assert tfa.launches["flash_fwd"] == 2 * st["prefill_steps"]
    finally:
        tfa.reset_launches()
        js.stop()
        ts.stop()


def test_swap_captures_one_generation_and_retires_the_old():
    jm, jp, tm, tp = _models()
    jp_b = jm.init_params(seed=99)
    tp_b = tserving.params_from_numpy(
        {k: np.asarray(v) for k, v in jp_b.items()}, "cpu", model=tm)
    prompt = np.arange(1, 8)
    outs = []
    js, ts = _servers(jm, jp, tm, tp, seq_ladder=[8, 16],
                      max_new_tokens=8, window=4, page_size=8,
                      pool_pages=32)
    _graphed(ts)
    ts.warmup()
    try:
        for srv, new in ((js, jp_b), (ts, tp_b)):
            inflight = srv.submit(prompt, max_new_tokens=8)
            srv._tick()
            srv._tick()
            srv.swap_weights(new)
            later = srv.submit(prompt, max_new_tokens=8)
            srv._tick()                 # admits `later` on generation 2
            if srv is ts:
                g = ts.stats()["graphs"]
                # one generation's programs, captured at its first use;
                # generation 1 lives on while `inflight` decodes on it
                assert g["after_warmup"] == 1 + 2
                assert g["generations"] == [1, 2]
            _drain(srv, inflight, later)
            outs.append(([int(t) for t in inflight.result(timeout=1)],
                         [int(t) for t in later.result(timeout=1)]))
        assert outs[0] == outs[1]
        assert outs[1][0] != outs[1][1]       # the swap is observable
        g = ts.stats()["graphs"]
        assert g["generations"] == [2] and g["retired"] == 1
        assert g["captures"]["step"] == 2 and g["captures"]["prefill"] == 4
        assert g["recaptures"] == 0
    finally:
        js.stop()
        ts.stop()


def test_capture_failure_raises_no_eager_fallback():
    _, _, tm, tp = _models(n_layers=1)
    srv = tserving.DecodeServer(tm, tp, seq_ladder=[8], max_new_tokens=4,
                                window=2, page_size=4, pool_pages=16,
                                device="cpu", start=False)

    def broken(body, device, pool):
        raise RuntimeError("capture refused")
    srv._programs = tdecode._Programs(CPU, capture=broken)
    try:
        with pytest.raises(RuntimeError, match="capture refused"):
            srv.warmup()
        req = srv.submit(np.arange(1, 5), max_new_tokens=2)
        srv._tick()
        # the request fails with the capture's error; nothing ran eagerly
        with pytest.raises(RuntimeError, match="capture refused"):
            req.result(timeout=1)
        assert srv.stats()["prefill_steps"] == 0
    finally:
        srv.stop()


def test_program_set_stats_while_generations_come_and_go():
    """stats() runs on other threads (a router's health probe) while the
    server's thread captures and retires generations: no read may fail
    on a dict changing under it."""
    import sys
    progs = tdecode._Programs(CPU, capture=lambda body, device, pool: (
        lambda: None, None, dict.fromkeys(tfa.launches, 0)))
    args = (np.zeros((2,), np.int64),)
    errors, stop = [], threading.Event()

    def read():
        while not stop.is_set():
            try:
                progs.stats()
            except Exception as exc:        # noqa: BLE001 — the finding
                errors.append(exc)
                return
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    readers = [threading.Thread(target=read) for _ in range(8)]
    try:
        for t in readers:
            t.start()
        for gen in range(1, 100):
            for rung in range(4):
                progs.capture("prefill", rung, gen, args, lambda x: None)
            progs.retire({gen})
    finally:
        stop.set()
        for t in readers:
            t.join(10)
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in readers)
    assert errors == []
    assert progs.generations() == [99] and progs.retired == 98


def test_cpu_server_runs_eagerly():
    _, _, tm, tp = _models(n_layers=1)
    srv = tserving.DecodeServer(tm, tp, seq_ladder=[8], max_new_tokens=4,
                                window=2, page_size=4, pool_pages=16,
                                device="cpu", start=False)
    try:
        assert srv._programs is None
        assert srv.warmup() == 2
        assert srv.stats()["graphs"] is None
    finally:
        srv.stop()
