"""Port parity: mxnet_tpu_torch.serving.decode (ToyDecoderLM +
DecodeServer) against the JAX package's, on the CPU.

Both packages serve the SAME weights: the JAX ``init_params(seed)``
dict is carried into the port with ``params_from_numpy``. Then

- prefill and decode logits agree within rtol=atol=1e-5 (fp32; matmul
  summation order differs between XLA's and torch's CPU kernels), and
  also against the JAX model on its interpret-mode Pallas kernels;
- greedy streams are TOKEN-IDENTICAL to the JAX DecodeServer's for
  fixed prompts, both servers driven tick by tick (``start=False``),
  over the float32 pool, the int8 pool and the prefix cache;
- cancel, deadlines under a planned ``serve_decode`` hang, priority
  shedding, KV-pool preemption, hot swap and stop follow the JAX
  tests of the same names, with the same outcomes and counters."""
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu import compile_watch
from mxnet_tpu import fault as jfault
from mxnet_tpu import serving as jserving
from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch import fault as tfault
from mxnet_tpu_torch import profiler as tprofiler
from mxnet_tpu_torch import serving as tserving

CPU = "cpu"


@pytest.fixture(autouse=True)
def _clean_state():
    jfault.reset()
    tfault.reset()
    compile_watch.disable()
    yield
    jfault.reset()
    tfault.reset()
    compile_watch.disable()


def _models(n_layers=1, seed=3, head_dim=8, max_len=128):
    """(jax model, jax params, port model, port params): same weights."""
    kw = dict(vocab=32, n_layers=n_layers, n_heads=2, head_dim=head_dim,
              max_len=max_len)
    jm = jserving.ToyDecoderLM(**kw)
    jp = jm.init_params(seed=seed)
    tm = tserving.ToyDecoderLM(**kw)
    tp = tserving.params_from_numpy(
        {k: np.asarray(v) for k, v in jp.items()}, CPU, model=tm)
    return jm, jp, tm, tp


def _servers(jm, jp, tm, tp, **kw):
    kw.setdefault("start", False)
    return (jserving.DecodeServer(jm, jp, **kw),
            tserving.DecodeServer(tm, tp, device=CPU, **kw))


def _drain(srv, *reqs, limit=500):
    n = 0
    while not all(r.done() for r in reqs):
        srv._tick()
        n += 1
        assert n < limit, "scheduler made no progress"
    return n


def _run(srv, prompts, n):
    reqs = [srv.submit(p, max_new_tokens=n) for p in prompts]
    _drain(srv, *reqs)
    return [[int(t) for t in r.result(timeout=1)] for r in reqs]


# ---------------------------------------------------------------------------
# the model: logits parity
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("use_pallas", [False, True], ids=["jnp", "pallas"])
def test_prefill_and_decode_logits_match_jax(use_pallas):
    jm, jp, tm, tp = _models(n_layers=2, head_dim=16)
    jm.use_pallas = use_pallas
    rs = np.random.RandomState(0)
    toks = rs.randint(0, 32, size=(2, 11)).astype(np.int32)
    jl, jk, jv = jm.prefill(jp, jnp.asarray(toks))
    tl, tk, tv = tm.prefill(tp, torch.from_numpy(toks).long())
    tol = dict(rtol=1e-5, atol=1e-5) if not use_pallas \
        else dict(rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **tol)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), **tol)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **tol)
    # one decode step over a padded cache of T = 16 positions
    T = 16
    kc = np.zeros((2, 2, T, 2, 16), np.float32)
    vc = np.zeros((2, 2, T, 2, 16), np.float32)
    kc[:, :, :11] = np.asarray(jk)
    vc[:, :, :11] = np.asarray(jv)
    kc[:, :, 11:] = 7.0                       # garbage tail, masked
    vc[:, :, 11:] = -7.0
    new = np.asarray([5, 9], np.int32)
    pos = np.asarray([11, 6], np.int32)       # row 1 re-writes pos 6
    jl, jkn, jvn = jm.decode(jp, jnp.asarray(new), jnp.asarray(pos),
                             jnp.asarray(kc), jnp.asarray(vc))
    tl, tkn, tvn = tm.decode(tp, torch.from_numpy(new).long(),
                             torch.from_numpy(pos).long(),
                             torch.from_numpy(kc), torch.from_numpy(vc))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **tol)
    np.testing.assert_allclose(tkn.numpy(), np.asarray(jkn), **tol)
    np.testing.assert_allclose(tvn.numpy(), np.asarray(jvn), **tol)


def test_params_from_numpy_checks_names_and_shapes():
    jm, jp, tm, _ = _models()
    tree = {k: np.asarray(v) for k, v in jp.items()}
    bad = dict(tree)
    bad.pop("wout")
    with pytest.raises(MXNetError, match="missing"):
        tserving.params_from_numpy(bad, CPU, model=tm)
    bad = dict(tree, wout=np.zeros((3, 3), np.float32))
    with pytest.raises(MXNetError, match="shape"):
        tserving.params_from_numpy(bad, CPU, model=tm)
    bad = dict(tree, wout=np.zeros((16, 32), np.int32))
    with pytest.raises(MXNetError, match="float"):
        tserving.params_from_numpy(bad, CPU, model=tm)
    assert set(tm.init_params(seed=1, device=CPU)) == set(tree)


# ---------------------------------------------------------------------------
# the server: token-identical greedy streams
# ---------------------------------------------------------------------------

PROMPTS = [np.arange(1, 8), np.asarray([3, 9, 4, 1, 7, 2, 6, 5, 11]),
           np.asarray([30]), np.arange(5, 20)]


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_server_streams_token_identical_to_jax(dtype, monkeypatch):
    monkeypatch.setenv("MXNET_KV_DTYPE", dtype)
    jm, jp, tm, tp = _models(n_layers=2)
    js, ts = _servers(jm, jp, tm, tp, seq_ladder=[8, 16],
                      max_new_tokens=10, window=3, page_size=8,
                      pool_pages=32)
    try:
        assert ts._pool.quantized == (dtype == "int8")
        want = _run(js, PROMPTS, 10)
        got = _run(ts, PROMPTS, 10)
        assert got == want
        jst, tst = js.stats(), ts.stats()
        for key in ("completed", "tokens_out", "prefill_steps",
                    "decode_steps"):
            assert tst[key] == jst[key], key
        for key in ("used", "evicted", "peak_used", "dtype"):
            assert tst["kv"][key] == jst["kv"][key], key
    finally:
        js.stop()
        ts.stop()


def test_prefix_cache_streams_token_identical_to_jax():
    """Miss, full-page hit (its re-fed last token COWs the shared page)
    and partial hit + suffix — same tokens and counters as JAX."""
    jm, jp, tm, tp = _models()
    base = np.arange(10, 22, dtype=np.int32)        # 3 full pages of 4
    longer = np.concatenate([base, [5, 6]]).astype(np.int32)
    js, ts = _servers(jm, jp, tm, tp, seq_ladder=[16], max_new_tokens=8,
                      window=4, page_size=4, pool_pages=32,
                      prefix_cache=True)
    try:
        want = [_run(js, [p], 8)[0] for p in (base, base, longer)]
        got = [_run(ts, [p], 8)[0] for p in (base, base, longer)]
        assert got == want
        jpx, tpx = js.stats()["prefix"], ts.stats()["prefix"]
        for key in ("hits", "misses", "hit_tokens", "cow_splits"):
            assert tpx[key] == jpx[key], key
        assert tpx["hits"] == 2 and tpx["cow_splits"] == 1
        assert ts.stats()["prefill_steps"] == 1
    finally:
        js.stop()
        ts.stop()


def test_prefix_cache_faults_match_jax():
    """kv_share raise → a forced miss; kv_cow raise → a private
    re-prefill; tokens never change."""
    jm, jp, tm, tp = _models()
    base = np.arange(10, 22, dtype=np.int32)
    plan = "kv_share:step=1:raise;kv_cow:step=1:raise"
    outs = []
    for fmod, srv in zip((jfault, tfault),
                         _servers(jm, jp, tm, tp, seq_ladder=[16],
                                  max_new_tokens=8, window=4,
                                  page_size=4, pool_pages=32,
                                  prefix_cache=True)):
        fmod.set_plan(plan)
        try:
            toks = [_run(srv, [base], 8)[0] for _ in range(3)]
            st = srv.stats()
            outs.append((toks, st["prefix"]["misses"],
                         st["prefix"]["cow_degraded"],
                         st["prefill_steps"], fmod.stats()["injected"]))
        finally:
            fmod.set_plan(None)
            srv.stop()
    assert outs[0] == outs[1]
    assert outs[1][0][0] == outs[1][0][1] == outs[1][0][2]


def test_hot_swap_mid_traffic_matches_jax():
    jm, jp, tm, tp = _models()
    jp_b = jm.init_params(seed=99)
    tp_b = tserving.params_from_numpy(
        {k: np.asarray(v) for k, v in jp_b.items()}, CPU, model=tm)
    prompt = np.arange(1, 8)
    outs = []
    for srv, new in zip(_servers(jm, jp, tm, tp, seq_ladder=[16],
                                 max_new_tokens=8, window=4,
                                 page_size=8, pool_pages=32),
                        (jp_b, tp_b)):
        try:
            inflight = srv.submit(prompt, max_new_tokens=8)
            srv._tick()
            srv._tick()
            assert srv.swap_weights(new) == 2
            later = srv.submit(prompt, max_new_tokens=8)
            _drain(srv, inflight, later)
            st = srv.stats()
            outs.append(([int(t) for t in inflight.result(timeout=1)],
                         [int(t) for t in later.result(timeout=1)],
                         st["completed"], st["swaps"],
                         st["versions_alive"]))
        finally:
            srv.stop()
    assert outs[0] == outs[1]
    assert outs[1][0] != outs[1][1]           # the swap is observable


def test_swap_rejects_mismatched_dict():
    _, _, tm, tp = _models()
    srv = tserving.DecodeServer(tm, tp, seq_ladder=[16], max_new_tokens=4,
                                window=1, page_size=8, pool_pages=16,
                                device=CPU, start=False)
    try:
        bad = dict(tp)
        bad.pop("wout")
        with pytest.raises(MXNetError, match="structure"):
            srv.swap_weights(bad)
        with pytest.raises(MXNetError, match="never shapes"):
            srv.swap_weights(dict(tp, wout=torch.zeros(3, 3)))
    finally:
        srv.stop()


# ---------------------------------------------------------------------------
# the server: lifecycle paths, same outcomes as the JAX tests
# ---------------------------------------------------------------------------

def test_streaming_iterator_and_cancel_frees_pages():
    jm, jp, tm, tp = _models()
    outs = []
    for srv in _servers(jm, jp, tm, tp, seq_ladder=[16],
                        max_new_tokens=16, window=2, page_size=8,
                        pool_pages=16):
        try:
            free0 = srv._pool.stats()["free"]
            req = srv.submit(np.arange(1, 8), max_new_tokens=16)
            srv._tick()
            srv._tick()
            it = req.tokens(timeout=1)
            seen = [next(it), next(it)]
            req.cancel()
            srv._tick()
            assert req.done() and req.state == "cancelled"
            rest = list(it)
            got = [int(t) for t in req.result(timeout=1)]
            assert seen + rest == got and len(got) == 3
            st = srv._pool.stats()
            assert st["free"] == free0
            outs.append((got, st["evicted"], srv.stats()["cancelled"]))
        finally:
            srv.stop()
    assert outs[0] == outs[1]
    assert outs[1][1] == 2


def test_decode_hang_ages_request_past_deadline_pages_reclaimed(
        monkeypatch):
    monkeypatch.setenv("MXNET_FAULT_HANG_SECONDS", "0.02")
    _, _, tm, tp = _models()
    srv = tserving.DecodeServer(tm, tp, seq_ladder=[16],
                                max_new_tokens=32, window=2, page_size=8,
                                pool_pages=16, device=CPU)
    free0 = srv._pool.stats()["free"]
    tfault.set_plan("serve_decode:step=1:hang:count=inf;"
                    "kv_evict:step=1:raise:count=inf")
    try:
        req = srv.submit(np.arange(1, 10), max_new_tokens=32,
                         deadline_ms=120)
        with pytest.raises(tserving.RequestTimeoutError,
                           match=req.request_id):
            req.result(timeout=30)
        deadline = time.monotonic() + 30
        while srv._pool.stats()["free"] != free0:
            assert time.monotonic() < deadline, "pages leaked"
            time.sleep(0.01)
        st = srv.stats()
        assert st["timeouts"] == 1 and st["decode_faults"] >= 1
        inj = tfault.stats()["injected"]
        assert inj.get("serve_decode", 0) >= 1
        assert inj.get("kv_evict", 0) == srv._pool.stats()["evicted"] >= 2
    finally:
        tfault.set_plan(None)
        srv.stop(drain=False)


def test_priority_shed_and_pool_preemption_match_jax():
    jm, jp, tm, tp = _models()
    outs = []
    for srv in _servers(jm, jp, tm, tp, seq_ladder=[16],
                        max_new_tokens=4, window=1, page_size=8,
                        pool_pages=16, max_queue=2):
        try:
            low = [srv.submit(np.arange(1, 4), priority=0)
                   for _ in range(2)]
            high = srv.submit(np.arange(1, 4), priority=2)
            assert low[1].done()
            with pytest.raises(Exception, match=r"priority 0.*priority-2"):
                low[1].result(timeout=1)
            high2 = srv.submit(np.arange(1, 4), priority=1)
            with pytest.raises(Exception, match="priority 0"):
                srv.submit(np.arange(1, 4), priority=0)
            with pytest.raises(Exception, match="MXNET_SERVING_PRIORITIES"):
                srv.submit(np.arange(1, 4), priority=99)
            _drain(srv, high, high2)
            st = srv.stats()
            outs.append((st["shed"], st["shed_by_priority"],
                         [int(t) for t in high.result(timeout=1)]))
            if srv.__module__.startswith("mxnet_tpu_torch"):
                assert tprofiler.counters()["decode_shed"] >= 3
        finally:
            srv.stop()
    assert outs[0] == outs[1]
    outs = []
    # two max-budget requests cannot coexist: 3 pages each, 5 usable
    for srv in _servers(jm, jp, tm, tp, seq_ladder=[16],
                        max_new_tokens=8, window=2, page_size=8,
                        pool_pages=6):
        try:
            low = srv.submit(np.arange(1, 16), priority=0,
                             max_new_tokens=8)
            srv._tick()
            assert low.pages == [1, 2]
            high = srv.submit(np.arange(1, 16), priority=2,
                              max_new_tokens=8)
            _drain(srv, high)
            assert low.state == "failed"
            with pytest.raises(Exception, match="preempted"):
                low.result(timeout=1)
            st = srv.stats()
            outs.append(([int(t) for t in high.result(timeout=1)],
                         st["preempted"], st["completed"],
                         srv._pool.stats()["free"]))
        finally:
            srv.stop()
    assert outs[0] == outs[1]
    assert outs[1][1:] == (1, 1, 5)


def test_stop_nodrain_and_wedged_scheduler(monkeypatch):
    _, _, tm, tp = _models()
    srv = tserving.DecodeServer(tm, tp, seq_ladder=[16],
                                max_new_tokens=16, window=2, page_size=8,
                                pool_pages=32, device=CPU, start=False)
    req = srv.submit(np.arange(1, 8), max_new_tokens=16)
    for _ in range(5):
        srv._tick()
    streamed = [int(t) for t in req.generated]
    srv.stop(drain=False)
    got = []
    with pytest.raises(tserving.ServerClosedError, match=req.request_id):
        for t in req.tokens(timeout=1):
            got.append(int(t))
    assert got == streamed and srv._pool.stats()["used"] == 0

    monkeypatch.setenv("MXNET_FAULT_HANG_SECONDS", "0.4")
    monkeypatch.setenv("MXNET_DECODE_STOP_TIMEOUT_MS", "50")
    srv = tserving.DecodeServer(tm, tp, seq_ladder=[16], max_new_tokens=8,
                                window=2, page_size=8, pool_pages=16,
                                device=CPU)
    tfault.set_plan("serve_decode:step=1:hang:count=inf")
    try:
        req = srv.submit(np.arange(1, 6), max_new_tokens=8)
        deadline = time.monotonic() + 5
        while not tfault.stats()["injected"].get("serve_decode"):
            assert time.monotonic() < deadline, "hang never entered"
            time.sleep(0.005)
        t0 = time.monotonic()
        srv.stop()                            # drain=True, but wedged
        assert time.monotonic() - t0 < 0.35
        with pytest.raises(tserving.ServerClosedError,
                           match=req.request_id):
            req.result(timeout=1)
    finally:
        tfault.set_plan(None)
        srv._thread.join(2)
    assert not srv._thread.is_alive()
    assert srv._pool.stats()["used"] == 0


def test_threaded_server_and_warmup():
    """The started scheduler thread serves concurrent submissions to
    the same tokens as the hand-driven JAX server."""
    jm, jp, tm, tp = _models()
    js = jserving.DecodeServer(jm, jp, seq_ladder=[16, 32],
                               max_new_tokens=6, window=4, page_size=8,
                               pool_pages=64, start=False)
    ts = tserving.DecodeServer(tm, tp, seq_ladder=[16, 32],
                               max_new_tokens=6, window=4, page_size=8,
                               pool_pages=64, device=CPU)
    try:
        assert ts.warmup() == 3
        rs = np.random.RandomState(2)
        prompts = [rs.randint(1, 32, size=rs.randint(2, 30))
                   for _ in range(6)]
        reqs = [ts.submit(p, max_new_tokens=6) for p in prompts]
        got = [[int(t) for t in r.result(timeout=60)] for r in reqs]
        assert got == _run(js, prompts, 6)
        assert ts._pool.stats()["used"] == 0
    finally:
        js.stop()
        ts.stop()


def test_server_input_checks():
    _, _, tm, tp = _models()
    with pytest.raises(MXNetError, match="max_len"):
        tserving.DecodeServer(tm, tp, seq_ladder=[128], max_new_tokens=8,
                              device=CPU, start=False)
    srv = tserving.DecodeServer(tm, tp, seq_ladder=[16], max_new_tokens=4,
                                window=1, page_size=8, pool_pages=16,
                                device=CPU, start=False)
    try:
        with pytest.raises(MXNetError, match="0..31"):
            srv.submit(np.asarray([1, 32]))
        with pytest.raises(MXNetError, match="ladder top"):
            srv.submit(np.arange(20) % 32)
    finally:
        srv.stop()


def test_server_defaults_to_cuda_and_never_falls_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, _, tm, tp = _models()
    with pytest.raises(MXNetError, match="device='cpu'"):
        tserving.DecodeServer(tm, tp, seq_ladder=[16], max_new_tokens=4,
                              start=False)
    with pytest.raises(MXNetError, match="device='cpu'"):
        tm.init_params(seed=0)


# ---------------------------------------------------------------------------
# the scaffold: envs, ladder and fault parser behave as the JAX ones
# ---------------------------------------------------------------------------

def test_envs_declarations_match_jax():
    from mxnet_tpu import envs as jenvs
    from mxnet_tpu_torch import envs as tenvs
    jreg = jenvs.registry()
    for name, var in tenvs.registry().items():
        assert (var.kind, var.default) == (jreg[name].kind,
                                           jreg[name].default), name
    with pytest.raises(MXNetError, match="not a registered"):
        tenvs.get_int("MXNET_NO_SUCH_KNOB")


def test_envs_strict_parse(monkeypatch):
    from mxnet_tpu_torch import envs as tenvs
    monkeypatch.setenv("MXNET_DECODE_WINDOW", "eight")
    with pytest.raises(MXNetError, match="MXNET_DECODE_WINDOW"):
        tenvs.get_int("MXNET_DECODE_WINDOW")
    monkeypatch.setenv("MXNET_KV_PREFIX_CACHE", "")
    assert tenvs.get_bool("MXNET_KV_PREFIX_CACHE") is False
    with pytest.raises(MXNetError, match="declared as int"):
        tenvs.get_str("MXNET_DECODE_WINDOW")


@pytest.mark.parametrize("rungs,page", [([10, 20, 30], 16), ([64], 16),
                                        ([1, 7, 33, 100], 8)])
def test_ladder_matches_jax(rungs, page):
    from mxnet_tpu.serving import BucketLadder as JLadder
    from mxnet_tpu_torch.serving import BucketLadder as TLadder
    jl, tl = JLadder(rungs).aligned(page), TLadder(rungs).aligned(page)
    assert tl.buckets == jl.buckets
    for n in (1, 9, 16, 33, 99, 100, 1000):
        assert tl.bucket_for(n) == jl.bucket_for(n)
    assert TLadder.geometric(128, 16).buckets \
        == JLadder.geometric(128, 16).buckets
    with pytest.raises(MXNetError):
        TLadder([8]).aligned(0)


def test_fault_plan_parse_and_visits_match_jax():
    spec = "kv_evict:step=2:raise:count=2;serve_decode:step=1:stall"
    jp, tp = jfault.FaultPlan.parse(spec), tfault.FaultPlan.parse(spec)
    assert repr(tp) == repr(jp)
    for site in ("kv_evict",) * 4 + ("serve_decode",) * 2:
        je, te = jp.visit(site), tp.visit(site)
        assert repr(te) == repr(je)
    for bad in ("kv_evict", "kv_evict:step=0:raise", "nope:step=1:raise",
                "kv_evict:step=1:explode"):
        with pytest.raises(MXNetError):
            tfault.FaultPlan.parse(bad)
