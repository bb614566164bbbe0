"""On-card smoke run of the PyTorch/CUDA port (mxnet_tpu_torch).

    python3 chip_smoke.py

Needs one NVIDIA Hopper card (sm_90) and nvcc; exits non-zero, printing
no result, anywhere else. Phases (any failure exits non-zero):

1. device — CUDA present, capability >= (9, 0); prints the card's
   ``nvidia-smi`` name and power limit;
2. build — both attention kernels from ``mxnet_tpu_torch/parallel/csrc``
   (one nvcc per source, started together);
3. kernels vs plain — each kernel against its plain PyTorch version on
   the card at the serving path's shapes (fp32, TF32 off, tolerance
   rtol = atol = 1e-5), with the device time (CUDA-graph replay) and
   per-call time (CUDA events) of the kernel, the plain version and torch's
   scaled_dot_product_attention (a yardstick only), and each kernel's
   bound from its bytes and flops;
4. model — ToyDecoderLM at GPT-2-small width (12 layers, 12 heads x 64,
   d_ff 3072, vocab 50257, 1024 positions; random weights from seed 0):
   prefill logits and 16 stepwise decode logits, kernels vs plain;
5. server — the main path: DecodeServer serves 16 streamed requests
   (one consumed through tokens(), one cancelled midway); every stream
   equals a server-free greedy loop over the same model; then a short
   run over an int8 KV pool. Kernel launch counts are zeroed just
   before this phase and read just after it;
6. step profile — where one steady decode step's time goes (kernel
   classes, device idle share), from the profiler.

It prints a ``{"kernels": [...]}`` line and, last, ``{"ok": true,
"device": {...}}``.
"""
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

# H100 SXM data-sheet peaks (dense): fp32 on the CUDA cores, HBM3
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
TOL = dict(rtol=1e-5, atol=1e-5)
# logits tolerance of the 12-layer model, kernels vs plain: attention
# rounding (~1e-7 relative) is carried through 12 residual layers into
# logits of magnitude up to ~30
LOGIT_ATOL = 1e-3
TIE_MARGIN = 1e-4
GPT2_SMALL = dict(vocab=50257, n_layers=12, n_heads=12, head_dim=64,
                  d_ff=3072, max_len=1024)
FWD_SRC = "mxnet_tpu_torch/parallel/csrc/flash_fwd.cu"
DEC_SRC = "mxnet_tpu_torch/parallel/csrc/flash_decode.cu"
FWD_TPU = "mxnet_tpu/parallel/flash_attention.py:83"
DEC_TPU = "mxnet_tpu/parallel/flash_attention.py:516"


def fail(msg):
    raise SystemExit("chip_smoke: FAILED: " + msg)


def call_ms(fn, iters=20, warm=3):
    """Median time of one call on the card's clock, from CUDA events:
    device work plus any gap while the host prepares the launch."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, iters=20, reps=5):
    """Device time of the GPU work one call launches, without host
    gaps: ``iters`` calls captured in one CUDA graph, the graph replayed
    between CUDA events; the median of ``reps`` replays over ``iters``."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                                   # warm up off the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def timed(fn):
    """(device ms, per-call ms) of one call."""
    return device_ms(fn), call_ms(fn)


def report(name, what, ms, plain_ms, lib_ms, bound, bound_by):
    print("  %-30s %s | device ms: kernel %.4f plain %.4f sdpa %.4f |"
          " per-call ms: kernel %.4f plain %.4f sdpa %.4f | bound %.2f us"
          " (%s)" % (name, what, ms[0], plain_ms[0], lib_ms[0], ms[1],
                     plain_ms[1], lib_ms[1], bound * 1e3, bound_by))


def close(got, want):
    """(max abs error, within TOL) over finite reference entries."""
    err = (got - want).abs()
    ok = bool(torch.isfinite(got).all()) and bool(
        (err <= TOL["atol"] + TOL["rtol"] * want.abs()).all())
    return float(err.max()), ok


def phase_device():
    if not torch.cuda.is_available():
        fail("no CUDA device")
    cap = torch.cuda.get_device_capability(0)
    if cap < (9, 0):
        fail("needs compute capability >= 9.0, got %s" % (cap,))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    line = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() \
        else "nvidia-smi failed: %s" % smi.stderr.strip()
    print("card:", line)
    print("torch %s, CUDA %s, capability %s"
          % (torch.__version__, torch.version.cuda, cap))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return line


def phase_build():
    from mxnet_tpu_torch.parallel import _build
    t0 = time.perf_counter()
    libs = _build.build_all()
    print("build: %.1f s" % (time.perf_counter() - t0))
    for name in libs:
        with open(_build.log_path(name)) as f:
            for ln in f:
                if "registers" in ln or "spill" in ln:
                    print("  %s: %s" % (name, ln.strip()))


def fwd_case(tfa, B, T, H, D, causal, segmented, seed):
    dev = torch.device("cuda", 0)
    g = torch.Generator(device="cpu").manual_seed(seed)
    q, k, v = (torch.randn(B, T, H, D, generator=g).to(dev)
               for _ in range(3))
    seg = None
    if segmented:
        rs = np.random.RandomState(seed)
        cuts = np.sort(rs.choice(np.arange(1, T - 16), 3, replace=False))
        ids = np.zeros(T, np.int32)
        for i, (a, b) in enumerate(zip([0] + list(cuts),
                                       list(cuts) + [T - 16])):
            ids[a:b] = i + 1                   # last 16 positions: pad
        seg = torch.from_numpy(np.tile(ids, (B, 1))).to(dev)
    got, lse = tfa._fwd_cuda(q, k, v, seg, D ** -0.5, causal)
    want = tfa.flash_attention(q, k, v, causal=causal, segment_ids=seg,
                               impl="plain")
    # live pairs: the rows and keys the mask lets through
    pos = torch.arange(T, device=dev)
    live = torch.ones(T, T, dtype=torch.bool, device=dev)
    if causal:
        live &= pos[:, None] >= pos[None, :]
    rows = torch.ones(B, T, dtype=torch.bool, device=dev)
    if seg is not None:
        live = live & (seg[:, :, None] == seg[:, None, :]) \
            & (seg[:, :, None] > 0)
        rows = seg > 0                          # rows with a live key
    live = live.expand(B, T, T)
    err, ok = close(got[rows], want[rows])
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * D ** -0.5
    s = torch.where(live[:, None], s, -1e30)
    lse_err, lse_ok = close(lse.permute(0, 2, 1)[rows],
                            torch.logsumexp(s, -1).permute(0, 2, 1)[rows])
    pairs = int(live.sum()) * H
    flops = 4.0 * D * pairs
    nbytes = 4.0 * B * H * (4 * T * D + T)      # q, k, v in; o, lse out
    bound = max(flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES) * 1e3
    ms = timed(lambda: tfa._fwd_cuda(q, k, v, seg, D ** -0.5, causal))
    plain_ms = timed(lambda: tfa.flash_attention(
        q, k, v, causal=causal, segment_ids=seg, impl="plain"))
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    if seg is None:
        lib = lambda: sdpa(qt, kt, vt, is_causal=causal)  # noqa: E731
    else:
        mask = live[:, None]
        lib = lambda: sdpa(qt, kt, vt, attn_mask=mask)    # noqa: E731
    lib_ms = timed(lib)
    name = "fwd B%d T%d H%d D%d %s%s" % (
        B, T, H, D, "causal" if causal else "full",
        " seg" if segmented else "")
    bound_by = "bytes" if nbytes / PEAK_BYTES > flops / PEAK_FP32_FLOPS \
        else "operations"
    report(name, "err %.3g lse_err %.3g" % (err, lse_err), ms, plain_ms,
           lib_ms, bound, bound_by)
    if not (ok and lse_ok):
        fail("flash_fwd disagrees with the plain version: %s" % name)
    return dict(err=err, ms=ms[0], plain_ms=plain_ms[0],
                library_ms=lib_ms[0], bound_ms=bound, bound_by=bound_by)


def decode_case(tfa, B, T, H, D, seed):
    dev = torch.device("cuda", 0)
    g = torch.Generator(device="cpu").manual_seed(seed)
    q = torch.randn(B, 1, H, D, generator=g).to(dev)
    k, v = (torch.randn(B, T, H, D, generator=g).to(dev)
            for _ in range(2))
    lens_np = np.random.RandomState(seed).randint(1, T + 1, size=B)
    lens_np[0], lens_np[-1] = 1, T
    lens = torch.from_numpy(lens_np.astype(np.int32)).to(dev)
    got = tfa._decode_cuda(q, k, v, lens, D ** -0.5)
    want = tfa.flash_decode(q, k, v, lens, impl="plain")
    err, ok = close(got, want)
    live = int(lens_np.sum())
    flops = 4.0 * D * live * H
    nbytes = 4.0 * H * (2 * live * D + 2 * B * D) + 4.0 * B
    bound = max(flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES) * 1e3
    ms = timed(lambda: tfa._decode_cuda(q, k, v, lens, D ** -0.5))
    plain_ms = timed(lambda: tfa.flash_decode(q, k, v, lens,
                                              impl="plain"))
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    mask = (torch.arange(T, device=dev)[None, :] < lens[:, None])
    mask = mask[:, None, None, :]
    lib_ms = timed(lambda: torch.nn.functional
                   .scaled_dot_product_attention(qt, kt, vt,
                                                 attn_mask=mask))
    report("decode B%d T%d H%d D%d" % (B, T, H, D),
           "err %.3g live keys %d" % (err, live), ms, plain_ms, lib_ms,
           bound, "bytes")
    if not ok:
        fail("flash_decode disagrees with the plain version")
    return dict(err=err, ms=ms[0], plain_ms=plain_ms[0],
                library_ms=lib_ms[0], bound_ms=bound, bound_by="bytes")


def phase_kernels(tfa):
    H, D = 12, 64
    fwd = {}
    for T in (128, 300, 512):
        fwd[T] = fwd_case(tfa, 1, T, H, D, True, False, seed=T)
    seg = fwd_case(tfa, 2, 256, H, D, True, True, seed=7)
    full = fwd_case(tfa, 1, 256, H, D, False, False, seed=8)
    dec = decode_case(tfa, 8, 576, H, D, seed=9)
    fwd_err = max([c["err"] for c in fwd.values()]
                  + [seg["err"], full["err"]])
    return fwd[512], fwd_err, dec


def top2_margin(logits):
    top = torch.topk(logits.float(), 2).values
    return float(top[0] - top[1])


def phase_model(model_k, model_p, params):
    dev = torch.device("cuda", 0)
    g = torch.Generator(device="cpu").manual_seed(1)
    P, steps = 128, 16
    toks = torch.randint(0, model_k.vocab, (1, P), generator=g).to(dev)
    with torch.no_grad():
        lk, kk, vk = model_k.prefill(params, toks)
        lp, _, _ = model_p.prefill(params, toks)
        err = float((lk - lp).abs().max())
        L, H, Dh = model_k.n_layers, model_k.n_heads, model_k.head_dim
        kc = torch.zeros(L, 1, P + steps, H, Dh, device=dev)
        vc = torch.zeros_like(kc)
        kc[:, :, :P], vc[:, :, :P] = kk, vk
        tok = torch.argmax(lk[0, P - 1])[None]
        for i in range(steps):
            pos = torch.tensor([P + i], device=dev)
            dk, nk, nv = model_k.decode(params, tok, pos, kc, vc)
            dp, _, _ = model_p.decode(params, tok, pos, kc, vc)
            err = max(err, float((dk - dp).abs().max()))
            kc[:, :, P + i], vc[:, :, P + i] = nk, nv
            tok = torch.argmax(dk[0])[None]
    scale = float(lk.abs().max())
    print("model: prefill + %d decode steps, max |logit| %.3g, kernels vs"
          " plain max abs err %.3g (tolerance %g)"
          % (steps, scale, err, LOGIT_ATOL))
    if not err <= LOGIT_ATOL:
        fail("model logits: kernels vs plain differ by %g" % err)
    return err


def greedy_loop(model, params, prompt, n_new, rung, window, T):
    """Server-free greedy generation at the server's shapes: prefill at
    the prompt's rung, then stepwise decode at the window width with
    the request in row 0 of a contiguous cache. Returns the tokens and
    the top-2 logit margin at each."""
    dev = torch.device("cuda", 0)
    L, H, Dh = model.n_layers, model.n_heads, model.head_dim
    P = len(prompt)
    toks = torch.zeros(1, rung, dtype=torch.long, device=dev)
    toks[0, :P] = torch.from_numpy(prompt.astype(np.int64)).to(dev)
    with torch.no_grad():
        logits, k, v = model.prefill(params, toks)
        kc = torch.zeros(L, window, T, H, Dh, device=dev)
        vc = torch.zeros_like(kc)
        kc[:, 0, :P], vc[:, 0, :P] = k[:, 0, :P], v[:, 0, :P]
        out = [int(torch.argmax(logits[0, P - 1]))]
        margins = [top2_margin(logits[0, P - 1])]
        tokens = torch.zeros(window, dtype=torch.long, device=dev)
        positions = torch.zeros(window, dtype=torch.long, device=dev)
        while len(out) < n_new:
            pos = P + len(out) - 1
            tokens[0], positions[0] = out[-1], pos
            lg, nk, nv = model.decode(params, tokens, positions, kc, vc)
            kc[:, 0, pos], vc[:, 0, pos] = nk[:, 0], nv[:, 0]
            out.append(int(torch.argmax(lg[0])))
            margins.append(top2_margin(lg[0]))
    return out, margins


def phase_server(model, params, tfa):
    from mxnet_tpu_torch.serving import DecodeServer
    cfg = dict(seq_ladder=[64, 128, 256, 512], max_new_tokens=64,
               window=8, page_size=16, pool_pages=384)
    rs = np.random.RandomState(0)
    specs = [(rs.randint(0, model.vocab, size=rs.randint(20, 501)),
              int(rs.randint(32, 65)), i % 2) for i in range(16)]
    tfa.reset_launches()                  # the main path starts here
    t0 = time.perf_counter()
    srv = DecodeServer(model, params, **cfg)
    try:
        srv.warmup()
        t_warm = time.perf_counter() - t0
        reqs = [srv.submit(p, max_new_tokens=n, priority=pri)
                for p, n, pri in specs]
        victim = reqs[1]
        deadline = time.monotonic() + 120
        while len(victim.generated) < 8 and not victim.done():
            if time.monotonic() > deadline:
                fail("request 1 made no progress")
            time.sleep(0.001)
        victim.cancel()
        streamed = list(reqs[0].tokens(timeout=120))
        results = [r.result(timeout=300) for r in reqs]
        st = srv.stats()
    finally:
        srv.stop()
    launches = dict(tfa.launches)         # ... and ends here
    wall = time.perf_counter() - t0
    print("server: %d requests, warmup %.2f s, serve %.2f s; tokens/s %.1f,"
          " ttft p50 %.2f ms, inter-token p50 %.2f ms; launches %s"
          % (len(reqs), t_warm, wall - t_warm, st["tokens_per_sec"],
             st["ttft_ms"]["p50"], st["inter_token_ms"]["p50"], launches))
    if streamed != [int(t) for t in results[0]]:
        fail("tokens() stream differs from result()")
    if victim.state != "cancelled" or not 8 <= len(results[1]) < \
            specs[1][1]:
        fail("request 1 was not cancelled midway (state %s, %d tokens)"
             % (victim.state, len(results[1])))
    for i, (r, (_p, n, _pri)) in enumerate(zip(reqs, specs)):
        if i != 1 and (r.state != "done" or len(results[i]) != n):
            fail("request %d: state %s, %d/%d tokens"
                 % (i, r.state, len(results[i]), n))
    if st["completed"] != 15 or st["cancelled"] != 1 or st["errors"]:
        fail("server counters: %s" % {k: st[k] for k in
                                      ("completed", "cancelled", "errors")})
    if min(launches.values()) < 1:
        fail("a kernel of the path never launched: %s" % launches)
    # every stream against the server-free greedy loop
    T = srv._max_pages * cfg["page_size"]
    ties = 0
    for i, ((p, n, _pri), got) in enumerate(zip(specs, results)):
        rung = srv._seq_ladder.bucket_for(len(p))
        want, margins = greedy_loop(model, params, p, len(got), rung,
                                    cfg["window"], T)
        got = [int(t) for t in got]
        if got != want:
            step = next(j for j, (a, b) in enumerate(zip(got, want))
                        if a != b)
            print("  request %d diverges at step %d: top-2 margin %.3g"
                  % (i, step, margins[step]))
            if margins[step] >= TIE_MARGIN:
                fail("request %d differs from the greedy loop" % i)
            ties += 1
    print("server streams equal the greedy loop: 16/16 (%d at a tie)"
          % ties)
    return launches, st


def phase_step_profile(model, params, steps=5):
    """Where one steady decode step's time goes: a full window of 8
    requests (prompts of 256) is admitted, then `steps` ticks run under
    the profiler. Prints wall ms per step, device ms per step by kernel
    class, and the device's idle share."""
    from torch.profiler import ProfilerActivity, profile
    from mxnet_tpu_torch.serving import DecodeServer
    srv = DecodeServer(model, params, seq_ladder=[256], max_new_tokens=64,
                       window=8, page_size=16, pool_pages=384, start=False)
    try:
        rs = np.random.RandomState(2)
        reqs = [srv.submit(rs.randint(0, model.vocab, size=256),
                           max_new_tokens=64) for _ in range(8)]
        while srv.stats()["active"] < 8:
            srv._tick()                   # prefills (one per tick)
        srv._tick()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(steps):
                srv._tick()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3 / steps
        for r in reqs:
            r.cancel()
    finally:
        srv.stop(drain=False)
    classes = {"attention kernels": ("decode_kernel", "fwd_kernel"),
               "matmul": ("gemm", "cutlass", "sm90_", "ampere_"),
               "KV gather/scatter": ("index", "gather", "scatter")}
    by_class, kernels = {}, []
    for e in prof.key_averages():
        us = e.self_device_time_total
        if us <= 0:
            continue
        kernels.append((us, e.key, e.count))
        name = e.key.lower()
        cls = next((c for c, keys in classes.items()
                    if any(k in name for k in keys)), "other")
        by_class[cls] = by_class.get(cls, 0.0) + us / 1e3 / steps
    busy = sum(by_class.values())
    print("decode step (window 8, ~256-token contexts): wall %.2f ms,"
          " device busy %.2f ms, idle share %.2f"
          % (wall, busy, 1 - busy / wall if wall else float("nan")))
    for cls, ms in sorted(by_class.items(), key=lambda kv: -kv[1]):
        print("  %-18s %.3f ms/step" % (cls, ms))
    for us, key, count in sorted(kernels, reverse=True)[:6]:
        print("  top: %.3f ms/step in %d calls/step  %s"
              % (us / 1e3 / steps, count // steps, key[:70]))


def phase_server_int8(model, params):
    from mxnet_tpu_torch.serving import DecodeServer
    os.environ["MXNET_KV_DTYPE"] = "int8"
    try:
        srv = DecodeServer(model, params, seq_ladder=[64, 128],
                           max_new_tokens=32, window=8, page_size=16,
                           pool_pages=64)
    finally:
        del os.environ["MXNET_KV_DTYPE"]
    rs = np.random.RandomState(1)
    try:
        if not srv._pool.quantized:
            fail("the int8 pool is not quantized")
        reqs = [srv.submit(rs.randint(0, model.vocab, size=40 + 20 * i),
                           max_new_tokens=32) for i in range(4)]
        out = [r.result(timeout=120) for r in reqs]
        st = srv.stats()
    finally:
        srv.stop()
    if any(len(o) != 32 for o in out) or st["completed"] != 4:
        fail("int8 pool run did not complete")
    print("server int8 pool: 4/4 requests complete, tokens/s %.1f"
          % st["tokens_per_sec"])


def main():
    t_start = time.perf_counter()
    card = phase_device()
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import importlib
    from mxnet_tpu_torch.serving import ToyDecoderLM
    tfa = importlib.import_module(
        "mxnet_tpu_torch.parallel.flash_attention")
    phase_build()
    print("kernels vs plain (fp32, TF32 off, rtol = atol = 1e-5; device ms"
          " = GPU time per call from CUDA-graph replays, per-call ms ="
          " median CUDA-event time of one eager call; %s):" % card)
    fwd, fwd_err, dec = phase_kernels(tfa)
    t0 = time.perf_counter()
    model_k = ToyDecoderLM(**GPT2_SMALL)
    model_p = ToyDecoderLM(impl="plain", **GPT2_SMALL)
    params = model_k.init_params(seed=0, device="cuda")
    print("model: GPT-2-small width, %.1fM parameters, init %.1f s"
          % (sum(p.numel() for p in params.values()) / 1e6,
             time.perf_counter() - t0))
    phase_model(model_k, model_p, params)
    launches, _st = phase_server(model_k, params, tfa)
    phase_server_int8(model_k, params)
    phase_step_profile(model_k, params)
    kernels = [
        dict(name="flash_fwd", route="cuda", source=FWD_SRC,
             replaces=FWD_TPU, launches=launches["flash_fwd"],
             max_abs_err=fwd_err, ms=fwd["ms"], plain_ms=fwd["plain_ms"],
             bound_ms=fwd["bound_ms"], bound_by=fwd["bound_by"],
             library_ms=fwd["library_ms"], ok=True),
        dict(name="flash_decode", route="cuda", source=DEC_SRC,
             replaces=DEC_TPU, launches=launches["flash_decode"],
             max_abs_err=dec["err"], ms=dec["ms"],
             plain_ms=dec["plain_ms"], bound_ms=dec["bound_ms"],
             bound_by=dec["bound_by"], library_ms=dec["library_ms"],
             ok=True),
    ]
    print("total %.1f s" % (time.perf_counter() - t_start))
    print("card:", card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
