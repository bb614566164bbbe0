"""On-card smoke run of the PyTorch/CUDA port (mxnet_tpu_torch).

    python3 chip_smoke.py

Needs one NVIDIA Hopper card (sm_90) and nvcc; exits non-zero, printing
no result, anywhere else. Phases (any failure exits non-zero):

1. device — CUDA present, capability >= (9, 0); prints the card's
   ``nvidia-smi`` name and power limit;
2. build — the five attention kernels from
   ``mxnet_tpu_torch/parallel/csrc`` (one nvcc per source, started
   together), with the ptxas register and spill lines of every kernel
   instance (the decode libraries: one kernel a width), and the count
   of tensor-core instructions
   (``HMMA``/``HGMMA`` in ``cuobjdump -sass``) in the forward and each
   backward library, which must not be 0;
3. kernels vs plain — the forward kernel (3xTF32 on the tensor cores)
   at the server's one-prompt prefill, B1 at every rung of its ladder
   (T 64, 128, 256, 512) and at T 300, and the decode kernel over the
   server's window (B8 T576 H12 D64) at random lengths and with one
   live stream (lengths 576, 1, ..., 1), against
   their plain PyTorch versions on the card (fp32, TF32 off, forward O
   and LSE and decode within rtol = atol = 1e-5), with the
   device time (CUDA-graph replay) and per-call time (CUDA events) of
   the kernel, the plain version and torch's
   scaled_dot_product_attention (a yardstick only), and each kernel's
   bound from its bytes and flops; the forward at each of its two
   block shapes (S = 1 or 4 warps on a row group, forced through
   ``mxt_flash_fwd_split``), each held to the plain version and timed,
   beside the host's choice; the decode kernel's splits of the cache
   (the host's choice), a second launch bit-identical, NaN past each
   length changing nothing, and one call's device time with a cold L2
   (``cold_ms``) beside the warm one;
4. training-shape kernels vs plain — the forward kernel at the LM's
   B8 T1024 causal, a packed causal batch (B2 T256), non-causal
   cross-attention (Tq 128, Tk 320), D = 30 (4-byte staging) with Tq <
   Tk and D = 128 with Tq > Tk, at both block shapes (rtol = atol =
   1e-5; rows with no live key must carry the plain version's LSE), each
   shape timed at B8 T1024; two launches bit-identical; at B2 T256 its O
   and LSE against float64 dense attention, at most FWD_F64_RATIO times
   the fp32 plain version's own error. Then the
   dK/dV and dQ kernels (3xTF32 on the tensor cores) against their plain
   versions and against torch autograd of dense attention (rtol = atol
   = 1e-4) at the same five shapes, timed the same way, with the
   backward of scaled_dot_product_attention as the yardstick and both
   bounds (3xTF32 on the tensor cores, fp32 on the CUDA cores); two
   launches on one input must be bit-identical, and a dK with a zeroed
   tile must fail the comparison; at B2 T256 each kernel's error against
   a float64 dense autograd, beside the fp32 plain version's own;
   flash_attention on CUDA tensors returns a tensor with a grad_fn whose
   gradients reach q, k and v;
5. model — ToyDecoderLM at GPT-2-small width (12 layers, 12 heads x 64,
   d_ff 3072, vocab 50257, 1024 positions; random weights from seed 0):
   prefill logits and 16 stepwise decode logits, kernels vs plain;
6. server — the first slice's main path: DecodeServer serves 16
   streamed requests (one consumed through tokens(), one cancelled
   midway); every stream equals a server-free greedy loop over the same
   model; then a short run over an int8 KV pool. Kernel launch counts
   are zeroed just before this phase and read just after it;
7. int8 decode — the third slice's ``flash_decode(k_scale=, v_scale=)``
   on ``flash_decode_q8.cu``: at B8 T576 H12 D64 on a cache quantized
   page by page as the int8 pool does it (raw int8 pages, each page's
   scale repeated over its 16 slots) and at the JAX test's B2 T128 H2
   D8, the kernel against its plain version and against
   ``flash_decode.cu`` on the dequantized cache (rtol = atol = 1e-5,
   and whether the two are bit-identical), and garbage past each row's
   length (random bytes, NaN scales) must leave its output
   bit-identical; the host's splits and cold-L2 times of both decode
   kernels at B8 T576; then, on phase 6's int8 pool, one decode step's
   calls (one per layer) over the raw pages of live requests, launch
   counts zeroed just before and read just after, held the same way;
8. rtc — ``mx.rtc.CudaModule`` compiles three CUDA C kernels (axpy and
   scale_rows of tests/test_rtc.py, and row_sum, a shared-memory
   reduction with 256-thread blocks) with NVRTC and launches them on
   gpu(0) arrays, held to torch (rtol = atol = 1e-6 for axpy and
   scale_rows, 1e-5 for row_sum); in-out arrays of another dtype or
   layout are written back, a launch above 48 KB of shared memory
   works, a broken source raises with the compiler's log, and a CPU
   context raises. Compile seconds (cold and from the disk cache), host
   microseconds per launch, and axpy's device time at 2^26 floats
   against torch.add and its bound. Launch counts are zeroed just before
   the three kernels' run and read just after;
9. step profile — where one steady decode step's time goes (kernel
   classes, device idle share), from the profiler;
10. training — the second slice's main path: a Gluon decoder LM at the
   same width (``gluon_lm``) on gpu(0), batch 8 x 1024 random tokens,
   next-token SoftmaxCrossEntropyLoss, Adam (lr 1e-3). One
   record/backward against a twin with dense attention and the same
   weights (every gradient and the loss must agree), and again with the
   twin reusing the kernel route's ReLU masks, then 20 Trainer
   steps on one fixed batch (the loss must fall; launch counts zeroed
   just before and read just after: 12 per step for each of flash_fwd,
   flash_bwd_dkdv and flash_bwd_dq), then ms per step, tokens/s and the
   device idle share from the profiler.

It prints a ``{"kernels": [...]}`` line, one entry per kernel and main
path (``path``: server, training, int8 decode or rtc; ``launches`` from
that path's run, times at the shape it gives the kernel), and, last,
``{"ok": true, "device": {...}}``.
"""
import ctypes
import gc
import json
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

# H100 SXM data-sheet peaks (dense): fp32 on the CUDA cores, TF32 on the
# tensor cores, HBM3
PEAK_FP32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BYTES = 3.35e12
# the attention forward and backward kernels take each fp32 product as
# three TF32 products (3xTF32: hi*hi + hi*lo + lo*hi)
TF32_PASSES = 3
TOL = dict(rtol=1e-5, atol=1e-5)
# the scratch buffer written before each cold-L2 timing (L2: 50 MB), and
# the spin (~0.5 ms at the H100's clock) that hides the call's host work
COLD_FLUSH_BYTES = 128 << 20
SPIN_CYCLES = 1 << 20
# the forward's float64 check (B2 T256): the kernel's error against
# float64 dense attention may be at most this many times the fp32 plain
# version's own (3xTF32 products, summed in another order)
FWD_F64_RATIO = 4.0
# flash_fwd.cu's block shapes: S warps share each 16-row group of a
# block's query tile (64- or 16-row blocks). mxt_flash_fwd, which the port
# calls, picks one from the grid; mxt_flash_fwd_split forces one
FWD_SPLITS = (1, 4)
# logits tolerance of the 12-layer model, kernels vs plain: attention
# rounding (~1e-7 relative) is carried through 12 residual layers into
# logits of magnitude up to ~30
LOGIT_ATOL = 1e-3
TIE_MARGIN = 1e-4
GPT2_SMALL = dict(vocab=50257, n_layers=12, n_heads=12, head_dim=64,
                  d_ff=3072, max_len=1024)
FWD_SRC = "mxnet_tpu_torch/parallel/csrc/flash_fwd.cu"
DEC_SRC = "mxnet_tpu_torch/parallel/csrc/flash_decode.cu"
BWD_SRC = {"flash_bwd_dkdv": "mxnet_tpu_torch/parallel/csrc/flash_bwd_dkdv.cu",
           "flash_bwd_dq": "mxnet_tpu_torch/parallel/csrc/flash_bwd_dq.cu"}
FWD_TPU = "mxnet_tpu/parallel/flash_attention.py:83"
DEC_TPU = "mxnet_tpu/parallel/flash_attention.py:516"
BWD_TPU = {"flash_bwd_dkdv": "mxnet_tpu/parallel/flash_attention.py:137",
           "flash_bwd_dq": "mxnet_tpu/parallel/flash_attention.py:187"}
# backward kernels vs plain: 3xTF32 products (~2^-22 relative each, a
# scratch emulation put them 1e-6 to 3e-6 off fp32) summed over up to
# 1024 rows in another order than the plain einsums
BWD_TOL = dict(rtol=1e-4, atol=1e-4)
# flops per live (q, k) pair and head, per D: dK/dV (S, dP, dV, dK) and
# dQ (S, dP, dQ)
BWD_FLOPS = {"flash_bwd_dkdv": 8, "flash_bwd_dq": 6}
# the training check, max|diff| / max|grad| per parameter, kernel route
# vs the dense-attention twin. The two softmax algorithms differ by ~1e-7
# in fp32; where that flips a ReLU pre-activation across zero, one
# token's term (about 1% of max |grad|) enters or leaves a row of that
# layer's ffn1 weight gradient. So the ffn1 weights get GRAD_RTOL_RELU
# (a few flips), every other parameter GRAD_RTOL (7x the largest
# reading, 1.3e-3), and a second pass of the twin that reuses the kernel
# route's ReLU masks, which takes the flips out, holds every parameter
# to GRAD_RTOL_SHARED. Per-sample losses within LOSS_ATOL.
GRAD_RTOL = 1e-2
GRAD_RTOL_RELU = 5e-2
GRAD_RTOL_SHARED = 1e-3
LOSS_ATOL = 1e-4
TRAIN_BATCH = 8
Q8_SRC = "mxnet_tpu_torch/parallel/csrc/flash_decode_q8.cu"
Q8_TPU = "mxnet_tpu/parallel/flash_attention.py:528"
RTC_SRC = "mxnet_tpu_torch/rtc.py"
RTC_TPU = "mxnet_tpu/rtc.py:105"
# the int8 pool's page size
PAGE = 16
# rtc kernels vs torch: axpy may contract to one FMA (one ulp), row_sum
# adds in another order than torch.sum
RTC_TOL = dict(rtol=1e-6, atol=1e-6)
ROWSUM_TOL = dict(rtol=1e-5, atol=1e-5)
# the kernels each main path runs
SERVER_KERNELS = ("flash_fwd", "flash_decode")
TRAIN_KERNELS = ("flash_fwd", "flash_bwd_dkdv", "flash_bwd_dq")
# user kernels for mx.rtc: tests/test_rtc.py's two in CUDA C, and a
# shared-memory reduction
RTC_KERNELS = r"""
extern "C" __global__ void axpy(float alpha, const float *x, float *y) {
    long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
    y[i] += alpha * x[i];
}

// out[row, :] = x[row, :] * (row + 1): one block per row, one thread per
// column
extern "C" __global__ void scale_rows(const float *x, float *out) {
    long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
    out[i] = x[i] * (float)(blockIdx.x + 1);
}

// out[row] = sum of x[row, 0:n]: one block per row, blockDim.x strided
// partial sums added by a tree in dynamic shared memory (blockDim.x
// floats, a power of two)
extern "C" __global__ void row_sum(const float *x, float *out, int n) {
    extern __shared__ float part[];
    const float *r = x + (long)blockIdx.x * n;
    float s = 0.f;
    for (int j = threadIdx.x; j < n; j += blockDim.x) s += r[j];
    part[threadIdx.x] = s;
    __syncthreads();
    for (int w = blockDim.x / 2; w > 0; w >>= 1) {
        if (threadIdx.x < w) part[threadIdx.x] += part[threadIdx.x + w];
        __syncthreads();
    }
    if (threadIdx.x == 0) out[blockIdx.x] = part[0];
}
"""


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


def events_ms(fn, before=None):
    """CUDA-event time of ``fn()``, after ``before()`` (queued ahead of
    the start event)."""
    if before is not None:
        before()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


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
    return statistics.median(events_ms(graph.replay) / iters
                             for _ in range(reps))


def cold_ms(fn, reps=20):
    """(cold, warm) device ms of ONE call: the median over ``reps``
    CUDA-event timings of one eager call, cold each after COLD_FLUSH_BYTES
    of a scratch buffer are written (more than twice the 50 MB L2: none
    of the call's inputs is left there), warm each right after another
    call. A spin kernel (``torch.cuda._sleep``, ~0.5 ms, no memory
    traffic) runs ahead of the start event each time, so the call's host
    work is queued before its timing starts. A decode layer's gathered
    cache (28 MB at B8 T576) is otherwise partly held in L2 from one
    graph replay to the next, which flatters a kernel bound by its
    bytes."""
    flush = torch.empty(COLD_FLUSH_BYTES // 4, device="cuda")

    def after(first):
        first()
        torch.cuda._sleep(SPIN_CYCLES)
    fn()
    cold = statistics.median(
        events_ms(fn, lambda i=i: after(lambda: flush.fill_(float(i))))
        for i in range(reps))
    warm = statistics.median(events_ms(fn, lambda: after(fn))
                             for _ in range(reps))
    del flush
    return cold, warm


def timed(fn):
    """(device ms, per-call ms) of one call."""
    return device_ms(fn), call_ms(fn)


def stream_ms(fn, iters=10):
    """Time per call of ``iters`` calls issued back to back between two
    CUDA events, after a warm-up call: device time when the device is
    the bottleneck (used where a call runs torch autograd, which a CUDA
    graph capture does not take)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def report(name, what, ms, plain_ms, lib_ms, bound, bound_by):
    print("  %-30s %s | device ms: kernel %.4f plain %.4f sdpa %.4f |"
          " per-call ms: kernel %.4f plain %.4f sdpa %.4f | bound %.2f us"
          " (%s)" % (name, what, ms[0], plain_ms[0], lib_ms[0], ms[1],
                     plain_ms[1], lib_ms[1], bound * 1e3, bound_by))


def close(got, want, tol=TOL):
    """(max abs error, within tol) over finite reference entries."""
    err = (got - want).abs()
    ok = bool(torch.isfinite(got).all()) and bool(
        (err <= tol["atol"] + tol["rtol"] * want.abs()).all())
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
                # ptxas names each kernel instance, then its resources
                entry = re.search(r"Compiling entry function .*?((?:fwd|dkdv|"
                                  r"dq|decode_q8|decode)_kernel)(?:I((?:Li"
                                  r"\d+E)+)E)?", ln)
                if entry:
                    print("  %s: %s<%s>" % (name, entry.group(1), ", ".join(
                        re.findall(r"\d+", entry.group(2) or ""))))
                elif "registers" in ln or "spill" in ln:
                    print("  %s: %s" % (name, ln.strip()))
    # the forward and backward kernels' contractions must run on the tensor
    # cores
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    for name in ("flash_fwd",) + tuple(BWD_SRC):
        sass = subprocess.run([cuobjdump, "-sass", libs[name]],
                              capture_output=True, text=True, timeout=120)
        if sass.returncode != 0:
            fail("cuobjdump -sass %s: %s" % (libs[name], sass.stderr))
        hmma = len(re.findall(r"\bHMMA\b", sass.stdout))
        hgmma = len(re.findall(r"\bHGMMA\b", sass.stdout))
        print("  %s: tensor-core instructions in the SASS: HMMA %d, HGMMA %d"
              % (name, hmma, hgmma))
        if hmma + hgmma == 0:
            fail("%s has no tensor-core instruction" % name)


def fwd_split_entry(path):
    """``mxt_flash_fwd_split`` of the flash_fwd library at ``path``:
    ``mxt_flash_fwd``'s arguments, then S before the stream."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn = ctypes.CDLL(path).mxt_flash_fwd_split
    fn.argtypes = [p] * 6 + [i] * 5 + [f, i, i, p]
    fn.restype = i
    return fn


_fwd_split_fn = []


def fwd_forced(q, k, v, seg, scale, causal, split, fn=None):
    """One call of flash_fwd.cu at block shape ``split`` (``fn``, an
    ``mxt_flash_fwd_split``, else the port's built library's) on
    contiguous inputs, as ``_fwd_cuda`` makes it but counting no launch:
    (o, lse)."""
    if fn is None:
        if not _fwd_split_fn:
            from mxnet_tpu_torch.parallel import _build
            _fwd_split_fn.append(fwd_split_entry(
                _build.build_all()["flash_fwd"]))
        fn = _fwd_split_fn[0]
    B, Tq, H, D = q.shape
    o = torch.empty_like(q)
    lse = torch.empty(B, H, Tq, device=q.device)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if seg is None else seg.data_ptr(), o.data_ptr(),
            lse.data_ptr(), B, H, Tq, k.shape[1], D, float(scale),
            int(causal), split, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        fail("flash_fwd at S = %d: launch failed with cudaError %d"
             % (split, rc))
    return o, lse


def segment_plane(B, T, seed, dev):
    """(B, T) int32 packed-row segment ids: four segments, then a pad
    tail of 16 positions (id 0)."""
    rs = np.random.RandomState(seed)
    cuts = np.sort(rs.choice(np.arange(1, T - 16), 3, replace=False))
    ids = np.zeros(T, np.int32)
    for i, (a, b) in enumerate(zip([0] + list(cuts), list(cuts) + [T - 16])):
        ids[a:b] = i + 1
    return torch.from_numpy(np.tile(ids, (B, 1))).to(dev)


def live_mask(B, Tq, Tk, causal, seg, dev):
    """(B, Tq, Tk) bool: the (q, k) pairs the masks let through."""
    qp = torch.arange(Tq, device=dev)[:, None]
    kp = torch.arange(Tk, device=dev)[None, :]
    live = torch.ones(Tq, Tk, dtype=torch.bool, device=dev)
    if causal:
        live &= qp >= kp
    live = live.expand(B, Tq, Tk)
    if seg is not None:
        live = live & (seg[:, :, None] == seg[:, None, :]) \
            & (seg[:, :, None] > 0)
    return live


def fwd_bounds(B, Tq, Tk, H, D, live, segmented):
    """(3xTF32 bound ms, fp32 bound ms, bound_by, flops, bytes) of the
    forward: 4*D flops per live pair and head (S = Q K^T and P V); q, k
    and v read, o and the LSE written, and the segment plane read."""
    flops = 4.0 * D * int(live.sum()) * H
    nbytes = 4.0 * (2 * B * Tq * H * D + 2 * B * Tk * H * D + B * H * Tq)
    if segmented:
        nbytes += 4.0 * B * Tq
    tc_s = TF32_PASSES * flops / PEAK_TF32_FLOPS
    bound = max(tc_s, nbytes / PEAK_BYTES) * 1e3
    bound_fp32 = max(flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES) * 1e3
    bound_by = "bytes" if nbytes / PEAK_BYTES > tc_s else "operations"
    return bound, bound_fp32, bound_by, flops, nbytes


def fwd_case(tfa, B, Tq, Tk, H, D, causal, segmented, seed,
             time_splits=False):
    """The forward kernel on one input: O and LSE against the plain
    version (``_torch_fwd_lse``) on the rows with a live key, and the LSE
    of rows with none equal to the plain version's, at the host's block
    shape and at each forced one (``FWD_SPLITS``); a second
    launch must be bit-identical; the host's choice is read off as the
    forced shape whose output it equals. Times the host's choice (and,
    with ``time_splits``, every shape) beside the plain version and
    SDPA."""
    dev = torch.device("cuda", 0)
    g = torch.Generator(device="cpu").manual_seed(seed)
    q = torch.randn(B, Tq, H, D, generator=g).to(dev)
    k, v = (torch.randn(B, Tk, H, D, generator=g).to(dev) for _ in range(2))
    seg = segment_plane(B, Tq, seed, dev) if segmented else None
    scale = D ** -0.5
    want, want_lse = tfa._torch_fwd_lse(q, k, v, seg, scale, causal)
    live = live_mask(B, Tq, Tk, causal, seg, dev)
    rows = live.any(-1)                   # (B, Tq): rows with a live key
    want_rows = want_lse.permute(0, 2, 1)
    outs, errs = {}, []
    for split in (None,) + FWD_SPLITS:
        got, lse = tfa._fwd_cuda(q, k, v, seg, scale, causal) \
            if split is None else \
            fwd_forced(q, k, v, seg, scale, causal, split)
        outs[split] = (got, lse)
        err, ok = close(got[rows], want[rows], TOL)
        lse_rows = lse.permute(0, 2, 1)
        lse_err, lse_ok = close(lse_rows[rows], want_rows[rows], TOL)
        # rows that attend to nothing (segment id 0): the plain version's
        # LSE exactly, which the backward's P recompute reads
        dead_ok = torch.equal(lse_rows[~rows], want_rows[~rows])
        errs.append((split, err, lse_err, ok and lse_ok and dead_ok))
    again = tfa._fwd_cuda(q, k, v, seg, scale, causal)
    same = all(torch.equal(a, b) for a, b in zip(again, outs[None]))
    choice = next((s for s in FWD_SPLITS
                   if all(torch.equal(a, b)
                          for a, b in zip(outs[s], outs[None]))), None)
    bound, bound_fp32, bound_by, flops, nbytes = fwd_bounds(
        B, Tq, Tk, H, D, live, segmented)
    ms = timed(lambda: tfa._fwd_cuda(q, k, v, seg, scale, causal))
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
    split_ms = {s: device_ms(lambda s=s: fwd_forced(
        q, k, v, seg, scale, causal, s)) for s in FWD_SPLITS} \
        if time_splits else {}
    name = "fwd B%d Tq%d Tk%d H%d D%d %s%s" % (
        B, Tq, Tk, H, D, "causal" if causal else "full",
        " seg" if segmented else "")
    err = max(e for _, e, _, _ in errs)
    lse_err = max(e for _, _, e, _ in errs)
    print("  %-34s err %.3g lse_err %.3g | device ms: kernel %.4f plain %.4f"
          " sdpa %.4f | per-call ms: kernel %.4f plain %.4f sdpa %.4f |"
          " bound %.2f us 3xTF32 (%s) [%.2f us fp32 CUDA cores] | %.2f"
          " GFLOP, %.1f MB" % (name, err, lse_err, ms[0], plain_ms[0],
                              lib_ms[0], ms[1], plain_ms[1], lib_ms[1],
                              bound * 1e3, bound_by, bound_fp32 * 1e3,
                              flops / 1e9, nbytes / 1e6))
    print("    block shapes (S warps a row group), err O/LSE: %s; %d rows"
          " with no live key, LSE equal to plain: %s; host's choice S ="
          " %s; second launch bit-identical: %s%s" % (
              ", ".join("S=%s %.3g/%.3g" % ("host" if sp is None else sp,
                                            e, le)
                        for sp, e, le, _ in errs), int((~rows).sum()),
              all(ok for _, _, _, ok in errs), choice, same,
              "" if not split_ms else "; device ms " + ", ".join(
                  "S=%d %.4f" % kv for kv in split_ms.items())))
    if not all(ok for _, _, _, ok in errs):
        fail("flash_fwd disagrees with the plain version: %s" % name)
    if not same or choice is None:
        fail("flash_fwd: a second launch differs, or the host's launch"
             " equals no block shape: %s" % name)
    return dict(err=max(err, lse_err), ms=ms[0], plain_ms=plain_ms[0],
                library_ms=lib_ms[0], bound_ms=bound, bound_by=bound_by,
                bound_fp32_ms=bound_fp32, split_ms=split_ms, choice=choice)


def fwd_f64_case(tfa, B=2, T=256, H=12, D=64):
    """The forward kernel's O and LSE against float64 dense attention,
    beside the fp32 plain version's own float64 error, on one causal
    input (B2 T256): the kernel's may be at most ``FWD_F64_RATIO`` times
    the plain version's."""
    dev = torch.device("cuda", 0)
    g = torch.Generator(device="cpu").manual_seed(14)
    q, k, v = (torch.randn(B, T, H, D, generator=g).to(dev)
               for _ in range(3))
    scale = D ** -0.5
    kern = tfa._fwd_cuda(q, k, v, None, scale, True)
    plain = tfa._torch_fwd_lse(q, k, v, None, scale, True)
    q64, k64, v64 = (x.double() for x in (q, k, v))
    o64 = tfa._torch_reference(q64, k64, v64, scale, True)
    s64 = torch.einsum("bqhd,bkhd->bhqk", q64, k64) * scale
    s64 = torch.where(live_mask(1, T, T, True, None, dev)[:, None], s64,
                      -1e30)
    ref = (o64, torch.logsumexp(s64, -1))
    errs = {what: [float((a.double() - r).abs().max())
                   for a, r in zip(outs, ref)]
            for what, outs in (("kernel", kern), ("fp32 plain", plain))}
    ratio = [a / b for a, b in zip(errs["kernel"], errs["fp32 plain"])]
    print("  forward vs float64 dense attention at B%d T%d H%d D%d causal,"
          " max abs err O/LSE: kernel %s; fp32 plain version %s; ratio %s"
          " (at most %g)"
          % (B, T, H, D, "/".join("%.3g" % e for e in errs["kernel"]),
             "/".join("%.3g" % e for e in errs["fp32 plain"]),
             "/".join("%.2f" % r for r in ratio), FWD_F64_RATIO))
    if not all(e <= TOL["atol"] for e in errs["kernel"]) \
            or not all(r <= FWD_F64_RATIO for r in ratio):
        fail("flash_fwd disagrees with float64 dense attention")


def decode_splits(name, B, H, T, D):
    """The host's number of splits of the cache for a call of decode
    kernel ``name`` (flash_decode or flash_decode_q8) on these shapes."""
    from mxnet_tpu_torch.parallel import _build
    return _build.library(name).splits(B, H, T, D)


def decode_case(tfa, B, T, H, D, seed, lens_np=None):
    """The fp32 decode kernel on one input, at random lengths from 1 to T
    (rows 0 and B-1 at 1 and T) or at ``lens_np``: against its plain
    version (and, twice launched, against itself; with NaN past each
    length, bit-identical), timed warm from CUDA-graph replays and cold
    after an L2 flush, beside SDPA and its bound."""
    dev = torch.device("cuda", 0)
    g = torch.Generator(device="cpu").manual_seed(seed)
    q = torch.randn(B, 1, H, D, generator=g).to(dev)
    k, v = (torch.randn(B, T, H, D, generator=g).to(dev)
            for _ in range(2))
    if lens_np is None:
        lens_np = np.random.RandomState(seed).randint(1, T + 1, size=B)
        lens_np[0], lens_np[-1] = 1, T
    lens_np = np.asarray(lens_np)
    lens = torch.from_numpy(lens_np.astype(np.int32)).to(dev)
    got = tfa._decode_cuda(q, k, v, lens, D ** -0.5)
    want = tfa.flash_decode(q, k, v, lens, impl="plain")
    err, ok = close(got, want)
    tail = torch.arange(T, device=dev)[None, :] >= lens[:, None]
    dirty = tfa._decode_cuda(q, k.masked_fill(tail[:, :, None, None],
                                              float("nan")),
                             v.masked_fill(tail[:, :, None, None],
                                           float("nan")), lens, D ** -0.5)
    same = torch.equal(tfa._decode_cuda(q, k, v, lens, D ** -0.5), got)
    clean_tail = torch.equal(dirty, got)
    live = int(lens_np.sum())
    flops = 4.0 * D * live * H
    nbytes = 4.0 * H * (2 * live * D + 2 * B * D) + 4.0 * B
    bound = max(flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES) * 1e3
    ms = timed(lambda: tfa._decode_cuda(q, k, v, lens, D ** -0.5))
    cold = cold_ms(lambda: tfa._decode_cuda(q, k, v, lens, D ** -0.5))
    plain_ms = timed(lambda: tfa.flash_decode(q, k, v, lens,
                                              impl="plain"))
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    mask = (torch.arange(T, device=dev)[None, :] < lens[:, None])
    mask = mask[:, None, None, :]
    lib_ms = timed(lambda: torch.nn.functional
                   .scaled_dot_product_attention(qt, kt, vt,
                                                 attn_mask=mask))
    splits = decode_splits("flash_decode", B, H, T, D)
    report("decode B%d T%d H%d D%d" % (B, T, H, D),
           "err %.3g live keys %d" % (err, live), ms, plain_ms, lib_ms,
           bound, "bytes")
    print("  %-30s splits %d (%d blocks); one call, device ms: cold L2 %.4f,"
          " warm %.4f; second launch bit-identical %s; NaN past each length"
          " leaves the output bit-identical: %s"
          % ("", splits, B * H * splits, cold[0], cold[1], same, clean_tail))
    if not ok:
        fail("flash_decode disagrees with the plain version")
    if not same:
        fail("flash_decode is not deterministic")
    if not clean_tail:
        fail("flash_decode read past a row's length")
    return dict(err=err, ms=ms[0], plain_ms=plain_ms[0],
                library_ms=lib_ms[0], bound_ms=bound, bound_by="bytes",
                cold_ms=cold[0], splits=splits)


def probe_comparison(tfa, args, got, want):
    """Two launches of each backward kernel on one input must give
    bit-identical outputs (no atomics: each block sums in a fixed
    order), and the comparison must fail on a dK with one 64-key tile
    zeroed."""
    again = {"flash_bwd_dkdv": tfa._bwd_cuda("flash_bwd_dkdv", *args),
             "flash_bwd_dq": (tfa._bwd_cuda("flash_bwd_dq", *args),)}
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for kn in got
               for a, b in zip(got[kn], again[kn]))
    bad = got["flash_bwd_dkdv"][0].clone()
    bad[0, 64:128, 0] = 0.0
    tile_err, tile_ok = close(bad, want["flash_bwd_dkdv"][0], BWD_TOL)
    print("  determinism: a second launch of each kernel on the same input"
          " gives bit-identical dk, dv, dq: %s; dK with keys 64-127 of"
          " (b0, h0) zeroed: err %.3g, check %s"
          % (same, tile_err, "passes" if tile_ok else "fails (as it must)"))
    if not same:
        fail("the backward kernels are not deterministic")
    if tile_ok:
        fail("the backward comparison cannot see a planted difference")


def f64_case(tfa, B=2, T=256, H=12, D=64):
    """Each backward kernel's error against torch autograd of dense
    attention in float64, beside the fp32 plain version's own float64
    error, on one causal input (B2 T256)."""
    dev = torch.device("cuda", 0)
    g = torch.Generator(device="cpu").manual_seed(14)
    q, k, v, do = (torch.randn(B, T, H, D, generator=g).to(dev)
                   for _ in range(4))
    scale = D ** -0.5
    o, lse = tfa._fwd_cuda(q, k, v, None, scale, True)
    dcap = torch.sum(do * o, dim=-1).permute(0, 2, 1).contiguous()
    args = (q, k, v, do, lse, dcap, None, scale, True)
    kern = tfa._bwd_cuda("flash_bwd_dkdv", *args) \
        + (tfa._bwd_cuda("flash_bwd_dq", *args),)
    plain = tfa._torch_bwd_dkdv(*args) + (tfa._torch_bwd_dq(*args),)
    leaves = [x.double().requires_grad_(True) for x in (q, k, v)]
    dq, dk, dv = torch.autograd.grad(tfa.flash_attention(
        *leaves, causal=True, scale=scale, impl="plain"), leaves,
        do.double())
    ref = (dk, dv, dq)
    errs = {}
    for what, outs in (("kernels", kern), ("fp32 plain", plain)):
        errs[what] = [float((a.double() - r).abs().max())
                      for a, r in zip(outs, ref)]
    print("  vs float64 dense autograd at B%d T%d H%d D%d causal, max abs err"
          " dk/dv/dq: kernels %s; fp32 plain versions %s (max |grad| %.3g)"
          % (B, T, H, D, "/".join("%.3g" % e for e in errs["kernels"]),
             "/".join("%.3g" % e for e in errs["fp32 plain"]),
             max(float(r.abs().max()) for r in ref)))
    if not all(e <= BWD_TOL["atol"] for e in errs["kernels"]):
        fail("backward kernels disagree with float64 dense autograd")


def bwd_case(tfa, B, Tq, Tk, H, D, causal, segmented, seed, probe=False):
    """Both backward kernels against their plain versions on one input,
    with a zero cotangent on rows that attend to nothing (a masked
    loss), and the backward of scaled_dot_product_attention as the
    yardstick; with ``probe``, also :func:`probe_comparison`. Returns
    {kernel name: record}."""
    dev = torch.device("cuda", 0)
    g = torch.Generator(device="cpu").manual_seed(seed)
    q, do = (torch.randn(B, Tq, H, D, generator=g).to(dev) for _ in range(2))
    k, v = (torch.randn(B, Tk, H, D, generator=g).to(dev) for _ in range(2))
    seg = segment_plane(B, Tq, seed, dev) if segmented else None
    scale = D ** -0.5
    if seg is not None:
        do[seg == 0] = 0.0
    o, lse = tfa._fwd_cuda(q, k, v, seg, scale, causal)
    dcap = torch.sum(do * o, dim=-1).permute(0, 2, 1).contiguous()
    args = (q, k, v, do, lse, dcap, seg, scale, causal)
    got = {"flash_bwd_dkdv": tfa._bwd_cuda("flash_bwd_dkdv", *args),
           "flash_bwd_dq": (tfa._bwd_cuda("flash_bwd_dq", *args),)}
    torch.cuda.synchronize()
    want = {"flash_bwd_dkdv": tfa._torch_bwd_dkdv(*args),
            "flash_bwd_dq": (tfa._torch_bwd_dq(*args),)}
    plain = {"flash_bwd_dkdv": lambda: tfa._torch_bwd_dkdv(*args),
             "flash_bwd_dq": lambda: tfa._torch_bwd_dq(*args)}
    # the yardstick: SDPA's backward (dq, dk and dv in one call)
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_(True)
                  for x in (q, k, v))
    live = live_mask(B, Tq, Tk, causal, seg, dev)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    if seg is None:
        out = sdpa(qt, kt, vt, is_causal=causal)
    else:
        out = sdpa(qt, kt, vt, attn_mask=live[:, None])
    dot = do.transpose(1, 2).contiguous()
    lib_ms = stream_ms(lambda: torch.autograd.grad(
        out, (qt, kt, vt), dot, retain_graph=True))
    pairs = int(live.sum()) * H
    name = "bwd B%d Tq%d Tk%d H%d D%d %s%s" % (
        B, Tq, Tk, H, D, "causal" if causal else "full",
        " seg" if segmented else "")
    # an independent reference: torch autograd of the dense attention
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    dense = torch.autograd.grad(tfa.flash_attention(
        *leaves, causal=causal, segment_ids=seg, impl="plain"), leaves, do)
    del leaves
    kernel_grads = (got["flash_bwd_dq"][0],) + got["flash_bwd_dkdv"]
    dense_errs = [close(a, b, BWD_TOL) for a, b in zip(kernel_grads, dense)]
    print("  %-14s %-34s dq/dk/dv vs torch autograd of dense attention:"
          " max abs err %.3g" % ("both", name,
                                 max(e for e, _ in dense_errs)))
    if not all(ok for _, ok in dense_errs):
        fail("backward kernels disagree with dense autograd: %s" % name)
    if probe:
        probe_comparison(tfa, args, got, want)
    rec = {}
    for kname in ("flash_bwd_dkdv", "flash_bwd_dq"):
        errs = [close(a, b, BWD_TOL) for a, b in zip(got[kname],
                                                     want[kname])]
        err = max(e for e, _ in errs)
        flops = BWD_FLOPS[kname] * D * pairs
        qd, kd = B * Tq * H * D, B * Tk * H * D
        if kname == "flash_bwd_dkdv":     # q, do, k, v, lse, D in; dk, dv out
            nbytes = 4.0 * (2 * qd + 4 * kd + 2 * B * H * Tq)
        else:                              # q, do, k, v, lse, D in; dq out
            nbytes = 4.0 * (3 * qd + 2 * kd + 2 * B * H * Tq)
        if seg is not None:
            nbytes += 4.0 * B * Tq
        # the bound: 3xTF32 on the tensor cores (what the kernels run);
        # beside it the same flops in fp32 on the CUDA cores
        tc_s = TF32_PASSES * flops / PEAK_TF32_FLOPS
        bound = max(tc_s, nbytes / PEAK_BYTES) * 1e3
        bound_fp32 = max(flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES) * 1e3
        bound_by = "bytes" if nbytes / PEAK_BYTES > tc_s else "operations"
        ms = timed(lambda kn=kname: tfa._bwd_cuda(kn, *args))
        plain_ms = timed(plain[kname])
        print("  %-14s %-34s err %.3g | device ms: kernel %.4f plain %.4f |"
              " per-call ms: kernel %.4f plain %.4f | sdpa bwd (dq, dk, dv)"
              " %.4f ms | bound %.2f us 3xTF32 (%s), %.2f us fp32 CUDA"
              " cores | %.1f GFLOP, %.1f MB"
              % (kname, name, err, ms[0], plain_ms[0], ms[1], plain_ms[1],
                 lib_ms, bound * 1e3, bound_by, bound_fp32 * 1e3,
                 flops / 1e9, nbytes / 1e6))
        if not all(ok for _, ok in errs):
            fail("%s disagrees with the plain version: %s" % (kname, name))
        rec[kname] = dict(err=err, ms=ms[0], plain_ms=plain_ms[0],
                          library_ms=lib_ms, bound_ms=bound,
                          bound_by=bound_by, bound_fp32_ms=bound_fp32)
    return rec


def check_flash_grad(tfa):
    """flash_attention on CUDA tensors that require grad returns a tensor
    with a grad_fn, and the gradients that reach q, k and v equal torch
    autograd of the plain version."""
    dev = torch.device("cuda", 0)
    g = torch.Generator(device="cpu").manual_seed(3)
    q, k, v, do = (torch.randn(2, 200, 4, 32, generator=g).to(dev)
                   for _ in range(4))
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    out = tfa.flash_attention(*leaves, causal=True)
    if out.grad_fn is None:
        fail("flash_attention on CUDA returned a tensor with no grad_fn")
    got = torch.autograd.grad(out, leaves, do)
    ref = [x.clone().requires_grad_(True) for x in (q, k, v)]
    want = torch.autograd.grad(
        tfa.flash_attention(*ref, causal=True, impl="plain"), ref, do)
    errs = [close(a, b, BWD_TOL) for a, b in zip(got, want)]
    print("flash_attention on CUDA: grad_fn %s; dq/dk/dv vs torch autograd"
          " of the plain version: max abs err %.3g"
          % (type(out.grad_fn).__name__, max(e for e, _ in errs)))
    if not all(ok for _, ok in errs):
        fail("flash_attention gradients disagree with the plain version")


def phase_bwd_kernels(tfa):
    """The training shapes: the forward kernel at the LM's B8 T1024
    causal, on a packed causal batch, on non-causal cross-attention and
    at D = 30 and D = 128, and against float64; then both backward
    kernels at the same shapes. Returns the forward's main-shape record
    (its error the largest of these cases), the backward kernels'
    main-shape records and the largest error of each backward kernel."""
    H, D = 12, 64
    print("forward kernel (3xTF32 tensor cores) vs plain (fp32, TF32 off,"
          " O and LSE, rtol = atol = %g):" % TOL["rtol"])
    T = GPT2_SMALL["max_len"]
    fwd = fwd_case(tfa, TRAIN_BATCH, T, T, H, D, True, False, seed=10,
                   time_splits=True)
    others = [fwd_case(tfa, 2, 256, 256, H, D, True, True, seed=7),
              fwd_case(tfa, 2, 128, 320, H, D, False, False, seed=13),
              fwd_case(tfa, 1, 100, 150, 3, 30, True, False, seed=15),
              fwd_case(tfa, 1, 160, 96, 2, 128, True, False, seed=16)]
    fwd["err"] = max([fwd["err"]] + [c["err"] for c in others])
    fwd_f64_case(tfa)
    print("backward kernels (3xTF32 tensor cores) vs plain (fp32, TF32 off,"
          " rtol = atol = %g):" % BWD_TOL["rtol"])
    main = bwd_case(tfa, TRAIN_BATCH, 1024, 1024, H, D, True, False,
                    seed=11, probe=True)
    seg = bwd_case(tfa, 2, 256, 256, H, D, True, True, seed=12)
    cross = bwd_case(tfa, 2, 128, 320, H, D, False, False, seed=13)
    # the other staging paths and causal alignments: D = 30 (4-byte
    # granules, padded columns) with Tq < Tk, D = 128 with Tq > Tk
    odd = bwd_case(tfa, 1, 100, 150, 3, 30, True, False, seed=15)
    wide = bwd_case(tfa, 1, 160, 96, 2, 128, True, False, seed=16)
    errs = {kn: max(c[kn]["err"] for c in (main, seg, cross, odd, wide))
            for kn in main}
    print("  both kernels at %s: %.4f ms, sdpa backward %.4f ms; bounds"
          " %.4f ms 3xTF32, %.4f ms fp32 CUDA cores"
          % ("B8 T1024 causal", sum(main[kn]["ms"] for kn in main),
             main["flash_bwd_dkdv"]["library_ms"],
             sum(main[kn]["bound_ms"] for kn in main),
             sum(main[kn]["bound_fp32_ms"] for kn in main)))
    f64_case(tfa)
    check_flash_grad(tfa)
    return fwd, main, errs


def phase_kernels(tfa):
    """The server's shapes: the forward at one prompt (B1) at every rung
    of the server's ladder and at a ragged T 300, each block shape timed;
    the decode kernel over the window of 8 at random lengths and with one
    live stream (one row at T, seven at 1). Returns the forward's T512
    record (its error the largest of the rungs), and the decode record
    at random lengths (its error the larger of the two)."""
    H, D = 12, 64
    print("forward kernel (3xTF32 tensor cores) at the server's prefill"
          " rungs vs plain (O and LSE, rtol = atol = %g):" % TOL["rtol"])
    fwd = {T: fwd_case(tfa, 1, T, T, H, D, True, False, seed=T,
                       time_splits=True) for T in (64, 128, 256, 300, 512)}
    print("decode kernel vs plain (rtol = atol = %g):" % TOL["rtol"])
    dec = decode_case(tfa, 8, 576, H, D, seed=9)
    one = decode_case(tfa, 8, 576, H, D, seed=19,
                      lens_np=[576] + [1] * 7)
    rec = dict(fwd[512], err=max(c["err"] for c in fwd.values()))
    return rec, dict(dec, err=max(dec["err"], one["err"]))


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
    if min(launches[k] for k in SERVER_KERNELS) < 1:
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


def gluon_lm(mx):
    """The training model, a user script of the port's Gluon: the pre-LN
    decoder of ToyDecoderLM.prefill composed from Embedding, LayerNorm,
    MeshMultiHeadAttention and Dense blocks."""
    nn = mx.gluon.nn

    class DecoderLayer(mx.gluon.HybridBlock):
        def __init__(self, units, heads, d_ff, impl, **kwargs):
            super().__init__(**kwargs)
            with self.name_scope():
                self.ln1 = nn.LayerNorm()
                self.attn = mx.gluon.contrib.nn.MeshMultiHeadAttention(
                    units, heads, causal=True, use_bias=False, impl=impl)
                self.ln2 = nn.LayerNorm()
                self.ffn1 = nn.Dense(d_ff, activation="relu", use_bias=False,
                                     flatten=False)
                self.ffn2 = nn.Dense(units, use_bias=False, flatten=False)
            self.relu_masks = None    # a list: keeps each pass's ReLU mask

        def hybrid_forward(self, F, x):
            h = x + self.attn(self.ln1(x))
            a = self.ffn1(self.ln2(h))
            if self.relu_masks is not None:
                self.relu_masks.append(a > 0)
            return h + self.ffn2(a)

    class DecoderLM(mx.gluon.HybridBlock):
        def __init__(self, vocab, units, heads, layers, d_ff, max_len,
                     impl="auto", **kwargs):
            super().__init__(**kwargs)
            with self.name_scope():
                self.embed = nn.Embedding(vocab, units)
                self.pos = nn.Embedding(max_len, units)
                self.layers = nn.HybridSequential()
                with self.layers.name_scope():
                    for _ in range(layers):
                        self.layers.add(DecoderLayer(units, heads, d_ff,
                                                     impl))
                self.ln_f = nn.LayerNorm()
                self.head = nn.Dense(vocab, use_bias=False, flatten=False)

        def hybrid_forward(self, F, tokens, positions):
            h = self.embed(tokens) + self.pos(positions)
            return self.head(self.ln_f(self.layers(h)))

    return DecoderLM


def shared_relu(mx):
    """A ReLU block that applies a given 0/1 mask instead of its input's
    sign, and counts the positions where the two disagree (``flips``)."""

    class SharedReLU(mx.gluon.nn.Activation):
        def __init__(self, mask, **kwargs):
            super().__init__("relu", **kwargs)
            self.mask, self.flips = mask, 0

        def hybrid_forward(self, F, x):
            self.flips = int(((x > 0) != self.mask).sum().asscalar())
            return x * self.mask

    return SharedReLU


def grad_ratios(src, twin):
    """max|diff| / max|grad| per parameter: ``src``'s gradients (by
    structural name) against ``twin``'s."""
    out = {}
    for name, p in twin._collect_params_with_prefix().items():
        gd, gk = p.grad()._data, src[name].grad()._data
        out[name] = float((gk - gd).abs().max()
                          / gd.abs().max().clamp_min(1e-30))
    return out


def print_groups(ratios):
    for group, keys in (("attention", ("attn.",)),
                        ("ffn1", ("ffn1.",)), ("ffn2", ("ffn2.",)),
                        ("other", ())):
        names = [n for n in ratios if any(k in n for k in keys)] if keys \
            else [n for n in ratios if "attn." not in n and "ffn" not in n]
        top = sorted(names, key=lambda n: -ratios[n])[:3]
        print("    %-9s worst: %s" % (group, ", ".join(
            "%s %.3g" % (n, ratios[n]) for n in top)))


def check_against_dense(mx, net, twin, ctx, step_loss):
    """One record/backward on the kernel route ``net`` and on ``twin``
    (dense attention, given ``net``'s weights), then again on the twin
    with the kernel route's ReLU masks; fails unless every gradient and
    per-sample loss agrees within its tolerance."""
    twin.initialize(mx.init.Xavier(), ctx=ctx)
    src = net._collect_params_with_prefix()
    for name, p in twin._collect_params_with_prefix().items():
        p.set_data(src[name].data())
    layers = [net.layers[i] for i in range(len(net.layers))]
    for layer in layers:
        layer.relu_masks = []
    loss_k = step_loss(net)
    masks = [layer.relu_masks[0] for layer in layers]
    for layer in layers:
        layer.relu_masks = None
    loss_d = step_loss(twin)
    ratios = grad_ratios(src, twin)
    tol = {n: GRAD_RTOL_RELU if n.endswith("ffn1.weight") else GRAD_RTOL
           for n in ratios}
    loss_err = float(np.abs(loss_k - loss_d).max())
    print("  gradients, kernels vs dense attention, max|diff| / max|grad|"
          " per parameter: worst %.3g, median %.3g (tolerance %g, ffn1"
          " weights %g); loss %.6f vs %.6f, max per-sample diff %.3g"
          " (tolerance %g)"
          % (max(ratios.values()), statistics.median(ratios.values()),
             GRAD_RTOL, GRAD_RTOL_RELU, float(loss_k.mean()),
             float(loss_d.mean()), loss_err, LOSS_ATOL))
    print_groups(ratios)
    SharedReLU = shared_relu(mx)
    twin_layers = [twin.layers[i] for i in range(len(twin.layers))]
    for layer, mask in zip(twin_layers, masks):
        layer.ffn1.act = SharedReLU(mask)
    loss_s = step_loss(twin)
    shared = grad_ratios(src, twin)
    flips = [layer.ffn1.act.flips for layer in twin_layers]
    shared_loss_err = float(np.abs(loss_k - loss_s).max())
    print("  the twin again with the kernel route's ReLU masks: %d of %d"
          " ReLU pre-activations flipped sign between the routes (per"
          " layer: %s); gradients worst %.3g, median %.3g (tolerance %g);"
          " max per-sample loss diff %.3g"
          % (sum(flips), len(flips) * masks[0].size, flips,
             max(shared.values()), statistics.median(shared.values()),
             GRAD_RTOL_SHARED, shared_loss_err))
    print_groups(shared)
    if any(ratios[n] > tol[n] for n in ratios) or loss_err > LOSS_ATOL:
        fail("training gradients or loss: kernels vs dense attention")
    if max(shared.values()) > GRAD_RTOL_SHARED \
            or shared_loss_err > LOSS_ATOL:
        fail("training gradients or loss: kernels vs dense attention with"
             " shared ReLU masks")


def phase_training(tfa, card, steps=20, prof_steps=3):
    """The second slice's main path: Gluon training of the LM at
    GPT-2-small width on gpu(0). (a) one record/backward against a twin
    with dense attention and the same weights, then again with the twin
    reusing the kernel route's ReLU masks; (b) `steps` Adam steps on one
    fixed batch, launch counts zeroed just before and read just after;
    (c) the step's time and device idle share. Returns the launches."""
    import mxnet_tpu_torch as mx
    cfg = dict(vocab=GPT2_SMALL["vocab"], layers=GPT2_SMALL["n_layers"],
               heads=GPT2_SMALL["n_heads"],
               units=GPT2_SMALL["n_heads"] * GPT2_SMALL["head_dim"],
               d_ff=GPT2_SMALL["d_ff"], max_len=GPT2_SMALL["max_len"])
    B, T = TRAIN_BATCH, GPT2_SMALL["max_len"]
    ctx = mx.gpu(0)
    seq = np.random.RandomState(0).randint(0, cfg["vocab"], size=(B, T + 1))
    tokens = mx.nd.array(seq[:, :T].astype(np.float32), ctx=ctx)
    labels = mx.nd.array(seq[:, 1:].astype(np.float32), ctx=ctx)
    positions = mx.nd.array(np.arange(T, dtype=np.float32), ctx=ctx)
    DecoderLM = gluon_lm(mx)
    t0 = time.perf_counter()
    mx.random.seed(0)
    net = DecoderLM(**cfg)
    net.initialize(mx.init.Xavier(), ctx=ctx)
    with mx.autograd.pause():          # deferred shapes, from a short input
        net(tokens[:1, :16], positions[:16])
    n_params = sum(p.data().size for p in net.collect_params().values())
    torch.cuda.synchronize()
    print("training: GPT-2-small-width Gluon LM, %.1fM parameters, batch"
          " %d x %d tokens, init %.1f s"
          % (n_params / 1e6, B, T, time.perf_counter() - t0))
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()

    def step_loss(m):
        with mx.autograd.record():
            loss = loss_fn(m(tokens, positions), labels)
        loss.backward()
        return loss.asnumpy()

    # (a) the kernel route against a dense-attention twin
    check_against_dense(mx, net, DecoderLM(impl="dense", **cfg), ctx,
                        step_loss)
    gc.collect()                          # a block and its scope: a cycle
    torch.cuda.empty_cache()

    # (b) Adam steps on one fixed batch: the main path
    trainer = mx.gluon.Trainer(net.collect_params(), "adam",
                               {"learning_rate": 1e-3})
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tfa.reset_launches()                  # the main path starts here
    curve, step_ms = [], []
    for _ in range(steps):
        t1 = time.perf_counter()
        loss = step_loss(net)
        trainer.step(B)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t1) * 1e3)
        curve.append(float(loss.mean()))
    launches = dict(tfa.launches)         # ... and ends here
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print("  Adam loss curve (%d steps, lr 1e-3): %s"
          % (steps, " ".join("%.4f" % x for x in curve)))
    print("  launches in %d steps: %s" % (steps, launches))
    if not all(np.isfinite(curve)) or not curve[-1] < curve[0]:
        fail("the training loss did not fall: %s" % curve)
    for kname in TRAIN_KERNELS:
        if launches[kname] != cfg["layers"] * steps:
            fail("%s launched %d times in %d steps, want %d per step"
                 % (kname, launches[kname], steps, cfg["layers"]))

    # (c) where a step's time goes
    ms = statistics.median(step_ms[1:])
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        for _ in range(prof_steps):
            step_loss(net)
            trainer.step(B)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t1) * 1e3 / prof_steps
    classes = {"attention fwd": ("fwd_kernel",),
               "attention bwd": ("dkdv_kernel", "dq_kernel"),
               "matmul": ("gemm", "cutlass", "sm90_", "ampere_"),
               "softmax/log_softmax": ("softmax",),
               "layer norm": ("layer_norm", "layernorm")}
    by_class, kernels = {}, []
    for e in prof.key_averages():
        us = e.self_device_time_total
        if us <= 0:
            continue
        kernels.append((us, e.key, e.count))
        name = e.key.lower()
        cls = next((c for c, keys in classes.items()
                    if any(k in name for k in keys)), "other")
        by_class[cls] = by_class.get(cls, 0.0) + us / 1e3 / prof_steps
    busy = sum(by_class.values())
    print("  train step (%s): %.1f ms per step (median of steps 2-%d),"
          " %.0f tokens/s; peak memory %.1f GB; profiled %d steps: wall"
          " %.1f ms, device busy %.1f ms, idle share %.3f"
          % (card, ms, steps, B * T / ms * 1e3, peak_gb, prof_steps, wall,
             busy, 1 - busy / wall if wall else float("nan")))
    for cls, cms in sorted(by_class.items(), key=lambda kv: -kv[1]):
        print("    %-20s %.2f ms/step" % (cls, cms))
    for us, key, count in sorted(kernels, reverse=True)[:8]:
        print("    top: %.2f ms/step in %d calls/step  %s"
              % (us / 1e3 / prof_steps, count // prof_steps, key[:70]))
    return launches


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
    return srv._pool


def q8_pool_cache(B, T, H, D, lens, seed):
    """A seeded fp32 K and V cache stored the way the int8 pool stores
    it: each row quantized page by page (``scatter_prefill_q8``, pages of
    16 slots, rows up to its length), then gathered raw (int8 pages, each
    page's scale repeated over its slots) and dequantized
    (``gather_pages_q8``). Returns (k8, v8, k_scale, v_scale, k_deq,
    v_deq)."""
    from mxnet_tpu_torch.serving import kvcache
    dev = torch.device("cuda", 0)
    M = T // PAGE
    g = torch.Generator(device="cpu").manual_seed(seed)
    table = torch.arange(1, B * M + 1, device=dev).reshape(B, M)
    out = []
    for _ in range(2):
        seq = torch.randn(B, T, H, D, generator=g).to(dev)
        pages = torch.zeros(1, B * M + 1, PAGE, H, D, dtype=torch.int8,
                            device=dev)
        scales = torch.zeros(1, B * M + 1, device=dev)
        for b in range(B):
            kvcache.scatter_prefill_q8(pages, scales, table[b], seq[b][None],
                                       int(lens[b]))
        out += [kvcache.gather_pages(pages, table)[0],
                torch.repeat_interleave(scales[:, table], PAGE,
                                        dim=-1)[0].contiguous(),
                kvcache.gather_pages_q8(pages, scales, table)[0]]
    k8, ks, kd, v8, vs, vd = out
    return k8, v8, ks, vs, kd, vd


def q8_hold(tfa, what, q, k8, v8, ks, vs, kd, vd, lens, seed):
    """The int8 kernel on one input: (i) against its plain version, (ii)
    against flash_decode.cu on the dequantized cache, (iii) with random
    bytes and NaN scales past each row's length, which must leave its
    output bit-identical. Returns (output, error vs plain, error vs the
    fp32 kernel)."""
    scale = q.shape[-1] ** -0.5
    got = tfa.flash_decode(q, k8, v8, lens, k_scale=ks, v_scale=vs)
    want = tfa.flash_decode(q, k8, v8, lens, k_scale=ks, v_scale=vs,
                            impl="plain")
    err, ok = close(got, want)
    fp32 = tfa._decode_cuda(q, kd, vd, lens, scale)
    err32, ok32 = close(got, fp32)
    same = torch.equal(got, fp32)
    B, T = ks.shape
    tail = torch.arange(T, device=q.device)[None, :] >= lens[:, None].long()
    g = torch.Generator(device="cpu").manual_seed(seed)
    gk, gv = k8.clone(), v8.clone()
    for t in (gk, gv):
        noise = torch.randint(-128, 128, t.shape, generator=g,
                              dtype=torch.int8).to(q.device)
        t[tail] = noise[tail]
    nan = float("nan")
    dirty = tfa.flash_decode(q, gk, gv, lens, k_scale=ks.masked_fill(tail, nan),
                             v_scale=vs.masked_fill(tail, nan))
    clean_tail = torch.equal(dirty, got)
    torch.cuda.synchronize()
    print("  %-34s vs plain err %.3g; vs flash_decode.cu on the dequantized"
          " cache err %.3g, bit-identical %s; garbage tail (%d positions,"
          " NaN scales) leaves the output bit-identical: %s"
          % (what, err, err32, same, int(tail.sum()), clean_tail))
    if not ok:
        fail("flash_decode_q8 disagrees with the plain version: %s" % what)
    if not ok32:
        fail("flash_decode_q8 disagrees with flash_decode.cu on the"
             " dequantized cache: %s" % what)
    if not clean_tail:
        fail("flash_decode_q8 read past a row's length: %s" % what)
    return got, err, err32


def phase_q8_decode(tfa):
    """The int8 kernel at decode_case's shape on a pool-built cache, and
    at the JAX test's shape on random int8 and scales; times at the
    first. Returns the record of the first and the largest error vs the
    plain version."""
    dev = torch.device("cuda", 0)
    B, T, H, D = 8, 576, 12, 64
    print("int8 decode kernel (flash_decode_q8.cu) vs plain and vs"
          " flash_decode.cu (rtol = atol = %g):" % TOL["rtol"])
    lens_np = np.random.RandomState(9).randint(1, T + 1, size=B)
    lens_np[0], lens_np[-1] = 1, T                # decode_case's lengths
    lens = torch.from_numpy(lens_np.astype(np.int32)).to(dev)
    g = torch.Generator(device="cpu").manual_seed(21)
    q = torch.randn(B, 1, H, D, generator=g).to(dev)
    k8, v8, ks, vs, kd, vd = q8_pool_cache(B, T, H, D, lens_np, seed=22)
    _, err, _ = q8_hold(tfa, "B8 T576 H12 D64 pool pages", q, k8, v8, ks,
                        vs, kd, vd, lens, seed=23)
    # the JAX test's inputs (tests/test_kv_int8.py): B2 T128 H2 D8 (int8
    # rows staged 4 bytes at a time); and D7 (one byte at a time)
    err_small = 0.0
    for (sB, sT, sH, sD), slens, what in (
            ((2, 128, 2, 8), [37, 128], "B2 T128 H2 D8 (JAX test inputs)"),
            ((3, 100, 3, 7), [1, 50, 100], "B3 T100 H3 D7")):
        rs = np.random.RandomState(5)
        sq = torch.from_numpy(rs.randn(sB, 1, sH, sD).astype(np.float32))
        sk, sv = (torch.from_numpy(rs.randint(-127, 128, size=(
            sB, sT, sH, sD)).astype(np.int8)) for _ in range(2))
        sks, svs = (torch.from_numpy(rs.uniform(0.005, 0.02, size=(
            sB, sT)).astype(np.float32)) for _ in range(2))
        sq, sk, sv, sks, svs = (t.to(dev) for t in (sq, sk, sv, sks, svs))
        slens = torch.tensor(slens, dtype=torch.int32, device=dev)
        sdeq = [t.float() * sc[:, :, None, None]
                for t, sc in ((sk, sks), (sv, svs))]
        _, e, _ = q8_hold(tfa, what, sq, sk, sv, sks, svs, sdeq[0], sdeq[1],
                          slens, seed=24)
        err_small = max(err_small, e)
    live = int(lens_np.sum())
    nbytes = 2.0 * live * H * D + 2 * 4.0 * live + 2 * 4.0 * B * H * D \
        + 4.0 * B                 # int8 K, V; their scales; q, o; lengths
    flops = 6.0 * D * live * H    # dequantizing multiplies, q.k, p.v
    bound = max(flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES) * 1e3
    bound_by = "bytes" if nbytes / PEAK_BYTES > flops / PEAK_FP32_FLOPS \
        else "operations"
    ms = timed(lambda: tfa.flash_decode(q, k8, v8, lens, k_scale=ks,
                                        v_scale=vs))
    cold = cold_ms(lambda: tfa.flash_decode(q, k8, v8, lens, k_scale=ks,
                                            v_scale=vs))
    plain_ms = timed(lambda: tfa.flash_decode(q, k8, v8, lens, k_scale=ks,
                                              v_scale=vs, impl="plain"))
    fp32_ms = timed(lambda: tfa._decode_cuda(q, kd, vd, lens, D ** -0.5))
    fp32_cold = cold_ms(lambda: tfa._decode_cuda(q, kd, vd, lens,
                                                 D ** -0.5))
    qt = q.transpose(1, 2).contiguous()
    mask = (torch.arange(T, device=dev)[None, :] < lens[:, None])
    mask = mask[:, None, None, :]

    def deq_sdpa():                # a yardstick only: no single call
        kf = (k8.float() * ks[:, :, None, None]).transpose(1, 2)
        vf = (v8.float() * vs[:, :, None, None]).transpose(1, 2)
        return torch.nn.functional.scaled_dot_product_attention(
            qt, kf, vf, attn_mask=mask)
    yard_ms = timed(deq_sdpa)
    fp32_bytes = 4.0 * H * (2 * live * D + 2 * B * D) + 4.0 * B
    splits = decode_splits("flash_decode_q8", B, H, T, D)
    print("  %-34s device ms: kernel %.4f plain %.4f | flash_decode.cu on"
          " the dequantized cache %.4f (bound %.2f us) | dequantize + sdpa"
          " %.4f (yardstick) | per-call ms: kernel %.4f plain %.4f | bound"
          " %.2f us (%s, %.3f MB)"
          % ("B8 T576 H12 D64 (%d live keys)" % live, ms[0], plain_ms[0],
             fp32_ms[0], fp32_bytes / PEAK_BYTES * 1e6, yard_ms[0], ms[1],
             plain_ms[1], bound * 1e3, bound_by, nbytes / 1e6))
    print("  %-34s splits %d (%d blocks); one call, device ms: cold L2 %.4f,"
          " warm %.4f | flash_decode.cu on the dequantized cache: cold L2"
          " %.4f, warm %.4f"
          % ("", splits, B * H * splits, cold[0], cold[1], fp32_cold[0],
             fp32_cold[1]))
    return dict(err=max(err, err_small), ms=ms[0], plain_ms=plain_ms[0],
                library_ms=None, bound_ms=bound, bound_by=bound_by,
                cold_ms=cold[0], splits=splits)


def phase_q8_pool(tfa, model, params, pool):
    """The int8 kernel's main path: on phase 6's int8 pool, a server
    admits 4 requests and runs a few decode steps; then one decode
    step's calls, ``flash_decode(k_scale=, v_scale=)`` for each layer
    over the live requests' raw pages and scales, with launch counts
    zeroed just before and read just after; then each layer held as in
    phase 7. Returns the launches and the largest error vs plain."""
    from mxnet_tpu_torch.serving import DecodeServer, kvcache
    dev = torch.device("cuda", 0)
    srv = DecodeServer(model, params, pool=pool, seq_ladder=[64, 128],
                       max_new_tokens=32, window=8, start=False)
    rs = np.random.RandomState(4)
    reqs = [srv.submit(rs.randint(0, model.vocab, size=30 + 25 * i),
                       max_new_tokens=32) for i in range(4)]
    try:
        while srv.stats()["active"] < len(reqs):
            srv._tick()                   # prefills (one per tick)
        for _ in range(5):
            srv._tick()
        torch.cuda.synchronize()
        rows = [r for r in reqs if r.state == "active"]
        table = torch.zeros(len(rows), srv._max_pages, dtype=torch.long)
        lens = []
        for i, r in enumerate(rows):
            table[i, :len(r.pages)] = torch.tensor(r.pages)
            lens.append(len(r.prompt) + len(r.generated) - 1)
        table = table.to(dev)
        lens = torch.tensor(lens, dtype=torch.int32, device=dev)
        k8, v8 = (kvcache.gather_pages(t, table) for t in (pool.k, pool.v))
        ks, vs = (torch.repeat_interleave(s[:, table], PAGE, dim=-1)
                  .contiguous() for s in (pool.k_scale, pool.v_scale))
        kd, vd = (kvcache.gather_pages_q8(t, s, table) for t, s in
                  ((pool.k, pool.k_scale), (pool.v, pool.v_scale)))
    finally:
        for r in reqs:
            r.cancel()
        srv.stop(drain=False)
    L, n, T, H, D = k8.shape
    g = torch.Generator(device="cpu").manual_seed(25)
    q = torch.randn(L, n, 1, H, D, generator=g).to(dev)
    tfa.reset_launches()                  # the main path starts here
    outs = [tfa.flash_decode(q[i], k8[i], v8[i], lens, k_scale=ks[i],
                             v_scale=vs[i]) for i in range(L)]
    torch.cuda.synchronize()
    launches = dict(tfa.launches)         # ... and ends here
    print("int8 pool of the server: %d live requests, lengths %s, %d layers"
          " x %d cached positions; launches %s"
          % (n, lens.tolist(), L, T, launches))
    if launches["flash_decode_q8"] != L:
        fail("flash_decode_q8 launched %d times in %d layers"
             % (launches["flash_decode_q8"], L))
    if launches["flash_decode"]:
        fail("an int8 call went through the fp32 decode kernel")
    err = 0.0
    for i in (0, L - 1):
        got, e, _ = q8_hold(tfa, "layer %d of the server's pool" % i, q[i],
                            k8[i], v8[i], ks[i], vs[i], kd[i], vd[i], lens,
                            seed=26 + i)
        if not torch.equal(got, outs[i]):
            fail("flash_decode_q8 is not deterministic on layer %d" % i)
        err = max(err, e)
    return launches, err


def phase_rtc(card):
    """The rtc path: mx.rtc compiles RTC_KERNELS and launches each on
    gpu(0) arrays (launch counts zeroed just before, read just after),
    held to torch; then write-back, shared memory above 48 KB, a broken
    source, a CPU context, and the times. Returns the rtc record and the
    launches."""
    import mxnet_tpu_torch as mx
    dev = torch.device("cuda", 0)
    ctx = mx.gpu(0)
    g = torch.Generator(device="cpu").manual_seed(31)
    n = 1 << 26
    x = mx.nd.NDArray(torch.randn(n, generator=g).to(dev))
    y = mx.nd.NDArray(torch.randn(n, generator=g).to(dev))
    rows, cols = 4096, 1024
    xs = mx.nd.NDArray(torch.randn(rows, cols, generator=g).to(dev))
    outs = mx.nd.zeros((rows, cols), ctx=ctx)
    xr = mx.nd.NDArray(torch.rand(4096, 4096, generator=g).to(dev))
    sums = mx.nd.zeros((4096,), ctx=ctx)
    alpha = 0.5
    y0 = y._data.clone()
    y_ptr = y._data.data_ptr()

    mx.rtc.reset_launches()               # the rtc path starts here
    mod = mx.rtc.CudaModule(RTC_KERNELS)
    axpy = mod.get_kernel("axpy", "float alpha, const float *x, float *y")
    scale_rows = mod.get_kernel("scale_rows", "const float *x, float *out")
    row_sum = mod.get_kernel("row_sum", "const float *x, float *out, int n")
    axpy.launch((alpha, x, y), ctx, (n // 256, 1, 1), (256, 1, 1))
    scale_rows.launch((xs, outs), ctx, (rows, 1, 1), (cols, 1, 1))
    row_sum.launch((xr, sums, 4096), ctx, (4096, 1, 1), (256, 1, 1),
                   shared_mem=256 * 4)
    torch.cuda.synchronize()
    launches = dict(mx.rtc.launches)      # ... and ends here
    cold = (mod.compile_seconds, mod.from_cache)
    errs = {}
    for name, got, want, tol in (
            ("axpy", y._data, torch.add(y0, x._data, alpha=alpha), RTC_TOL),
            ("scale_rows", outs._data, xs._data * torch.arange(
                1, rows + 1, device=dev, dtype=torch.float32)[:, None],
             RTC_TOL),
            ("row_sum", sums._data, xr._data.sum(dim=1), ROWSUM_TOL)):
        errs[name], ok = close(got, want, tol)
        if not ok:
            fail("rtc kernel %s disagrees with torch (err %g)"
                 % (name, errs[name]))
    if y._data.data_ptr() != y_ptr:
        fail("rtc: a contiguous float32 in-out array was not written in"
             " place")
    print("rtc: 3 kernels compiled by NVRTC in %.3f s (from the disk cache:"
          " %s), launched on %s: max abs err vs torch axpy %.3g, scale_rows"
          " %.3g, row_sum %.3g; launches %s"
          % (cold[0], cold[1], ctx, errs["axpy"], errs["scale_rows"],
             errs["row_sum"], launches))
    if launches["rtc"] != 3:
        fail("rtc launched %d kernels, want 3" % launches["rtc"])

    # a second module of the same source loads the cubin from the disk
    mod2 = mx.rtc.CudaModule(RTC_KERNELS)
    ax2 = mod2.get_kernel("axpy", "float alpha, const float *x, float *y")
    small = 1 << 12
    xh = mx.nd.NDArray(torch.randn(small, generator=g).to(dev).half())
    y64 = mx.nd.NDArray(torch.randn(small, generator=g,
                                    dtype=torch.float64).to(dev))
    y64_0 = y64._data.clone()
    ax2.launch((2.0, xh, y64), ctx, (small // 256, 1, 1), (256, 1, 1))
    want = (y64_0.float() + 2.0 * xh._data.float()).double()
    wb_err, wb_ok = close(y64._data, want, RTC_TOL)
    if not (mod2.from_cache and wb_ok and y64._data.dtype == torch.float64):
        fail("rtc: cache load %s, float16 input / float64 in-out write-back"
             " err %g (dtype %s)" % (mod2.from_cache, wb_err,
                                     y64._data.dtype))
    # a non-contiguous in-out array, and more than 48 KB of shared memory
    out_t = mx.nd.NDArray(torch.zeros(cols, 256, device=dev).t())
    scale_rows.launch((xs[:256], out_t), ctx, (256, 1, 1), (cols, 1, 1))
    part = mx.nd.zeros((256,), ctx=ctx)
    row_sum.launch((xr[:256], part, 4096), ctx, (256, 1, 1), (256, 1, 1),
                   shared_mem=64 * 1024)
    nc_err, nc_ok = close(out_t._data, outs._data[:256], RTC_TOL)
    sm_err, sm_ok = close(part._data, sums._data[:256], ROWSUM_TOL)
    torch.cuda.synchronize()
    print("  from the disk cache: %.3f s; float16 input + float64 in-out"
          " array written back (err %.3g, dtype %s); non-contiguous in-out"
          " (err %.3g); row_sum with 64 KB of shared memory (err %.3g)"
          % (mod2.compile_seconds, wb_err, str(y64._data.dtype), nc_err,
             sm_err))
    if not (nc_ok and sm_ok):
        fail("rtc: non-contiguous write-back or large shared memory")

    # errors: a broken source carries the compiler's log; a CPU context
    broken = mx.rtc.CudaModule(
        'extern "C" __global__ void broken(float *x) '
        '{ x[0] = undefined_name; }')
    try:
        broken.get_kernel("broken", "float *x").launch(
            (part,), ctx, (1, 1, 1), (1, 1, 1))
        fail("rtc: a broken source compiled")
    except mx.MXNetError as exc:
        if "undefined_name" not in str(exc):
            fail("rtc: the compile error lacks the compiler's log: %s" % exc)
        print("  broken source raises MXNetError with the log: %s"
              % str(exc).strip().splitlines()[-1][:100])
    try:
        axpy.launch((alpha, x, y), mx.cpu(), (1, 1, 1), (1, 1, 1))
        fail("rtc: a launch on mx.cpu() did not raise")
    except mx.MXNetError as exc:
        print("  mx.cpu() launch raises MXNetError: %s" % exc)

    # times: host cost of a launch, axpy on the card
    xs_small = mx.nd.NDArray(torch.randn(1024, device=dev))
    ys_small = mx.nd.NDArray(torch.randn(1024, device=dev))
    for _ in range(10):
        axpy.launch((alpha, xs_small, ys_small), ctx, (4, 1, 1), (256, 1, 1))
    torch.cuda.synchronize()
    reps = 2000
    t0 = time.perf_counter()
    for _ in range(reps):
        axpy.launch((alpha, xs_small, ys_small), ctx, (4, 1, 1), (256, 1, 1))
    host_us = (time.perf_counter() - t0) / reps * 1e6
    torch.cuda.synchronize()
    ms = stream_ms(lambda: axpy.launch((alpha, x, y), ctx, (n // 256, 1, 1),
                                       (256, 1, 1)), iters=20)
    plain_ms = stream_ms(lambda: y._data + alpha * x._data, iters=20)
    lib_ms = stream_ms(lambda: torch.add(y._data, x._data, alpha=alpha),
                       iters=20)
    nbytes = 3 * 4.0 * n
    flops = 2.0 * n
    bound = max(nbytes / PEAK_BYTES, flops / PEAK_FP32_FLOPS) * 1e3
    print("  host %.1f us per launch (%d launches of a 1024-float axpy);"
          " axpy 2^26 floats, device ms per call (20 back to back): kernel"
          " %.4f, y + a * x %.4f, torch.add %.4f | bound %.4f ms (bytes)"
          " (%s)" % (host_us, reps, ms, plain_ms, lib_ms, bound, card))
    rec = dict(err=errs["axpy"], ms=ms, plain_ms=plain_ms,
               library_ms=lib_ms, bound_ms=bound, bound_by="bytes")
    return rec, launches


def kernel_row(name, source, replaces, path, shape, launches, rec, err):
    """One entry of the ``{"kernels": [...]}`` line; the decode kernels'
    also carry their cold-L2 time of one call and the host's splits."""
    row = dict(name=name, route="cuda", source=source, replaces=replaces,
               path=path, shape=shape, launches=launches[name],
               max_abs_err=err, ms=rec["ms"], plain_ms=rec["plain_ms"],
               bound_ms=rec["bound_ms"], bound_by=rec["bound_by"],
               library_ms=rec["library_ms"], ok=True)
    row.update((key, rec[key]) for key in ("cold_ms", "splits")
               if key in rec)
    return row


def main():
    t_start = time.perf_counter()
    card = phase_device()
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import importlib
    from mxnet_tpu_torch.serving import ToyDecoderLM
    tfa = importlib.import_module(
        "mxnet_tpu_torch.parallel.flash_attention")
    phase_build()
    print("kernels vs plain (fp32, TF32 off; device ms = GPU time per call"
          " from CUDA-graph replays, per-call ms = median CUDA-event time of"
          " one eager call; %s):" % card)
    fwd, dec = phase_kernels(tfa)
    train_fwd, bwd, bwd_errs = phase_bwd_kernels(tfa)
    t0 = time.perf_counter()
    model_k = ToyDecoderLM(**GPT2_SMALL)
    model_p = ToyDecoderLM(impl="plain", **GPT2_SMALL)
    params = model_k.init_params(seed=0, device="cuda")
    print("model: GPT-2-small width, %.1fM parameters, init %.1f s"
          % (sum(p.numel() for p in params.values()) / 1e6,
             time.perf_counter() - t0))
    phase_model(model_k, model_p, params)
    launches, _st = phase_server(model_k, params, tfa)
    pool8 = phase_server_int8(model_k, params)
    q8 = phase_q8_decode(tfa)
    q8_launches, q8_pool_err = phase_q8_pool(tfa, model_k, params, pool8)
    del pool8
    rtc, rtc_launches = phase_rtc(card)
    phase_step_profile(model_k, params)
    del model_k, model_p, params
    torch.cuda.empty_cache()
    train_launches = phase_training(tfa, card)
    # one row per kernel and main path: launches from that path's run,
    # times at the shape that path gives the kernel
    train_shape = "B%d T%d H12 D64 causal" % (TRAIN_BATCH,
                                              GPT2_SMALL["max_len"])
    kernels = [
        kernel_row("flash_fwd", FWD_SRC, FWD_TPU, "server",
                   "B1 T512 H12 D64 causal", launches, fwd, fwd["err"]),
        kernel_row("flash_decode", DEC_SRC, DEC_TPU, "server",
                   "B8 T576 H12 D64", launches, dec, dec["err"]),
        kernel_row("flash_fwd", FWD_SRC, FWD_TPU, "training", train_shape,
                   train_launches, train_fwd, train_fwd["err"]),
    ] + [kernel_row(kname, BWD_SRC[kname], BWD_TPU[kname], "training",
                    train_shape, train_launches, bwd[kname],
                    bwd_errs[kname])
         for kname in ("flash_bwd_dkdv", "flash_bwd_dq")] + [
        kernel_row("flash_decode_q8", Q8_SRC, Q8_TPU, "int8 decode",
                   "B8 T576 H12 D64 int8", q8_launches, q8,
                   max(q8["err"], q8_pool_err)),
        kernel_row("rtc", RTC_SRC, RTC_TPU, "rtc", "axpy 2^26 float32",
                   rtc_launches, rtc, rtc["err"]),
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
