"""On-card A/B of the decode kernels' design choices.

    python3 scratch/decode_variants.py [--parent DIR]

Needs one NVIDIA Hopper card and nvcc, and exits non-zero anywhere else.
It builds ``flash_decode.cu`` and ``flash_decode_q8.cu`` once per variant
with chip_bwd_variants.py's helpers (a copy of
``mxnet_tpu_torch/parallel/csrc`` with the variant's text edits, each of
which must match exactly once; all nvcc runs at once, under
``mxnet_tpu_torch/_build/decode_variants/``) and runs every variant in one
process on the same inputs, at B8 T576 H12 D64 (the server's window) at
chip_smoke.py's random lengths (2583 live keys) and with one live stream
(576, 1, ..., 1), at B1 T576, and at B8 T576 with every length 1 (what
a call costs with next to no bytes to move): device ms per call (20
calls in a CUDA graph, median of 5 replays), one call's device ms with
a cold L2 (chip_smoke.cold_ms), and the max abs error against the plain
version;
the shipped sources are timed first and again last, and ptxas's
registers and spill stores of the D = 64 kernels are printed.

The variants undo one choice each: a ring of three stages instead of
two; 2 or 8 keys a lane group takes from a stage instead of 4 (stages of
16 or 64 keys at D = 64); 4-byte copies of the fp32 cache instead of 16;
4-byte granules of the int8 cache instead of 16; and one trial that
adds a choice: int8 converted to fp32 by a byte permute and a
subtraction instead of the conversion instruction. Then, on the shipped
build, the number of splits (the size of a row's cluster) forced through
the C entry points: one a row (the grid of the kernels before the
split), and 2 to 8.

With ``--parent DIR`` (DIR holding ``mxnet_tpu_torch/parallel/csrc`` of
a commit before the split, whose decode entry points take no split
count: ``git archive <commit> mxnet_tpu_torch/parallel/csrc
| tar -x -C DIR``), it also builds that commit's two decode kernels and
times them against the shipped ones at the same shapes, in the order
parent, shipped, shipped, parent.
"""
import ctypes
import importlib
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_bwd_variants  # noqa: E402
import chip_smoke  # noqa: E402

OUT = os.path.join(ROOT, "mxnet_tpu_torch", "_build", "decode_variants")
DEC, Q8, COMMON = "flash_decode.cu", "flash_decode_q8.cu", "flash_common.cuh"
KERNELS = ("flash_decode", "flash_decode_q8")
# variant -> [(file, shipped text, variant text)]
VARIANTS = {
    "shipped": [],
    "stages-3": [(COMMON, "constexpr int kStages = 2;",
                  "constexpr int kStages = 3;")],
    "batch-2": [(COMMON, "constexpr int kBatch = 4;",
                 "constexpr int kBatch = 2;")],
    "batch-8": [(COMMON, "constexpr int kBatch = 4;",
                 "constexpr int kBatch = 8;")],
    "fp32-4-byte": [(DEC, "const int vec = D % 4 == 0 &&",
                     "const int vec = 0 &&")],
    # each int8 value to fp32 by a byte permute into the mantissa of
    # 2^23 + 128 + value and one subtraction (exact, as the conversion is),
    # in place of the conversion instruction
    "prmt-convert": [(Q8, """  return make_float4(
      (float)(signed char)(w) * s, (float)(signed char)(w >> 8) * s,
      (float)(signed char)(w >> 16) * s, (float)(signed char)(w >> 24) * s);""",
                      """  const unsigned u = (unsigned)w ^ 0x80808080u;
  float f[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    f[i] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650 + i)) -
           8388736.f;
  return make_float4(f[0] * s, f[1] * s, f[2] * s, f[3] * s);""")],
    "int8-4-byte": [(Q8, "const int gran = D % 16 == 0 &&",
                     "const int gran = false &&")],
}
# ptxas's D = 64 instance of each library's split kernel (L = 16)
INSTANCES = (("", "_kernelILi16E"),)


def declare(lib, kname):
    from mxnet_tpu_torch.parallel import _build
    return _build._declare(ctypes.CDLL(lib), kname)


def call(fn, q, k, v, lens, scale, S, ks=None, vs=None):
    """One call of a variant's decode kernel at S splits, 0 for the
    host's choice (the int8 kernel when ``ks`` is given), as the port's
    wrapper makes it."""
    B, _, H, D = q.shape
    T = k.shape[1]
    o = torch.empty_like(q)
    scales = () if ks is None else (ks.data_ptr(), vs.data_ptr())
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), *scales,
            lens.data_ptr(), o.data_ptr(), B, H, T, D, scale, S,
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        chip_smoke.fail("decode launch failed with cudaError %d" % rc)
    return o


def inputs(B, T, lens, seed, H=12, D=64):
    """fp32 and pool-quantized int8 inputs at one shape (chip_smoke's
    q8_pool_cache), with the plain versions' outputs."""
    tfa = importlib.import_module("mxnet_tpu_torch.parallel.flash_attention")
    dev = torch.device("cuda", 0)
    g = torch.Generator(device="cpu").manual_seed(seed)
    q = torch.randn(B, 1, H, D, generator=g).to(dev)
    k, v = (torch.randn(B, T, H, D, generator=g).to(dev) for _ in range(2))
    k8, v8, ks, vs, _, _ = chip_smoke.q8_pool_cache(B, T, H, D, lens, seed)
    lens = torch.tensor(lens, dtype=torch.int32, device=dev)
    want = tfa.flash_decode(q, k, v, lens, impl="plain")
    want8 = tfa.flash_decode(q, k8, v8, lens, k_scale=ks, v_scale=vs,
                             impl="plain")
    return dict(f32=(q, k, v, lens), q8=(q, k8, v8, lens, ks, vs),
                want=want, want8=want8)


def measure(fns, x, S):
    """'ms / cold ms (err)' of both kernels of one variant at S splits."""
    cells = []
    for kname, args, want in (("flash_decode", x["f32"], x["want"]),
                              ("flash_decode_q8", x["q8"], x["want8"])):
        q, k, v, lens = args[:4]
        extra = args[4:]

        def run(fn=fns[kname]):
            return call(fn, q, k, v, lens, 0.125, S, *extra)
        err = float((run() - want).abs().max())
        ms = chip_smoke.device_ms(run)
        cold = chip_smoke.cold_ms(run)[0]
        cells.append("%s %.4f / %.4f (%.2g)"
                     % ("fp32" if kname == "flash_decode" else "int8", ms,
                        cold, err))
    return " | ".join(cells)


def parent_kernels(src):
    """The decode entry points of an earlier commit's sources under
    ``src``, built with the port's flags: (fp32, int8), each called as
    ``fn(q, k, v[, ks, vs], lens, o, B, H, T, D, scale, stream)``."""
    from mxnet_tpu_torch.parallel import _build
    csrc = os.path.join(src, "mxnet_tpu_torch", "parallel", "csrc")
    out = os.path.join(OUT, "parent")
    os.makedirs(out, exist_ok=True)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fns = []
    for kname, sym, argtypes in (
            ("flash_decode", "mxt_flash_decode", [p] * 5 + [i] * 4 + [f, p]),
            ("flash_decode_q8", "mxt_flash_decode_q8",
             [p] * 7 + [i] * 4 + [f, p])):
        lib = os.path.join(out, "lib%s.so" % kname)
        subprocess.run([_build._nvcc()] + _build._FLAGS + [
            "-o", lib, os.path.join(csrc, _build.SOURCES[kname])],
            check=True, capture_output=True)
        fn = getattr(ctypes.CDLL(lib), sym)
        fn.argtypes, fn.restype = argtypes, i
        fns.append(fn)
    return fns


def time_parent(parent, fns, x):
    """'ms / cold ms (err)' of both kernels, parent or shipped (``fns``)."""
    cells = []
    for kname, args, want in (("flash_decode", x["f32"], x["want"]),
                              ("flash_decode_q8", x["q8"], x["want8"])):
        q, k, v, lens = args[:4]
        extra = args[4:]
        B, _, H, D = q.shape
        if parent is None:
            def run(fn=fns[kname]):
                return call(fn, q, k, v, lens, 0.125, 0, *extra)
        else:
            def run(fn=parent[kname != "flash_decode"]):
                o = torch.empty_like(q)
                rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        *[t.data_ptr() for t in extra], lens.data_ptr(),
                        o.data_ptr(), B, H, k.shape[1], D, 0.125,
                        torch.cuda.current_stream().cuda_stream)
                if rc != 0:
                    chip_smoke.fail("parent launch failed: %d" % rc)
                return o
        err = float((run() - want).abs().max())
        cells.append("%s %.4f / %.4f (%.2g)" % (
            "fp32" if kname == "flash_decode" else "int8",
            chip_smoke.device_ms(run), chip_smoke.cold_ms(run)[0], err))
    return " | ".join(cells)


def main():
    card = chip_smoke.phase_device()
    parent = None
    if "--parent" in sys.argv:
        parent = parent_kernels(sys.argv[sys.argv.index("--parent") + 1])
    from mxnet_tpu_torch.parallel import _build
    jobs = {n: chip_bwd_variants.start_builds(_build, n, VARIANTS, KERNELS,
                                              OUT)
            for n in VARIANTS}
    fns = {n: chip_bwd_variants.finish_builds(_build, n, j, INSTANCES,
                                              declare)
           for n, j in jobs.items()}
    T = 576
    rand = np.random.RandomState(9).randint(1, T + 1, size=8)
    rand[0], rand[-1] = 1, T
    shapes = {"B8 random": inputs(8, T, rand, 9),
              "B8 one stream": inputs(8, T, [T] + [1] * 7, 19),
              "B1": inputs(1, T, [T], 29),
              "B8 floor": inputs(8, T, [1] * 8, 39)}
    host = {key: fns["shipped"]["flash_decode"].splits(
        x["f32"][0].shape[0], 12, T, 64) for key, x in shapes.items()}
    print("device ms per call / one call cold L2 (max abs err vs plain),"
          " H12 D64 T576; host's splits %s (%s):" % (host, card))
    for name in list(fns) + ["shipped"]:
        for key, x in shapes.items():
            print("  %-12s %-14s S=%-3d %s"
                  % (name, key, host[key], measure(fns[name], x, host[key])))
    if parent is not None:
        print("parent (one block a row) vs shipped, ms / one call cold L2"
              " (err):")
        for key, x in shapes.items():
            for name in ("parent", "shipped", "shipped", "parent"):
                print("  %-8s %-14s %s" % (name, key, time_parent(
                    parent if name == "parent" else None,
                    fns["shipped"], x)))
    print("forced splits on the shipped build:")
    for key, x in shapes.items():
        for S in sorted({1, 2, 3, 4, 6, 8} - {host[key]}):
            print("  %-14s S=%-3d %s" % (key, S,
                                         measure(fns["shipped"], x, S)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
