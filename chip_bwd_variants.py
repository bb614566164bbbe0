"""On-card A/B of the backward attention kernels' design choices.

    python3 chip_bwd_variants.py

Needs one NVIDIA Hopper card and nvcc, and exits non-zero anywhere else.
It copies ``mxnet_tpu_torch/parallel/csrc`` once per variant, applies
that variant's text edits (each must match exactly once, or the script
fails), builds ``flash_bwd_dkdv.cu`` and ``flash_bwd_dq.cu`` from each
copy (all nvcc runs at once, under ``mxnet_tpu_torch/_build/variants/``)
and runs every variant in one process on the same inputs:

- device ms per call of each kernel at the training shape, B8 T1024 H12
  D64 causal (20 calls in a CUDA graph, median of 5 replays), the
  shipped sources timed first and again last;
- max abs error against the plain fp32 versions at that shape, and
  against torch autograd of dense attention in float64 at B2 T256;
- whether the outputs are bit-identical to the shipped kernels';
- ptxas registers and spill stores of each D = 64 kernel.

The variants undo one choice each: rounding with ``cvt.rna.tf32.f32``
instead of the integer add and mask (the same rounding, so bit-identical
outputs); one tensor-core sum over the whole sequence instead of
per-tile sums added in fp32; walked tiles of 64 rows instead of 32; dQ
at two blocks an SM instead of three; and a single TF32 pass (which
fails the kernels' tolerance; it shows the share of the three
tensor-core products in the time).
"""
import ctypes
import importlib
import os
import re
import shutil
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402

CSRC = os.path.join(ROOT, "mxnet_tpu_torch", "parallel", "csrc")
OUT = os.path.join(ROOT, "mxnet_tpu_torch", "_build", "variants")
KERNELS = ("flash_bwd_dkdv", "flash_bwd_dq")
COMMON = "flash_common.cuh"
# variant -> [(file, shipped text, variant text)]
VARIANTS = {
    "shipped": [],
    "cvt.rna": [(COMMON,
                 "return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;",
                 'uint32_t r;\n  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) '
                 ': "f"(x));\n  return r;')],
    "one-sum": [("flash_bwd_dkdv.cu", "mma3(pv[n]", "mma3(accv[n]"),
                ("flash_bwd_dkdv.cu", "mma3(pk[n]", "mma3(acck[n]"),
                ("flash_bwd_dkdv.cu", "tile_sum(accv, pv);", ""),
                ("flash_bwd_dkdv.cu", "tile_sum(acck, pk);", ""),
                ("flash_bwd_dq.cu", "mma3(pq[n]", "mma3(acc[n]"),
                ("flash_bwd_dq.cu", "tile_sum(acc, pq);", "")],
    "walk-64": [(COMMON, "constexpr int kWalk = 32;",
                 "constexpr int kWalk = 64;")],
    "dq-2-blocks": [("flash_bwd_dq.cu", "constexpr int kBlocksPerSM = 3;",
                     "constexpr int kBlocksPerSM = 2;")],
    "tf32x1": [(COMMON, "  mma_tf32(d, a.lo, b.hi);\n"
                "  mma_tf32(d, a.hi, b.lo);\n", "")],
}


def start_builds(build, name, variants=VARIANTS, kernels=KERNELS, out=OUT):
    """Copy the sources into ``out`` with the edits of ``variants[name]``
    and start nvcc for each of ``kernels``; returns {kernel: (process,
    library path)}. scratch/fwd_variants.py builds the forward's variants
    with it."""
    d = os.path.join(out, name.split()[0])
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(CSRC, d)
    for fname, old, new in variants[name]:
        path = os.path.join(d, fname)
        with open(path) as f:
            text = f.read()
        if text.count(old) != 1:
            chip_smoke.fail("variant %s: %r is not in %s exactly once"
                            % (name, old, fname))
        with open(path, "w") as f:
            f.write(text.replace(old, new))
    jobs = {}
    for kname in kernels:
        lib = os.path.join(d, "lib%s.so" % kname)
        cmd = [build._nvcc()] + build._FLAGS + [
            "-o", lib, os.path.join(d, build.SOURCES[kname])]
        jobs[kname] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT,
                                        text=True), lib)
    return jobs


def finish_builds(build, name, jobs, instances=(("", "kernelILi8E"),),
                  declare=None):
    """Wait for variant ``name``'s builds and print ptxas's registers and
    spill stores of each of ``instances`` ((label, start of the mangled
    name) pairs; by default the D = 64 instance, NT = 8). Returns
    {kernel: C entry point}, each from ``declare(library path, kernel)``,
    by default the port's own declaration."""
    fns = {}
    for kname, (proc, lib) in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            chip_smoke.fail("variant %s: nvcc failed for %s:\n%s"
                            % (name, kname, log[-4000:]))
        for label, mangled in instances:
            block = log[log.index(mangled):]
            regs = re.search(r"Used (\d+) registers", block).group(1)
            spill = re.search(r"(\d+) bytes spill stores", block).group(1)
            print("  %-12s %-15s D = 64%s: %s registers, %s bytes spill"
                  " stores" % (name, kname, label, regs, spill))
        fns[kname] = build._declare(ctypes.CDLL(lib), kname) \
            if declare is None else declare(lib, kname)
    return fns


def launch(fn, kname, q, k, v, do, lse, dcap, seg, scale, causal):
    """One call of a variant's kernel, as ``_bwd_cuda`` makes it."""
    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    ptrs = [x.data_ptr() for x in (q, k, v, do, lse, dcap)] + [None]
    outs = (torch.empty_like(k), torch.empty_like(v)) \
        if kname == "flash_bwd_dkdv" else (torch.empty_like(q),)
    rc = fn(*ptrs, *[o.data_ptr() for o in outs], B, H, Tq, Tk, D,
            float(scale), int(causal), torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        chip_smoke.fail("%s launch failed with cudaError %d" % (kname, rc))
    return outs


def inputs(tfa, B, T, H, D, seed):
    dev = torch.device("cuda", 0)
    g = torch.Generator(device="cpu").manual_seed(seed)
    q, k, v, do = (torch.randn(B, T, H, D, generator=g).to(dev)
                   for _ in range(4))
    scale = D ** -0.5
    o, lse = tfa._fwd_cuda(q, k, v, None, scale, True)
    dcap = torch.sum(do * o, dim=-1).permute(0, 2, 1).contiguous()
    return (q, k, v, do, lse, dcap, None, scale, True)


def main():
    card = chip_smoke.phase_device()
    from mxnet_tpu_torch.parallel import _build
    tfa = importlib.import_module("mxnet_tpu_torch.parallel.flash_attention")
    _build.library("flash_fwd")
    jobs = {name: start_builds(_build, name) for name in VARIANTS}
    fns = {name: finish_builds(_build, name, j) for name, j in jobs.items()}

    big = inputs(tfa, 8, 1024, 12, 64, seed=11)
    small = inputs(tfa, 2, 256, 12, 64, seed=14)
    want = tfa._torch_bwd_dkdv(*big) + (tfa._torch_bwd_dq(*big),)
    leaves = [x.double().requires_grad_(True) for x in small[:3]]
    dq, dk, dv = torch.autograd.grad(tfa.flash_attention(
        *leaves, causal=True, scale=small[7], impl="plain"), leaves,
        small[3].double())
    ref64 = (dk, dv, dq)
    plain = tfa._torch_bwd_dkdv(*small) + (tfa._torch_bwd_dq(*small),)
    print("errors as max abs dk/dv/dq; the fp32 plain versions vs float64"
          " at B2 T256: %s" % "/".join(
              "%.3g" % float((a.double() - r).abs().max())
              for a, r in zip(plain, ref64)))
    outs = {}
    for name, f in fns.items():
        got = sum((launch(f[kn], kn, *big) for kn in KERNELS), ())
        got64 = sum((launch(f[kn], kn, *small) for kn in KERNELS), ())
        torch.cuda.synchronize()
        outs[name] = got
        e32 = [float((a - b).abs().max()) for a, b in zip(got, want)]
        e64 = [float((a.double() - r).abs().max())
               for a, r in zip(got64, ref64)]
        same = all(torch.equal(a, b) for a, b in zip(got, outs["shipped"]))
        print("  %-12s vs plain at B8 T1024 %s | vs float64 at B2 T256 %s |"
              " bit-identical to shipped: %s"
              % (name, "/".join("%.3g" % e for e in e32),
                 "/".join("%.3g" % e for e in e64), same))
    print("device ms per call at B8 T1024 H12 D64 causal (%s):" % card)
    for name in list(fns) + ["shipped"]:
        ms = [chip_smoke.device_ms(lambda kn=kn: launch(fns[name][kn], kn,
                                                        *big))
              for kn in KERNELS]
        print("  %-12s dkdv %.4f  dq %.4f  both %.4f"
              % (name, ms[0], ms[1], sum(ms)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
