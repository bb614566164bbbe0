"""On-card A/B of the forward attention kernel's design choices.

    python3 scratch/fwd_variants.py

Needs one NVIDIA Hopper card and nvcc, and exits non-zero anywhere else.
It builds ``flash_fwd.cu`` once per variant with chip_bwd_variants.py's
helpers (a copy of ``mxnet_tpu_torch/parallel/csrc`` with the variant's
text edits, each of which must match exactly once; all nvcc runs at
once, under ``mxnet_tpu_torch/_build/fwd_variants/``) and runs every
variant in one process on the same inputs: device ms per call (20 calls in a
CUDA graph, median of 5 replays) at the training shape B8 T1024 H12 D64
causal with 64-row blocks (S = 1) and at the server's B1 T512 and B1
T128 prefill with 16-row blocks (S = 4), the shipped source timed first
and again last; the max abs error of O and the LSE against the plain
fp32 version; ptxas registers and spill stores of the D = 64 kernels.

The variants undo one choice each: Q's split fragments held in
registers in 64-row blocks too; two blocks an SM instead of three for
64-row blocks; both (the kernel's first tensor-core version); walked
tiles of 64 keys instead of 32 in 64-row blocks; and a single TF32 pass
(which fails the kernel's tolerance; it shows the share of the three
tensor-core products in the time).
"""
import importlib
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_bwd_variants  # noqa: E402
import chip_smoke  # noqa: E402

OUT = os.path.join(ROOT, "mxnet_tpu_torch", "_build", "fwd_variants")
FWD, COMMON = "flash_fwd.cu", "flash_common.cuh"
QREG = ("constexpr bool kQReg = S > 1 && NT <= 8;",
        "constexpr bool kQReg = NT <= 8;")
BLK2 = ("constexpr int kMinBlocks = S == 1 && NT <= 8 ? 3 : 2;",
        "constexpr int kMinBlocks = 2;")
# variant -> [(file, shipped text, variant text)]
VARIANTS = {
    "shipped": [],
    "q-in-registers": [(FWD,) + QREG],
    "2-blocks": [(FWD,) + BLK2],
    "both (first)": [(FWD,) + QREG, (FWD,) + BLK2],
    "walk-64": [(FWD, "return S == 1 ? 32 : 16;", "return S == 1 ? 64 : 16;")],
    "tf32x1": [(COMMON, "  mma_tf32(d, a.lo, b.hi);\n"
                "  mma_tf32(d, a.hi, b.lo);\n", "")],
}
# ptxas's D = 64 instances at both block shapes
INSTANCES = ((" S=1", "fwd_kernelILi8ELi1E"), (" S=4", "fwd_kernelILi8ELi4E"))


def main():
    card = chip_smoke.phase_device()
    from mxnet_tpu_torch.parallel import _build
    tfa = importlib.import_module("mxnet_tpu_torch.parallel.flash_attention")
    jobs = {n: chip_bwd_variants.start_builds(_build, n, VARIANTS,
                                              ("flash_fwd",), OUT)
            for n in VARIANTS}
    fns = {n: chip_bwd_variants.finish_builds(
        _build, n, j, INSTANCES,
        lambda lib, _: chip_smoke.fwd_split_entry(lib))["flash_fwd"]
        for n, j in jobs.items()}
    dev = torch.device("cuda", 0)
    g = torch.Generator(device="cpu").manual_seed(10)
    shapes = {"B8 T1024 S=1": (8, 1024, 1), "B1 T512 S=4": (1, 512, 4),
              "B1 T128 S=4": (1, 128, 4)}
    data = {}
    for key, (B, T, s) in shapes.items():
        q, k, v = (torch.randn(B, T, 12, 64, generator=g).to(dev)
                   for _ in range(3))
        data[key] = (q, k, v, s, tfa._torch_fwd_lse(q, k, v, None, 0.125,
                                                     True))
    print("device ms per call and max abs err O/LSE vs plain (%s):" % card)
    for name in list(fns) + ["shipped"]:
        cells = []
        for key, (q, k, v, s, want) in data.items():
            got = chip_smoke.fwd_forced(q, k, v, None, 0.125, True, s,
                                        fns[name])
            err = [float((a - b).abs().max()) for a, b in zip(got, want)]
            ms = chip_smoke.device_ms(lambda: chip_smoke.fwd_forced(
                q, k, v, None, 0.125, True, s, fns[name]))
            cells.append("%s %.4f (%.2g/%.2g)" % (key, ms, err[0], err[1]))
        print("  %-18s %s" % (name, " | ".join(cells)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
