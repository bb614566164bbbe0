"""NVRTC's code against nvcc's for ``chip_smoke.RTC_KERNELS``, on the card.

    python3 chip_rtc_sass.py

``mx.rtc`` compiles a user's source with NVRTC; ``chip_smoke.py`` phase 8
compares its SASS (``cuobjdump -sass``) with ``nvcc -O3 -gencode
arch=compute_90a,code=sm_90a``'s for the same source, kernel by kernel.
This script finds where a difference comes from: it compares the PTX of
the two front ends, the SASS of ``ptxas -O3`` (the toolkit's binary) run
on NVRTC's PTX, and the SASS of NVRTC under a few options, none of which
changes what the source means (no fast math, no ``-restrict``). Each
NVRTC build whose SASS differs from the default one is then timed on
``row_sum`` at phase 8's shape (4096 x 4096, 256-thread blocks), device
ms from CUDA-graph replays, beside the default build and nvcc's cubin
(loaded and launched through the driver) in the same process, in turns.
"""
import ctypes
import difflib
import os
import re
import subprocess
import sys

import torch

import chip_smoke as c

# NVRTC options to try; the first is mx.rtc's own
VARIANTS = ([], ["--dopt=on"], ["-default-device"],
            ["--extra-device-vectorization"], ["--ptxas-options=-O3"],
            ["--std=c++17"])


def nvrtc_build(mx, source, options):
    """(PTX text, cubin bytes) of ``source`` from NVRTC with ``options``
    after the card's architecture, as mx.rtc passes it."""
    lib = mx.rtc._nvrtc()
    p, sz = ctypes.c_void_p, ctypes.c_size_t
    lib.nvrtcGetPTXSize.argtypes = [p, ctypes.POINTER(sz)]
    lib.nvrtcGetPTX.argtypes = [p, ctypes.c_char_p]
    opts = ["--gpu-architecture=%s" % mx.rtc._arch(0)] + options
    prog = p()
    if lib.nvrtcCreateProgram(ctypes.byref(prog), source.encode(),
                              b"sass_probe.cu", 0, None, None):
        c.fail("nvrtcCreateProgram")
    try:
        arr = (ctypes.c_char_p * len(opts))(*[o.encode() for o in opts])
        if lib.nvrtcCompileProgram(prog, len(opts), arr):
            size = sz()
            lib.nvrtcGetProgramLogSize(prog, ctypes.byref(size))
            log = ctypes.create_string_buffer(size.value)
            lib.nvrtcGetProgramLog(prog, log)
            c.fail("NVRTC %s: %s" % (opts, log.value.decode()))
        size = sz()
        lib.nvrtcGetPTXSize(prog, ctypes.byref(size))
        ptx = ctypes.create_string_buffer(size.value)
        lib.nvrtcGetPTX(prog, ptx)
        lib.nvrtcGetCUBINSize(prog, ctypes.byref(size))
        cubin = ctypes.create_string_buffer(size.value)
        lib.nvrtcGetCUBIN(prog, cubin)
        return ptx.value.decode(), cubin.raw
    finally:
        lib.nvrtcDestroyProgram(ctypes.byref(prog))


def ptx_body(text):
    """PTX without comments and the header lines that name the compiler."""
    lines = []
    for line in text.splitlines():
        line = line.split("//")[0].rstrip()
        if line and not line.startswith((".version", ".target",
                                         ".address_size")):
            lines.append(line)
    return lines


def entry(lines, name):
    """The lines of kernel ``name``'s ``.entry`` in PTX ``lines``."""
    start = next(i for i, ln in enumerate(lines)
                 if re.search(r"\.entry\s+%s\b" % name, ln))
    end = next(i for i in range(start, len(lines)) if lines[i] == "}")
    return lines[start:end + 1]


def driver_function(mx, cubin, name):
    """The CUfunction ``name`` of the cubin at ``cubin``, loaded into the
    card's primary context through the driver."""
    cu = mx.rtc._cuda()
    with open(cubin, "rb") as f:
        data = f.read()
    module, fn = ctypes.c_void_p(), ctypes.c_void_p()
    with mx.rtc._pushed(0):
        mx.rtc._cu_check(cu.cuModuleLoadData(ctypes.byref(module), data),
                         "cuModuleLoadData")
        mx.rtc._cu_check(cu.cuModuleGetFunction(ctypes.byref(fn), module,
                                                name.encode()),
                         "cuModuleGetFunction")
    return fn


def run(cmd):
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    if out.returncode != 0:
        c.fail("%s: %s" % (" ".join(cmd), out.stderr))
    return out.stdout


def compare(name, got, want):
    """One line on the kernels of two SASS listings."""
    parts = []
    for k in sorted(want):
        a, b = got.get(k, []), want[k]
        ops = sorted(i.split()[0] for i in a) == sorted(i.split()[0]
                                                         for i in b)
        parts.append("%s %d/%d %s" % (k, len(a), len(b),
                                      "identical" if a == b else
                                      "same opcodes" if ops else "differs"))
    print("  %-46s %s" % (name, "; ".join(parts)))


def main():
    card = c.phase_device()
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.parallel import _build
    bindir = os.path.dirname(_build._nvcc())
    out = os.path.join(mx.rtc._OUT, "sass_probe")
    os.makedirs(out, exist_ok=True)
    src = os.path.join(out, "kernels.cu")
    with open(src, "w") as f:
        f.write(c.RTC_KERNELS)
    gencode = ["-O3", "-gencode", "arch=compute_90a,code=sm_90a"]
    run([_build._nvcc(), "-ptx", "-O3", "-arch=compute_90a", "-o",
         os.path.join(out, "nvcc.ptx"), src])
    run([_build._nvcc(), "-cubin"] + gencode + ["-o",
        os.path.join(out, "nvcc.cubin"), src])
    with open(os.path.join(out, "nvcc.ptx")) as f:
        nvcc_ptx = ptx_body(f.read())
    want = c.sass_kernels(os.path.join(out, "nvcc.cubin"))
    print("NVRTC against nvcc -O3 for RTC_KERNELS, SASS instructions"
          " NVRTC/nvcc a kernel (%s; %s):" % (
              run([_build._nvcc(), "--version"]).strip().splitlines()[-1],
              card))
    builds = {}
    for opts in VARIANTS:
        ptx, cubin = nvrtc_build(mx, c.RTC_KERNELS, opts)
        path = os.path.join(out, "nvrtc_%d.cubin" % len(builds))
        with open(path, "wb") as f:
            f.write(cubin)
        got = c.sass_kernels(path)
        builds[" ".join(opts) or "(mx.rtc's options)"] = (opts, got)
        compare("NVRTC %s, PTX %s nvcc's" % (
            " ".join(opts) or "(mx.rtc's options)",
            "equal to" if ptx_body(ptx) == nvcc_ptx else "unlike"),
            got, want)
        if not opts:
            ptx_path = os.path.join(out, "nvrtc.ptx")
            with open(ptx_path, "w") as f:
                f.write(ptx)
            run([os.path.join(bindir, "ptxas"), "-O3", "-arch=sm_90a",
                 "-o", os.path.join(out, "ptxas.cubin"), ptx_path])
            compare("ptxas -O3 on NVRTC's PTX",
                    c.sass_kernels(os.path.join(out, "ptxas.cubin")), want)
            default = got
    # where row_sum's PTX differs
    with open(os.path.join(out, "nvrtc.ptx")) as f:
        nvrtc_ptx = ptx_body(f.read())
    diff = [d for d in difflib.unified_diff(
        entry(nvrtc_ptx, "row_sum"), entry(nvcc_ptx, "row_sum"),
        "NVRTC", "nvcc", n=0, lineterm="") if not d.startswith("@@")]
    print("row_sum's PTX, NVRTC against nvcc (%d lines differ):\n  %s"
          % (len(diff) - 2, "\n  ".join(diff[:24])))
    # time row_sum from each build whose code differs from the default,
    # and from nvcc's cubin, loaded and launched through the driver
    dev = torch.device("cuda", 0)
    xr = mx.nd.NDArray(torch.rand(4096, 4096, device=dev))
    sums = mx.nd.zeros((4096,), ctx=mx.gpu(0))
    want_sums = xr._data.sum(dim=1)
    times = []
    for name, (opts, got) in builds.items():
        if opts and got.get("row_sum") == default.get("row_sum"):
            continue
        k = mx.rtc.CudaModule(c.RTC_KERNELS, options=opts).get_kernel(
            "row_sum", "const float *x, float *out, int n")

        def launch(k=k):
            k.launch((xr, sums, 4096), mx.gpu(0), (4096, 1, 1),
                     (256, 1, 1), shared_mem=256 * 4)
        if not opts:
            first_launch = launch
        launch()
        err, ok = c.close(sums._data, want_sums, c.ROWSUM_TOL)
        if not ok:
            c.fail("row_sum under %s disagrees (err %g)" % (name, err))
        times.append((name, c.device_ms(launch)))
    nvcc_fn = driver_function(mx, os.path.join(out, "nvcc.cubin"),
                              "row_sum")
    vals = [ctypes.c_void_p(xr._data.data_ptr()),
            ctypes.c_void_p(sums._data.data_ptr()), ctypes.c_int(4096)]
    params = (ctypes.c_void_p * 3)(*[ctypes.addressof(v) for v in vals])
    cu = mx.rtc._cuda()

    def nvcc_launch():
        rc = cu.cuLaunchKernel(nvcc_fn, 4096, 1, 1, 256, 1, 1, 256 * 4,
                               torch.cuda.current_stream().cuda_stream,
                               params, None)
        if rc:
            c.fail("cuLaunchKernel of nvcc's row_sum: %d" % rc)
    sums._data.zero_()
    nvcc_launch()
    err, ok = c.close(sums._data, want_sums, c.ROWSUM_TOL)
    if not ok:
        c.fail("nvcc's row_sum disagrees (err %g)" % err)
    # in turns: NVRTC, nvcc, nvcc, NVRTC
    times += [("nvcc -O3", c.device_ms(nvcc_launch)),
              ("nvcc -O3", c.device_ms(nvcc_launch))]
    times.append((times[0][0], c.device_ms(first_launch)))
    print("row_sum 4096 x 4096 device ms (20 in one CUDA graph): %s (%s)"
          % (", ".join("%s %.4f" % t for t in times), card))
    return 0


if __name__ == "__main__":
    sys.exit(main())
