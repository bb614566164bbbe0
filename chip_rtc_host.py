"""Host cost of one ``mx.rtc`` launch, stage by stage, on one card.

    python3 chip_rtc_host.py [--parent DIR]

Each measurement runs in a process of its own: it imports
``mxnet_tpu_torch`` from a tree, compiles ``chip_smoke.RTC_KERNELS`` and
makes RTC_REPS launches of the 1024-float axpy on gpu(0), timing each
stage of the launch with ``time.perf_counter_ns``, then the launch whole,
then two floors (``cuLaunchKernel`` alone through ctypes with a prebuilt
argument array, and ``torch.add(y, x, alpha=)``), three ways to read
torch's current stream, and cuLaunchKernel paired with one other call of
the kind a launch makes (:func:`launch_pairs`). A tree whose ``rtc`` has
no launch plan (``_Plan``: the launch that rebuilt its arguments and
pushed the primary context at every call) is timed by a copy of that
launch with a clock between its stages (:func:`unplanned_breakdown`); a
tree with one by ``chip_smoke.rtc_breakdown``. With ``--parent DIR`` (an
earlier commit unpacked with ``git archive``, in a directory that
.gitignore lists) the runs go parent, checkout, checkout, parent; without
it the checkout runs once. Each run prints one JSON line.
"""
import json
import os
import subprocess
import sys
import time

import torch

HERE = os.path.dirname(os.path.abspath(__file__))


def unplanned_breakdown(mx, k, args, ctx, grid_dims, block_dims, reps,
                  shared_mem=0):
    """Mean ns per launch of each stage of ``CudaKernel.launch`` as it was
    before the launch plan, over ``reps`` launches: its statements, in
    its order, with a clock read between stages."""
    rtc = mx.rtc
    ns = time.perf_counter_ns
    stages = ("imports", "checks", "marshalling", "_function",
              "argument array", "stream lookup", "context push",
              "cuLaunchKernel", "context pop", "count + write-back")
    acc = [0] * len(stages)
    for _ in range(reps):
        t = [ns()]
        from mxnet_tpu_torch.context import current_context
        from mxnet_tpu_torch.ndarray import NDArray
        t.append(ns())
        if len(grid_dims) != 3 or len(block_dims) != 3:
            raise ValueError("grid_dims/block_dims")
        grid = tuple(int(g) for g in grid_dims)
        block = tuple(int(b) for b in block_dims)
        if min(grid + block) < 1:
            raise mx.MXNetError("dims")
        if block[0] * block[1] * block[2] > rtc._MAX_THREADS or any(
                b > m for b, m in zip(block, rtc._MAX_BLOCK)):
            raise mx.MXNetError("block_dims")
        shared_mem = int(shared_mem)
        if shared_mem < 0:
            raise mx.MXNetError("shared_mem")
        if len(args) != len(k._dtypes):
            raise mx.MXNetError("arguments")
        for i, (arg, is_nd) in enumerate(zip(args, k._is_ndarray)):
            if is_nd and not isinstance(arg, NDArray):
                raise mx.MXNetError("NDArray")
        if not any(nd and not c for nd, c in zip(k._is_ndarray,
                                                 k._is_const)):
            raise mx.MXNetError("writable")
        c = ctx if ctx is not None else current_context()
        if c.device_type != "gpu":
            raise mx.MXNetError("GPU context")
        dev = c.torch_device()
        t.append(ns())
        values, temps, writeback = [], [], []
        for i, (arg, is_nd, const, dt) in enumerate(
                zip(args, k._is_ndarray, k._is_const, k._dtypes)):
            if not is_nd:
                values.append(rtc._scalar(arg, dt))
                continue
            x = arg._data
            if x.device != dev:
                raise mx.MXNetError("device")
            if x.dtype != dt or not x.is_contiguous():
                x = x.detach().to(dt).contiguous()
                temps.append(x)
                if not const:
                    writeback.append((arg, x))
            values.append(rtc.ctypes.c_void_p(x.data_ptr()))
        t.append(ns())
        fn = k._module._function(dev.index, k._name)
        t.append(ns())
        params = (rtc.ctypes.c_void_p * max(1, len(values)))()
        for i, v in enumerate(values):
            params[i] = rtc.ctypes.cast(rtc.ctypes.pointer(v),
                                        rtc.ctypes.c_void_p)
        t.append(ns())
        cu = rtc._cuda()
        stream = torch.cuda.current_stream(dev).cuda_stream
        t.append(ns())
        with rtc._Context(dev.index):
            t.append(ns())
            if shared_mem > rtc._DEFAULT_SMEM:
                raise mx.MXNetError("shared memory")
            rtc._cu_check(cu.cuLaunchKernel(
                fn, grid[0], grid[1], grid[2], block[0], block[1], block[2],
                shared_mem, stream, params, None), "cuLaunchKernel")
            t.append(ns())
        t.append(ns())
        rtc.launches["rtc"] += 1
        with torch.no_grad():
            for arr, x in writeback:
                arr._data.copy_(x)
        del temps
        t.append(ns())
        for i in range(len(stages)):
            acc[i] += t[i + 1] - t[i]
    return {s: a / reps for s, a in zip(stages, acc)}


def stream_lookups(reps):
    """Host µs per call of three ways to read torch's current stream of
    device 0."""
    dev = torch.device("cuda", 0)
    ways = {
        "current_stream(torch.device)":
            lambda: torch.cuda.current_stream(dev).cuda_stream,
        "current_stream(0)": lambda: torch.cuda.current_stream(0).cuda_stream,
        "_cuda_getCurrentRawStream(0)":
            lambda: torch._C._cuda_getCurrentRawStream(0),
    }
    out = {}
    for name, fn in ways.items():
        fn()
        t0 = time.perf_counter_ns()
        for _ in range(reps):
            fn()
        out[name] = (time.perf_counter_ns() - t0) / reps / 1e3
    return out


def launch_pairs(rtc, fn, x, y, reps):
    """Host µs per iteration of cuLaunchKernel (the 1024-float axpy,
    prebuilt arguments) paired with one other call, and of that call
    alone: whether a launch costs more when other work runs between
    launches."""
    import ctypes
    cu = rtc._cuda()
    cu.cuCtxGetCurrent.argtypes = [ctypes.POINTER(ctypes.c_void_p)]
    vals = [ctypes.c_float(0.5), ctypes.c_void_p(x.data_ptr()),
            ctypes.c_void_p(y.data_ptr())]
    params = (ctypes.c_void_p * 3)(*[ctypes.addressof(v) for v in vals])
    stream = torch.cuda.current_stream(0).cuda_stream
    cur = ctypes.c_void_p()
    ref = ctypes.pointer(cur)
    others = {
        "nothing": lambda: None,
        "cuCtxGetCurrent": lambda: cu.cuCtxGetCurrent(ref),
        "_cuda_getCurrentRawStream":
            lambda: torch._C._cuda_getCurrentRawStream(0),
        "current_stream(0)":
            lambda: torch.cuda.current_stream(0).cuda_stream,
        "sum(range(100))": lambda: sum(range(100)),
    }
    out = {}
    # ctypes' own cost: the same launch through a handle of the function
    # with no argtypes, given ctypes objects; and the driver's refusal of
    # a NULL function, which does no launch
    bare = ctypes.CDLL("libcuda.so.1").cuLaunchKernel
    objs = ([fn] + [ctypes.c_uint(v) for v in (4, 1, 1, 256, 1, 1, 0)]
            + [ctypes.c_void_p(stream), params, None])
    for name, call in (
            ("cuLaunchKernel, ctypes objects, no argtypes",
             lambda: bare(*objs)),
            ("cuLaunchKernel of NULL (refused)",
             lambda: cu.cuLaunchKernel(None, 4, 1, 1, 256, 1, 1, 0, stream,
                                       params, None))):
        torch.cuda.synchronize()
        t0 = time.perf_counter_ns()
        for _ in range(reps):
            call()
        out[name] = (time.perf_counter_ns() - t0) / reps / 1e3
        torch.cuda.synchronize()
    for name, other in others.items():
        for paired in (True, False):
            torch.cuda.synchronize()
            t0 = time.perf_counter_ns()
            for _ in range(reps):
                other()
                if paired:
                    cu.cuLaunchKernel(fn, 4, 1, 1, 256, 1, 1, 0, stream,
                                      params, None)
            dt = (time.perf_counter_ns() - t0) / reps / 1e3
            torch.cuda.synchronize()
            out[name + (" + cuLaunchKernel" if paired else "")] = dt
    print("  launch pairs, host us per iteration: %s" % ", ".join(
        "%s %.2f" % kv for kv in out.items()))
    return out


def one(tree):
    """The measurements on the ``mxnet_tpu_torch`` of ``tree``."""
    import chip_smoke as c                 # from the checkout, first
    sys.path.insert(0, os.path.abspath(tree))
    import mxnet_tpu_torch as mx
    if not torch.cuda.is_available():
        c.fail("no CUDA device")
    card = c.phase_device()
    reps = c.RTC_REPS
    ctx = mx.gpu(0)
    dev = torch.device("cuda", 0)
    mod = mx.rtc.CudaModule(c.RTC_KERNELS)
    axpy = mod.get_kernel("axpy", "float alpha, const float *x, float *y")
    x = mx.nd.NDArray(torch.randn(1024, device=dev))
    y = mx.nd.NDArray(torch.randn(1024, device=dev))
    alpha = 0.5
    args, grid, block = (alpha, x, y), (4, 1, 1), (256, 1, 1)
    for _ in range(10):
        axpy.launch(args, ctx, grid, block)
    torch.cuda.synchronize()
    if hasattr(mx.rtc, "_Plan"):
        stages = c.rtc_breakdown(axpy, args, ctx, grid, block, reps)
    else:
        stages = unplanned_breakdown(mx, axpy, args, ctx, grid, block, reps)
    stages = {s: v / 1e3 for s, v in stages.items()}

    def loop():
        for _ in range(reps):
            axpy.launch(args, ctx, grid, block)
    loop()
    launch_us = c.host_us(loop, reps)
    fn = mod._function(0, "axpy")
    floors = c.rtc_floors(mx.rtc, fn, alpha, x._data, y._data, reps)
    rec = dict(tree=tree, card=card, stages_us=stages,
               stages_sum_us=sum(stages.values()), launch_us=launch_us,
               stream_us=stream_lookups(reps),
               pairs_us=launch_pairs(mx.rtc, fn, x._data, y._data, reps),
               **floors)
    print("%s: launch %.2f us (stages %s, sum %.2f); cuLaunchKernel alone"
          " %.2f us, torch.add %.2f us; %s" % (
              tree, launch_us, ", ".join("%s %.2f" % kv
                                         for kv in stages.items()),
              rec["stages_sum_us"], floors["raw_launch_us"],
              floors["library_host_us"], card))
    print(json.dumps(rec))


def main():
    if "--one" in sys.argv:
        one(sys.argv[sys.argv.index("--one") + 1])
        return 0
    trees = ["."]
    if "--parent" in sys.argv:
        parent = sys.argv[sys.argv.index("--parent") + 1]
        trees = [parent, ".", ".", parent]
    for tree in trees:
        rc = subprocess.run([sys.executable, os.path.abspath(__file__),
                             "--one", tree], cwd=HERE, timeout=600).returncode
        if rc != 0:
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main())
