"""Runtime kernel compilation — ``mx.rtc`` (counterpart of
``mxnet_tpu/rtc.py``).

MXNet's ``mx.rtc.CudaModule`` compiles CUDA C source at run time with
NVRTC and launches its kernels on GPU NDArrays. The port keeps that
object model and that source language::

    source = r'''
    extern "C" __global__ void axpy(float alpha, const float *x, float *y) {
        int i = blockIdx.x * blockDim.x + threadIdx.x;
        y[i] += alpha * x[i];
    }
    '''
    mod = mx.rtc.CudaModule(source)
    k = mod.get_kernel("axpy", "float alpha, const float *x, float *y")
    k.launch((2.0, x, y), mx.gpu(0), (n // 256, 1, 1), (256, 1, 1))

The JAX package's ``PallasModule`` (Python text with Pallas bodies) has
no counterpart here.

- **Signature grammar**, as in MXNet: ``const`` marks an input array,
  ``*`` an array, a bare type a scalar passed by value; argument names
  are optional.
- **Kernel names** come from the source's ``__global__`` declarations,
  so :meth:`CudaModule.get_kernel` and the ``exports`` check need no
  compiler. ``exports`` names kernels by NVRTC name expression, which
  is how a templated kernel (``"axpy<float>"``) is reached; a
  non-templated kernel is reached by its name with or without
  ``extern "C"``.
- **Compiling** happens at a module's first launch, once: NVRTC
  (``libnvrtc`` through ctypes) turns the source into a cubin for the
  card's architecture (``sm_90a`` on an H100), cached on disk under
  ``mxnet_tpu_torch/_build/rtc/`` by the SHA-256 of the source, the
  options and the exports, or, with ``MXNET_COMPILE_CACHE_DIR`` set, in
  the persistent compile cache (:mod:`~mxnet_tpu_torch.compile_cache`,
  site ``nvrtc``; its key adds the architecture, NVRTC's version and
  the card). The cubin is loaded with the driver API
  (``cuModuleLoadData``) into the device's primary context. A compile or
  load error raises :class:`~mxnet_tpu_torch.MXNetError` with the
  compiler's log.
- **Launching**: ``grid_dims``, ``block_dims`` (at most 1024 threads)
  and ``shared_mem`` (dynamic shared memory in bytes; above 48 KB the
  kernel's limit is raised first) are real launch parameters, on
  torch's current stream of the context's device. A const array whose
  dtype or layout differs from the signature is cast or made contiguous
  into a temporary; a non-const array is in-out: a contiguous array of
  the signature's dtype is written in place, any other goes through a
  temporary that is written back into it in its own dtype.
- **The launch plan**: a kernel's first launch on a device builds its
  plan once (the CUfunction, one ctypes slot per signature argument, the
  ``void*[]`` array pointing at them). Every launch then makes its checks,
  writes the data pointers and scalars into the slots in place (a half
  or bfloat16 scalar rounded to nearest even, as torch rounds it), reads
  torch's current stream and calls ``cuLaunchKernel`` once. The device's
  primary context is pushed only on a thread where it is not current.
- **CUDA graphs**: a launch of contiguous arrays of the signature's
  dtypes allocates nothing and never synchronises, so it can be captured
  in a CUDA graph (``torch.cuda.graph``) once it has launched eagerly on
  that device (the first launch compiles and loads). A replay of the
  graph does not tick :data:`launches`.
- **GPU only**: a CPU context, or an array on another device than the
  context's, raises MXNetError. There is no CPU runner and no fallback.

:data:`launches` counts kernel launches.
"""
from __future__ import annotations

import contextlib
import ctypes
import ctypes.util
import glob
import hashlib
import json
import os
import re
import threading
import time

import torch

from . import compile_cache
from .base import MXNetError
from .context import current_context
from .ndarray import NDArray

__all__ = ["CudaModule", "CudaKernel", "launches", "reset_launches",
           "nvrtc_version"]

# reference rtc.py _DTYPE_CPP_TO_NP, plus numpy-style spellings (the JAX
# package's _DTYPE_TO_NP), as torch dtypes
_DTYPE_TO_TORCH = {
    "float": torch.float32, "double": torch.float64,
    "__half": torch.float16, "uint8_t": torch.uint8, "int": torch.int32,
    "int32_t": torch.int32, "int8_t": torch.int8, "char": torch.int8,
    "int64_t": torch.int64, "float32": torch.float32,
    "float64": torch.float64, "float16": torch.float16,
    "bfloat16": torch.bfloat16, "int32": torch.int32,
    "int64": torch.int64, "int8": torch.int8, "uint8": torch.uint8,
    "bool": torch.bool,
}

_SIG_RE = re.compile(
    r"""^\s*(const)?\s*([\w_]+)\s*(\*)?\s*([\w_]+)?\s*$""")

# a kernel declaration: optional template header, __global__, optional
# qualifiers (__launch_bounds__(...), static, ...) before or after void,
# the name
_GLOBAL_RE = re.compile(
    r"(template\s*<[^;{]*?>\s*)?(?:extern\s+\"C\"\s*)?__global__\s+"
    r"(?:[\w:]+(?:\([^)]*\))?\s+)*?void\s+"
    r"(?:__launch_bounds__\s*\([^)]*\)\s*)?(\w+)\s*\(")
_COMMENT_RE = re.compile(r"//[^\n]*|/\*.*?\*/", re.S)

# scalar arguments: the C type each torch dtype is passed as (half and
# bfloat16 by their 16 bits)
_CTYPES = {
    torch.float32: ctypes.c_float, torch.float64: ctypes.c_double,
    torch.float16: ctypes.c_uint16, torch.bfloat16: ctypes.c_uint16,
    torch.uint8: ctypes.c_uint8, torch.int8: ctypes.c_int8,
    torch.int32: ctypes.c_int32, torch.int64: ctypes.c_int64,
    torch.bool: ctypes.c_bool,
}

_MAX_THREADS = 1024
_MAX_BLOCK = (1024, 1024, 64)
_DEFAULT_SMEM = 48 * 1024
_CU_FUNC_ATTRIBUTE_MAX_DYNAMIC_SHARED_SIZE_BYTES = 8
_OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build",
                    "rtc")

# torch's current stream of a device as the driver's handle: the call
# under torch.cuda.current_stream(index).cuda_stream, without building a
# Stream object (0.1-0.2 µs against 2.1-3.7 on the host of an NVIDIA H100
# 80GB HBM3 at 700.00 W: PERF.md); chip_smoke.py holds it to the public
# value. Absent where torch has no CUDA, where no launch gets this far.
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)

# kernel name -> launches since the last reset_launches()
launches = {"rtc": 0}


def reset_launches():
    """Set the launch count to 0."""
    for name in launches:
        launches[name] = 0


def _kernel_names(source):
    """{name: templated?} of the ``__global__`` functions of ``source``."""
    out = {}
    for m in _GLOBAL_RE.finditer(_COMMENT_RE.sub(" ", source)):
        out[m.group(2)] = bool(m.group(1))
    return out


# ---------------------------------------------------------------------------
# NVRTC and the driver API, through ctypes (loaded at first use)
# ---------------------------------------------------------------------------

_lock = threading.Lock()
_libs = {}


def _nvrtc_candidates():
    homes = [os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
             "/usr/local/cuda"]
    cands = []
    for home in homes:
        if home:
            cands += sorted(glob.glob(os.path.join(home, "lib64",
                                                   "libnvrtc.so*")))
    try:
        import nvidia.cuda_nvrtc as pkg   # the CUDA wheels torch depends on
        for root in pkg.__path__:
            cands += sorted(glob.glob(os.path.join(root, "lib",
                                                   "libnvrtc.so*")))
    except ImportError:
        pass
    found = ctypes.util.find_library("nvrtc")
    if found:
        cands.append(found)
    return [c for c in cands if "builtins" not in os.path.basename(c)]


def _nvrtc():
    lib = _libs.get("nvrtc")
    if lib is not None:
        return lib
    errors = []
    for path in _nvrtc_candidates():
        try:
            # NVRTC opens its builtins library by name at compile time
            for b in sorted(glob.glob(os.path.join(
                    os.path.dirname(path), "libnvrtc-builtins.so*"))):
                ctypes.CDLL(b, mode=ctypes.RTLD_GLOBAL)
            lib = ctypes.CDLL(path)
            break
        except OSError as exc:
            errors.append("%s: %s" % (path, exc))
    else:
        raise MXNetError("mx.rtc: libnvrtc not found (looked under "
                         "$CUDA_HOME/lib64, /usr/local/cuda/lib64, the "
                         "nvidia-cuda-nvrtc wheel and the loader path)%s"
                         % ("".join("\n  " + e for e in errors)))
    p, sz = ctypes.c_void_p, ctypes.c_size_t
    pp = ctypes.POINTER(ctypes.c_char_p)
    lib.nvrtcCreateProgram.argtypes = [ctypes.POINTER(p), ctypes.c_char_p,
                                       ctypes.c_char_p, ctypes.c_int, pp, pp]
    lib.nvrtcCompileProgram.argtypes = [p, ctypes.c_int, pp]
    lib.nvrtcAddNameExpression.argtypes = [p, ctypes.c_char_p]
    lib.nvrtcGetLoweredName.argtypes = [p, ctypes.c_char_p, pp]
    lib.nvrtcGetProgramLogSize.argtypes = [p, ctypes.POINTER(sz)]
    lib.nvrtcGetProgramLog.argtypes = [p, ctypes.c_char_p]
    lib.nvrtcGetCUBINSize.argtypes = [p, ctypes.POINTER(sz)]
    lib.nvrtcGetCUBIN.argtypes = [p, ctypes.c_char_p]
    lib.nvrtcDestroyProgram.argtypes = [ctypes.POINTER(p)]
    lib.nvrtcVersion.argtypes = [ctypes.POINTER(ctypes.c_int)] * 2
    for fn in ("nvrtcVersion", "nvrtcCreateProgram", "nvrtcCompileProgram",
               "nvrtcAddNameExpression", "nvrtcGetLoweredName",
               "nvrtcGetProgramLogSize", "nvrtcGetProgramLog",
               "nvrtcGetCUBINSize", "nvrtcGetCUBIN", "nvrtcDestroyProgram"):
        getattr(lib, fn).restype = ctypes.c_int       # nvrtcResult
    lib.nvrtcGetErrorString.argtypes = [ctypes.c_int]
    lib.nvrtcGetErrorString.restype = ctypes.c_char_p
    _libs["nvrtc"] = lib
    return lib


def nvrtc_version():
    """NVRTC's ``nvrtcVersion`` as ``"major.minor"`` (part of the compile
    cache's version tag)."""
    lib = _nvrtc()
    major, minor = ctypes.c_int(), ctypes.c_int()
    _nvrtc_check(lib, lib.nvrtcVersion(ctypes.byref(major),
                                       ctypes.byref(minor)), "nvrtcVersion")
    return "%d.%d" % (major.value, minor.value)


def _cuda():
    lib = _libs.get("cuda")
    if lib is not None:
        return lib
    try:
        lib = ctypes.CDLL("libcuda.so.1")
    except OSError as exc:
        raise MXNetError("mx.rtc: the CUDA driver (libcuda.so.1) cannot "
                         "be loaded: %s" % exc)
    p, u = ctypes.c_void_p, ctypes.c_uint
    lib.cuInit.argtypes = [u]
    lib.cuDeviceGet.argtypes = [ctypes.POINTER(ctypes.c_int), ctypes.c_int]
    lib.cuDevicePrimaryCtxRetain.argtypes = [ctypes.POINTER(p),
                                             ctypes.c_int]
    lib.cuCtxPushCurrent_v2.argtypes = [p]
    lib.cuCtxPopCurrent_v2.argtypes = [ctypes.POINTER(p)]
    lib.cuCtxGetCurrent.argtypes = [ctypes.POINTER(p)]
    lib.cuModuleLoadData.argtypes = [ctypes.POINTER(p), ctypes.c_char_p]
    lib.cuModuleGetFunction.argtypes = [ctypes.POINTER(p), p,
                                        ctypes.c_char_p]
    lib.cuFuncSetAttribute.argtypes = [p, ctypes.c_int, ctypes.c_int]
    lib.cuLaunchKernel.argtypes = [p, u, u, u, u, u, u, u, p, p, p]
    lib.cuGetErrorName.argtypes = [ctypes.c_int,
                                   ctypes.POINTER(ctypes.c_char_p)]
    for fn in ("cuInit", "cuDeviceGet", "cuDevicePrimaryCtxRetain",
               "cuCtxPushCurrent_v2", "cuCtxPopCurrent_v2",
               "cuCtxGetCurrent", "cuModuleLoadData", "cuModuleGetFunction",
               "cuFuncSetAttribute", "cuLaunchKernel", "cuGetErrorName"):
        getattr(lib, fn).restype = ctypes.c_int       # CUresult
    _libs["cuda"] = lib
    return lib


def _nvrtc_check(lib, rc, what):
    if rc != 0:
        raise MXNetError("mx.rtc: %s failed: %s"
                         % (what, lib.nvrtcGetErrorString(rc).decode()))


def _cu_check(rc, what):
    if rc != 0:
        name = ctypes.c_char_p()
        _cuda().cuGetErrorName(rc, ctypes.byref(name))
        raise MXNetError("mx.rtc: %s failed: %s (CUresult %d)"
                         % (what, (name.value or b"?").decode(), rc))


_primary_ctx = {}          # device index -> primary context handle


def _primary(index):
    """The handle of device ``index``'s primary context (the one torch's
    runtime uses), retained at the first call."""
    ctx = _primary_ctx.get(index)
    if ctx is None:
        with _lock:
            ctx = _primary_ctx.get(index)
            if ctx is None:
                cu = _cuda()
                _cu_check(cu.cuInit(0), "cuInit")
                dev = ctypes.c_int()
                _cu_check(cu.cuDeviceGet(ctypes.byref(dev), index),
                          "cuDeviceGet")
                handle = ctypes.c_void_p()
                _cu_check(cu.cuDevicePrimaryCtxRetain(
                    ctypes.byref(handle), dev), "cuDevicePrimaryCtxRetain")
                ctx = _primary_ctx[index] = handle.value
    return ctx


@contextlib.contextmanager
def _pushed(index):
    """Device ``index``'s primary context pushed on this thread for a
    ``with`` (loading a module, looking up a function: off the launch
    path, which pushes it only where it is not current)."""
    cu = _cuda()
    _cu_check(cu.cuCtxPushCurrent_v2(_primary(index)), "cuCtxPushCurrent")
    try:
        yield
    finally:
        cu.cuCtxPopCurrent_v2(ctypes.byref(ctypes.c_void_p()))


def _compile(source, options, names, name):
    """NVRTC: ``source`` -> (cubin bytes, {name expression: lowered})."""
    lib = _nvrtc()
    prog = ctypes.c_void_p()
    _nvrtc_check(lib, lib.nvrtcCreateProgram(
        ctypes.byref(prog), source.encode(), name.encode(), 0, None, None),
        "nvrtcCreateProgram")
    try:
        for n in names:
            _nvrtc_check(lib, lib.nvrtcAddNameExpression(prog, n.encode()),
                         "nvrtcAddNameExpression(%r)" % n)
        opts = (ctypes.c_char_p * len(options))(
            *[o.encode() for o in options])
        rc = lib.nvrtcCompileProgram(prog, len(options), opts)
        size = ctypes.c_size_t()
        lib.nvrtcGetProgramLogSize(prog, ctypes.byref(size))
        log = ctypes.create_string_buffer(size.value)
        lib.nvrtcGetProgramLog(prog, log)
        if rc != 0:
            raise MXNetError(
                "mx.rtc: NVRTC failed to compile %s (%s), options %s:\n%s"
                % (name, lib.nvrtcGetErrorString(rc).decode(),
                   " ".join(options), log.value.decode(errors="replace")))
        lowered = {}
        for n in names:
            out = ctypes.c_char_p()
            _nvrtc_check(lib, lib.nvrtcGetLoweredName(
                prog, n.encode(), ctypes.byref(out)),
                "nvrtcGetLoweredName(%r)" % n)
            lowered[n] = out.value.decode()
        _nvrtc_check(lib, lib.nvrtcGetCUBINSize(prog, ctypes.byref(size)),
                     "nvrtcGetCUBINSize")
        cubin = ctypes.create_string_buffer(size.value)
        _nvrtc_check(lib, lib.nvrtcGetCUBIN(prog, cubin), "nvrtcGetCUBIN")
        return cubin.raw, lowered
    finally:
        lib.nvrtcDestroyProgram(ctypes.byref(prog))


def _arch(index):
    major, minor = torch.cuda.get_device_capability(index)
    # sm_90a: the Hopper features (wgmma, setmaxnreg) exist only there
    return "sm_%d%d%s" % (major, minor, "a" if (major, minor) == (9, 0)
                          else "")


class CudaModule:
    """Compile CUDA C ``source`` at run time (reference: python/mxnet/
    rtc.py:42). ``options`` are NVRTC flags (an architecture flag of the
    caller's replaces the card's own); ``exports`` are name expressions
    of kernels to reach, required for templated ones."""

    def __init__(self, source, options=(), exports=()):
        self._source = source
        self._options = tuple(str(o) for o in options)
        self._exports = tuple(str(e) for e in exports)
        self._names = _kernel_names(source)
        for name in self._exports:
            if name.split("<")[0].strip() not in self._names:
                raise MXNetError(
                    "rtc source does not define exported name %r" % name)
        # name expressions compiled in: every non-templated kernel, and
        # the exports
        self._exprs = tuple(sorted(
            {n for n, templated in self._names.items() if not templated}
            | set(self._exports)))
        digest = hashlib.sha256()
        for part in (source,) + self._options + ("exports",) \
                + self._exports:
            digest.update(part.encode())
            digest.update(b"\0")
        self._key = digest.hexdigest()
        self._loaded = {}      # device index -> (CUmodule, {name: CUfunc})
        self._lock = threading.Lock()
        self.compile_seconds = None   # of the first launch's compile/load
        self.from_cache = None        # whether it came from the disk cache

    def get_kernel(self, name, signature):
        """The kernel ``name`` with MXNet's ``signature`` grammar
        (reference: rtc.py get_kernel)."""
        if name not in self._exprs:
            templated = self._names.get(name.split("<")[0].strip())
            raise MXNetError(
                "rtc module has no kernel function %r%s" % (
                    name, " — a templated kernel is reached through "
                    "exports=" if templated else ""))
        is_ndarray, is_const, dtypes = [], [], []
        for arg in re.sub(r"\s+", " ", signature).split(","):
            m = _SIG_RE.match(arg)
            if not m or m.groups()[1] == "const":
                raise ValueError(
                    'Invalid function prototype "%s". Must be in the '
                    'form of "(const) type (*) (name)"' % arg)
            is_const.append(bool(m.groups()[0]))
            dtype = m.groups()[1]
            is_ndarray.append(bool(m.groups()[2]))
            if dtype not in _DTYPE_TO_TORCH:
                raise TypeError(
                    "Unsupported kernel argument type %s. Supported: %s"
                    % (arg, ", ".join(sorted(_DTYPE_TO_TORCH))))
            dtypes.append(_DTYPE_TO_TORCH[dtype])
        return CudaKernel(self, name, is_ndarray, is_const, dtypes)

    def _options_for(self, arch):
        if any(o.startswith(("-arch", "--gpu-architecture"))
               for o in self._options):
            return self._options
        return ("--gpu-architecture=%s" % arch,) + self._options

    def _function(self, index, name):
        """The CUfunction of ``name`` on device ``index``, compiling (or
        reading the disk cache) and loading at the first call."""
        entry = self._loaded.get(index)
        if entry is None:
            with self._lock:
                entry = self._loaded.get(index)
                if entry is None:
                    entry = self._load(index)
                    self._loaded[index] = entry
        module, funcs = entry
        fn = funcs.get(name)
        if fn is None:
            fn = ctypes.c_void_p()
            with _pushed(index):
                _cu_check(_cuda().cuModuleGetFunction(
                    ctypes.byref(fn), module,
                    self._lowered[name].encode()),
                    "cuModuleGetFunction(%r)" % name)
            funcs[name] = fn
        return fn

    def _load(self, index):
        t0 = time.perf_counter()
        arch = _arch(index)
        if compile_cache.maybe_enable():
            cubin = self._through_cache(arch)
        else:
            cubin = self._through_build_dir(arch)
        module = ctypes.c_void_p()
        with _pushed(index):
            _cu_check(_cuda().cuModuleLoadData(ctypes.byref(module), cubin),
                      "cuModuleLoadData")
        self.compile_seconds = time.perf_counter() - t0
        return module, {}

    def _through_cache(self, arch):
        """The cubin for ``arch`` from the compile cache, or compiled and
        queued for it."""
        options = self._options_for(arch)
        key = compile_cache.entry_key("nvrtc", (options, self._exports),
                                      self._key, arch)
        payload = compile_cache.lookup(key)
        self.from_cache = payload is not None
        if self.from_cache:
            lowered, cubin = compile_cache.unpack_parts(payload)
            self._lowered = json.loads(lowered.decode())
            return cubin
        cubin, self._lowered = _compile(self._source, options, self._exprs,
                                        "mx_rtc_%s.cu" % self._key[:16])
        compile_cache.store(key, compile_cache.pack_parts(
            json.dumps(self._lowered).encode(), cubin))
        return cubin

    def _through_build_dir(self, arch):
        """The cubin for ``arch`` from ``_build/rtc/``, or compiled and
        written there."""
        path = os.path.join(_OUT, "%s-%s" % (self._key[:16], arch))
        if os.path.exists(path + ".cubin") and os.path.exists(
                path + ".json"):
            with open(path + ".cubin", "rb") as f:
                cubin = f.read()
            with open(path + ".json") as f:
                self._lowered = json.load(f)
            self.from_cache = True
        else:
            cubin, self._lowered = _compile(
                self._source, self._options_for(arch), self._exprs,
                "mx_rtc_%s.cu" % self._key[:16])
            os.makedirs(_OUT, exist_ok=True)
            for ext, data, mode in ((".cubin", cubin, "wb"),
                                    (".json", json.dumps(self._lowered),
                                     "w")):
                tmp = "%s%s.tmp%d" % (path, ext, os.getpid())
                with open(tmp, mode) as f:
                    f.write(data)
                os.replace(tmp, path + ext)
            self.from_cache = False
        return cubin


class CudaKernel:
    """A launchable kernel; create it with :meth:`CudaModule.get_kernel`
    (reference: rtc.py CudaKernel)."""

    def __init__(self, module, name, is_ndarray, is_const, dtypes):
        self._module = module
        self._name = name
        self._is_ndarray = is_ndarray
        self._is_const = is_const
        self._dtypes = dtypes
        # per argument: array?, const?, dtype, the scalar's encoder
        self._spec = tuple(zip(is_ndarray, is_const, dtypes,
                               (_ENCODE[dt] for dt in dtypes)))
        self._arrays = tuple(i for i, nd in enumerate(is_ndarray) if nd)
        self._writable = any(nd and not c
                             for nd, c in zip(is_ndarray, is_const))
        self._plans = {}           # device index -> _Plan

    def launch(self, args, ctx, grid_dims, block_dims, shared_mem=0):
        """Launch the kernel on ``ctx`` (a GPU context). Arrays marked
        const are inputs; other arrays are in-out and receive the
        kernel's writes (reference: CudaKernel.launch)."""
        grid, block, shared_mem = self._check(args, grid_dims, block_dims,
                                              shared_mem)
        ctx = ctx if ctx is not None else current_context()
        if ctx.device_type != "gpu":
            raise MXNetError(
                "mx.rtc kernels run on a GPU context, got %s (there is "
                "no CPU runner)" % ctx)
        index = ctx.device_id
        plan = self._plans.get(index)
        if plan is None:
            ctx.torch_device()     # raises where the device is not visible
        for i in self._arrays:
            if args[i]._data.get_device() != index:
                raise MXNetError("argument %d of %s is on %s, the launch "
                                 "context is %s" % (i, self._name,
                                                    args[i].context, ctx))
        if plan is None:
            plan = self._plan(index)
        stream = _raw_stream(index)
        # temporaries stay referenced until the launch is enqueued: the
        # allocator would otherwise hand a freed one's memory to the next
        temps, writeback = plan.launch(args, grid, block, shared_mem, stream,
                                       self._name)
        launches["rtc"] += 1
        if writeback:
            with torch.no_grad():
                for arr, t in writeback:
                    arr._data.copy_(t)
        del temps            # freed in stream order, after the kernel

    def _check(self, args, grid_dims, block_dims, shared_mem):
        """The checks that come before the device's, in the JAX package's
        order; returns the grid, the block and the shared memory as
        ints."""
        if len(grid_dims) != 3 or len(block_dims) != 3:
            raise ValueError(
                "grid_dims/block_dims must be tuples of 3 integers")
        grid = (int(grid_dims[0]), int(grid_dims[1]), int(grid_dims[2]))
        block = (int(block_dims[0]), int(block_dims[1]), int(block_dims[2]))
        if min(grid + block) < 1:
            raise MXNetError("grid_dims %s and block_dims %s must be >= 1"
                             % (grid, block))
        if block[0] * block[1] * block[2] > _MAX_THREADS \
                or block[0] > _MAX_BLOCK[0] or block[1] > _MAX_BLOCK[1] \
                or block[2] > _MAX_BLOCK[2]:
            raise MXNetError(
                "block_dims %s: a block holds at most %d threads, at most "
                "%s along x, y, z" % (block, _MAX_THREADS, _MAX_BLOCK))
        shared_mem = int(shared_mem)
        if shared_mem < 0:
            raise MXNetError("shared_mem must be >= 0, got %d" % shared_mem)
        if len(args) != len(self._spec):
            raise MXNetError(
                "CudaKernel(%s) expects %d arguments but got %d"
                % (self._name, len(self._spec), len(args)))
        for i in self._arrays:
            if not isinstance(args[i], NDArray):
                raise MXNetError("argument %d of %s must be an NDArray"
                                 % (i, self._name))
        if not self._writable:
            raise MXNetError(
                "kernel %s has no writable (non-const) array argument"
                % self._name)
        return grid, block, shared_mem

    def _plan(self, index):
        """The launch plan on device ``index``, built at the first launch
        there (compiling or reading the disk cache, and loading)."""
        fn = self._module._function(index, self._name)
        ctx = _primary(index)
        with _lock:
            plan = self._plans.get(index)
            if plan is None:
                plan = self._plans[index] = _Plan(self._spec, fn, ctx)
        return plan


class _Plan:
    """What every launch of one kernel on one device shares, built once:
    the CUfunction, one ctypes slot per argument of the argument's C type
    (an array's as ``c_void_p``), the ``void*[]`` array that points at
    the slots, the primary context, and the dynamic shared memory the
    function has been allowed. A launch writes its arguments into the
    slots in place and hands the driver the same array each time, under
    the plan's lock: the driver reads the slots inside cuLaunchKernel,
    which releases the interpreter lock."""

    def __init__(self, spec, fn=None, ctx=None):
        self.fn = fn
        self.slots = [ctypes.c_void_p() if nd else _CTYPES[dt]()
                      for nd, _, dt, _ in spec]
        self.params = (ctypes.c_void_p * max(1, len(self.slots)))(
            *[ctypes.addressof(s) for s in self.slots])
        # (slot, argument index, encoder) of each scalar, (slot, argument
        # index, const?, dtype) of each array
        self.scalars = [(self.slots[i], i, encode)
                        for i, (nd, _, _, encode) in enumerate(spec)
                        if not nd]
        self.arrays = [(self.slots[i], i, const, dt)
                       for i, (nd, const, dt, _) in enumerate(spec) if nd]
        self.ctx = ctx
        self.cur = ctypes.c_void_p()       # the thread's current context
        self.cur_ref = ctypes.pointer(self.cur)
        self.smem = _DEFAULT_SMEM
        self.lock = threading.Lock()

    def pack(self, args):
        """Write ``args`` into the slots: a scalar as its C type's bits, an
        array as its data pointer. An array whose dtype or layout differs
        from the signature's goes through a contiguous temporary of the
        signature's dtype. Returns the temporaries, which must stay
        referenced until the launch is queued, and the (array, temporary)
        pairs of in-out arrays to write back."""
        temps, writeback = [], []
        for slot, i, encode in self.scalars:
            slot.value = encode(args[i])
        for slot, i, const, dt in self.arrays:
            t = args[i]._data
            if t.dtype is not dt or not t.is_contiguous():
                t = t.detach().to(dt).contiguous()
                temps.append(t)
                if not const:
                    writeback.append((args[i], t))
            slot.value = t.data_ptr()
        return temps, writeback

    def launch(self, args, grid, block, shared_mem, stream, name):
        """Pack ``args`` and launch on ``stream``: one cuLaunchKernel,
        after raising the function's dynamic shared memory where this
        launch asks for more than it has. The primary context is pushed,
        and popped after, only where it is not current on this thread
        (torch's runtime makes it current on a thread that has used the
        device). Returns what :meth:`pack` returns."""
        cu = _libs["cuda"]
        with self.lock:
            temps, writeback = self.pack(args)
            cu.cuCtxGetCurrent(self.cur_ref)
            pushed = self.cur.value != self.ctx
            if pushed:
                _cu_check(cu.cuCtxPushCurrent_v2(self.ctx),
                          "cuCtxPushCurrent")
            try:
                if shared_mem > self.smem:
                    _cu_check(cu.cuFuncSetAttribute(
                        self.fn,
                        _CU_FUNC_ATTRIBUTE_MAX_DYNAMIC_SHARED_SIZE_BYTES,
                        shared_mem), "raising %s's dynamic shared memory to"
                        " %d bytes" % (name, shared_mem))
                    self.smem = shared_mem
                rc = cu.cuLaunchKernel(self.fn, grid[0], grid[1], grid[2],
                                       block[0], block[1], block[2],
                                       shared_mem, stream, self.params, None)
            finally:
                if pushed:
                    cu.cuCtxPopCurrent_v2(self.cur_ref)
        if rc:
            _cu_check(rc, "cuLaunchKernel(%s)" % name)
        return temps, writeback


def _f32_bits(value):
    """The bits of ``value`` rounded to float32 as C rounds a double (to
    nearest even; ±inf beyond float32's range)."""
    return ctypes.c_uint32.from_buffer(ctypes.c_float(value)).value


def _rne(m, s):
    """``m >> s`` rounded to nearest, ties to even."""
    q = m >> s
    r, half = m - (q << s), 1 << (s - 1)
    return q + (r > half or (r == half and q & 1))


def _half_bits(value):
    """The float16 bits of ``value`` as torch makes them from a Python
    float: rounded to float32, then to nearest even (NaN: the sign and
    0x7E00)."""
    f = _f32_bits(float(value))
    sign, a = (f >> 16) & 0x8000, f & 0x7FFFFFFF
    if a > 0x7F800000:
        return sign | 0x7E00
    if a >= 0x477FF000:          # 65520 and above round to inf
        return sign | 0x7C00
    if a >= 0x38800000:          # normal: exponent bias 127 -> 15
        return sign | _rne(a - 0x38000000, 13)
    if a < 0x33000000:           # below 2^-25: to zero
        return sign
    # subnormal: the significand in units of 2^-24
    return sign | _rne((a & 0x7FFFFF) | 0x800000, 126 - (a >> 23))


def _bf16_bits(value):
    """The bfloat16 bits of ``value`` as torch makes them from a Python
    float: rounded to float32, then to nearest even (NaN: 0x7FC0)."""
    f = _f32_bits(float(value))
    if f & 0x7FFFFFFF > 0x7F800000:
        return 0x7FC0
    return (f + 0x7FFF + ((f >> 16) & 1)) >> 16


# scalar arguments: what each dtype's slot is given
_ENCODE = {dt: (float if dt.is_floating_point else int)
           for dt in _CTYPES}
_ENCODE[torch.float16] = _half_bits
_ENCODE[torch.bfloat16] = _bf16_bits
