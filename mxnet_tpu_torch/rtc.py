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
  options and the exports. The cubin is loaded with the driver API
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
- **GPU only**: a CPU context, or an array on another device than the
  context's, raises MXNetError. There is no CPU runner and no fallback.

:data:`launches` counts kernel launches.
"""
from __future__ import annotations

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

from .base import MXNetError

__all__ = ["CudaModule", "CudaKernel", "launches", "reset_launches"]

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
    for fn in ("nvrtcCreateProgram", "nvrtcCompileProgram",
               "nvrtcAddNameExpression", "nvrtcGetLoweredName",
               "nvrtcGetProgramLogSize", "nvrtcGetProgramLog",
               "nvrtcGetCUBINSize", "nvrtcGetCUBIN", "nvrtcDestroyProgram"):
        getattr(lib, fn).restype = ctypes.c_int       # nvrtcResult
    lib.nvrtcGetErrorString.argtypes = [ctypes.c_int]
    lib.nvrtcGetErrorString.restype = ctypes.c_char_p
    _libs["nvrtc"] = lib
    return lib


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
    lib.cuModuleLoadData.argtypes = [ctypes.POINTER(p), ctypes.c_char_p]
    lib.cuModuleGetFunction.argtypes = [ctypes.POINTER(p), p,
                                        ctypes.c_char_p]
    lib.cuFuncSetAttribute.argtypes = [p, ctypes.c_int, ctypes.c_int]
    lib.cuLaunchKernel.argtypes = [p, u, u, u, u, u, u, u, p, p, p]
    lib.cuGetErrorName.argtypes = [ctypes.c_int,
                                   ctypes.POINTER(ctypes.c_char_p)]
    for fn in ("cuInit", "cuDeviceGet", "cuDevicePrimaryCtxRetain",
               "cuCtxPushCurrent_v2", "cuCtxPopCurrent_v2",
               "cuModuleLoadData", "cuModuleGetFunction",
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


class _Context:
    """The device's primary context (the one torch's runtime uses) made
    current on this thread for the duration of a ``with``."""

    _ctx = {}

    def __init__(self, index):
        self.index = index

    def __enter__(self):
        cu = _cuda()
        ctx = _Context._ctx.get(self.index)
        if ctx is None:
            with _lock:
                ctx = _Context._ctx.get(self.index)
                if ctx is None:
                    _cu_check(cu.cuInit(0), "cuInit")
                    dev = ctypes.c_int()
                    _cu_check(cu.cuDeviceGet(ctypes.byref(dev), self.index),
                              "cuDeviceGet")
                    ctx = ctypes.c_void_p()
                    _cu_check(cu.cuDevicePrimaryCtxRetain(
                        ctypes.byref(ctx), dev), "cuDevicePrimaryCtxRetain")
                    _Context._ctx[self.index] = ctx
        _cu_check(cu.cuCtxPushCurrent_v2(ctx), "cuCtxPushCurrent")
        return self

    def __exit__(self, *exc):
        _cuda().cuCtxPopCurrent_v2(ctypes.byref(ctypes.c_void_p()))
        return False


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
            with _Context(index):
                _cu_check(_cuda().cuModuleGetFunction(
                    ctypes.byref(fn), module,
                    self._lowered[name].encode()),
                    "cuModuleGetFunction(%r)" % name)
            funcs[name] = fn
        return fn

    def _load(self, index):
        t0 = time.perf_counter()
        arch = _arch(index)
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
        module = ctypes.c_void_p()
        with _Context(index):
            _cu_check(_cuda().cuModuleLoadData(ctypes.byref(module), cubin),
                      "cuModuleLoadData")
        self.compile_seconds = time.perf_counter() - t0
        return module, {}


class CudaKernel:
    """A launchable kernel; create it with :meth:`CudaModule.get_kernel`
    (reference: rtc.py CudaKernel)."""

    def __init__(self, module, name, is_ndarray, is_const, dtypes):
        self._module = module
        self._name = name
        self._is_ndarray = is_ndarray
        self._is_const = is_const
        self._dtypes = dtypes

    def launch(self, args, ctx, grid_dims, block_dims, shared_mem=0):
        """Launch the kernel on ``ctx`` (a GPU context). Arrays marked
        const are inputs; other arrays are in-out and receive the
        kernel's writes (reference: CudaKernel.launch)."""
        from .context import current_context
        from .ndarray import NDArray

        if len(grid_dims) != 3 or len(block_dims) != 3:
            raise ValueError(
                "grid_dims/block_dims must be tuples of 3 integers")
        grid = tuple(int(g) for g in grid_dims)
        block = tuple(int(b) for b in block_dims)
        if min(grid + block) < 1:
            raise MXNetError("grid_dims %s and block_dims %s must be >= 1"
                             % (grid, block))
        if block[0] * block[1] * block[2] > _MAX_THREADS or any(
                b > m for b, m in zip(block, _MAX_BLOCK)):
            raise MXNetError(
                "block_dims %s: a block holds at most %d threads, at most "
                "%s along x, y, z" % (block, _MAX_THREADS, _MAX_BLOCK))
        shared_mem = int(shared_mem)
        if shared_mem < 0:
            raise MXNetError("shared_mem must be >= 0, got %d" % shared_mem)
        if len(args) != len(self._dtypes):
            raise MXNetError(
                "CudaKernel(%s) expects %d arguments but got %d"
                % (self._name, len(self._dtypes), len(args)))
        for i, (arg, is_nd) in enumerate(zip(args, self._is_ndarray)):
            if is_nd and not isinstance(arg, NDArray):
                raise MXNetError("argument %d of %s must be an NDArray"
                                 % (i, self._name))
        if not any(nd and not c for nd, c in zip(self._is_ndarray,
                                                  self._is_const)):
            raise MXNetError(
                "kernel %s has no writable (non-const) array argument"
                % self._name)

        ctx = ctx if ctx is not None else current_context()
        if ctx.device_type != "gpu":
            raise MXNetError(
                "mx.rtc kernels run on a GPU context, got %s (there is "
                "no CPU runner)" % ctx)
        dev = ctx.torch_device()
        # temporaries stay referenced until the launch is enqueued: the
        # allocator would otherwise hand a freed one's memory to the next
        values, temps, writeback = [], [], []
        for i, (arg, is_nd, const, dt) in enumerate(
                zip(args, self._is_ndarray, self._is_const, self._dtypes)):
            if not is_nd:
                values.append(_scalar(arg, dt))
                continue
            t = arg._data
            if t.device != dev:
                raise MXNetError("argument %d of %s is on %s, the launch "
                                 "context is %s" % (i, self._name,
                                                    arg.context, ctx))
            if t.dtype != dt or not t.is_contiguous():
                t = t.detach().to(dt).contiguous()
                temps.append(t)
                if not const:
                    writeback.append((arg, t))
            values.append(ctypes.c_void_p(t.data_ptr()))

        fn = self._module._function(dev.index, self._name)
        params = (ctypes.c_void_p * max(1, len(values)))()
        for i, v in enumerate(values):
            params[i] = ctypes.cast(ctypes.pointer(v), ctypes.c_void_p)
        cu = _cuda()
        stream = torch.cuda.current_stream(dev).cuda_stream
        with _Context(dev.index):
            if shared_mem > _DEFAULT_SMEM:
                _cu_check(cu.cuFuncSetAttribute(
                    fn, _CU_FUNC_ATTRIBUTE_MAX_DYNAMIC_SHARED_SIZE_BYTES,
                    shared_mem), "raising %s's dynamic shared memory to %d "
                    "bytes" % (self._name, shared_mem))
            _cu_check(cu.cuLaunchKernel(fn, grid[0], grid[1], grid[2],
                                        block[0], block[1], block[2],
                                        shared_mem, stream, params, None),
                      "cuLaunchKernel(%s)" % self._name)
        launches["rtc"] += 1
        with torch.no_grad():
            for arr, t in writeback:
                arr._data.copy_(t)
        del temps            # freed in stream order, after the kernel


def _scalar(value, dtype):
    """``value`` as the ctypes object of the signature's C type."""
    if dtype in (torch.float16, torch.bfloat16):
        bits = torch.tensor(float(value), dtype=dtype).view(torch.int16)
        return ctypes.c_uint16(int(bits) & 0xFFFF)
    if dtype.is_floating_point:
        return _CTYPES[dtype](float(value))
    return _CTYPES[dtype](int(value))
