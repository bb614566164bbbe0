"""Port parity: mxnet_tpu_torch.rtc against the JAX package's mx.rtc, on
the CPU.

Everything here runs without a compiler or a card: the signature grammar
(held to ``mxnet_tpu.rtc.PallasModule.get_kernel``), the kernel names
read from the source's ``__global__`` declarations, the launch checks
that come before the device check (in the JAX package's order), and the
device check itself; the launch plan's argument packing, its reuse
across launches and threads against a stand-in for the driver, and the
half and bfloat16 scalar encodings against torch's. Compiling and
launching run only on a card: chip_smoke.py holds four CUDA kernels
launched through ``mx.rtc`` to their torch expressions there."""
import ctypes
import sys
import threading
import time

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import MXNetError

# the kernels of tests/test_rtc.py, in CUDA C
CUDA_SRC = r"""
extern "C" __global__ void axpy(float alpha, const float *x, float *y) {
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    y[i] += alpha * x[i];
}

extern "C" __global__ void scale_rows(const float *x, float *out) {
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    out[i] = x[i] * (blockIdx.x + 1);
}
"""
# a Python source for PallasModule whose kernel takes any signature
PALLAS_SRC = "def k(*refs):\n    pass\n"
CUDA_K = 'extern "C" __global__ void k(float *x) {}\n'

TYPES = sorted(jmx.rtc._DTYPE_TO_NP)


def _parse(sig):
    j = jmx.rtc.PallasModule(PALLAS_SRC).get_kernel("k", sig)
    t = tmx.rtc.CudaModule(CUDA_K).get_kernel("k", sig)
    return j, t


@pytest.mark.parametrize("ctype", TYPES)
def test_signature_parses_like_jax(ctype):
    """Every type, named and unnamed, const and not, array and scalar."""
    sig = ("{t} alpha, const {t} *x, {t} *y, {t}, const {t}*, {t}*out,"
           "  const   {t}   *  z ").format(t=ctype)
    j, t = _parse(sig)
    assert t._is_const == j._is_const
    assert t._is_ndarray == j._is_ndarray
    assert [str(d).replace("torch.", "") for d in t._dtypes] \
        == [np.dtype(d).name for d in j._dtypes]


@pytest.mark.parametrize("sig,exc", [
    ("const const *x", ValueError),
    ("float x y", ValueError),
    ("float *x, ", ValueError),
    ("quaternion *x", TypeError),
    ("float a, half *x", TypeError),
], ids=["const_const", "two_names", "trailing_comma", "unknown_type",
        "unknown_second"])
def test_bad_signatures_raise_like_jax(sig, exc):
    with pytest.raises(exc):
        jmx.rtc.PallasModule(PALLAS_SRC).get_kernel("k", sig)
    with pytest.raises(exc):
        tmx.rtc.CudaModule(CUDA_K).get_kernel("k", sig)


def test_missing_kernel_raises_like_jax():
    with pytest.raises(jmx.base.MXNetError):
        jmx.rtc.PallasModule(PALLAS_SRC).get_kernel("missing", "float *x")
    with pytest.raises(MXNetError, match="no kernel function 'missing'"):
        tmx.rtc.CudaModule(CUDA_SRC).get_kernel("missing", "float *x")


def test_kernel_names_come_from_global_declarations():
    src = CUDA_SRC + r"""
// __global__ void in_a_comment(float *x) {}
/* __global__ void in_a_block_comment(float *x) {} */
__global__ void __launch_bounds__(256) row_sum(const float *x, float *out,
                                               int n) {}
static __global__ void cxx_linkage(int *a) {}
template <typename T, int N>
__global__ void templated(T *x) {}
__device__ float helper(float x) { return x; }
"""
    assert tmx.rtc._kernel_names(src) == {
        "axpy": False, "scale_rows": False, "row_sum": False,
        "cxx_linkage": False, "templated": True}
    mod = tmx.rtc.CudaModule(src, exports=("templated<float, 4>",))
    for name in ("axpy", "row_sum", "cxx_linkage", "templated<float, 4>"):
        mod.get_kernel(name, "float *x")
    with pytest.raises(MXNetError, match="exports="):
        tmx.rtc.CudaModule(src).get_kernel("templated", "float *x")
    for name in ("helper", "in_a_comment", "in_a_block_comment"):
        with pytest.raises(MXNetError, match="no kernel function"):
            mod.get_kernel(name, "float *x")


def test_missing_export_raises_like_jax():
    with pytest.raises(jmx.base.MXNetError, match="exported name"):
        jmx.rtc.PallasModule(PALLAS_SRC, exports=("nope",))
    with pytest.raises(MXNetError, match="exported name 'nope<int>'"):
        tmx.rtc.CudaModule(CUDA_SRC, exports=("nope<int>",))


def test_cache_key_follows_source_options_and_exports():
    base = tmx.rtc.CudaModule(CUDA_SRC)._key
    assert tmx.rtc.CudaModule(CUDA_SRC)._key == base
    assert tmx.rtc.CudaModule(CUDA_SRC, options=("-DN=1",))._key != base
    assert tmx.rtc.CudaModule(CUDA_SRC, options=("-DN=2",))._key \
        != tmx.rtc.CudaModule(CUDA_SRC, options=("-DN=1",))._key
    assert tmx.rtc.CudaModule(CUDA_SRC + " ")._key != base
    assert tmx.rtc.CudaModule(CUDA_SRC, exports=("axpy",))._key != base


def _axpy(mx, sig="float alpha, const float *x, float *y"):
    src = CUDA_SRC if mx is tmx else \
        "def axpy(alpha, x_ref, y_ref):\n    y_ref[...] += alpha * x_ref[...]\n"
    mod = mx.rtc.CudaModule(src)
    x = mx.nd.ones((2,), ctx=mx.cpu())
    y = mx.nd.ones((2,), ctx=mx.cpu())
    return mod.get_kernel("axpy", sig), x, y


@pytest.mark.parametrize("case", ["grid_2", "block_2", "expects_3",
                                  "no_writable", "not_ndarray"])
def test_launch_validation_like_jax(case):
    """The checks of tests/test_rtc.py that carry over raise the same
    exception type, with the same message, in both packages."""
    for mx in (jmx, tmx):
        err = mx.base.MXNetError
        if case == "no_writable":
            k, x, y = _axpy(mx, "float a, const float *x, const float *y")
        else:
            k, x, y = _axpy(mx)
        launch = {
            "grid_2": lambda: k.launch((1.0, x, y), mx.cpu(), (1, 1),
                                       (1, 1, 1)),
            "block_2": lambda: k.launch((1.0, x, y), mx.cpu(), (1, 1, 1),
                                        (1, 1)),
            "expects_3": lambda: k.launch((x, y), mx.cpu(), (1, 1, 1),
                                          (1, 1, 1)),
            "no_writable": lambda: k.launch((1.0, x, y), mx.cpu(),
                                            (1, 1, 1), (1, 1, 1)),
            "not_ndarray": lambda: k.launch((1.0, x, np.ones(2)), mx.cpu(),
                                            (1, 1, 1), (1, 1, 1)),
        }[case]
        exc, match = {"grid_2": (ValueError, "tuples of 3"),
                      "block_2": (ValueError, "tuples of 3"),
                      "expects_3": (err, "expects 3 arguments but got 2"),
                      "no_writable": (err, "no writable"),
                      "not_ndarray": (err, "argument 2 of axpy must be an "
                                           "NDArray")}[case]
        with pytest.raises(exc, match=match):
            launch()


@pytest.mark.parametrize("block", [(1025, 1, 1), (32, 32, 2), (1, 1, 65),
                                   (0, 1, 1)])
def test_block_dims_outside_the_card_raise(block):
    k, x, y = _axpy(tmx)
    with pytest.raises(MXNetError, match="block_dims"):
        k.launch((1.0, x, y), tmx.gpu(0), (1, 1, 1), block)


def test_cpu_context_raises():
    """There is no CPU runner: a CPU context raises before anything
    compiles, and so does a GPU context where no CUDA device is
    visible."""
    k, x, y = _axpy(tmx)
    before = dict(tmx.rtc.launches)
    with pytest.raises(MXNetError, match="GPU context"):
        k.launch((2.0, x, y), tmx.cpu(), (1, 1, 1), (2, 1, 1))
    with pytest.raises(MXNetError, match="GPU context"):
        with tmx.cpu():
            k.launch((2.0, x, y), None, (1, 1, 1), (2, 1, 1))
    np.testing.assert_array_equal(y.asnumpy(), [1.0, 1.0])
    if not torch.cuda.is_available():
        with pytest.raises(MXNetError, match="no CUDA device"):
            k.launch((2.0, x, y), tmx.gpu(0), (1, 1, 1), (2, 1, 1))
    assert tmx.rtc.launches == before
    assert k._module._loaded == {}          # nothing compiled or loaded
    assert k._plans == {}                   # and no launch plan built


def _packed(value, ctype):
    """The slot a scalar ``value`` of C type ``ctype`` is packed into."""
    k = tmx.rtc.CudaModule(CUDA_K).get_kernel("k", "%s a, float *x" % ctype)
    plan = tmx.rtc._Plan(k._spec)
    plan.pack((value, tmx.nd.ones((1,), ctx=tmx.cpu())))
    return plan.slots[0]


def test_scalars_pass_as_their_c_type():
    assert _packed(2.5, "float").value == 2.5
    assert isinstance(_packed(2, "double"), ctypes.c_double)
    assert _packed(-3.7, "int").value == -3
    assert _packed(300, "uint8_t").value == 300 % 256
    half = np.float16(1.5).view(np.uint16)
    assert _packed(1.5, "__half").value == int(half)
    assert _packed(1.5, "bfloat16").value == 0x3FC0
    assert _packed(1, "bool").value is True


@pytest.mark.parametrize("ctype", TYPES)
def test_pack_writes_each_signature_type(ctype):
    """Packing runs without a launch: a scalar's slot holds the bytes
    numpy gives the value in the C type, an array's slot the tensor's
    data pointer, and the argument array points at the slots."""
    np_dtype = np.dtype(jmx.rtc._DTYPE_TO_NP[ctype])
    k = tmx.rtc.CudaModule(CUDA_K).get_kernel(
        "k", "{t} a, const {t} *x, {t} *y".format(t=ctype))
    plan = tmx.rtc._Plan(k._spec)
    value = 1.3 if np_dtype.kind == "f" else 3
    x = tmx.nd.NDArray(torch.ones(4, dtype=k._dtypes[1]))
    y = tmx.nd.NDArray(torch.zeros(4, dtype=k._dtypes[2]))
    temps, writeback = plan.pack((value, x, y))
    assert temps == [] and writeback == []
    assert bytes(plan.slots[0]) == np.array(value, np_dtype).tobytes()
    assert plan.slots[1].value == x._data.data_ptr()
    assert plan.slots[2].value == y._data.data_ptr()
    assert list(plan.params) == [ctypes.addressof(s) for s in plan.slots]


def test_pack_sends_other_dtypes_and_layouts_through_temporaries():
    k = tmx.rtc.CudaModule(CUDA_K).get_kernel(
        "k", "const float *x, double *y, float *z")
    plan = tmx.rtc._Plan(k._spec)
    x = tmx.nd.NDArray(torch.ones(4, dtype=torch.float16))
    y = tmx.nd.NDArray(torch.zeros(4))
    z = tmx.nd.NDArray(torch.zeros(4, 2).t())
    temps, writeback = plan.pack((x, y, z))
    assert [t.dtype for t in temps] == [torch.float32, torch.float64,
                                        torch.float32]
    assert all(t.is_contiguous() for t in temps)
    assert [s.value for s in plan.slots] == [t.data_ptr() for t in temps]
    assert [(a is b, t is c) for (a, t), b, c in
            zip(writeback, (y, z), temps[1:])] == [(True, True)] * 2


class _FakeDriver:
    """The driver calls a launch makes, recorded: what the kernel would
    read through the argument array at cuLaunchKernel, pushes and pops,
    shared-memory raises."""

    def __init__(self, current):
        self.current = current
        self.calls, self.pushes, self.pops, self.smem = [], 0, 0, []

    def cuCtxGetCurrent(self, ref):
        ref.contents.value = self.current

    def cuCtxPushCurrent_v2(self, ctx):
        self.pushes += 1
        return 0

    def cuCtxPopCurrent_v2(self, ref):
        self.pops += 1
        return 0

    def cuFuncSetAttribute(self, fn, attr, value):
        self.smem.append(value)
        return 0

    def cuLaunchKernel(self, fn, gx, gy, gz, bx, by, bz, smem, stream,
                       params, extra):
        self.calls.append(dict(
            params=params, grid=(gx, gy, gz), block=(bx, by, bz),
            stream=stream, alpha=ctypes.c_float.from_address(params[0]).value,
            x=ctypes.c_void_p.from_address(params[1]).value,
            y=ctypes.c_void_p.from_address(params[2]).value))
        return 0


@pytest.mark.parametrize("current", ["primary", "none"])
def test_plan_is_reused_and_its_slots_rewritten(monkeypatch, current):
    """One plan per device serves every launch: each launch rewrites the
    slots that the same argument array points at, raises the shared
    memory only past what it has, and pushes the primary context only
    where it is not current."""
    fake = _FakeDriver(77 if current == "primary" else None)
    monkeypatch.setitem(tmx.rtc._libs, "cuda", fake)
    monkeypatch.setattr(tmx.rtc, "_primary", lambda index: 77)
    k, _, _ = _axpy(tmx)
    monkeypatch.setattr(k._module, "_function", lambda index, name: 1234)
    plan = k._plan(0)
    assert k._plan(0) is plan and k._plans == {0: plan}
    arrays = [tmx.nd.ones((8,), ctx=tmx.cpu()) for _ in range(4)]
    for i, (alpha, smem) in enumerate([(0.5, 0), (2.0, 64 << 10),
                                       (-1.0, 64 << 10), (3.0, 100 << 10)]):
        x, y = arrays[i % 2], arrays[2 + i // 2]
        plan.launch((alpha, x, y), (i + 1, 1, 1), (32, 1, 1), smem, 9, "k")
        call = fake.calls[-1]
        assert call["params"] is plan.params
        assert (call["alpha"], call["x"], call["y"]) == (
            alpha, x._data.data_ptr(), y._data.data_ptr())
        assert call["grid"] == (i + 1, 1, 1) and call["stream"] == 9
    assert fake.smem == [64 << 10, 100 << 10]
    pushed = 0 if current == "primary" else 4
    assert (fake.pushes, fake.pops) == (pushed, pushed)


def test_plan_launches_from_many_threads_keep_their_arguments(monkeypatch):
    """Threads share a plan's slots: each launch must reach the driver
    with its own arguments, even when threads switch inside the call."""
    fake = _FakeDriver(77)
    seen = []

    def launch_kernel(fn, gx, gy, gz, bx, by, bz, smem, stream, params,
                      extra):
        first = [ctypes.c_void_p.from_address(params[i]).value
                 for i in (1, 2)]
        time.sleep(0)                       # let another thread run
        alpha = ctypes.c_float.from_address(params[0]).value
        again = [ctypes.c_void_p.from_address(params[i]).value
                 for i in (1, 2)]
        seen.append((alpha, first, again))
        return 0
    fake.cuLaunchKernel = launch_kernel
    monkeypatch.setitem(tmx.rtc._libs, "cuda", fake)
    k, _, _ = _axpy(tmx)
    plan = tmx.rtc._Plan(k._spec, 1234, 77)
    n_threads, reps = 16, 50
    arrays = [(tmx.nd.ones((4,), ctx=tmx.cpu()),
               tmx.nd.ones((4,), ctx=tmx.cpu())) for _ in range(n_threads)]
    want = {float(i): [x._data.data_ptr(), y._data.data_ptr()]
            for i, (x, y) in enumerate(arrays)}

    def work(i):
        for _ in range(reps):
            plan.launch((float(i), *arrays[i]), (1, 1, 1), (1, 1, 1), 0, 0,
                        "k")
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(i,))
                   for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert len(seen) == n_threads * reps
    assert all(first == again == want[alpha]
               for alpha, first, again in seen)


def _rounding_cases():
    """Values whose float16 or bfloat16 needs rounding: ties and their
    neighbours at every exponent, subnormals, overflow, ±inf, NaN, and
    doubles that round twice (to float32, then to 16 bits)."""
    vals = [0.0, -0.0, 65504.0, 65519.99, 65520.0, 65536.0, 1e39, -1e39,
            float("inf"), -float("inf"), float("nan"), 2.0 ** -24,
            2.0 ** -25, 2.0 ** -25 * 1.0000001, 3 * 2.0 ** -26,
            1 + 2.0 ** -8 + 2.0 ** -30, 3.4028235e38]
    for e in range(-26, 17, 3):
        for m in range(0, 2048, 97):
            v = (1 + m / 2048) * 2.0 ** e
            for w in (v, v * (1 + 2.0 ** -11), v * (1 + 2.0 ** -8),
                      np.nextafter(v, 0.0), np.nextafter(v, 2 * v)):
                vals += [float(w), -float(w)]
    rng = np.random.default_rng(7)
    vals += list(rng.standard_normal(500) * np.exp(rng.uniform(-30, 12,
                                                               500)))
    return vals


@pytest.mark.parametrize("dtype", ["float16", "bfloat16"])
def test_half_and_bfloat16_scalars_encode_like_torch(dtype):
    dt = getattr(torch, dtype)
    encode = tmx.rtc._ENCODE[dt]
    vals = _rounding_cases()
    # torch's scalar conversion, as a launch made it before the plan
    want = [int(torch.tensor(v, dtype=dt).view(torch.int16)) & 0xFFFF
            for v in vals]
    assert [encode(v) for v in vals] == want
