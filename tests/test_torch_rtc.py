"""Port parity: mxnet_tpu_torch.rtc against the JAX package's mx.rtc, on
the CPU.

Everything here runs without a compiler or a card: the signature grammar
(held to ``mxnet_tpu.rtc.PallasModule.get_kernel``), the kernel names
read from the source's ``__global__`` declarations, the launch checks
that come before the device check (in the JAX package's order), and the
device check itself. Compiling and launching run only on a card:
chip_smoke.py holds three CUDA kernels launched through ``mx.rtc`` to
their torch expressions there."""
import numpy as np
import pytest

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
    import torch
    if not torch.cuda.is_available():
        with pytest.raises(MXNetError, match="no CUDA device"):
            k.launch((2.0, x, y), tmx.gpu(0), (1, 1, 1), (2, 1, 1))
    assert tmx.rtc.launches == before
    assert k._module._loaded == {}          # nothing compiled or loaded


def test_scalars_pass_as_their_c_type():
    import ctypes
    import torch
    assert tmx.rtc._scalar(2.5, torch.float32).value == 2.5
    assert isinstance(tmx.rtc._scalar(2, torch.float64), ctypes.c_double)
    assert tmx.rtc._scalar(-3.7, torch.int32).value == -3
    assert tmx.rtc._scalar(300, torch.uint8).value == 300 % 256
    half = np.float16(1.5).view(np.uint16)
    assert tmx.rtc._scalar(1.5, torch.float16).value == int(half)
    assert tmx.rtc._scalar(1.5, torch.bfloat16).value == 0x3FC0
    assert tmx.rtc._scalar(1, torch.bool).value is True
