"""The port's breadth ops (``mxnet_tpu_torch/ops/extra.py``) against the
JAX package's (``mxnet_tpu/ops/extra.py``) on the CPU: forward values and
input gradients (``jax.vjp``) from the same numpy inputs at ``rtol=1e-5,
atol=1e-6``. ``SVMOutput``'s and ``_contrib_gradientmultiplier``'s custom
gradients are held to their formulas as well; the assignment ops return
new arrays (the JAX bodies are functional and register no mutable
input)."""
import numpy as np
import pytest

from torch_parity import hold, port_run, rand


@pytest.fixture(autouse=True)
def _port_on_cpu(monkeypatch):
    monkeypatch.setenv("MXNET_DEFAULT_CONTEXT", "cpu")


def test_crop():
    x = rand(1, 2, 3, 8, 9)
    hold("Crop", [x], {"h_w": (4, 5), "offset": (1, 2)})
    hold("Crop", [x], {"h_w": (4, 5), "center_crop": True})
    hold("Crop", [x, rand(2, 2, 3, 5, 6)], {"num_args": 2})


def test_fft_ifft():
    x = rand(3, 3, 8)
    # the FFT sums n products: float32 rounding of the transform
    ftol = dict(rtol=1e-5, atol=4e-6)
    spec = hold("_contrib_fft", [x], tol=ftol, gtol=ftol)[0]
    back = hold("_contrib_ifft", [spec], tol=ftol, gtol=ftol)[0]
    np.testing.assert_allclose(back, 8 * x, rtol=1e-5, atol=2e-5)


@pytest.mark.parametrize("size", [(8, 10), (3, 4), (5, 3), (6, 6)])
def test_bilinear_resize(size):
    hold("_contrib_BilinearResize2D", [rand(4, 2, 3, 6, 6)],
         {"height": size[0], "width": size[1]})


@pytest.mark.parametrize("out", [None, 1, 2, (3, 2), (4, 4)])
def test_adaptive_avg_pooling(out):
    hold("_contrib_AdaptiveAvgPooling2D", [rand(5, 2, 3, 6, 4)],
         {"output_size": out})


def test_histogram():
    data = rand(6, 40, lo=-0.2, hi=1.2)
    data[:3] = [0.0, 1.0, 0.5]
    hold("_histogram", [data], {"bin_cnt": 5, "range": (0.0, 1.0)},
         grad=False)
    hold("_histogram", [data, np.array([-0.1, 0.2, 0.25, 0.9, 1.0],
                                       np.float32)], grad=False)


def test_ravel_and_unravel():
    coords = np.array([[0, 1, 2, 5], [3, 0, 1, 1]], np.float32)
    flat = hold("_ravel_multi_index", [coords], {"shape": (3, 4)},
                grad=False)[0]
    hold("_unravel_index", [flat], {"shape": (3, 4)}, grad=False)
    hold("_unravel_index", [np.array([[-1, 13], [4, 7]], np.float32)],
         {"shape": (3, 4)}, grad=False)


@pytest.mark.parametrize("alpha,beta", [(0.2, 0.5), (1.0, 0.0)])
def test_hard_sigmoid(alpha, beta):
    hold("hard_sigmoid", [rand(7, 4, 5, lo=-4, hi=4)],
         {"alpha": alpha, "beta": beta})


@pytest.mark.parametrize("name", ["add_n", "ElementWiseSum"])
def test_add_n(name):
    hold(name, [rand(8, 2, 3), rand(9, 2, 3), rand(10, 2, 3)],
         {"num_args": 3})


def test_graph_helpers():
    a, b = rand(11, 3, 4), rand(12, 3, 4)
    hold("_grad_add", [a, b])
    hold("_identity_with_attr_like_rhs", [a, b])
    hold("_zeros_without_dtype", [], {"shape": (2, 3)}, grad=False)


@pytest.mark.parametrize("attrs", [{"sections": 3, "axis": 1},
                                   {"indices": (1, 4), "axis": 1},
                                   {"indices": (2,), "axis": 0,
                                    "squeeze_axis": False},
                                   {"sections": 2, "axis": 0,
                                    "squeeze_axis": True}])
def test_split_v2(attrs):
    hold("_split_v2", [rand(13, 2, 6, 3)], attrs)


@pytest.mark.parametrize("begin,end,step", [
    ((0, 1), (2, 3), ()), ((None, 0), (None, 4), (1, 2)),
    ((3, 2), (0, None), (-1, -2))])
def test_slice_assign(begin, end, step):
    lhs = rand(14, 4, 5)
    ref = lhs.copy()
    ref[tuple(slice(b, e, s) for b, e, s in
              zip(begin, end, step or (None,) * len(begin)))] = 7.0
    rhs = np.zeros_like(ref[tuple(slice(b, e, s) for b, e, s in zip(
        begin, end, step or (None,) * len(begin)))]) + rand(15, 1)
    attrs = {"begin": begin, "end": end, "step": step}
    hold("_slice_assign", [lhs, rhs], attrs)
    got = hold("_slice_assign_scalar", [lhs], dict(attrs, scalar=7.0))[0]
    np.testing.assert_array_equal(got, ref)


def test_scatter_set_nd():
    idx = np.array([[0, 2, 3], [1, 1, 0]], np.int32)
    hold("_scatter_set_nd", [rand(16, 4, 3), idx, rand(17, 3)],
         {"shape": (4, 3)})


def test_quadratic():
    hold("_contrib_quadratic", [rand(18, 3, 4)], {"a": 0.5, "b": -2.0,
                                                  "c": 1.5})


@pytest.mark.parametrize("scalar", [1.0, -0.5, 3.0])
def test_gradient_multiplier_scales_the_incoming_gradient(scalar):
    x, head = rand(19, 3, 4), rand(20, 3, 4)
    hold("_contrib_gradientmultiplier", [x], {"scalar": scalar})
    out, grads = port_run("_contrib_gradientmultiplier", [x],
                          {"scalar": scalar}, heads=[head])
    np.testing.assert_array_equal(out[0], x)
    np.testing.assert_allclose(grads[0], head * scalar, rtol=1e-6)


@pytest.mark.parametrize("linear", [False, True])
def test_svm_output_hinge_gradient(linear):
    """svm_output.cc: L1 hinge -sign*reg, L2 squared hinge
    -2*reg*sign*slack, where slack = margin - sign*data > 0; the head
    gradient is not read."""
    data = rand(21, 4, 5)
    label = np.array([0, 3, 1, 4], np.float32)
    attrs = {"margin": 1.5, "regularization_coefficient": 0.7,
             "use_linear": linear}
    hold("SVMOutput", [data, label], attrs)
    _, grads = port_run("SVMOutput", [data, label], attrs,
                        heads=[rand(22, 4, 5) * 10.0])
    sign = 2 * np.eye(5, dtype=np.float32)[label.astype(int)] - 1
    slack = 1.5 - sign * data
    want = -sign * 0.7 if linear else -2.0 * 0.7 * sign * slack
    np.testing.assert_allclose(grads[0], np.where(slack > 0, want, 0.0),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(grads[1], 0.0)


def test_identity_attach_kl_sparse_reg_is_the_identity():
    x = rand(23, 3, 4)
    got = hold("IdentityAttachKLSparseReg", [x],
               {"sparseness_target": 0.2, "penalty": 0.01})
    np.testing.assert_array_equal(got[0], x)
