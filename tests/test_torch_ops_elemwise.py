"""The port's elementwise ops (``mxnet_tpu_torch/ops/elemwise.py``)
against the JAX package's (``mxnet_tpu/ops/elemwise.py``) on the CPU:
forward values and input gradients (``jax.vjp``) from the same numpy
inputs at ``rtol=1e-5, atol=1e-6`` unless a case states a wider
tolerance with its reason. Includes the cases where a naive torch port
parts from JAX: ``round``/``rint`` round half to even, ``fix``
truncates, ``_mod`` takes the divisor's sign, ``gamma`` at negative
arguments, and ``MakeLoss``/``BlockGrad``'s gradients."""
import numpy as np
import pytest

from torch_parity import hold, port_run, rand

# the unary ops by input domain: (name, low, high)
UNARY = [
    ("sin", -3, 3), ("cos", -3, 3), ("tan", -1.2, 1.2),
    ("arcsin", -0.9, 0.9), ("arccos", -0.9, 0.9), ("arctan", -3, 3),
    ("sinh", -2, 2), ("cosh", -2, 2),
    ("arcsinh", -3, 3), ("arccosh", 1.1, 3), ("arctanh", -0.9, 0.9),
    ("degrees", -3, 3), ("radians", -200, 200),
    ("log10", 0.1, 5), ("log2", 0.1, 5), ("log1p", -0.5, 3),
    ("expm1", -2, 2), ("rsqrt", 0.2, 4), ("reciprocal", 0.3, 3),
    ("erf", -2, 2), ("erfinv", -0.9, 0.9),
    ("identity", -2, 2), ("sign", -2, 2), ("ceil", -3, 3),
    ("floor", -3, 3), ("trunc", -3, 3), ("fix", -3, 3), ("round", -3, 3),
    ("rint", -3, 3), ("logical_not", -1, 1),
]

# ops through a special function or a power with a wider error than
# rtol 1e-5: the stated tolerance and why
WIDE = {
    # torch's cube root is |x|^(1/3) by pow (torch has no cbrt); jnp.cbrt
    # is correctly rounded: a few float32 ulps apart
    "cbrt": dict(rtol=1.2e-5, atol=1e-6),
    "rcbrt": dict(rtol=1.2e-5, atol=1e-6),
    # lgamma/exp: torch's and XLA's lgamma differ in the last float32
    # ulps, and exp multiplies lgamma's absolute error into a relative one
    "gamma": dict(rtol=2e-5, atol=1e-6),
    "gammaln": dict(rtol=2e-5, atol=2e-6),
}


@pytest.mark.parametrize("name,lo,hi", UNARY)
def test_unary(name, lo, hi):
    hold(name, [rand(1, 3, 7, lo=lo, hi=hi)])


@pytest.mark.parametrize("name,lo,hi", [
    ("cbrt", -3, 3), ("rcbrt", 0.3, 3), ("gamma", 0.2, 4.5),
    ("gammaln", 0.2, 6)])
def test_unary_special_functions(name, lo, hi):
    x = rand(2, 4, 5, lo=lo, hi=hi)
    hold(name, [x], tol=WIDE[name], gtol=dict(rtol=5e-5, atol=5e-6))


def test_gamma_at_negative_arguments_keeps_its_sign_and_poles():
    x = np.array([-2.5, -1.5, -0.5, 0.5, 3.0, -1.0, -3.0], np.float32)
    got = hold("gamma", [x], grad=False, tol=WIDE["gamma"])[0]
    assert np.isnan(got[-2:]).all()
    np.testing.assert_array_equal(np.sign(got[:5]), [-1, 1, -1, 1, 1])


def test_round_and_rint_round_half_to_even_and_fix_truncates():
    x = np.array([0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 0.49, -2.7], np.float32)
    for name in ("round", "rint"):
        got = hold(name, [x])[0]
        np.testing.assert_array_equal(
            got, [0., 2., 2., -0., -2., -2., 0., -3.])
    np.testing.assert_array_equal(hold("fix", [x])[0],
                                  [0., 1., 2., -0., -1., -2., 0., -2.])


def test_mod_takes_the_divisors_sign():
    x = np.array([-3., 3., -3., 3., 5.5, -5.5], np.float32)
    y = np.array([2., -2., -2., 2., 2., 2.], np.float32)
    for name in ("_mod", "broadcast_mod"):
        got = hold(name, [x, y])[0]
        np.testing.assert_array_equal(got, [1., -1., -1., 1., 1.5, 0.5])
    np.testing.assert_array_equal(
        hold("_mod_scalar", [x], {"scalar": -2.0})[0],
        [-1., -1., -1., -1., -0.5, -1.5])
    np.testing.assert_array_equal(
        hold("_rmod_scalar", [y], {"scalar": -3.0})[0],
        [1., -1., -1., 1., 1., 1.])


def test_mod_on_integers():
    x = np.array([-7, 7, -7, 7], np.int32)
    y = np.array([3, -3, -3, 3], np.int32)
    hold("broadcast_mod", [x, y], grad=False)
    hold("_mod_scalar", [x], {"scalar": 3}, grad=False)


BINARY = ["_minimum", "broadcast_minimum", "_hypot", "broadcast_hypot",
          "_equal", "_not_equal", "_greater", "_greater_equal", "_lesser",
          "_lesser_equal", "_logical_and", "_logical_or", "_logical_xor",
          "broadcast_logical_and", "broadcast_logical_or",
          "broadcast_logical_xor", "_scatter_elemwise_div"]


@pytest.mark.parametrize("name", BINARY)
def test_binary_broadcasting(name):
    x = rand(3, 3, 1, 4)
    y = rand(4, 1, 5, 4)
    if name.endswith("logical_and") or name.endswith("logical_or") \
            or name.endswith("logical_xor"):
        x = np.where(np.abs(x) < 0.5, 0.0, x).astype(np.float32)
        y = np.where(np.abs(y) < 0.5, 0.0, y).astype(np.float32)
    if name == "_scatter_elemwise_div":
        y = y[:1, :1]
        x = np.broadcast_to(x, (3, 5, 4)).copy()
        y = rand(5, 3, 5, 4, lo=0.5, hi=2)
    hold(name, [x, y])


def test_minimum_and_maximum_split_the_gradient_at_ties():
    x = np.array([1., 2., 3.], np.float32)
    y = np.array([1., 1., 4.], np.float32)
    hold("broadcast_minimum", [x, y])
    hold("_minimum_scalar", [x], {"scalar": 2.0})
    hold("_maximum_scalar", [x], {"scalar": 2.0})


SCALAR = ["_mod_scalar", "_rmod_scalar", "_maximum_scalar",
          "_minimum_scalar", "_hypot_scalar", "_logical_and_scalar",
          "_logical_or_scalar", "_logical_xor_scalar",
          "_scatter_plus_scalar", "_scatter_minus_scalar"]


@pytest.mark.parametrize("scalar", [0.0, 1.5, -2.0])
@pytest.mark.parametrize("name", SCALAR)
def test_scalar_ops(name, scalar):
    x = rand(6, 4, 6, lo=0.5, hi=3) * np.sign(rand(7, 4, 6))
    x[0, :2] = 0.0
    if name == "_rmod_scalar" or (name == "_mod_scalar" and scalar == 0.0):
        # x mod 0 is NaN in both (equal NaN positions)
        hold(name, [x], {"scalar": scalar}, grad=False)
        return
    if name == "_hypot_scalar" and scalar == 0.0:
        # hypot(0, 0) has no derivative: JAX's abs takes slope 1 at 0,
        # torch's 0; both finite. Compare the gradient elsewhere
        hold(name, [x], {"scalar": scalar}, grad=False)
        hold(name, [x[1:]], {"scalar": scalar})
        _, grads = port_run(name, [x], {"scalar": scalar},
                            heads=[np.ones_like(x)])
        assert np.isfinite(grads[0]).all()
        return
    hold(name, [x], {"scalar": scalar})


@pytest.mark.parametrize("name", ["_logical_and_scalar", "_maximum_scalar",
                                  "_mod_scalar", "_equal_scalar"])
def test_scalar_ops_on_integers(name):
    x = np.array([[-3, 0, 2], [5, -1, 4]], np.int32)
    hold(name, [x], {"scalar": 2}, grad=False)


@pytest.mark.parametrize("sigma", [1.0, 0.5, 2.0])
def test_smooth_l1(sigma):
    x = rand(8, 5, 6, lo=-3, hi=3)
    hold("smooth_l1", [x], {"scalar": sigma})


def test_shape_and_size_arrays():
    x = rand(9, 2, 3, 4)
    for name in ("shape_array", "size_array"):
        hold(name, [x], grad=False)


@pytest.mark.parametrize("name", ["BlockGrad", "stop_gradient"])
def test_block_grad_passes_values_and_stops_gradients(name):
    x = rand(10, 3, 4)
    got = hold(name, [x])
    np.testing.assert_array_equal(got[0], x)
    _, grads = port_run(name, [x], {}, heads=[np.ones((3, 4), np.float32)])
    np.testing.assert_array_equal(grads[0], 0.0)


@pytest.mark.parametrize("name", ["MakeLoss", "make_loss"])
@pytest.mark.parametrize("grad_scale", [1.0, 0.25])
def test_make_loss_gradient_is_grad_scale_whatever_the_head(name,
                                                            grad_scale):
    """elemwise.py's custom VJP: grad_scale everywhere; the head gradient,
    ``normalization`` and ``valid_thresh`` are not read."""
    x = rand(11, 4, 3)
    attrs = {"grad_scale": grad_scale, "normalization": "batch",
             "valid_thresh": 0.5}
    hold(name, [x], attrs)
    _, grads = port_run(name, [x], attrs,
                        heads=[rand(12, 4, 3) * 100.0])
    np.testing.assert_array_equal(grads[0], np.float32(grad_scale))
