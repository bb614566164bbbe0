"""The port's reductions and broadcast-shape ops
(``mxnet_tpu_torch/ops/reduce.py``) against the JAX package's
(``mxnet_tpu/ops/reduce.py``) on the CPU: forward values and input
gradients (``jax.vjp``) from the same numpy inputs at ``rtol=1e-5,
atol=1e-6``. ``argmax``/``argmin``/``argmax_channel`` return float32
indices and the first index wins a tie."""
import numpy as np
import pytest

from torch_parity import hold, rand

AXES = [None, 0, 1, (0, 2), -1]


@pytest.mark.parametrize("axis", AXES)
@pytest.mark.parametrize("keepdims", [False, True])
@pytest.mark.parametrize("name", ["prod", "nansum", "nanprod", "sum_axis",
                                  "max_axis", "min_axis"])
def test_reductions(name, axis, keepdims):
    x = rand(1, 3, 4, 5, lo=0.5, hi=1.5) * np.sign(rand(2, 3, 4, 5))
    if name.startswith("nan"):
        x[0, 1, 2] = np.nan
        x[2, 0, 0] = np.nan
    hold(name, [x], {"axis": axis, "keepdims": keepdims})


@pytest.mark.parametrize("name", ["prod", "nansum", "nanprod"])
def test_reduction_exclude(name):
    hold(name, [rand(3, 2, 3, 4, lo=0.5, hi=1.5)],
         {"axis": 1, "exclude": True})


def test_prod_with_zeros_has_jaxs_gradient():
    x = rand(4, 3, 4)
    x[0, 1] = 0.0
    x[2, 0] = x[2, 3] = 0.0
    hold("prod", [x], {"axis": 1})


@pytest.mark.parametrize("axis", [None, 0, 1, 2])
@pytest.mark.parametrize("keepdims", [False, True])
@pytest.mark.parametrize("name", ["argmax", "argmin"])
def test_argmax_argmin(name, axis, keepdims):
    got = hold(name, [rand(5, 3, 4, 5)], {"axis": axis,
                                          "keepdims": keepdims})
    assert got[0].dtype == np.float32


@pytest.mark.parametrize("name", ["argmax", "argmin", "argmax_channel"])
def test_ties_go_to_the_first_index(name):
    x = np.array([[1., 3., 3., 0.], [2., 2., 2., 2.], [0., -1., 5., 5.],
                  [-4., 7., -4., 7.]], np.float32)
    attrs = {} if name == "argmax_channel" else {"axis": 1}
    got = hold(name, [x], attrs)[0]
    want = {"argmax": [1, 0, 2, 1], "argmin": [3, 0, 1, 0],
            "argmax_channel": [1, 0, 2, 1]}[name]
    np.testing.assert_array_equal(got, want)


def test_argmax_channel():
    hold("argmax_channel", [rand(6, 2, 7, 3)])


@pytest.mark.parametrize("shape,target", [((3, 1), (3, 4)), ((1, 4), (0, 4)),
                                          ((2, 1, 3), (2, 5, 3)),
                                          ((4,), (2, 3, 4))])
def test_broadcast_to(shape, target):
    hold("broadcast_to", [rand(7, *shape)], {"shape": target})


@pytest.mark.parametrize("axis,size", [(1, 4), ((0, 2), (3, 5)), (2, 6)])
@pytest.mark.parametrize("name", ["broadcast_axis", "broadcast_axes"])
def test_broadcast_axis(name, axis, size):
    x = rand(8, 1, 2, 1) if axis != 1 else rand(8, 3, 1, 2)
    if axis == (0, 2):
        x = rand(8, 1, 2, 1)
    hold(name, [x], {"axis": axis, "size": size})


def test_broadcast_like():
    hold("broadcast_like", [rand(9, 1, 4, 1), rand(10, 3, 4, 5)])
