"""The port's shape and product ops added with the operator breadth
(``mxnet_tpu_torch/ops/matrix.py``) against the JAX package's
(``mxnet_tpu/ops/matrix.py``) on the CPU: forward values and input
gradients (``jax.vjp``) from the same numpy inputs at ``rtol=1e-5,
atol=1e-6``. ``slice`` takes negative steps, which torch's slicing does
not."""
import numpy as np
import pytest

from torch_parity import hold, rand


@pytest.mark.parametrize("ta", [False, True])
@pytest.mark.parametrize("tb", [False, True])
def test_batch_dot(ta, tb):
    a = rand(1, 3, 4, 5) if not ta else rand(1, 3, 5, 4)
    b = rand(2, 3, 5, 6) if not tb else rand(2, 3, 6, 5)
    hold("batch_dot", [a, b], {"transpose_a": ta, "transpose_b": tb})


def test_batch_dot_four_dims():
    hold("batch_dot", [rand(3, 2, 3, 4, 5), rand(4, 2, 3, 6, 5)],
         {"transpose_b": True})


@pytest.mark.parametrize("begin,end,step", [
    ((1,), (3,), None), ((0, 1), (2, 4), None), ((None, 2), (None, None),
                                                 None),
    ((3, None), (0, None), (-1, None)), ((None, 4), (None, 0), (2, -2)),
    ((-2, 1), (None, -1), (1, 2)), ((4, 5), (None, None), (-2, -3))])
def test_slice(begin, end, step):
    hold("slice", [rand(5, 5, 6, 3)], {"begin": begin, "end": end,
                                       "step": step})


@pytest.mark.parametrize("axes", [(), (0,), (1, 2), (-1,)])
def test_slice_like(axes):
    hold("slice_like", [rand(6, 5, 6, 7), rand(7, 3, 4, 2)], {"axes": axes})


@pytest.mark.parametrize("axis", [None, 0, (0, 2), -1])
def test_squeeze(axis):
    hold("squeeze", [rand(8, 1, 3, 1, 1)], {"axis": axis})


@pytest.mark.parametrize("axis", [None, 0, 1, -1])
def test_repeat(axis):
    hold("repeat", [rand(9, 2, 3, 4)], {"repeats": 3, "axis": axis})


@pytest.mark.parametrize("k", [0, 1, -2])
def test_diag(k):
    hold("diag", [rand(10, 5)], {"k": k})
    hold("diag", [rand(11, 4, 6)], {"k": k})
    hold("diag", [rand(12, 3, 4, 5)], {"k": k, "axis1": 1, "axis2": 2})
    hold("diag", [rand(13, 3, 4, 5)], {"k": k, "axis1": 0, "axis2": 2})


@pytest.mark.parametrize("n", [1, 2, 3])
def test_khatri_rao(n):
    mats = [rand(14 + i, 2 + i, 4) for i in range(n)]
    hold("khatri_rao", mats, {"num_args": n})


@pytest.mark.parametrize("block", [1, 2, 3])
def test_depth_space_round_trip(block):
    x = rand(20, 2, 9 * block * block, 3, 4)
    y = hold("depth_to_space", [x], {"block_size": block})[0]
    back = hold("space_to_depth", [y], {"block_size": block})[0]
    np.testing.assert_array_equal(back, x)


def test_rnn_param_concat():
    hold("_rnn_param_concat", [rand(21, 6), rand(22, 4), rand(23, 2)],
         {"num_args": 3, "dim": 0})
    hold("_rnn_param_concat", [rand(24, 2, 3), rand(25, 2, 5)],
         {"num_args": 2, "dim": 1})
