"""The port's indexing and ordering ops
(``mxnet_tpu_torch/ops/indexing.py``) against the JAX package's
(``mxnet_tpu/ops/indexing.py``) on the CPU: forward values and input
gradients (``jax.vjp``) from the same numpy inputs at ``rtol=1e-5,
atol=1e-6``. Ties follow JAX: ``sort``/``argsort`` flip a stable sort for
descending order (tied elements in reverse index order), ``topk`` keeps
the lower index first; ``_contrib_boolean_mask`` keeps JAX's padded,
static-shape form."""
import numpy as np
import pytest

from torch_parity import hold, port_run, rand


@pytest.mark.parametrize("mode", ["clip", "wrap"])
@pytest.mark.parametrize("axis", [0, 1, -1])
def test_take(mode, axis):
    idx = np.array([[0, 2, -1], [5, 1, 1]], np.float32)
    hold("take", [rand(1, 4, 3, 5), idx], {"axis": axis, "mode": mode})


def test_batch_take():
    hold("batch_take", [rand(2, 4, 5), np.array([0, 4, 2, 9], np.int32)])


@pytest.mark.parametrize("dtype", ["float32", "int32"])
def test_one_hot(dtype):
    idx = np.array([[0, 3, -1], [5, 2, 1]], np.float32)
    hold("one_hot", [idx], {"depth": 4, "dtype": dtype}, grad=False)
    hold("one_hot", [idx], {"depth": 6, "on_value": 2.5, "off_value": -1.0,
                            "dtype": dtype}, grad=False)


@pytest.mark.parametrize("axis", [-1, 0, None])
@pytest.mark.parametrize("ascend", [True, False])
def test_sort_and_argsort(axis, ascend):
    x = rand(3, 4, 6)
    attrs = {"axis": axis, "is_ascend": ascend}
    hold("sort", [x], attrs)
    got = hold("argsort", [x], attrs)[0]
    assert got.dtype == np.float32
    hold("argsort", [x], dict(attrs, dtype="int32"))


def test_descending_ties_come_out_in_reverse_index_order():
    x = np.array([[1., 3., 3., 2., 3.], [0., 0., 0., 0., 0.]], np.float32)
    got = hold("argsort", [x], {"is_ascend": False})[0]
    np.testing.assert_array_equal(got, [[4, 2, 1, 3, 0], [4, 3, 2, 1, 0]])
    got = hold("argsort", [x], {"is_ascend": True})[0]
    np.testing.assert_array_equal(got, [[0, 3, 1, 2, 4], [0, 1, 2, 3, 4]])


@pytest.mark.parametrize("ret_typ", ["indices", "value", "mask", "both"])
@pytest.mark.parametrize("ascend", [False, True])
@pytest.mark.parametrize("k", [1, 3])
def test_topk(ret_typ, ascend, k):
    attrs = {"k": k, "ret_typ": ret_typ, "is_ascend": ascend}
    hold("topk", [rand(4, 3, 7)], attrs)
    hold("topk", [rand(5, 5, 3, 4)], dict(attrs, axis=0))
    hold("topk", [rand(6, 2, 5)], dict(attrs, axis=None))


@pytest.mark.parametrize("k", [1, 2, 3])
def test_topk_ties_keep_the_lower_index_first(k):
    x = np.array([[3., 1., 3., 2., 3.], [0., 5., 5., 5., 0.]], np.float32)
    got = hold("topk", [x], {"k": k})[0]
    np.testing.assert_array_equal(got, np.array([[0, 2, 4], [1, 2, 3]])
                                  [:, :k])
    got = hold("topk", [x], {"k": k, "is_ascend": True})[0]
    np.testing.assert_array_equal(got, np.array([[1, 3, 0], [0, 4, 1]])
                                  [:, :k])
    got = hold("topk", [x], {"k": k, "ret_typ": "both"})
    np.testing.assert_array_equal(got[1], np.array([[0, 2, 4], [1, 2, 3]])
                                  [:, :k])


def test_scatter_nd():
    idx = np.array([[0, 1, 3], [2, 0, 1]], np.int32)
    hold("scatter_nd", [rand(7, 3, 5), idx], {"shape": (4, 3, 5)})
    hold("scatter_nd", [rand(8, 3), idx], {"shape": (4, 3)})


SPECS = [
    ((("s", 1, 3, None),), 0),
    ((("s", None, None, -1), ("s", 0, 4, 2)), 0),
    ((("s", 3, None, -2),), 0),
    ((("e",), ("s", None, None, -1)), 0),
    ((("n",), ("s", 1, None, None), ("n",)), 0),
    ((("a",),), 1),
    ((("s", None, 2, None), ("a",)), 1),
    ((("a",), ("e",), ("a",)), 2),
    ((("i", 2), ("s", None, None, -3)), 0),
    ((("b", True), ("s", 1, None, None)), 0),
]


@pytest.mark.parametrize("spec,n_arrays", SPECS)
def test_getitem(spec, n_arrays):
    arrays = [np.array([3, 0, -1], np.int32), np.array([1, 0, 4], np.int32)]
    hold("_getitem", [rand(9, 4, 5, 6)] + arrays[:n_arrays],
         {"spec": spec, "num_arrays": n_arrays})


def test_boolean_mask_is_padded_to_a_static_shape():
    data = rand(10, 5, 3)
    index = np.array([0., 1., 0., 2., 1.], np.float32)
    got = hold("_contrib_boolean_mask", [data, index])[0]
    np.testing.assert_array_equal(got[:3], data[[1, 3, 4]])
    np.testing.assert_array_equal(got[3:], 0.0)


def test_index_copy():
    hold("_contrib_index_copy",
         [rand(11, 5, 3), np.array([3, 0], np.int32), rand(12, 2, 3)])


def test_no_host_read_in_the_ordering_ops():
    """The ordering ops take no ``.item()``/``.cpu()``: they run under a
    tensor that refuses a host read."""
    import torch

    class NoHost(torch.Tensor):
        def item(self):
            raise AssertionError("host read")

        def cpu(self, *a, **k):
            raise AssertionError("host read")

        def numpy(self, *a, **k):
            raise AssertionError("host read")

    x = torch.from_numpy(rand(13, 3, 6)).as_subclass(NoHost)
    from mxnet_tpu_torch import ops
    for name, attrs in (("topk", {"k": 2, "ret_typ": "both"}),
                        ("sort", {}), ("argsort", {"is_ascend": False}),
                        ("_contrib_boolean_mask", {})):
        args = [x] if name != "_contrib_boolean_mask" \
            else [x, torch.tensor([1., 0., 1.])]
        ops.invoke(ops.get_op(name), args, attrs)
    assert port_run("topk", [rand(13, 3, 6)], {"k": 1})[0][0].shape == (3, 1)
