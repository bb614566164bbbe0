"""The port's neural-network ops added with the operator breadth
(``mxnet_tpu_torch/ops/nn.py``) against the JAX package's
(``mxnet_tpu/ops/nn.py``) on the CPU: forward values and input
gradients (``jax.vjp``) from the same numpy inputs at ``rtol=1e-5,
atol=1e-6``. The regression output layers' gradients are also held to
``tests/test_head_op_gradients.py``'s analytic formulas (they ignore the
head gradient), and ``ctc_loss`` to optax's through the JAX op: padding
by zero labels, explicit lengths, and an alignment that cannot exist
(a large finite loss in both, where ``torch.nn.functional.ctc_loss``
would return inf)."""
import numpy as np
import pytest
import torch

from torch_parity import hold, port_run, rand


def _sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))


@pytest.mark.parametrize("name", ["LinearRegressionOutput",
                                  "LogisticRegressionOutput",
                                  "MAERegressionOutput"])
@pytest.mark.parametrize("grad_scale", [1.0, 3.0])
def test_regression_outputs_match_jax_and_the_analytic_gradient(
        name, grad_scale):
    data, label = rand(1, 4, 3), rand(2, 4, 3)
    attrs = {"grad_scale": grad_scale}
    hold(name, [data, label], attrs)
    out, grads = port_run(name, [data, label], attrs,
                          heads=[rand(3, 4, 3) * 50.0])
    pred = _sigmoid(data) if name.startswith("Logistic") else data
    np.testing.assert_allclose(out[0], pred, rtol=1e-6)
    diff = pred - label
    want = np.sign(diff) if name.startswith("MAE") else diff
    np.testing.assert_allclose(grads[0], want * grad_scale / 3, rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_array_equal(grads[1], 0.0)


def test_regression_output_label_of_another_shape():
    hold("LinearRegressionOutput", [rand(4, 5, 1), rand(5, 5)])


@pytest.mark.parametrize("mode", ["instance", "channel", "spatial"])
def test_l2_normalization(mode):
    hold("L2Normalization", [rand(6, 2, 3, 4, 5)], {"mode": mode})


@pytest.mark.parametrize("nsize", [3, 5])
def test_lrn(nsize):
    hold("LRN", [rand(7, 2, 6, 3, 4)], {"nsize": nsize, "alpha": 1e-2,
                                        "beta": 0.75, "knorm": 2.0})


def test_upsampling_nearest_and_multi_input():
    hold("UpSampling", [rand(8, 2, 3, 4, 5)], {"scale": 2, "num_args": 1})
    hold("UpSampling", [rand(9, 2, 3, 4, 4), rand(10, 2, 2, 2, 2)],
         {"scale": 2, "num_args": 2})


@pytest.mark.parametrize("scale", [2, 3])
def test_upsampling_bilinear(scale):
    hold("UpSampling", [rand(11, 2, 3, 4, 5)],
         {"scale": scale, "sample_type": "bilinear", "num_args": 1})


@pytest.mark.parametrize("mode", ["instance", "channel"])
def test_softmax_activation(mode):
    hold("SoftmaxActivation", [rand(12, 2, 3, 4)], {"mode": mode})


@pytest.mark.parametrize("axis", [-1, 1])
def test_softmin(axis):
    hold("softmin", [rand(13, 2, 3, 4)], {"axis": axis})


def test_softmax_cross_entropy():
    hold("softmax_cross_entropy", [rand(14, 6, 5),
                                   np.array([0, 4, 2, 1, 1, 3], np.float32)])


@pytest.mark.parametrize("width", [64, 30])
def test_div_sqrt_dim(width):
    hold("_contrib_div_sqrt_dim", [rand(15, 2, 3, width)])


def _ctc_inputs(seed, T=12, N=3, C=6, S=4):
    data = rand(seed, T, N, C) * 2.0
    label = np.array([[1, 2, 2, 0], [3, 1, 4, 5], [5, 0, 0, 0]],
                     np.float32)[:N, :S]
    return data, label


@pytest.mark.parametrize("name", ["ctc_loss", "_contrib_ctc_loss",
                                  "CTCLoss"])
def test_ctc_loss_zero_labels_are_padding(name):
    data, label = _ctc_inputs(16)
    hold(name, [data, label], gtol=dict(rtol=1e-5, atol=2e-6))


def test_ctc_loss_with_lengths():
    data, label = _ctc_inputs(17)
    dl = np.array([12, 9, 5], np.float32)
    ll = np.array([3, 4, 1], np.float32)
    hold("ctc_loss", [data, label, dl, ll],
         {"use_data_lengths": True, "use_label_lengths": True},
         gtol=dict(rtol=1e-5, atol=2e-6))
    hold("ctc_loss", [data, label, dl], {"use_data_lengths": True},
         gtol=dict(rtol=1e-5, atol=2e-6))


def test_ctc_loss_ignores_blank_label():
    data, label = _ctc_inputs(18)
    first = hold("ctc_loss", [data, label], {"blank_label": "first"})
    last = hold("ctc_loss", [data, label], {"blank_label": "last"})
    np.testing.assert_array_equal(first[0], last[0])


def test_ctc_loss_impossible_alignment_is_large_and_finite():
    """Four labels with a repeat need at least 5 frames; 3 frames cannot
    align. optax (and the port) give a large finite loss; torch's own
    CTC gives inf."""
    data = rand(19, 3, 1, 5)
    label = np.array([[1, 2, 2, 3]], np.float32)
    # the loss carries log(0) = -1e5 terms: at that magnitude a float32
    # ulp is 0.008, and each logaddexp's rounding (XLA's against torch's)
    # moves the soft path weights behind the gradient by up to ~5%
    got = hold("ctc_loss", [data, label],
               gtol=dict(rtol=0.1, atol=5e-3))[0]
    assert np.isfinite(got).all() and got[0] > 1e4
    lib = torch.nn.functional.ctc_loss(
        torch.log_softmax(torch.from_numpy(data), -1),
        torch.tensor([[1, 2, 2, 3]]), torch.tensor([3]), torch.tensor([4]),
        reduction="none")
    assert torch.isinf(lib).all()


def test_ctc_loss_matches_torch_where_an_alignment_exists():
    data, label = _ctc_inputs(20)
    got = port_run("ctc_loss", [data, label], {})[0][0]
    lens = (label != 0).sum(1)
    lib = torch.nn.functional.ctc_loss(
        torch.log_softmax(torch.from_numpy(data), -1),
        torch.from_numpy(label).long(), torch.full((3,), 12),
        torch.from_numpy(lens), reduction="none")
    np.testing.assert_allclose(got, lib.numpy(), rtol=1e-5)


def test_v1_ops_are_their_current_ops():
    x = rand(21, 2, 3, 6, 6)
    w = rand(22, 4, 3, 3, 3)
    b = rand(23, 4)
    conv = {"kernel": (3, 3), "num_filter": 4}
    hold("Convolution_v1", [x, w, b], conv)
    hold("Pooling_v1", [x], {"kernel": (2, 2), "stride": (2, 2),
                             "pool_type": "avg"})
    g, beta = rand(24, 3, lo=0.5, hi=1.5), rand(25, 3)
    mm, mv = rand(26, 3), rand(27, 3, lo=0.5, hi=1.5)
    hold("BatchNorm_v1", [x, g, beta, mm, mv],
         {"fix_gamma": False, "use_global_stats": True})
