"""The port's spatial-sampling and image ops (``GridGenerator``,
``BilinearSampler``, ``SpatialTransformer``, ``Correlation``, the
``_image_*`` ops, ``_contrib_edge_id``; ``mxnet_tpu_torch/ops/extra.py``)
against the JAX package's on the CPU: forward values and input gradients
(``jax.vjp``) from the same numpy inputs at ``rtol=1e-5, atol=1e-6``
(the resizes at a 255-valued image's float32 rounding).

``_image_resize`` is ``jax.image.resize``: antialiased when shrinking,
and float32 for a uint8 image (JAX promotes an integer image and does
not cast back), which the port returns too."""
import numpy as np
import pytest

from torch_parity import hold, rand

# the antialiasing weights' float32 rounding on values up to 255
RESIZE_TOL = dict(rtol=1e-5, atol=1e-4)


@pytest.fixture(autouse=True)
def _port_on_cpu(monkeypatch):
    monkeypatch.setenv("MXNET_DEFAULT_CONTEXT", "cpu")


def _theta(seed, n=2):
    base = np.array([[0.9, 0.1, 0.05, -0.1, 1.1, 0.0]], np.float32)
    return (np.tile(base, (n, 1)) + rand(seed, n, 6) * 0.05).astype(
        np.float32)


@pytest.mark.parametrize("target", [(5, 7), (4, 4)])
def test_grid_generator_affine(target):
    hold("GridGenerator", [_theta(1)], {"target_shape": target})


def test_grid_generator_warp():
    hold("GridGenerator", [rand(2, 2, 2, 5, 6)], {"transform_type": "warp"})


def test_bilinear_sampler_inside_and_outside_the_image():
    grid = rand(3, 2, 2, 4, 5, lo=-1.2, hi=1.2)
    hold("BilinearSampler", [rand(4, 2, 3, 6, 7), grid])


def test_spatial_transformer():
    hold("SpatialTransformer", [rand(5, 2, 3, 6, 7), _theta(6)],
         {"target_shape": (4, 5)})


@pytest.mark.parametrize("attrs", [
    {}, {"max_displacement": 2, "kernel_size": 3, "stride2": 2},
    {"max_displacement": 1, "stride1": 2, "is_multiply": False}])
def test_correlation(attrs):
    hold("Correlation", [rand(7, 2, 3, 6, 7), rand(8, 2, 3, 6, 7)], attrs)


def test_image_to_tensor_and_its_alias():
    u8 = np.random.RandomState(9).randint(0, 256, (5, 6, 3)).astype(np.uint8)
    for name in ("_image_to_tensor", "_image_totensor"):
        hold(name, [u8], grad=False)
        hold(name, [rand(10, 2, 5, 6, 3, lo=0, hi=1)])


def test_image_normalize_chw_and_nchw():
    attrs = {"mean": (0.4, 0.5, 0.6), "std": (0.2, 0.3, 0.25)}
    hold("_image_normalize", [rand(11, 3, 4, 5)], attrs)
    hold("_image_normalize", [rand(12, 2, 3, 4, 5)], attrs)


@pytest.mark.parametrize("size", [(4, 3), (9, 11), 6, (7, 5)])
def test_image_resize_float(size):
    hold("_image_resize", [rand(13, 7, 5, 3, lo=0, hi=255)],
         {"size": size}, tol=RESIZE_TOL, gtol=RESIZE_TOL)
    hold("_image_resize", [rand(14, 2, 7, 5, 3, lo=0, hi=255)],
         {"size": size}, tol=RESIZE_TOL, gtol=RESIZE_TOL)


@pytest.mark.parametrize("size", [(4, 3), (9, 11), (5, 7)])
def test_image_resize_uint8_gives_float32_like_jax(size):
    u8 = np.random.RandomState(15).randint(0, 256, (7, 5, 3)).astype(
        np.uint8)
    out = hold("_image_resize", [u8], {"size": size}, grad=False,
               tol=RESIZE_TOL)[0]
    assert out.dtype == np.float32


def test_edge_id():
    data = rand(16, 5, 6)
    u = np.array([0, 4, 2, 2], np.float32)
    v = np.array([5, 0, 3, 3], np.float32)
    hold("_contrib_edge_id", [data, u, v])


def test_filled_makes_each_constant_once():
    """``ops.extra.filled`` (the device constants of ``_image_normalize``,
    MultiBoxPrior and Proposal) returns the tensor it made before for the
    same numbers, dtype and device, and tells -0.0 from 0.0."""
    import torch
    from mxnet_tpu_torch.ops.extra import filled
    a = filled([0.5, -0.0, 3.0], "cpu")
    assert filled((0.5, -0.0, 3.0), torch.device("cpu")) is a
    assert a.tolist() == [0.5, 0.0, 3.0] and a.dtype == torch.float32
    b = filled([0.5, 0.0, 3.0], "cpu")
    assert b is not a
    assert bool(torch.signbit(a[1])) and not bool(torch.signbit(b[1]))
    assert filled([0.5, -0.0, 3.0], "cpu", torch.float64).dtype \
        == torch.float64
