"""The port's deformable and proposal ops and ``count_sketch``
(``mxnet_tpu_torch/ops/deformable.py``) against the JAX package's
(``mxnet_tpu/ops/deformable.py``) on the CPU: forward values and input
gradients (``jax.vjp``) from the same numpy inputs at ``rtol=1e-5,
atol=1e-6``; the proposals' rows (their order: the stable top-k, the
+1-IoU NMS keep mask and its cyclic repeat) exactly where the boxes
are, including a case where fewer than ``rpn_post_nms_top_n`` boxes
survive, so that the kept ones repeat."""
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from torch_parity import hold, jax_run, rand

# the integral image's cumulative sums: float32 rounding in another order
PS_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _port_on_cpu(monkeypatch):
    monkeypatch.setenv("MXNET_DEFAULT_CONTEXT", "cpu")


@pytest.mark.parametrize("attrs", [
    {"kernel": (3, 3), "pad": (1, 1), "num_filter": 4},
    {"kernel": (3, 3), "pad": (2, 2), "dilate": (2, 2), "num_filter": 4,
     "num_deformable_group": 2, "no_bias": True},
    {"kernel": (2, 3), "stride": (2, 1), "num_filter": 4, "num_group": 2}])
def test_deformable_convolution(attrs):
    kh, kw = attrs["kernel"]
    sh, sw = attrs.get("stride", (1, 1))
    ph, pw = attrs.get("pad", (0, 0))
    dh, dw = attrs.get("dilate", (1, 1))
    H, W = 6, 7
    OH = (H + 2 * ph - (dh * (kh - 1) + 1)) // sh + 1
    OW = (W + 2 * pw - (dw * (kw - 1) + 1)) // sw + 1
    ndg = attrs.get("num_deformable_group", 1)
    G = attrs.get("num_group", 1)
    arrays = [rand(1, 2, 4, H, W), rand(2, 2, 2 * ndg * kh * kw, OH, OW),
              rand(3, 4, 4 // G, kh, kw) * 0.3]
    if not attrs.get("no_bias"):
        arrays.append(rand(4, 4))
    hold("_contrib_DeformableConvolution", arrays, attrs)


def _rois(seed, R, B=2, extent=14.0):
    rs = np.random.RandomState(seed)
    ctr = rs.uniform(0, extent, (R, 2))
    wh = rs.uniform(1, 9, (R, 2))
    return np.concatenate([rs.randint(0, B, (R, 1)),
                           ctr - wh / 2, ctr + wh / 2], 1).astype(np.float32)


@pytest.mark.parametrize("gs", [0, 2])
def test_psroi_pooling(gs):
    attrs = {"spatial_scale": 0.5, "output_dim": 3, "pooled_size": 3,
             "group_size": gs}
    C = 3 * (gs or 3) ** 2
    hold("_contrib_PSROIPooling", [rand(5, 2, C, 8, 9), _rois(6, 7)], attrs,
         tol=PS_TOL, gtol=PS_TOL)


@pytest.mark.parametrize("no_trans", [False, True])
def test_deformable_psroi_pooling(no_trans):
    attrs = {"spatial_scale": 0.5, "output_dim": 4, "group_size": 3,
             "pooled_size": 3, "part_size": 2, "sample_per_part": 2,
             "trans_std": 0.1, "no_trans": no_trans}
    arrays = [rand(7, 2, 36, 8, 9), _rois(8, 6)]
    if not no_trans:
        arrays.append(rand(9, 6, 4, 2, 2))        # two classes of offsets
    hold("_contrib_DeformablePSROIPooling", arrays, attrs)


_PROP = dict(rpn_pre_nms_top_n=12, rpn_post_nms_top_n=6, threshold=0.7,
             rpn_min_size=4, scales=(8.0,), ratios=(0.5, 1.0, 2.0),
             feature_stride=16)


def _rpn_inputs(seed, B=1, Hf=3, Wf=4, A=3, spread=0.2):
    rs = np.random.RandomState(seed)
    return (rs.rand(B, 2 * A, Hf, Wf).astype(np.float32),
            (rs.randn(B, 4 * A, Hf, Wf) * spread).astype(np.float32),
            np.tile(np.array([[40.0, 56.0, 1.5]], np.float32), (B, 1)))


@pytest.mark.parametrize("attrs", [
    dict(_PROP), dict(_PROP, output_score=True),
    dict(_PROP, iou_loss=True),
    dict(_PROP, rpn_pre_nms_top_n=-1, rpn_post_nms_top_n=30)])
def test_proposal(attrs):
    hold("_contrib_Proposal", list(_rpn_inputs(10)), attrs)
    hold("Proposal", list(_rpn_inputs(11)), attrs)


def test_proposal_repeats_the_kept_boxes_when_few_survive():
    """Three anchors on one cell, one surviving NMS: the 6 rows are the
    kept box repeated, as in the JAX package."""
    attrs = dict(_PROP, rpn_pre_nms_top_n=3, rpn_post_nms_top_n=3,
                 threshold=0.01, ratios=(1.0,), scales=(4.0, 6.0, 8.0))
    cls, box, info = _rpn_inputs(12, Hf=1, Wf=1, spread=0.0)
    got = hold("_contrib_Proposal", [cls, box, info],
               dict(attrs, output_score=True))
    assert (got[0] == got[0][:1]).all() and (got[1] == got[1][:1]).all()


def test_multi_proposal():
    cls, box, info = _rpn_inputs(13, B=2)
    info[1] = [32.0, 48.0, 1.0]
    got = hold("_contrib_MultiProposal", [cls, box, info],
               dict(_PROP, output_score=True))
    assert got[0].shape == (12, 5)
    np.testing.assert_array_equal(got[0][:, 0], [0] * 6 + [1] * 6)
    hold("MultiProposal", [cls, box, info], _PROP)


def test_proposal_through_nd_contrib_matches_jax():
    cls, box, info = _rpn_inputs(14)
    got = tmx.nd.contrib.Proposal(tmx.nd.array(cls), tmx.nd.array(box),
                                  tmx.nd.array(info), **_PROP).asnumpy()
    want = jmx.nd.contrib.Proposal(jmx.nd.array(cls), jmx.nd.array(box),
                                   jmx.nd.array(info), **_PROP).asnumpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_count_sketch():
    rs = np.random.RandomState(15)
    h = rs.randint(0, 5, 9).astype(np.float32)
    s = rs.choice([-1.0, 1.0], 9).astype(np.float32)
    hold("_contrib_count_sketch", [rand(16, 2, 3, 9), h, s], {"out_dim": 5})
    want = jax_run("_contrib_count_sketch", [rand(16, 2, 3, 9), h, s],
                   {"out_dim": 5})[0][0]
    assert want.shape == (2, 3, 5)
