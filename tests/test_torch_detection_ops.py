"""The port's detection ops (``mxnet_tpu_torch/ops/detection.py``)
against the JAX package's (``mxnet_tpu/ops/detection.py``) on the CPU:
the MultiBox trio, ``box_iou``, ``box_nms`` (class-aware and
``force_suppress``), ``bipartite_matching``, ``ROIAlign`` and
``ROIPooling``, forward values and input gradients (``jax.vjp``) at
``rtol=1e-5, atol=1e-6``. Every NMS keep mask is compared exactly (the
kept rows' ids and the suppressed rows' -1), with tied scores and box
counts that are not multiples of 64; ``nms_topk``/``topk`` are accepted
and not read, as in the JAX package; ``ROIPooling`` equals the JAX op
bit for bit (a max is exact)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu.ops.detection as jdet
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.ops import detection as tdet
from torch_parity import hold, jax_run, port_run, rand


@pytest.fixture(autouse=True)
def _port_on_cpu(monkeypatch):
    monkeypatch.setenv("MXNET_DEFAULT_CONTEXT", "cpu")


def _boxes(seed, n, extent=1.0, lo=0.05, hi=0.4):
    rs = np.random.RandomState(seed)
    ctr = rs.uniform(0, extent, (n, 2))
    wh = rs.uniform(lo, hi, (n, 2))
    return np.concatenate([ctr - wh / 2, ctr + wh / 2], 1).astype(np.float32)


def _prob(seed, B, C, N):
    logits = rand(seed, B, C, N) * 2
    e = np.exp(logits)
    return (e / e.sum(1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("attrs", [
    {"sizes": (0.2, 0.3), "ratios": (1.0, 2.0, 0.5)},
    {"sizes": (0.5,), "ratios": (1.0,), "clip": True, "steps": (0.1, 0.2),
     "offsets": (0.3, 0.6)}])
def test_multibox_prior(attrs):
    hold("_contrib_MultiBoxPrior", [rand(1, 2, 3, 5, 6)], attrs)
    hold("MultiBoxPrior", [rand(1, 1, 2, 3, 4)], attrs)


def _label(seed, B, M, k_per=(1, 3, 0)):
    rs = np.random.RandomState(seed)
    label = np.full((B, M, 5), -1, np.float32)
    for b in range(B):
        k = k_per[b % len(k_per)]
        label[b, :k, 0] = rs.randint(0, 3, k)
        label[b, :k, 1:] = _boxes(seed + b, k, lo=0.1, hi=0.5)
    return label


def test_multibox_target():
    anchors = _boxes(2, 70)[None]
    hold("_contrib_MultiBoxTarget",
         [anchors, _label(3, 3, 4), _prob(4, 3, 4, 70)],
         {"overlap_threshold": 0.4})


def test_multibox_target_two_truths_forcing_one_anchor():
    """Two ground truths whose best anchor is the same: the later one
    takes it, in both packages."""
    anchors = np.array([[[0.1, 0.1, 0.5, 0.5], [0.6, 0.6, 0.9, 0.9],
                         [0.0, 0.0, 0.05, 0.05]]], np.float32)
    label = np.array([[[1, 0.1, 0.1, 0.45, 0.45], [2, 0.15, 0.15, 0.5, 0.5],
                       [-1, 0, 0, 0, 0]]], np.float32)
    out = hold("_contrib_MultiBoxTarget", [anchors, label,
                                           _prob(5, 1, 4, 3)])
    assert out[2][0, 0] == 3.0


@pytest.mark.parametrize("n,force", [(70, False), (129, False), (64, True)])
def test_multibox_detection(n, force):
    attrs = {"nms_threshold": 0.45, "threshold": 0.2,
             "force_suppress": force}
    prob = _prob(6, 2, 4, n)
    loc = rand(7, 2, 4 * n) * 0.5
    got = hold("_contrib_MultiBoxDetection", [prob, loc, _boxes(8, n)[None]],
               attrs)[0]
    want = jax_run("_contrib_MultiBoxDetection",
                   [prob, loc, _boxes(8, n)[None]], attrs)[0][0]
    np.testing.assert_array_equal(got[..., 0], want[..., 0])
    assert (got[..., 0] == -1).any() and (got[..., 0] >= 0).any()


def test_multibox_detection_ignores_nms_topk():
    args = [_prob(9, 1, 3, 40), rand(10, 1, 160) * 0.5, _boxes(11, 40)[None]]
    base = port_run("MultiBoxDetection", args, {})[0][0]
    for k in (1, 5, 400):
        got = hold("MultiBoxDetection", args, {"nms_topk": k})[0]
        np.testing.assert_array_equal(got, base)


@pytest.mark.parametrize("fmt", ["corner", "center"])
def test_box_iou(fmt):
    hold("_contrib_box_iou", [_boxes(12, 9), _boxes(13, 5)],
         {"format": fmt})
    hold("_contrib_box_iou", [_boxes(14, 14).reshape(2, 7, 4),
                              _boxes(15, 6).reshape(2, 3, 4)],
         {"format": fmt})


def _records(seed, shape, ties=False):
    rs = np.random.RandomState(seed)
    n = shape[-2]
    rec = np.zeros(shape, np.float32)
    rec[..., 0] = rs.randint(0, 3, shape[:-1])
    rec[..., 1] = rs.randint(0, 5, shape[:-1]) / 4.0 if ties \
        else rs.uniform(0, 1, shape[:-1])
    rec[..., 2:6] = _boxes(seed, int(np.prod(shape[:-1]))).reshape(
        shape[:-1] + (4,))
    rec[..., 6:] = rs.randn(*(shape[:-1] + (shape[-1] - 6,)))
    assert n == shape[-2]
    return rec


@pytest.mark.parametrize("attrs", [
    {"overlap_thresh": 0.5},
    {"overlap_thresh": 0.3, "id_index": 0, "valid_thresh": 0.2},
    {"overlap_thresh": 0.3, "id_index": 0, "force_suppress": True},
    {"overlap_thresh": 0.4, "in_format": "center", "topk": 3},
    {"overlap_thresh": 0.4, "score_index": 6, "coord_start": 2}])
@pytest.mark.parametrize("shape", [(65, 7), (2, 2, 130, 7)])
def test_box_nms(attrs, shape):
    rec = _records(16, shape, ties=True)
    got = hold("_contrib_box_nms", [rec], attrs)[0]
    want = jax_run("_contrib_box_nms", [rec], attrs)[0][0]
    si = attrs.get("score_index", 1)
    np.testing.assert_array_equal(got[..., si] == -1, want[..., si] == -1)


def test_box_nms_alias():
    rec = _records(16, (2, 63, 7), ties=True)
    hold("_contrib_box_non_maximum_suppression", [rec],
         {"overlap_thresh": 0.3, "id_index": 0})


def test_box_nms_ignores_topk():
    rec = _records(17, (50, 6))
    base = port_run("_contrib_box_nms", [rec], {})[0][0]
    for k in (1, 10):
        np.testing.assert_array_equal(
            port_run("_contrib_box_nms", [rec], {"topk": k})[0][0], base)


@pytest.mark.parametrize("attrs", [{"threshold": 0.1},
                                   {"threshold": 0.6, "is_ascend": True}])
def test_bipartite_matching(attrs):
    data = rand(18, 2, 5, 7, lo=0, hi=1)
    data[0, 1, 2] = data[0, 3, 4]                 # a tie
    hold("_contrib_bipartite_matching", [data], attrs)
    hold("_contrib_bipartite_matching", [rand(19, 6, 4, lo=0, hi=1)], attrs)


def _rois(seed, R, extent, lo, hi, B=2):
    rs = np.random.RandomState(seed)
    return np.concatenate([rs.randint(0, B, (R, 1)).astype(np.float32),
                           _boxes(seed, R, extent, lo, hi)], 1)


@pytest.mark.parametrize("attrs", [
    {"pooled_size": (3, 3), "spatial_scale": 0.5, "sample_ratio": 2},
    {"pooled_size": (2, 4), "spatial_scale": 1.0}])
def test_roi_align(attrs):
    hold("_contrib_ROIAlign", [rand(20, 2, 3, 8, 9), _rois(21, 6, 14, 1, 9)],
         attrs)
    hold("ROIAlign", [rand(22, 2, 3, 8, 9), _rois(23, 4, 14, 1, 9)], attrs)


@pytest.mark.parametrize("attrs", [
    {"pooled_size": (3, 3), "spatial_scale": 0.5},
    {"pooled_size": (4, 2), "spatial_scale": 1.0}])
def test_roi_pooling_is_bit_exact(attrs):
    data = rand(24, 2, 3, 8, 9)
    rois = _rois(25, 7, 14, 0.5, 9)
    rois[0, 1:] = [30, 30, 40, 40]             # wholly outside: empty bins
    got = hold("ROIPooling", [data, rois], attrs)[0]
    want = jax_run("ROIPooling", [data, rois], attrs)[0][0]
    np.testing.assert_array_equal(got, want)
    assert (got[0] == 0).all()


def test_roi_pooling_tied_bin_gives_its_gradient_to_one_argmax():
    """A kept difference from the JAX package: over a bin of tied maxima
    (a ReLU'd map's zeros) JAX splits the bin's gradient evenly among
    them, the port gives it whole to one. The forward is equal bit for
    bit and each bin's gradient sums alike."""
    data = np.zeros((1, 2, 4, 6), np.float32)
    data[0, 1, 0, 0] = 3.0                     # one bin of channel 1 untied
    rois = np.array([[0, 0, 0, 5, 3]], np.float32)
    attrs = {"pooled_size": (2, 3), "spatial_scale": 1.0}
    heads = [np.arange(1, 13, dtype=np.float32).reshape(1, 2, 2, 3)]
    got, (g_port, _) = port_run("ROIPooling", [data, rois], attrs, heads)
    want, vjp = jax_run("ROIPooling", [data, rois], attrs, grad=True)
    np.testing.assert_array_equal(got[0], want[0])
    g_jax = vjp(heads)[0]
    for c in range(2):
        for i in range(2):
            for j in range(3):
                cell = np.s_[0, c, 2 * i:2 * i + 2, 2 * j:2 * j + 2]
                head = heads[0][0, c, i, j]
                assert g_port[cell].sum() == g_jax[cell].sum() == head
                assert np.count_nonzero(g_port[cell]) == 1
                tied = not (c == 1 and (i, j) == (0, 0))
                assert np.count_nonzero(g_jax[cell]) == (4 if tied else 1)


def test_nms_keep_wrapper_routes_by_device():
    """A CPU tensor runs the plain version, a meta tensor gives the shape
    and nothing is launched (the CUDA launch is chip_smoke.py phase
    30's)."""
    boxes = torch.from_numpy(_boxes(26, 70))[None]
    before = dict(tdet.launches)
    keep = tdet.nms_keep(boxes, 0.4)
    np.testing.assert_array_equal(keep.numpy(),
                                  tdet.nms_keep_plain(boxes, 0.4).numpy())
    np.testing.assert_array_equal(
        keep[0].numpy(), np.asarray(jdet._nms_mask(
            jnp.asarray(boxes[0].numpy()), -jnp.arange(70.0), 0.4)))
    assert tdet.nms_keep(boxes.to("meta"), 0.4).shape == (1, 70)
    assert tdet.launches == before


def test_detection_ops_through_nd_and_sym():
    """The ops by their public names: ``nd.contrib``, ``sym.contrib`` and
    ``mx.nd``'s bare names."""
    prob, loc = _prob(27, 1, 3, 20), rand(28, 1, 80) * 0.5
    anchors = _boxes(29, 20)[None]
    got = tmx.nd.contrib.MultiBoxDetection(
        tmx.nd.array(prob), tmx.nd.array(loc), tmx.nd.array(anchors))
    want = jax_run("_contrib_MultiBoxDetection", [prob, loc, anchors], {})
    np.testing.assert_allclose(got.asnumpy(), want[0][0], rtol=1e-5,
                               atol=1e-6)
    data = tmx.sym.var("data")
    s = tmx.sym.contrib.box_nms(data, overlap_thresh=0.5)
    rec = _records(30, (30, 6))
    ex = s.bind(tmx.cpu(), {"data": tmx.nd.array(rec)}, grad_req="null")
    np.testing.assert_allclose(
        ex.forward()[0].asnumpy(),
        jax_run("_contrib_box_nms", [rec], {"overlap_thresh": 0.5})[0][0],
        rtol=1e-5, atol=1e-6)
    pooled = tmx.nd.ROIPooling(tmx.nd.array(rand(31, 1, 2, 6, 6)),
                               tmx.nd.array(_rois(32, 3, 6, 1, 5, B=1)),
                               pooled_size=(2, 2), spatial_scale=1.0)
    assert pooled.shape == (3, 2, 2, 2)
