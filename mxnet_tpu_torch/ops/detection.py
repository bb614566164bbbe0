"""Detection operators (counterpart of ``mxnet_tpu/ops/detection.py``):
the MultiBox family of SSD (``_contrib_MultiBoxPrior``,
``_contrib_MultiBoxTarget``, ``_contrib_MultiBoxDetection``),
``_contrib_box_iou``, ``_contrib_box_nms``,
``_contrib_bipartite_matching``, ``_contrib_ROIAlign`` and the legacy
``ROIPooling``.

Greedy NMS is the keep mask of the suppression chain: box i (in score
order) is kept iff no kept box before it overlaps it above the
threshold. The JAX package walks it with ``lax.scan`` over an (n, n)
IoU matrix; here :func:`nms_keep` launches ``parallel/csrc/
nms_sweep.cu`` on a CUDA tensor (one chain a class, from a stable sort of
the class ids; a short chain's bit mask and sweep in one block's shared
memory, a long chain's mask across the card and its sweep 64 boxes a
step) and runs :func:`nms_keep_plain` on a CPU tensor. Its IoU takes the
JAX package's operations in their order, so the keep masks are equal bit
for bit.
``nms_topk`` (MultiBoxDetection) and ``topk`` (box_nms) are accepted and
not read, as in the JAX package: NMS runs over every box.

``ROIPooling`` takes the same max as the JAX body without its (R, PH,
PW, C, H, W) masked copy of the map: the masked max over x within each
column bin first, giving (R, PW, C, H), then over y, outside autograd;
the output is ``data`` gathered at the arg-max (the gradient goes there;
where a bin holds tied maxima, to one of them, where JAX splits it).
"""
from __future__ import annotations

import numpy as np
import torch

from ..base import MXNetError
from .extra import filled, true_div
from .registry import register

__all__ = ["nms_keep", "nms_keep_plain", "launches", "reset_launches"]

# kernel name -> launches since the last reset_launches(); a CUDA graph
# replay does not tick it
launches = {"nms_sweep": 0}


def reset_launches():
    for name in launches:
        launches[name] = 0


# ---------------------------------------------------------------------------
# box geometry (the JAX package's operations, in its order)
# ---------------------------------------------------------------------------

def _iou_corner(a, b):
    """Pairwise IoU of corner boxes a (..., Na, 4) x b (..., Nb, 4)."""
    ax1, ay1, ax2, ay2 = [a[..., :, None, i] for i in range(4)]
    bx1, by1, bx2, by2 = [b[..., None, :, i] for i in range(4)]
    iw = torch.clamp(torch.minimum(ax2, bx2) - torch.maximum(ax1, bx1),
                     min=0)
    ih = torch.clamp(torch.minimum(ay2, by2) - torch.maximum(ay1, by1),
                     min=0)
    inter = iw * ih
    area_a = torch.clamp(ax2 - ax1, min=0) * torch.clamp(ay2 - ay1, min=0)
    area_b = torch.clamp(bx2 - bx1, min=0) * torch.clamp(by2 - by1, min=0)
    return inter / torch.clamp(area_a + area_b - inter, min=1e-12)


def _iou_plus_one(a, b):
    """Pairwise IoU with the proposal ops' +1 areas (no epsilon)."""
    area_a = (a[..., 2] - a[..., 0] + 1.0) * (a[..., 3] - a[..., 1] + 1.0)
    area_b = (b[..., 2] - b[..., 0] + 1.0) * (b[..., 3] - b[..., 1] + 1.0)
    ix1 = torch.maximum(a[..., :, None, 0], b[..., None, :, 0])
    iy1 = torch.maximum(a[..., :, None, 1], b[..., None, :, 1])
    ix2 = torch.minimum(a[..., :, None, 2], b[..., None, :, 2])
    iy2 = torch.minimum(a[..., :, None, 3], b[..., None, :, 3])
    iw = torch.clamp(ix2 - ix1 + 1.0, min=0.0)
    ih = torch.clamp(iy2 - iy1 + 1.0, min=0.0)
    inter = iw * ih
    return inter / (area_a[..., :, None] + area_b[..., None, :] - inter)


def _center_to_corner(boxes):
    cx, cy, w, h = [boxes[..., i] for i in range(4)]
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)


# ---------------------------------------------------------------------------
# the greedy NMS sweep
# ---------------------------------------------------------------------------

def nms_keep_plain(boxes, thresh, cls=None, plus_one=False):
    """Keep mask (B, n) bool of the greedy chain over ``boxes`` (B, n, 4)
    already in score order: the overlap matrix, then a loop over the
    boxes (no host read). ``cls`` (B, n): suppress only within a class;
    ``plus_one``: the proposal ops' IoU."""
    over = (_iou_plus_one if plus_one else _iou_corner)(boxes, boxes) \
        > thresh
    if cls is not None:
        over = over & (cls[..., :, None] == cls[..., None, :])
    over = torch.triu(over, 1)
    B, n = boxes.shape[:2]
    keep = torch.ones((B, n), dtype=torch.bool, device=boxes.device)
    removed = torch.zeros((B, n), dtype=torch.bool, device=boxes.device)
    for i in range(n):
        k = ~removed[:, i]
        keep[:, i] = k
        removed |= over[:, i] & k[:, None]
    return keep


def _nms_order(cls):
    """Each sample's positions in class order, (B, n) int64, or None
    without a class gate: a stable sort of the ids (-0 folded onto +0),
    so a class's boxes lie together in score order and the kernel's
    chains are the runs of one id."""
    if cls is None:
        return None
    return torch.argsort(cls + 0.0, dim=-1, stable=True)


# the kernel's passes as bits (nms_sweep.cu's `passes`): all of them
NMS_ALL_PASSES = 15
# the longest chain the kernel sweeps in one block's shared memory
# (kShortMax in nms_sweep.cu); longer ones take the card-wide mask
NMS_SHORT_CHAIN = 512


def _nms_launch(fn, boxes, thresh, cls, order, plus_one, work, keep,
                passes=NMS_ALL_PASSES, stream=None):
    """Run ``nms_sweep.cu``'s entry ``fn`` over ``boxes`` (B, n, 4) fp32
    in score order into ``keep`` (B, n) bool, with ``cls`` and ``order``
    (:func:`_nms_order`) or neither, in ``work`` (``fn.workspace(B, n)``
    bytes); ``passes`` picks the kernel's passes (all: the call)."""
    B, n = boxes.shape[:2]
    rc = fn(boxes.data_ptr(), None if cls is None else cls.data_ptr(),
            None if order is None else order.data_ptr(), work.data_ptr(),
            keep.data_ptr(), B, n, float(thresh), int(bool(plus_one)),
            passes, stream)
    if rc != 0:
        raise MXNetError("nms_sweep: kernel launch failed with cudaError %d"
                         % rc)
    return keep


# (device index, stream) -> the kernel's workspace, grown to the largest
# call made there; the oldest goes past _WORKSPACES_KEPT (each is used on
# the stream it was allocated on only, so freeing one is safe)
_workspaces = {}
_WORKSPACES_KEPT = 4


def _nms_workspace(fn, device, B, n):
    """``fn.workspace(B, n)`` bytes on ``device``: kept per device and
    stream (grown, never shrunk); under a CUDA graph capture taken anew
    from the graph's pool."""
    size = int(fn.workspace(B, n))
    if size < 0:
        raise MXNetError("nms_keep: %d boxes a sample over %d samples is "
                         "beyond the kernel's range" % (n, B))
    if torch.cuda.is_current_stream_capturing():
        return torch.empty(size, dtype=torch.uint8, device=device)
    key = (device.index, torch.cuda.current_stream(device).cuda_stream)
    work = _workspaces.get(key)
    if work is None or work.numel() < size:
        _workspaces.pop(key, None)    # the allocator may reuse it now
        while len(_workspaces) >= _WORKSPACES_KEPT:
            _workspaces.pop(next(iter(_workspaces)))
        work = _workspaces[key] = torch.empty(size, dtype=torch.uint8,
                                              device=device)
    return work


def _nms_cuda(boxes, thresh, cls, plus_one):
    from ..parallel import _build
    if boxes.dtype != torch.float32:
        raise MXNetError("nms_keep: the kernel takes float32 boxes, got %s"
                         % boxes.dtype)
    B, n = boxes.shape[:2]
    boxes = boxes.contiguous()
    if cls is not None:
        cls = cls.to(device=boxes.device, dtype=torch.float32).contiguous()
    keep = torch.empty((B, n), dtype=torch.bool, device=boxes.device)
    if keep.numel() == 0:
        return keep
    fn = _build.library("nms_sweep")
    with torch.cuda.device(boxes.device):
        order = _nms_order(cls)
        work = _nms_workspace(fn, boxes.device, B, n)
        _nms_launch(fn, boxes, thresh, cls, order, plus_one, work, keep,
                    stream=torch.cuda.current_stream(boxes.device)
                    .cuda_stream)
    launches["nms_sweep"] += 1
    return keep


def nms_keep(boxes, thresh, cls=None, plus_one=False):
    """Keep mask (B, n) bool of greedy NMS over ``boxes`` (B, n, 4) in
    score order (see :func:`nms_keep_plain`). A CUDA tensor launches
    ``nms_sweep.cu`` (or raises), a CPU tensor runs the plain version; a
    ``meta`` tensor gives the shape alone."""
    boxes = boxes.detach()
    cls = None if cls is None else cls.detach()
    if boxes.device.type == "meta":
        return torch.empty(boxes.shape[:2], dtype=torch.bool, device="meta")
    if boxes.device.type == "cpu":
        return nms_keep_plain(boxes, thresh, cls, plus_one)
    if boxes.device.type != "cuda":
        raise MXNetError("nms_keep: no kernel for device %s"
                         % boxes.device)
    return _nms_cuda(boxes, thresh, cls, plus_one)


def _nms_mask(boxes, scores, thresh, cls_id=None):
    """Keep mask (B, n) in input order: a stable sort of ``-scores``,
    the sweep in that order, and the mask put back."""
    order = torch.argsort(-scores, dim=-1, stable=True)
    sb = torch.gather(boxes, 1, order[..., None].expand(boxes.shape))
    sc = None if cls_id is None else torch.gather(cls_id, 1, order)
    ks = nms_keep(sb, thresh, cls=sc)
    return torch.empty_like(ks).scatter_(1, order, ks)


# ---------------------------------------------------------------------------
# MultiBox family (SSD)
# ---------------------------------------------------------------------------

def _multibox_prior(attrs, data):
    """Anchors per feature-map cell, (1, H*W*A, 4) corners: every size
    with ratio[0], then size[0] with the other ratios."""
    sizes = [float(s) for s in attrs.get("sizes", (1.0,))]
    ratios = [float(r) for r in attrs.get("ratios", (1.0,))]
    steps = attrs.get("steps", (-1.0, -1.0))
    offsets = attrs.get("offsets", (0.5, 0.5))
    H, W = data.shape[2], data.shape[3]
    step_y = float(steps[0]) if steps and float(steps[0]) > 0 else 1.0 / H
    step_x = float(steps[1]) if steps and float(steps[1]) > 0 else 1.0 / W
    f32 = dict(dtype=torch.float32, device=data.device)
    cy = (torch.arange(H, **f32) + float(offsets[0])) * step_y
    cx = (torch.arange(W, **f32) + float(offsets[1])) * step_x
    shapes = [(s * np.sqrt(ratios[0]), s / np.sqrt(ratios[0]))
              for s in sizes]
    shapes += [(sizes[0] * np.sqrt(r), sizes[0] / np.sqrt(r))
               for r in ratios[1:]]
    ws = filled([float(w) for w, _ in shapes], data.device)
    hs = filled([float(h) for _, h in shapes], data.device)
    cyg, cxg = torch.meshgrid(cy, cx, indexing="ij")
    cxg, cyg = cxg[..., None], cyg[..., None]
    out = torch.stack([cxg - ws / 2, cyg - hs / 2, cxg + ws / 2,
                       cyg + hs / 2], -1).reshape(1, -1, 4)
    if bool(attrs.get("clip", False)):
        out = torch.clamp(out, 0.0, 1.0)
    return out


register("_contrib_MultiBoxPrior", _multibox_prior, arg_names=("data",),
         defaults={"sizes": (1.0,), "ratios": (1.0,), "clip": False,
                   "steps": (-1.0, -1.0), "offsets": (0.5, 0.5)},
         aliases=("MultiBoxPrior",))


def _multibox_target(attrs, anchor, label, cls_pred):
    """Ground truth to anchors: anchor (1, N, 4), label (B, M, 5) [cls,
    x1, y1, x2, y2] with cls -1 padding, cls_pred (B, C+1, N) (a shape
    source). (loc_target (B, N*4), loc_mask (B, N*4), cls_target (B,
    N)). Every valid ground truth takes its best anchor; where two take
    one anchor the later wins."""
    thr = float(attrs.get("overlap_threshold", 0.5))
    var = [float(v) for v in attrs.get("variances", (0.1, 0.1, 0.2, 0.2))]
    B, M = label.shape[:2]
    N = anchor.shape[1]
    anchors = anchor[0]
    gt_valid = label[..., 0] >= 0                           # (B, M)
    gt_boxes = label[..., 1:5]
    iou = _iou_corner(anchors.expand(B, N, 4), gt_boxes)    # (B, N, M)
    iou = torch.where(gt_valid[:, None, :], iou, torch.full_like(iou, -1.0))
    best_iou, best_gt = torch.max(iou, 2)
    matched = best_iou >= thr
    best_anchor = torch.argmax(iou, 1)                      # (B, M)
    slot = torch.where(gt_valid, best_anchor, torch.full_like(best_anchor,
                                                              N))
    ar = torch.arange(M, device=label.device).expand(B, M)
    gt_for = torch.full((B, N + 1), -1, dtype=torch.long,
                        device=label.device).scatter_reduce(
        1, slot, ar, reduce="amax")[:, :N]
    forced = gt_for >= 0
    matched = matched | forced
    assigned = torch.where(forced, gt_for, best_gt)         # (B, N)
    cls_t = torch.where(
        matched, torch.gather(label[..., 0], 1, assigned).to(torch.int32)
        + 1, torch.zeros_like(assigned, dtype=torch.int32))
    aw = anchors[:, 2] - anchors[:, 0]
    ah = anchors[:, 3] - anchors[:, 1]
    acx = (anchors[:, 0] + anchors[:, 2]) / 2
    acy = (anchors[:, 1] + anchors[:, 3]) / 2
    g = torch.gather(gt_boxes, 1, assigned[..., None].expand(B, N, 4))
    gw = torch.clamp(g[..., 2] - g[..., 0], min=1e-12)
    gh = torch.clamp(g[..., 3] - g[..., 1], min=1e-12)
    gcx = (g[..., 0] + g[..., 2]) / 2
    gcy = (g[..., 1] + g[..., 3]) / 2
    aw_, ah_ = torch.clamp(aw, min=1e-12), torch.clamp(ah, min=1e-12)
    loc_t = torch.stack([(gcx - acx) / aw_ / var[0],
                         (gcy - acy) / ah_ / var[1],
                         torch.log(gw / aw_) / var[2],
                         torch.log(gh / ah_) / var[3]], -1)
    mask = matched[..., None].to(loc_t.dtype)
    return ((loc_t * mask).reshape(B, -1),
            mask.expand(B, N, 4).reshape(B, -1),
            cls_t.to(cls_pred.dtype))


register("_contrib_MultiBoxTarget", _multibox_target,
         arg_names=("anchor", "label", "cls_pred"),
         defaults={"overlap_threshold": 0.5, "ignore_label": -1.0,
                   "negative_mining_ratio": -1.0,
                   "negative_mining_thresh": 0.5,
                   "minimum_negative_samples": 0,
                   "variances": (0.1, 0.1, 0.2, 0.2)},
         num_outputs=3, aliases=("MultiBoxTarget",))


def _decode_boxes(anchors, loc_pred, var):
    aw = anchors[:, 2] - anchors[:, 0]
    ah = anchors[:, 3] - anchors[:, 1]
    acx = (anchors[:, 0] + anchors[:, 2]) / 2
    acy = (anchors[:, 1] + anchors[:, 3]) / 2
    p = loc_pred.reshape(loc_pred.shape[0], -1, 4)
    cx = p[..., 0] * var[0] * aw + acx
    cy = p[..., 1] * var[1] * ah + acy
    w = torch.exp(p[..., 2] * var[2]) * aw
    h = torch.exp(p[..., 3] * var[3]) * ah
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)


def _multibox_detection(attrs, cls_prob, loc_pred, anchor):
    """Decode and NMS a class: (B, N, 6) rows [cls_id, score, x1, y1,
    x2, y2], cls_id -1 where suppressed or at or below ``threshold``."""
    nms_thr = float(attrs.get("nms_threshold", 0.5))
    score_thr = float(attrs.get("threshold", 0.01))
    var = [float(v) for v in attrs.get("variances", (0.1, 0.1, 0.2, 0.2))]
    boxes = _decode_boxes(anchor[0], loc_pred, var)
    if bool(attrs.get("clip", True)):
        boxes = torch.clamp(boxes, 0.0, 1.0)
    score, cls_id = torch.max(cls_prob[:, 1:, :], 1)
    force = bool(attrs.get("force_suppress", False))
    keep = _nms_mask(boxes, score, nms_thr,
                     cls_id=None if force else cls_id.to(torch.float32))
    keep = keep & (score > score_thr)
    out_id = torch.where(keep, cls_id.to(torch.float32),
                         torch.full_like(score, -1.0))
    return torch.cat([out_id[..., None], score[..., None], boxes], -1)


register("_contrib_MultiBoxDetection", _multibox_detection,
         arg_names=("cls_prob", "loc_pred", "anchor"),
         defaults={"clip": True, "threshold": 0.01, "background_id": 0,
                   "nms_threshold": 0.5, "force_suppress": False,
                   "variances": (0.1, 0.1, 0.2, 0.2), "nms_topk": -1},
         aliases=("MultiBoxDetection",))


# ---------------------------------------------------------------------------
# bounding_box.cc ops
# ---------------------------------------------------------------------------

def _box_iou(attrs, lhs, rhs):
    if attrs.get("format", "corner") == "center":
        lhs, rhs = _center_to_corner(lhs), _center_to_corner(rhs)
    return _iou_corner(lhs, rhs)


register("_contrib_box_iou", _box_iou, arg_names=("lhs", "rhs"),
         defaults={"format": "corner"})


def _box_nms(attrs, data):
    """Greedy NMS over (..., N, K >= 5) records: a suppressed row's score
    becomes -1, rows stay in input order (the JAX package's simplified
    ``id_index``: ids only gate suppression)."""
    thr = float(attrs.get("overlap_thresh", 0.5))
    score_thr = float(attrs.get("valid_thresh", 0.0))
    si = int(attrs.get("score_index", 1))
    cs = int(attrs.get("coord_start", 2))
    id_index = int(attrs.get("id_index", -1))
    force = bool(attrs.get("force_suppress", False))
    rows = data.reshape((-1,) + tuple(data.shape[-2:]))
    boxes = rows[..., cs:cs + 4]
    if attrs.get("in_format", "corner") == "center":
        boxes = _center_to_corner(boxes)
    scores = rows[..., si]
    ids = rows[..., id_index] if id_index >= 0 and not force else None
    keep = _nms_mask(boxes, scores, thr, cls_id=ids) & (scores >= score_thr)
    new = torch.where(keep, scores, torch.full_like(scores, -1.0))
    out = torch.cat([rows[..., :si], new[..., None], rows[..., si + 1:]], -1)
    return out.reshape(data.shape)


register("_contrib_box_nms", _box_nms, arg_names=("data",),
         defaults={"overlap_thresh": 0.5, "valid_thresh": 0.0,
                   "topk": -1, "coord_start": 2, "score_index": 1,
                   "id_index": -1, "background_id": -1,
                   "force_suppress": False, "in_format": "corner",
                   "out_format": "corner"},
         aliases=("_contrib_box_non_maximum_suppression",))


def _bipartite_matching(attrs, data):
    """Greedy bipartite matching of a score matrix (..., M, N):
    min(M, N) steps, each taking the best remaining pair (the first in
    row-major order on ties). (row_match (..., M), col_match (..., N)),
    -1 where unmatched."""
    thr = float(attrs.get("threshold", 0.5))
    ascend = bool(attrs.get("is_ascend", False))
    score = data.detach().reshape((-1,) + tuple(data.shape[-2:]))
    Bf, M, N = score.shape
    s = -score if ascend else score.clone()
    ok_thr = (score <= thr) if ascend else (score >= thr)
    rows = torch.full((Bf, M), -1.0, dtype=torch.float32, device=data.device)
    cols = torch.full((Bf, N), -1.0, dtype=torch.float32, device=data.device)
    bidx = torch.arange(Bf, device=data.device)
    neg = float("-inf")
    for _ in range(min(M, N)):
        idx = torch.argmax(s.reshape(Bf, -1), 1)
        i, j = idx // N, idx % N
        best = s[bidx, i, j]
        valid = (best > neg) & ok_thr[bidx, i, j]
        rows[bidx, i] = torch.where(valid, j.to(rows.dtype), rows[bidx, i])
        cols[bidx, j] = torch.where(valid, i.to(cols.dtype), cols[bidx, j])
        hit = valid[:, None, None] & (
            (torch.arange(M, device=data.device)[None, :, None]
             == i[:, None, None])
            | (torch.arange(N, device=data.device)[None, None, :]
               == j[:, None, None]))
        s = s.masked_fill(hit, neg)
    return (rows.reshape(data.shape[:-1]),
            cols.reshape(tuple(data.shape[:-2]) + (N,)))


register("_contrib_bipartite_matching", _bipartite_matching,
         arg_names=("data",),
         defaults={"threshold": 0.5, "is_ascend": False, "topk": -1},
         num_outputs=2)


# ---------------------------------------------------------------------------
# ROI pooling / align
# ---------------------------------------------------------------------------

def _roi_align(attrs, data, rois):
    """data (B, C, H, W), rois (R, 5) [batch, x1, y1, x2, y2] → (R, C,
    PH, PW): the mean of ns x ns bilinear samples a bin (coordinates
    clamped into the map)."""
    ph, pw = [int(s) for s in attrs["pooled_size"]]
    scale = float(attrs.get("spatial_scale", 1.0))
    ratio = int(attrs.get("sample_ratio", -1))
    ns = ratio if ratio > 0 else 2
    B, C, H, W = data.shape
    R = rois.shape[0]
    dev = data.device
    b = rois[:, 0].to(torch.int64)
    x1, y1 = rois[:, 1] * scale, rois[:, 2] * scale
    x2, y2 = rois[:, 3] * scale, rois[:, 4] * scale
    bh = true_div(torch.clamp(y2 - y1, min=1.0), ph)
    bw = true_div(torch.clamp(x2 - x1, min=1.0), pw)
    iy = torch.arange(ph, device=dev).reshape(1, ph, 1, 1, 1)
    ix = torch.arange(pw, device=dev).reshape(1, 1, pw, 1, 1)
    sy = torch.arange(ns, device=dev).reshape(1, 1, 1, ns, 1)
    sx = torch.arange(ns, device=dev).reshape(1, 1, 1, 1, ns)
    r5 = (R, 1, 1, 1, 1)
    yy = y1.reshape(r5) + bh.reshape(r5) * (iy + true_div(sy + 0.5, ns))
    xx = x1.reshape(r5) + bw.reshape(r5) * (ix + true_div(sx + 0.5, ns))
    yy, xx = torch.broadcast_tensors(yy, xx)
    y = torch.clamp(yy.reshape(R, -1), 0.0, H - 1.0)
    x = torch.clamp(xx.reshape(R, -1), 0.0, W - 1.0)
    y0, x0 = torch.floor(y).long(), torch.floor(x).long()
    y1_, x1_ = torch.clamp(y0 + 1, max=H - 1), torch.clamp(x0 + 1, max=W - 1)
    wy, wx = y - y0, x - x0
    rows = data.permute(0, 2, 3, 1).reshape(B * H * W, C)
    base = b[:, None] * (H * W)

    def at(yi, xi):     # (R, P, C)
        return rows[(base + yi * W + xi).reshape(-1)].reshape(R, -1, C)
    wy, wx = wy[..., None], wx[..., None]
    vals = (at(y0, x0) * (1 - wy) * (1 - wx) + at(y0, x1_) * (1 - wy) * wx
            + at(y1_, x0) * wy * (1 - wx) + at(y1_, x1_) * wy * wx)
    vals = vals.reshape(R, ph, pw, ns * ns, C).mean(3)
    return vals.permute(0, 3, 1, 2)


register("_contrib_ROIAlign", _roi_align, arg_names=("data", "rois"),
         defaults={"pooled_size": (7, 7), "spatial_scale": 1.0,
                   "sample_ratio": -1, "position_sensitive": False},
         aliases=("ROIAlign",))


def _roi_pooling(attrs, data, rois):
    """The max over each integer bin (roi_pooling.cc), 0 for an empty
    bin. The arg-max is found without autograd, the max over x within
    each column bin first, then over y; the output gathers ``data`` at
    it, so the gradient goes to the arg-max and the graph keeps indices
    only."""
    ph, pw = [int(s) for s in attrs["pooled_size"]]
    scale = float(attrs.get("spatial_scale", 1.0))
    C, H, W = data.shape[1:]
    dev = data.device
    b = rois[:, 0].to(torch.int64)
    x1, y1, x2, y2 = [torch.round(rois[:, k] * scale).to(torch.int64)
                      for k in range(1, 5)]
    rw = torch.clamp(x2 - x1 + 1, min=1)
    rh = torch.clamp(y2 - y1 + 1, min=1)

    def bins(lo, size, n, extent):
        k = torch.arange(n, device=dev)[None, :]
        start = lo[:, None] + (k * size[:, None]) // n
        end = lo[:, None] + ((k + 1) * size[:, None] + n - 1) // n
        at = torch.arange(extent, device=dev)
        return (at >= start[..., None]) & (at < end[..., None])  # (R, n, ext)
    in_x, in_y = bins(x1, rw, pw, W), bins(y1, rh, ph, H)
    neg = float("-inf")
    with torch.no_grad():
        feat = data.detach()[b]                                  # (R, C, H, W)
        cols = [feat.masked_fill(~in_x[:, j, None, None, :], neg).max(-1)
                for j in range(pw)]
        col_v = torch.stack([v for v, _ in cols], 1)             # (R, PW, C, H)
        col_x = torch.stack([x for _, x in cols], 1)
        del feat, cols
        h_at = torch.stack([col_v.masked_fill(~in_y[:, i, None, None, :], neg)
                            .max(-1)[1] for i in range(ph)], 1)  # (R, PH, PW, C)
        w_at = torch.gather(col_x[:, None].expand((-1, ph) + col_x.shape[1:]),
                            4, h_at[..., None])[..., 0]
        plane = b[:, None, None, None] * C + torch.arange(C, device=dev)
        idx = (plane * H + h_at) * W + w_at
    out = data.reshape(-1)[idx.reshape(-1)].reshape(idx.shape)
    live = in_y.any(-1)[:, :, None] & in_x.any(-1)[:, None, :]
    out = torch.where(live[..., None], out, torch.zeros_like(out))
    return out.permute(0, 3, 1, 2)


register("ROIPooling", _roi_pooling, arg_names=("data", "rois"),
         defaults={"pooled_size": (7, 7), "spatial_scale": 1.0})
