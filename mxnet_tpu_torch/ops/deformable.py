"""The deformable and proposal detection ops, ``count_sketch`` and
``cast_storage`` (counterpart of ``mxnet_tpu/ops/deformable.py``):
``_contrib_DeformableConvolution``, ``_contrib_PSROIPooling``,
``_contrib_DeformablePSROIPooling``, ``_contrib_Proposal``/``Proposal``,
``_contrib_MultiProposal``/``MultiProposal`` and
``_contrib_count_sketch``.

The proposal ops run their greedy NMS through
:func:`mxnet_tpu_torch.ops.detection.nms_keep` (the ``nms_sweep.cu``
kernel on a CUDA tensor) with the +1 IoU; their top-k is a stable sort
of the scores (the lower index first on ties, as ``lax.top_k``), and
the count of kept boxes and its cyclic repeat stay on the device.

``cast_storage``: a graph carries every array dense, so the body is the
identity on values; the storage type is honoured at the NDArray layer
(``nd.cast_storage`` and ``NDArray.tostype``, ``ndarray/sparse.py``),
where sparse arrays exist."""
from __future__ import annotations

import numpy as np
import torch

from ..base import MXNetError
from .extra import filled, true_div
from .registry import register


def _cast_storage(attrs, data):
    stype = attrs.get("stype", "default")
    if stype not in ("default", "row_sparse", "csr"):
        raise MXNetError("cast_storage: unknown stype %r" % (stype,))
    return data.clone()


register("cast_storage", _cast_storage, arg_names=("data",),
         defaults={"stype": "default"},
         attr_docs={"stype": "target storage type: default | "
                             "row_sparse | csr"})


def _pair(v, default):
    if v is None or v == ():
        return (default, default)
    if isinstance(v, int):
        return (v, v)
    t = tuple(int(x) for x in v)
    return t if len(t) == 2 else (t[0], t[0])


# ---------------------------------------------------------------------------
# DeformableConvolution (deformable_convolution.cc)
# ---------------------------------------------------------------------------

def _deformable_convolution(attrs, data, offset, weight, bias=None):
    """data (B, C, H, W); offset (B, NDG*2*kh*kw, OH, OW), each tap's
    (dy, dx) inside its deformable group; weight (F, C/G, kh, kw). Each
    tap samples bilinearly (zero outside (-1, H) x (-1, W)), then one
    grouped contraction."""
    kernel = tuple(int(k) for k in attrs["kernel"])
    if len(kernel) != 2:
        raise MXNetError("DeformableConvolution supports 2D kernels "
                         "(reference GPU impl is 2D-only)")
    kh, kw = kernel
    sh, sw = _pair(attrs.get("stride"), 1)
    dh, dw = _pair(attrs.get("dilate"), 1)
    ph, pw = _pair(attrs.get("pad"), 0)
    G = int(attrs.get("num_group", 1))
    NDG = int(attrs.get("num_deformable_group", 1))
    B, C, H, W = data.shape
    F_ = weight.shape[0]
    OH = (H + 2 * ph - (dh * (kh - 1) + 1)) // sh + 1
    OW = (W + 2 * pw - (dw * (kw - 1) + 1)) // sw + 1
    taps = kh * kw
    dt = torch.promote_types(offset.dtype, torch.float32)
    dev = data.device
    off = offset.reshape(B, NDG, taps, 2, OH, OW).to(dt)
    t = torch.arange(taps, device=dev)
    tap_y = ((t // kw) * dh).to(dt)[:, None, None]
    tap_x = ((t % kw) * dw).to(dt)[:, None, None]
    base_y = (torch.arange(OH, device=dev) * sh - ph).to(dt)[None, :, None]
    base_x = (torch.arange(OW, device=dev) * sw - pw).to(dt)[None, None, :]
    y = tap_y + base_y + off[:, :, :, 0]          # (B, NDG, taps, OH, OW)
    x = tap_x + base_x + off[:, :, :, 1]
    in_range = (y > -1.0) & (y < H) & (x > -1.0) & (x < W)
    y0f, x0f = torch.floor(y), torch.floor(x)
    y0, x0 = y0f.long(), x0f.long()
    wy, wx = y - y0f, x - x0f
    Cg = C // NDG
    flat = data.reshape(B * NDG, Cg, H * W)
    samp = torch.zeros((B * NDG, Cg, taps * OH * OW), dtype=data.dtype,
                       device=dev)
    for ddy in (0, 1):
        for ddx in (0, 1):
            yy, xx = y0 + ddy, x0 + ddx
            valid = (yy >= 0) & (yy < H) & (xx >= 0) & (xx < W) & in_range
            w = (wy if ddy else 1.0 - wy) * (wx if ddx else 1.0 - wx)
            idx = (yy.clamp(0, H - 1) * W + xx.clamp(0, W - 1)).reshape(
                B * NDG, 1, -1)
            v = torch.gather(flat, 2, idx.expand(-1, Cg, -1))
            w = torch.where(valid, w, torch.zeros_like(w))
            samp = samp + v * w.reshape(B * NDG, 1, -1)
    vals = samp.reshape(B, G, C // G, taps, OH, OW)
    wg = weight.reshape(G, F_ // G, C // G, taps).to(vals.dtype)
    out = torch.einsum("bgcthw,gfct->bgfhw", vals, wg)
    out = out.reshape(B, F_, OH, OW).to(data.dtype)
    if bias is not None and not bool(attrs.get("no_bias", False)):
        out = out + bias.reshape(1, -1, 1, 1)
    return out


def _bias_args(names):
    def fn(attrs):
        return names[:-1] if attrs.get("no_bias", False) else names
    return fn


register("_contrib_DeformableConvolution", _deformable_convolution,
         arg_names=("data", "offset", "weight", "bias"),
         arg_names_fn=_bias_args(["data", "offset", "weight", "bias"]),
         defaults={"kernel": (), "stride": (), "dilate": (), "pad": (),
                   "num_filter": 0, "num_group": 1,
                   "num_deformable_group": 1, "workspace": 1024,
                   "no_bias": False, "layout": None},
         attr_docs={"kernel": "(h, w) convolution window",
                    "num_deformable_group": "offset group partitions"},
         attr_ranges={"num_filter": (1, 100000), "num_group": (1, None),
                      "num_deformable_group": (1, None)})


# ---------------------------------------------------------------------------
# PSROIPooling (psroi_pooling.cc) and DeformablePSROIPooling
# (deformable_psroi_pooling.cu)
# ---------------------------------------------------------------------------

def _psroi_channel_index(output_dim, pooled, group_size, device):
    """(output_dim, pooled, pooled): bin (i, j) of output channel ctop
    reads input channel (ctop * gs + gh) * gs + gw."""
    g = torch.clamp((torch.arange(pooled, device=device) * group_size)
                    // pooled, 0, group_size - 1)
    ct = torch.arange(output_dim, device=device)[:, None, None]
    return (ct * group_size + g[None, :, None]) * group_size \
        + g[None, None, :]


def _psroi_pooling(attrs, data, rois):
    """data (B, od*gs*gs, H, W), rois (R, 5) → (R, od, pooled, pooled):
    each bin's mean over its integer cells, from a 2-D integral image
    read at the bin's channel only."""
    scale = float(attrs["spatial_scale"])
    od = int(attrs["output_dim"])
    pooled = int(attrs["pooled_size"])
    gs = int(attrs.get("group_size", 0) or 0) or pooled
    B, C, H, W = data.shape
    R = rois.shape[0]
    dev = data.device
    c_idx = _psroi_channel_index(od, pooled, gs, dev)
    acc = torch.promote_types(data.dtype, torch.float32)
    S = torch.cumsum(torch.cumsum(data.to(acc), 2), 3)
    S = torch.nn.functional.pad(S, (1, 0, 1, 0))       # (B, C, H+1, W+1)
    b = rois[:, 0].to(torch.int64)
    x1 = torch.round(rois[:, 1]) * scale
    y1 = torch.round(rois[:, 2]) * scale
    x2 = (torch.round(rois[:, 3]) + 1.0) * scale
    y2 = (torch.round(rois[:, 4]) + 1.0) * scale
    bh = true_div(torch.clamp(y2 - y1, min=0.1), pooled)
    bw = true_div(torch.clamp(x2 - x1, min=0.1), pooled)
    i = torch.arange(pooled, dtype=torch.float32, device=dev)[None]
    hs = torch.clamp(torch.floor(i * bh[:, None] + y1[:, None]), 0, H).long()
    he = torch.clamp(torch.ceil((i + 1) * bh[:, None] + y1[:, None]),
                     0, H).long()
    ws = torch.clamp(torch.floor(i * bw[:, None] + x1[:, None]), 0, W).long()
    we = torch.clamp(torch.ceil((i + 1) * bw[:, None] + x1[:, None]),
                     0, W).long()
    flat = S.reshape(-1)
    ch = (b[:, None, None, None] * C + c_idx[None]) * (H + 1)   # (R,od,p,p)

    def at(hy, wx):     # S[b, c_idx, hy_i, wx_j] for each roi
        return flat[((ch + hy[:, None, :, None]) * (W + 1)
                     + wx[:, None, None, :]).reshape(-1)].reshape(ch.shape)
    rect = at(he, we) - at(hs, we) - at(he, ws) + at(hs, ws)
    area = ((he - hs)[:, :, None] * (we - ws)[:, None, :]).to(
        torch.float32)[:, None]
    out = torch.where(area > 0, rect / torch.clamp(area, min=1.0),
                      torch.zeros_like(rect))
    return out.to(data.dtype).reshape(R, od, pooled, pooled)


register("_contrib_PSROIPooling", _psroi_pooling,
         arg_names=("data", "rois"),
         defaults={"spatial_scale": 1.0, "output_dim": 0,
                   "pooled_size": 0, "group_size": 0},
         attr_ranges={"spatial_scale": (0.0, 1.0)})


def _deformable_psroi_pooling(attrs, data, rois, trans=None):
    """data (B, od*gs*gs, H, W), rois (R, 5), trans (R, 2*classes, part,
    part) ([x, y] a class) → (R, od, pooled, pooled): each bin, moved by
    its part's offset, is the mean of its in-bounds sample_per_part^2
    bilinear samples (clamped into the map)."""
    scale = float(attrs["spatial_scale"])
    od = int(attrs["output_dim"])
    gs = int(attrs["group_size"])
    pooled = int(attrs["pooled_size"])
    part = int(attrs.get("part_size", 0) or 0) or pooled
    ns = int(attrs.get("sample_per_part", 1))
    tstd = float(attrs.get("trans_std", 0.0))
    no_trans = bool(attrs.get("no_trans", False)) or trans is None
    B, C, H, W = data.shape
    R = rois.shape[0]
    dev = data.device
    ncls = 1 if no_trans else trans.shape[1] // 2
    cec = max(od // ncls, 1)
    c_idx = _psroi_channel_index(od, pooled, gs, dev)
    class_id = torch.arange(od, device=dev) // cec
    part_ij = torch.arange(pooled, device=dev) * part // pooled
    part_h, part_w = part_ij[:, None], part_ij[None, :]
    b = rois[:, 0].to(torch.int64)
    r1 = (R, 1, 1, 1)
    x1 = (torch.round(rois[:, 1]) * scale - 0.5).reshape(r1)
    y1 = (torch.round(rois[:, 2]) * scale - 0.5).reshape(r1)
    x2 = ((torch.round(rois[:, 3]) + 1.0) * scale - 0.5).reshape(r1)
    y2 = ((torch.round(rois[:, 4]) + 1.0) * scale - 0.5).reshape(r1)
    rw = torch.clamp(x2 - x1, min=0.1)
    rh = torch.clamp(y2 - y1, min=0.1)
    bh, bw = true_div(rh, pooled), true_div(rw, pooled)
    sub_h, sub_w = true_div(bh, ns), true_div(bw, ns)
    if no_trans:
        trans_x = torch.zeros((R, ncls, pooled, pooled), device=dev)
        trans_y = torch.zeros((R, ncls, pooled, pooled), device=dev)
    else:
        t = trans.reshape(R, ncls, 2, part, part)
        trans_x = t[:, :, 0][:, :, part_h, part_w] * tstd
        trans_y = t[:, :, 1][:, :, part_h, part_w] * tstd
    i = torch.arange(pooled, dtype=torch.float32, device=dev)
    hstart = (i[None, None, :, None] * bh + y1) + trans_y * rh
    wstart = (i[None, None, None, :] * bw + x1) + trans_x * rw
    si = torch.arange(ns, dtype=torch.float32, device=dev)
    r6 = (R, 1, 1, 1, 1, 1)
    hh = hstart[..., None, None] + (si[:, None] * sub_h.reshape(r6))
    ww = wstart[..., None, None] + (si[None, :] * sub_w.reshape(r6))
    hh, ww = torch.broadcast_tensors(hh, ww)      # (R, ncls, p, p, ns, ns)
    valid = (ww >= -0.5) & (ww <= W - 0.5) & (hh >= -0.5) & (hh <= H - 0.5)
    hc = torch.clamp(hh, 0.0, H - 1.0)
    wc = torch.clamp(ww, 0.0, W - 1.0)
    # each output channel's class: (R, od, p, p, ns, ns)
    hc, wc, valid = (v[:, class_id] for v in (hc, wc, valid))
    y0f, x0f = torch.floor(hc), torch.floor(wc)
    y0, x0 = y0f.long(), x0f.long()
    y1_, x1_ = torch.clamp(y0 + 1, max=H - 1), torch.clamp(x0 + 1, max=W - 1)
    wy, wx = hc - y0f, wc - x0f
    feat = data.to(torch.promote_types(data.dtype, torch.float32))
    flat = feat.reshape(-1)
    ch = ((b[:, None, None, None] * C + c_idx[None]) * H)[..., None, None]

    def at(yy, xx):
        return flat[((ch + yy) * W + xx).reshape(-1)].reshape(yy.shape)
    v = (at(y0, x0) * (1 - wy) * (1 - wx) + at(y0, x1_) * (1 - wy) * wx
         + at(y1_, x0) * wy * (1 - wx) + at(y1_, x1_) * wy * wx)
    cnt = valid.sum((-1, -2))
    s = torch.where(valid, v, torch.zeros_like(v)).sum((-1, -2))
    out = torch.where(cnt > 0, s / torch.clamp(cnt, min=1),
                      torch.zeros_like(s))
    return out.to(data.dtype)


def _trans_args(names):
    def fn(attrs):
        return names[:-1] if attrs.get("no_trans", False) else names
    return fn


register("_contrib_DeformablePSROIPooling", _deformable_psroi_pooling,
         arg_names=("data", "rois", "trans"),
         arg_names_fn=_trans_args(["data", "rois", "trans"]),
         defaults={"spatial_scale": 1.0, "output_dim": 0,
                   "group_size": 0, "pooled_size": 0, "part_size": 0,
                   "sample_per_part": 1, "trans_std": 0.0,
                   "no_trans": False},
         attr_ranges={"spatial_scale": (0.0, 1.0),
                      "trans_std": (0.0, 1.0)})


# ---------------------------------------------------------------------------
# Proposal / MultiProposal (proposal.cc, multi_proposal.cc)
# ---------------------------------------------------------------------------

def _generate_anchors(stride, scales, ratios):
    """proposal-inl.h GenerateAnchors: ratio-major, the reference's
    floor/round arithmetic."""
    base = np.array([0, 0, stride - 1, stride - 1], np.float32)
    w = base[2] - base[0] + 1.0
    h = base[3] - base[1] + 1.0
    x_ctr = base[0] + 0.5 * (w - 1.0)
    y_ctr = base[1] + 0.5 * (h - 1.0)
    size = w * h
    out = []
    for r in ratios:
        size_r = np.floor(size / r)
        new_w = np.floor(np.sqrt(size_r) + 0.5)
        new_h = np.floor((new_w * r) + 0.5)
        for s in scales:
            ws, hs = new_w * s, new_h * s
            out.append([x_ctr - 0.5 * (ws - 1.0), y_ctr - 0.5 * (hs - 1.0),
                        x_ctr + 0.5 * (ws - 1.0), y_ctr + 0.5 * (hs - 1.0)])
    return np.asarray(out, np.float32)


def _proposals(attrs, fg_scores, deltas, im_info):
    """The RPN proposal pipeline over a batch: fg_scores (B, A, Hf, Wf),
    deltas (B, 4A, Hf, Wf), im_info (B, 3) (height, width, scale) →
    (rois (B, post_n, 4), scores (B, post_n)): decode, clip, drop
    padded cells and boxes under the minimum size, the top pre_n by a
    stable sort, greedy NMS (+1 IoU), the kept boxes in order repeated
    cyclically to post_n. Everything stays on the device."""
    from .detection import nms_keep
    stride = int(attrs["feature_stride"])
    B, A, Hf, Wf = fg_scores.shape
    dev = fg_scores.device
    count = A * Hf * Wf
    pre_n = int(attrs["rpn_pre_nms_top_n"])
    pre_n = min(pre_n, count) if pre_n > 0 else count
    post_n = min(int(attrs["rpn_post_nms_top_n"]), pre_n)
    anchors = filled(_generate_anchors(
        stride, [float(s) for s in attrs["scales"]],
        [float(r) for r in attrs["ratios"]]).reshape(-1).tolist(),
        dev).reshape(-1, 4)
    im_h, im_w, im_scale = (im_info[:, k].reshape(B, 1, 1, 1)
                            for k in range(3))
    sx = (torch.arange(Wf, device=dev) * stride).to(torch.float32)
    sy = (torch.arange(Hf, device=dev) * stride).to(torch.float32)
    sxx, syy = sx[None, :].expand(Hf, Wf), sy[:, None].expand(Hf, Wf)
    shifts = torch.stack([sxx, syy, sxx, syy], -1)
    boxes = anchors[None, None] + shifts[:, :, None]     # (Hf, Wf, A, 4)
    d = deltas.reshape(B, A, 4, Hf, Wf).permute(0, 3, 4, 1, 2)
    if bool(attrs.get("iou_loss", False)):
        pred = boxes + d
    else:
        bw = boxes[..., 2] - boxes[..., 0] + 1.0
        bh = boxes[..., 3] - boxes[..., 1] + 1.0
        cx = boxes[..., 0] + 0.5 * (bw - 1.0)
        cy = boxes[..., 1] + 0.5 * (bh - 1.0)
        pcx = d[..., 0] * bw + cx
        pcy = d[..., 1] * bh + cy
        pw_ = torch.exp(d[..., 2]) * bw
        ph_ = torch.exp(d[..., 3]) * bh
        pred = torch.stack([pcx - 0.5 * (pw_ - 1.0), pcy - 0.5 * (ph_ - 1.0),
                            pcx + 0.5 * (pw_ - 1.0), pcy + 0.5 * (ph_ - 1.0)],
                           -1)
    lim = torch.stack([im_w - 1.0, im_h - 1.0, im_w - 1.0, im_h - 1.0],
                      -1).reshape(B, 1, 1, 1, 4)
    pred = torch.minimum(torch.clamp(pred, min=0.0), lim)
    scores = fg_scores.permute(0, 2, 3, 1)               # (B, Hf, Wf, A)
    real_h = true_div(im_h, stride).to(torch.int32)
    real_w = true_div(im_w, stride).to(torch.int32)
    pad = (torch.arange(Hf, device=dev)[None, :, None, None] >= real_h) \
        | (torch.arange(Wf, device=dev)[None, None, :, None] >= real_w)
    scores = torch.where(pad, torch.full_like(scores, -1.0), scores)
    min_size = float(attrs["rpn_min_size"]) * im_scale
    bw_ = pred[..., 2] - pred[..., 0] + 1.0
    bh_ = pred[..., 3] - pred[..., 1] + 1.0
    small = (bw_ < min_size) | (bh_ < min_size)
    half = (min_size / 2.0)[..., None]
    grow = torch.cat([-half, -half, half, half], -1)
    pred = torch.where(small[..., None], pred + grow, pred)
    scores = torch.where(small, torch.full_like(scores, -1.0), scores)
    flat_scores = scores.reshape(B, -1)       # index h*(Wf*A) + w*A + a
    flat_boxes = pred.reshape(B, -1, 4)
    order = torch.sort(-flat_scores, dim=1, stable=True)[1][:, :pre_n]
    top_sc = torch.gather(flat_scores, 1, order)
    props = torch.gather(flat_boxes, 1, order[..., None].expand(B, pre_n, 4))
    keep = nms_keep(props, float(attrs["threshold"]), plus_one=True)
    out_size = keep.sum(1, keepdim=True)
    ar = torch.arange(pre_n, device=dev)[None]
    rank = torch.where(keep, ar, pre_n + ar)
    kept_first = torch.argsort(rank, 1)
    pick = torch.remainder(torch.arange(post_n, device=dev)[None],
                           torch.clamp(out_size, min=1))
    idx = torch.gather(kept_first, 1, pick)
    return (torch.gather(props, 1, idx[..., None].expand(B, post_n, 4)),
            torch.gather(top_sc, 1, idx))


def _proposal(attrs, cls_prob, bbox_pred, im_info):
    """Batch 1 (MultiProposal is the batched form): (post_n, 5) rows
    [0, x1, y1, x2, y2]."""
    A2 = cls_prob.shape[1]
    rois, sc = _proposals(attrs, cls_prob[:1, A2 // 2:], bbox_pred[:1],
                          im_info[:1])
    rois, sc = rois[0], sc[0]
    out = torch.cat([torch.zeros_like(rois[:, :1]), rois], 1)
    if bool(attrs.get("output_score", False)):
        return out, sc[:, None]
    return out


def _multi_proposal(attrs, cls_prob, bbox_pred, im_info):
    """(B*post_n, 5) rows with the image index in column 0."""
    B, A2 = cls_prob.shape[:2]
    rois, sc = _proposals(attrs, cls_prob[:, A2 // 2:], bbox_pred, im_info)
    post_n = rois.shape[1]
    bidx = torch.arange(B, dtype=rois.dtype, device=rois.device)
    out = torch.cat([bidx[:, None, None].expand(B, post_n, 1), rois], 2)
    out = out.reshape(B * post_n, 5)
    if bool(attrs.get("output_score", False)):
        return out, sc.reshape(B * post_n, 1)
    return out


_PROPOSAL_DEFAULTS = {
    "rpn_pre_nms_top_n": 6000, "rpn_post_nms_top_n": 300,
    "threshold": 0.7, "rpn_min_size": 16,
    "scales": (4.0, 8.0, 16.0, 32.0), "ratios": (0.5, 1.0, 2.0),
    "feature_stride": 16, "output_score": False, "iou_loss": False,
}

register("_contrib_Proposal", _proposal,
         arg_names=("cls_prob", "bbox_pred", "im_info"),
         defaults=dict(_PROPOSAL_DEFAULTS),
         num_outputs=lambda attrs: 2 if attrs.get("output_score") else 1,
         aliases=("Proposal",))

register("_contrib_MultiProposal", _multi_proposal,
         arg_names=("cls_prob", "bbox_pred", "im_info"),
         defaults=dict(_PROPOSAL_DEFAULTS),
         num_outputs=lambda attrs: 2 if attrs.get("output_score") else 1,
         aliases=("MultiProposal",))


# ---------------------------------------------------------------------------
# count_sketch (count_sketch-inl.h)
# ---------------------------------------------------------------------------

def _count_sketch(attrs, data, h, s):
    """out[..., h[j]] += s[j] * data[..., j]: a scatter-add."""
    out_dim = int(attrs["out_dim"])
    lead = tuple(data.shape[:-1])
    d2 = data.reshape(-1, data.shape[-1])
    hv = h.reshape(-1).to(torch.int64)
    sv = s.reshape(-1).to(d2.dtype)
    out = torch.zeros((d2.shape[0], out_dim), dtype=d2.dtype,
                      device=d2.device)
    out = out.index_add(1, hv, d2 * sv[None, :])
    return out.reshape(lead + (out_dim,))


register("_contrib_count_sketch", _count_sketch,
         arg_names=("data", "h", "s"),
         defaults={"out_dim": 0, "processing_batch_size": 32},
         attr_ranges={"out_dim": (1, None)})
