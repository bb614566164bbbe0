"""Mask-aware losses and metrics: padded positions contribute ZERO
(counterpart of ``mxnet_tpu/bucketing/masked.py``).

The bucketing contract is only as good as the math downstream: padding
a batch to its ladder bucket must not change the loss, the gradients,
or the metrics. This module supplies the adapters that honor it.

**Losses** — :class:`MaskedSoftmaxCELoss` / :class:`MaskedL2Loss`
mirror ``gluon.loss.SoftmaxCrossEntropyLoss`` / ``L2Loss`` but take an
explicit ``(batch, positions)`` validity mask (``padding.position_mask``
of the bucket's ``valid_lengths``): the pointwise penalty is multiplied
by the mask BEFORE any reduction, and each sample's loss divides by its
own valid-position count — so a padded row's loss is exactly 0.0, a
padded position's gradient is exactly 0.0, and the per-sample values
equal the unpadded computation bit-for-bit (the padded terms enter
every sum as true IEEE zeros). :func:`masked_batch_loss` is the
matching batch reduction (sum over samples / number of REAL samples) —
``loss_vec.mean()`` would divide by the bucket's row count, silently
shrinking gradients by the row-padding factor.

**Metrics** — :class:`MaskedMetric` wraps any ``metric``
metric: it drops padded positions by ``ignore_label`` boolean selection
BEFORE delegating, so the wrapped metric sees the identical (ordered)
values an unpadded evaluation would and its denominator counts only
real positions. ``metric.Accuracy(ignore_label=...)`` and
``metric.Perplexity(ignore_label=...)`` apply the same selection
natively; the wrapper is for metrics without the knob.

The symbolic Module path needs no adapter: label padding with the
symbol's ``ignore_label`` (``SoftmaxOutput(use_ignore=True,
normalization='valid')``) already zeroes padded-position gradients and
divides by the valid count inside the step.
"""
from __future__ import annotations

from ..base import MXNetError
from ..gluon.loss import Loss as _GluonLoss
from ..metric import EvalMetric, create as _metric_create

__all__ = ["MaskedSoftmaxCELoss", "MaskedL2Loss",
           "PackedSoftmaxCELoss", "PackedL2Loss", "masked_batch_loss",
           "MaskedMetric"]


class _MaskedLoss(_GluonLoss):
    """Shared pipeline: pointwise penalty * mask, per-sample sum /
    per-sample valid count. Returns the per-sample loss vector (pad
    rows exactly 0); reduce across samples with
    :func:`masked_batch_loss`."""

    def __init__(self, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)

    def _penalty(self, F, pred, label):
        raise NotImplementedError

    def hybrid_forward(self, F, pred, label, mask):
        per_pos = self._penalty(F, pred, label)
        # reshape_like, not .reshape(per_pos.shape): the loss must
        # hybridize (Symbols have no concrete .shape)
        mask = F.reshape_like(mask, per_pos)
        per_pos = per_pos * mask
        loss = F.sum(per_pos, axis=self._batch_axis, exclude=True)
        count = F.sum(mask, axis=self._batch_axis, exclude=True)
        # pad rows: 0 / max(0, 1) = exactly 0, never NaN
        loss = loss / F.broadcast_maximum(count, count * 0 + 1.0)
        if self._weight is not None:
            loss = loss * self._weight
        return loss


class MaskedSoftmaxCELoss(_MaskedLoss):
    """Per-position sparse softmax cross-entropy, masked. ``pred`` is
    ``(batch, positions, classes)`` logits (or ``from_logits=True``
    log-probs), ``label``/``mask`` are ``(batch, positions)``."""

    def __init__(self, axis=-1, from_logits=False, weight=None,
                 batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._axis = axis
        self._from_logits = from_logits

    def _penalty(self, F, pred, label):
        logp = pred if self._from_logits else \
            F.log_softmax(pred, axis=self._axis)
        return -F.pick(logp, label, axis=self._axis, keepdims=False)


class MaskedL2Loss(_MaskedLoss):
    """Halved squared error per position, masked (the ``L2Loss``
    convention's 0.5 factor included)."""

    def _penalty(self, F, pred, label):
        label = F.reshape_like(label, pred)
        return F.square(label - pred) * 0.5


class _PackedLoss(_MaskedLoss):
    """Per-SAMPLE losses out of a PACKED batch, where one row holds
    several samples: the pointwise penalty is computed on the packed
    layout, then ``packing.segment_gather``'s indices rearrange it to
    the PADDED layout (sample ``s`` on row ``s`` at offset 0) before
    the per-row masked reduction — from there the computation is
    byte-for-byte the :class:`_MaskedLoss` pipeline, so per-sample
    losses AND gradients equal the padded (and unpadded) values
    bit-exactly at any bucket length (an in-place masked reduction
    would drift by an ulp once the row reduction vectorizes: a
    sample's terms would group by its row offset). Feed the resulting
    vector to :func:`masked_batch_loss` with ``n_valid = n_segments``
    exactly like the padded path."""

    def hybrid_forward(self, F, pred, label, indices, mask):
        per_pos = self._penalty(F, pred, label)      # (rows, L)
        # to the padded layout: (n_segments, L), sample s at offset 0
        per_pos = F.gather_nd(per_pos, indices) * mask
        loss = F.sum(per_pos, axis=self._batch_axis, exclude=True)
        count = F.sum(mask, axis=self._batch_axis, exclude=True)
        # absent segments: 0 / max(0, 1) = exactly 0, never NaN
        loss = loss / F.broadcast_maximum(count, count * 0 + 1.0)
        if self._weight is not None:
            loss = loss * self._weight
        return loss


class PackedSoftmaxCELoss(_PackedLoss, MaskedSoftmaxCELoss):
    """Per-position sparse softmax cross-entropy over a packed batch.
    ``pred`` is ``(rows, positions, classes)`` logits, ``label`` is
    ``(rows, positions)`` (``invalid_label`` at pad positions is fine
    — those positions never survive the gather's mask), and
    ``indices``/``mask`` come from ``packing.segment_gather(
    batch.segment_ids, batch.n_segments)``. Returns the
    ``(n_segments,)`` per-sample loss vector."""


class PackedL2Loss(_PackedLoss, MaskedL2Loss):
    """Halved squared error per position over a packed batch (same
    ``segment_gather`` contract as :class:`PackedSoftmaxCELoss`)."""


def masked_batch_loss(per_sample_loss, n_valid):
    """Reduce a per-sample masked-loss vector over the REAL samples:
    ``sum(loss) / n_valid``. Pad rows contribute exact zeros to the
    sum, so this equals the unpadded batch mean — where
    ``loss.mean()`` over the padded vector would divide by the bucket
    row count instead and shrink every gradient."""
    n = int(n_valid)
    if n < 1:
        raise MXNetError("masked_batch_loss: n_valid must be >= 1")
    return per_sample_loss.sum() / float(n)


class MaskedMetric(EvalMetric):
    """Wrap any metric so padded positions never reach it: labels
    equal to ``ignore_label`` are dropped (with their prediction rows)
    by ordered boolean selection before delegating — the inner metric
    sees exactly the arrays an unpadded evaluation would, value AND
    denominator."""

    def __init__(self, inner, ignore_label, name=None):
        self._inner = _metric_create(inner)
        self.ignore_label = ignore_label
        super().__init__(name or "masked-%s" % self._inner.name,
                         ignore_label=ignore_label)

    def update(self, labels, preds):
        from ..metric import _host, _listify, check_label_shapes
        labels, preds = check_label_shapes(labels, preds, True)
        kept_l, kept_p = [], []
        for label, pred in zip(_listify(labels), _listify(preds)):
            label = _host(label)
            pred = _host(pred)
            flat = label.ravel()
            keep = flat != self.ignore_label
            if pred.shape == label.shape:
                pred_sel = pred.ravel()[keep]
            else:
                rows = pred.reshape(-1, pred.shape[-1])
                if rows.shape[0] != flat.shape[0]:
                    raise MXNetError(
                        "MaskedMetric: %d labels do not match %d "
                        "prediction rows" % (flat.shape[0],
                                             rows.shape[0]))
                pred_sel = rows[keep]
            kept_l.append(flat[keep])
            kept_p.append(pred_sel)
        self._inner.update(kept_l, kept_p)

    def reset(self):
        if hasattr(self, "_inner"):
            self._inner.reset()

    def get(self):
        name, value = self._inner.get()
        return (self.name, value)
