"""Gluon losses (counterpart of ``mxnet_tpu/gluon/loss.py``), with the
JAX package's formulas in its order. The shared pipeline (reshape the
label like the prediction, a pointwise penalty, weighting, the mean
over the non-batch axes) lives once in :class:`_PointwiseLoss`; each
standard loss supplies its penalty in ``_penalty``. Losses of another
arity (Triplet, CosineEmbedding, SigmoidBCE with ``pos_weight``,
PoissonNLL, CTC) override ``hybrid_forward``."""
from __future__ import annotations

import math

from ..base import numeric_types
from .block import HybridBlock

__all__ = ["Loss", "L2Loss", "L1Loss", "SigmoidBinaryCrossEntropyLoss",
           "SigmoidBCELoss", "SoftmaxCrossEntropyLoss", "SoftmaxCELoss",
           "KLDivLoss", "CTCLoss", "HuberLoss", "HingeLoss", "SquaredHingeLoss",
           "LogisticLoss", "TripletLoss", "PoissonNLLLoss",
           "CosineEmbeddingLoss"]


def _apply_weighting(F, loss, weight=None, sample_weight=None):
    """Per-sample then global weighting (reference: loss.py:39)."""
    if sample_weight is not None:
        loss = F.broadcast_mul(loss, sample_weight)
    if weight is not None:
        if not isinstance(weight, numeric_types):
            raise AssertionError("weight must be a number")
        loss = loss * weight
    return loss


def _reshape_like(F, x, y):
    return x.reshape(y.shape)


def _softplus(F, x):
    """log(1+e^x) — the stable building block of the sigmoid-CE family."""
    return F.Activation(x, act_type="softrelu")


class Loss(HybridBlock):
    """Base loss (reference: loss.py:59)."""

    def __init__(self, weight, batch_axis, **kwargs):
        super().__init__(**kwargs)
        self._weight = weight
        self._batch_axis = batch_axis

    def __repr__(self):
        return "{}(batch_axis={}, w={})".format(
            type(self).__name__, self._batch_axis, self._weight)

    def _finish(self, F, loss, sample_weight):
        """Weighting + mean over non-batch axes — the common tail."""
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return F.mean(loss, axis=self._batch_axis, exclude=True)

    def hybrid_forward(self, F, x, *args, **kwargs):
        raise NotImplementedError


class _PointwiseLoss(Loss):
    """Template for losses of the form mean(penalty(pred, label))."""

    def __init__(self, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)

    def _penalty(self, F, pred, label):
        raise NotImplementedError

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        label = _reshape_like(F, label, pred)
        return self._finish(F, self._penalty(F, pred, label),
                            sample_weight)


class L2Loss(_PointwiseLoss):
    """Halved squared error (reference: loss.py:114)."""

    def __init__(self, weight=1., batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)

    def _penalty(self, F, pred, label):
        # the reference"s weight/2 convention lives in this 0.5 factor
        return F.square(label - pred) * 0.5


class L1Loss(_PointwiseLoss):
    """Absolute error (reference: loss.py:149)."""

    def _penalty(self, F, pred, label):
        return F.abs(label - pred)


class SigmoidBinaryCrossEntropyLoss(Loss):
    """BCE on logits (stable form) or probabilities
    (reference: loss.py:184)."""

    def __init__(self, from_sigmoid=False, weight=None, batch_axis=0,
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._from_sigmoid = from_sigmoid

    @staticmethod
    def _logit_bce(F, z, y, pos_weight):
        if pos_weight is None:
            # max(z,0) - z*y + log(1+e^-|z|)
            return F.relu(z) - z * y + _softplus(F, -F.abs(z))
        lw = 1 + F.broadcast_mul(pos_weight - 1, y)
        return z - z * y + lw * (_softplus(F, -F.abs(z)) + F.relu(-z))

    @staticmethod
    def _prob_bce(F, p, y, pos_weight):
        eps = 1e-12
        pos_term = F.log(p + eps) * y
        if pos_weight is not None:
            pos_term = F.broadcast_mul(pos_term, pos_weight)
        return -(pos_term + F.log(1. - p + eps) * (1. - y))

    def hybrid_forward(self, F, pred, label, sample_weight=None,
                       pos_weight=None):
        label = _reshape_like(F, label, pred)
        core = self._prob_bce if self._from_sigmoid else self._logit_bce
        return self._finish(F, core(F, pred, label, pos_weight),
                            sample_weight)


SigmoidBCELoss = SigmoidBinaryCrossEntropyLoss


class SoftmaxCrossEntropyLoss(Loss):
    """CE over log-softmax, sparse or dense labels
    (reference: loss.py:268)."""

    def __init__(self, axis=-1, sparse_label=True, from_logits=False,
                 weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._axis, self._sparse_label = axis, sparse_label
        self._from_logits = from_logits

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        logp = pred if self._from_logits else \
            F.log_softmax(pred, axis=self._axis)
        if self._sparse_label:
            loss = -F.pick(logp, label, axis=self._axis, keepdims=True)
        else:
            dense = _reshape_like(F, label, logp)
            loss = -F.sum(logp * dense, axis=self._axis, keepdims=True)
        return self._finish(F, loss, sample_weight)


SoftmaxCELoss = SoftmaxCrossEntropyLoss


class KLDivLoss(_PointwiseLoss):
    """KL(label || softmax(pred)) (reference: loss.py:344)."""

    def __init__(self, from_logits=True, axis=-1, weight=None,
                 batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._from_logits, self._axis = from_logits, axis

    def _penalty(self, F, pred, label):
        logp = pred if self._from_logits else \
            F.log_softmax(pred, axis=self._axis)
        return label * (F.log(label + 1e-12) - logp)


class CTCLoss(Loss):
    """Connectionist temporal classification over the ``ctc_loss`` op
    (reference: loss.py:403): blank 0, zero labels are padding unless
    ``label_lengths`` is given; one loss per sequence."""

    _PRED_LAYOUTS = ("NTC", "TNC")
    _LABEL_LAYOUTS = ("NT", "TN")

    def __init__(self, layout="NTC", label_layout="NT", weight=None,
                 **kwargs):
        if layout not in self._PRED_LAYOUTS:
            raise AssertionError(
                "Only 'NTC' and 'TNC' layouts for pred are supported, "
                "got: %s" % layout)
        if label_layout not in self._LABEL_LAYOUTS:
            raise AssertionError(
                "Only 'NT' and 'TN' layouts for label are supported, "
                "got: %s" % label_layout)
        self._layout, self._label_layout = layout, label_layout
        super().__init__(weight, label_layout.find("N"), **kwargs)

    def hybrid_forward(self, F, pred, label, pred_lengths=None,
                       label_lengths=None, sample_weight=None):
        # the op takes TNC predictions and NT labels
        if self._layout != "TNC":
            pred = F.SwapAxis(pred, dim1=0, dim2=1)
        if self._label_layout != "NT":
            label = F.SwapAxis(label, dim1=0, dim2=1)
        operands = [pred, label] + [x for x in (pred_lengths, label_lengths)
                                    if x is not None]
        loss = F._contrib_ctc_loss(
            *operands, use_data_lengths=pred_lengths is not None,
            use_label_lengths=label_lengths is not None)
        return _apply_weighting(F, loss, self._weight, sample_weight)


class HuberLoss(_PointwiseLoss):
    """Quadratic near zero, linear past rho (reference: loss.py:469)."""

    def __init__(self, rho=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight=weight, batch_axis=batch_axis, **kwargs)
        self._rho = rho

    def _penalty(self, F, pred, label):
        err = F.abs(label - pred)
        quad = (0.5 / self._rho) * F.square(err)
        return F.where(err > self._rho, err - 0.5 * self._rho, quad)


class HingeLoss(_PointwiseLoss):
    """max(0, margin - pred*label) (reference: loss.py:514)."""

    def __init__(self, margin=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight=weight, batch_axis=batch_axis, **kwargs)
        self._margin = margin

    def _penalty(self, F, pred, label):
        return F.relu(self._margin - pred * label)


class SquaredHingeLoss(HingeLoss):
    """Squared hinge (reference: loss.py:557)."""

    def _penalty(self, F, pred, label):
        return F.square(super()._penalty(F, pred, label))


class LogisticLoss(_PointwiseLoss):
    """Stable log(1+e^{-pred*label}) via the BCE form
    (reference: loss.py:600)."""

    def __init__(self, weight=None, batch_axis=0,
                 label_format="signed", **kwargs):
        super().__init__(weight=weight, batch_axis=batch_axis, **kwargs)
        if label_format not in ("signed", "binary"):
            raise ValueError(
                "label_format can only be signed or binary, recieved %s."
                % label_format)
        self._label_format = label_format

    def _penalty(self, F, pred, label):
        if self._label_format == "signed":
            label = (label + 1.0) * 0.5        # {-1,1} → {0,1}
        return F.relu(pred) - pred * label + _softplus(F, -F.abs(pred))


class TripletLoss(Loss):
    """max(0, margin + |pos-pred|² - |neg-pred|²)
    (reference: loss.py:650)."""

    def __init__(self, margin=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def hybrid_forward(self, F, pred, positive, negative):
        positive = _reshape_like(F, positive, pred)
        negative = _reshape_like(F, negative, pred)
        gap = F.square(positive - pred) - F.square(negative - pred)
        per_sample = F.sum(gap, axis=self._batch_axis, exclude=True)
        return _apply_weighting(F, F.relu(per_sample + self._margin),
                                self._weight, None)


class PoissonNLLLoss(Loss):
    """Poisson negative log likelihood (reference: loss.py:699)."""

    def __init__(self, weight=None, from_logits=True, batch_axis=0,
                 compute_full=False, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._from_logits, self._compute_full = from_logits, compute_full

    def hybrid_forward(self, F, pred, target, sample_weight=None,
                       epsilon=1e-08):
        target = _reshape_like(F, target, pred)
        if self._from_logits:
            nll = F.exp(pred) - target * pred
        else:
            nll = pred - target * F.log(pred + epsilon)
        if self._compute_full:
            # Stirling correction for target > 1
            stirling = target * F.log(target) - target + \
                0.5 * F.log(2 * math.pi * target)
            nll = nll + stirling * (target > 1)
        nll = _apply_weighting(F, nll, self._weight, sample_weight)
        return F.mean(nll)


class CosineEmbeddingLoss(Loss):
    """1-cos for positive pairs, relu(cos-margin) for negative
    (reference: loss.py:756)."""

    def __init__(self, weight=None, batch_axis=0, margin=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    @staticmethod
    def _cosine(F, x, y, axis=-1):
        dot = F.sum(x * y, axis=axis).reshape((-1, 1))
        nx = F.norm(x, axis=axis).reshape((-1, 1))
        ny = F.norm(y, axis=axis).reshape((-1, 1))
        floor = dot * 0 + 1e-12
        return dot / F.broadcast_maximum(nx * ny, floor)

    def hybrid_forward(self, F, input1, input2, label, sample_weight=None):
        input1 = _reshape_like(F, input1, input2)
        cos = self._cosine(F, input1, input2)
        label = label.reshape((-1, 1))
        loss = F.where(label == 1, 1 - cos, F.relu(cos - self._margin))
        return self._finish(F, loss, sample_weight)
