"""Gluon losses (counterpart of ``mxnet_tpu/gluon/loss.py``): the ``Loss``
base with its shared tail (weighting, then the mean over every axis but
the batch axis), ``L2Loss`` and ``SoftmaxCrossEntropyLoss``."""
from __future__ import annotations

from ..base import numeric_types
from .block import HybridBlock

__all__ = ["Loss", "L2Loss", "SoftmaxCrossEntropyLoss", "SoftmaxCELoss"]


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
        """Weighting + mean over the non-batch axes — the common tail."""
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return F.mean(loss, axis=self._batch_axis, exclude=True)

    def hybrid_forward(self, F, x, *args, **kwargs):
        raise NotImplementedError


class L2Loss(Loss):
    """Halved squared error (reference: loss.py:114)."""

    def __init__(self, weight=1., batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        label = _reshape_like(F, label, pred)
        # the reference's weight/2 convention lives in this 0.5 factor
        return self._finish(F, F.square(label - pred) * 0.5, sample_weight)


class SoftmaxCrossEntropyLoss(Loss):
    """Cross entropy over log-softmax, sparse or dense labels
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
