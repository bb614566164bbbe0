"""Evaluation metrics (counterpart of ``mxnet_tpu/metric.py``).

Every built-in metric is a *batch statistic*: a method returning
``(stat_sum, count)`` for one (label, pred) pair, which the base
accumulates into the running ``sum_metric / num_inst`` average.
Regression metrics share one elementwise-error class, F1 and MCC one
confusion-matrix accumulator, the likelihood metrics one gather of the
true class's probability. Metrics run in numpy on the host: each update
copies the outputs back from the device, one sync a batch, as in the
JAX package and the reference.
"""
from __future__ import annotations

import math
from collections import OrderedDict

import numpy

from .base import Registry, MXNetError, numeric_types

__all__ = ["EvalMetric", "CompositeEvalMetric", "Accuracy", "TopKAccuracy",
           "F1", "MCC", "Perplexity", "MAE", "MSE", "RMSE", "CrossEntropy",
           "NegativeLogLikelihood", "PearsonCorrelation", "Loss", "Torch",
           "Caffe", "CustomMetric", "np", "create", "register"]

_REG: Registry = Registry("metric", case_sensitive=False)


def register(klass):
    _REG.register(klass.__name__)(klass)
    return klass


def _host(x):
    """Fetch to host numpy (NDArray or array-like); a bfloat16 array,
    which numpy cannot hold, comes back as its float32 values."""
    if str(getattr(x, "dtype", "")) == "bfloat16":
        x = x.astype("float32")
    asnumpy = getattr(x, "asnumpy", None)
    return asnumpy() if asnumpy is not None else numpy.asarray(x)


def _listify(x):
    from .ndarray import NDArray
    return [x] if isinstance(x, NDArray) else x


def check_label_shapes(labels, preds, wrap=False, shape=False):
    """Reference-compatible shape guard (metric.py:32)."""
    got = (labels.shape, preds.shape) if shape else \
        (len(labels), len(preds))
    if got[0] != got[1]:
        raise ValueError(
            "Shape of labels {} does not match shape of predictions {}"
            .format(*got))
    if wrap:
        labels, preds = _listify(labels), _listify(preds)
    return labels, preds


def _as_2d(a):
    return a.reshape(a.shape[0], 1) if a.ndim == 1 else a


def _gathered_probs(label, pred):
    """Probability assigned to each sample's true class: pred rows
    indexed by the integer labels."""
    flat = label.ravel().astype(numpy.int64)
    rows = pred.reshape(-1, pred.shape[-1])
    if flat.shape[0] != rows.shape[0]:
        raise ValueError(
            "label count %d does not match prediction rows %d"
            % (flat.shape[0], rows.shape[0]))
    return flat, rows[numpy.arange(flat.shape[0]), flat]


class EvalMetric:
    """Running-average metric base (reference: metric.py:56).

    Built-ins implement :meth:`_batch_stat`; overriding :meth:`update`
    wholesale (the reference's protocol) also works.
    """

    def __init__(self, name, output_names=None, label_names=None, **kwargs):
        self.name = str(name)
        self.output_names, self.label_names = output_names, label_names
        self._kwargs = kwargs
        self.reset()

    def __str__(self):
        return "EvalMetric: {}".format(dict(self.get_name_value()))

    def get_config(self):
        cfg = dict(self._kwargs,
                   metric=type(self).__name__, name=self.name,
                   output_names=self.output_names,
                   label_names=self.label_names)
        return cfg

    # -- accumulation -----------------------------------------------------
    def _batch_stat(self, label, pred):
        raise NotImplementedError(
            "%s defines neither _batch_stat nor update" % type(self))

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, True)
        for label, pred in zip(labels, preds):
            s, n = self._batch_stat(_host(label), _host(pred))
            self.sum_metric += s
            self.num_inst += n

    def update_dict(self, label, pred):
        pick = lambda d, names: [d[k] for k in names] if names is not None \
            else list(d.values())
        self.update(pick(label, self.label_names),
                    pick(pred, self.output_names))

    def reset(self):
        self.sum_metric, self.num_inst = 0.0, 0

    # -- readout ----------------------------------------------------------
    def _value(self):
        return self.sum_metric / self.num_inst

    def get(self):
        if not self.num_inst:
            return (self.name, float("nan"))
        return (self.name, self._value())

    def get_name_value(self):
        name, value = self.get()
        names = name if isinstance(name, list) else [name]
        values = value if isinstance(value, list) else [value]
        return list(zip(names, values))


@register
class CompositeEvalMetric(EvalMetric):
    """Fan-out wrapper over child metrics (reference: metric.py:212)."""

    def __init__(self, metrics=None, name="composite", output_names=None,
                 label_names=None):
        super().__init__(name, output_names, label_names)
        self.metrics = [create(m) for m in (metrics or [])]

    def add(self, metric):
        self.metrics.append(create(metric))

    def get_metric(self, index):
        try:
            return self.metrics[index]
        except IndexError:
            return ValueError(
                "Metric index {} is out of range 0 and {}"
                .format(index, len(self.metrics)))

    def update_dict(self, labels, preds):
        for child in self.metrics:
            child.update_dict(labels, preds)

    def update(self, labels, preds):
        for child in self.metrics:
            child.update(labels, preds)

    def reset(self):
        for child in getattr(self, "metrics", ()):
            child.reset()

    def get(self):
        names, values = [], []
        for child in self.metrics:
            for n, v in child.get_name_value():
                names.append(n)
                values.append(v)
        return (names, values)


# ---------------------------------------------------------------------------
# classification
# ---------------------------------------------------------------------------

@register
class Accuracy(EvalMetric):
    """Fraction of argmax predictions equal to the label
    (reference: metric.py:365).

    ``ignore_label`` drops positions whose label equals it BEFORE
    counting — hits and the denominator alike — so padded bucketed
    batches (``bucketing``) score identically to their
    unpadded samples: the selection is an ordered boolean take, the
    ignored rows simply never existed."""

    def __init__(self, axis=1, name="accuracy", output_names=None,
                 label_names=None, ignore_label=None):
        super().__init__(name, output_names, label_names, axis=axis,
                         ignore_label=ignore_label)
        self.axis = axis
        self.ignore_label = ignore_label

    def _batch_stat(self, label, pred):
        if pred.shape != label.shape:
            pred = pred.argmax(axis=self.axis)
        pred = pred.ravel().astype(numpy.int32)
        label_raw = label.ravel()
        label = label_raw.astype(numpy.int32)
        check_label_shapes(label, pred)     # no silent broadcasting
        if self.ignore_label is not None:
            keep = label_raw != self.ignore_label
            pred, label = pred[keep], label[keep]
        hits = numpy.equal(pred, label)
        return hits.sum(), hits.size


@register
class TopKAccuracy(EvalMetric):
    """Label within the k highest-scored classes
    (reference: metric.py:439)."""

    def __init__(self, top_k=1, name="top_k_accuracy", output_names=None,
                 label_names=None):
        if top_k <= 1:
            raise ValueError("use Accuracy for top_k <= 1")
        super().__init__("%s_%d" % (name, top_k), output_names,
                         label_names, top_k=top_k)
        self.top_k = top_k

    def _batch_stat(self, label, pred):
        if pred.ndim > 2:
            raise ValueError("TopKAccuracy expects <= 2-d predictions")
        label = label.astype(numpy.int64).ravel()
        if pred.ndim == 1:
            return numpy.equal(pred.astype(numpy.int64),
                               label).sum(), label.shape[0]
        k = min(self.top_k, pred.shape[1])
        top = numpy.argpartition(pred.astype(numpy.float32), -k)[:, -k:]
        hits = (top == label[:, None]).any(axis=1)
        return hits.sum(), label.shape[0]


class _Confusion:
    """2x2 confusion counts via one bincount per batch."""

    __slots__ = ("counts",)

    def __init__(self):
        self.clear()

    def clear(self):
        self.counts = numpy.zeros(4, dtype=numpy.int64)

    def absorb(self, label, pred_scores):
        label = label.astype(numpy.int64).ravel()
        if numpy.unique(label).size > 2:
            raise ValueError(
                "confusion-matrix metrics support binary labels only")
        check_label_shapes(label, pred_scores)
        # anything other than class 1 counts as negative — matches the
        # reference's (pred_label == 1)/(label == 1) convention, and
        # keeps bincount indices in [0, 4) for signed labels or extra
        # prediction columns
        truth = (label == 1).astype(numpy.int64)
        decided = (pred_scores.argmax(axis=1) == 1).astype(numpy.int64)
        self.counts += numpy.bincount(2 * truth + decided, minlength=4)

    # counts layout: [TN, FP, FN, TP]
    tn = property(lambda self: float(self.counts[0]))
    fp = property(lambda self: float(self.counts[1]))
    fn = property(lambda self: float(self.counts[2]))
    tp = property(lambda self: float(self.counts[3]))

    @property
    def total(self):
        return int(self.counts.sum())

    @property
    def f1(self):
        denom = 2 * self.tp + self.fp + self.fn
        return 2 * self.tp / denom if denom else 0.0

    @property
    def mcc(self):
        num = self.tp * self.tn - self.fp * self.fn
        factors = [self.tp + self.fp, self.tp + self.fn,
                   self.tn + self.fp, self.tn + self.fn]
        denom = 1.0
        for f in factors:
            if f:
                denom *= f
        return num / math.sqrt(denom) if self.total else 0.0


class _ConfusionMetric(EvalMetric):
    """Shared macro/micro averaging over a _Confusion score."""

    _score_of = None        # property name on _Confusion

    def __init__(self, name, output_names=None, label_names=None,
                 average="macro"):
        self.average = average
        self._conf = _Confusion()
        super().__init__(name, output_names=output_names,
                         label_names=label_names)

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, True)
        for label, pred in zip(labels, preds):
            self._conf.absorb(_host(label), _host(pred))
        score = getattr(self._conf, self._score_of)
        if self.average == "macro":
            self.sum_metric += score
            self.num_inst += 1
            self._conf.clear()
        else:
            self.sum_metric = score * self._conf.total
            self.num_inst = self._conf.total

    def reset(self):
        self.sum_metric, self.num_inst = 0.0, 0
        if hasattr(self, "_conf"):
            self._conf.clear()


@register
class F1(_ConfusionMetric):
    """Binary F1 (reference: metric.py:565)."""
    _score_of = "f1"

    def __init__(self, name="f1", output_names=None, label_names=None,
                 average="macro"):
        super().__init__(name, output_names, label_names, average)


@register
class MCC(_ConfusionMetric):
    """Matthews correlation coefficient (reference: metric.py:665)."""
    _score_of = "mcc"

    def __init__(self, name="mcc", output_names=None, label_names=None,
                 average="macro"):
        super().__init__(name, output_names, label_names, average)


# ---------------------------------------------------------------------------
# likelihood family
# ---------------------------------------------------------------------------

@register
class Perplexity(EvalMetric):
    """exp of the mean negative log prob of the true class, with
    optional ignored label id (reference: metric.py:761)."""

    def __init__(self, ignore_label=None, axis=-1, name="perplexity",
                 output_names=None, label_names=None):
        super().__init__(name, output_names, label_names,
                         ignore_label=ignore_label, axis=axis)
        self.ignore_label, self.axis = ignore_label, axis

    def _batch_stat(self, label, pred):
        flat, probs = _gathered_probs(label, pred)
        count = flat.shape[0]
        if self.ignore_label is not None:
            # ordered boolean SELECTION, not a where()-to-1.0 mask: the
            # kept probabilities are the identical array an unpadded
            # batch would produce, so the summed NLL (and therefore the
            # perplexity of a padded bucketed batch) matches the
            # unpadded value bit-for-bit — where() would interleave
            # exact zeros and shift numpy's pairwise-sum grouping
            keep = flat != self.ignore_label
            probs = probs[keep]
            count = int(keep.sum())
        nll = -numpy.log(numpy.maximum(probs, 1e-10)).sum()
        return nll, count

    def _value(self):
        return math.exp(self.sum_metric / self.num_inst)


class _GatheredNLL(EvalMetric):
    """Mean -log(p_true + eps); CrossEntropy and NLL differ only in
    their default name (reference: metric.py:846, :917)."""

    def __init__(self, eps, name, output_names, label_names):
        super().__init__(name, output_names, label_names, eps=eps)
        self.eps = eps

    def _batch_stat(self, label, pred):
        flat, probs = _gathered_probs(label, pred)
        return -numpy.log(probs + self.eps).sum(), flat.shape[0]


@register
class CrossEntropy(_GatheredNLL):
    def __init__(self, eps=1e-12, name="cross-entropy", output_names=None,
                 label_names=None):
        super().__init__(eps, name, output_names, label_names)


@register
class NegativeLogLikelihood(_GatheredNLL):
    def __init__(self, eps=1e-12, name="nll-loss", output_names=None,
                 label_names=None):
        super().__init__(eps, name, output_names, label_names)


# ---------------------------------------------------------------------------
# regression
# ---------------------------------------------------------------------------

class _ElementwiseError(EvalMetric):
    """Batch-mean of an elementwise error, averaged over batches."""

    @staticmethod
    def _error(diff):
        raise NotImplementedError

    def _batch_stat(self, label, pred):
        diff = _as_2d(label) - _as_2d(pred)
        return self._error(diff), 1


@register
class MAE(_ElementwiseError):
    def __init__(self, name="mae", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    @staticmethod
    def _error(diff):
        return numpy.abs(diff).mean()


@register
class MSE(_ElementwiseError):
    def __init__(self, name="mse", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    @staticmethod
    def _error(diff):
        return numpy.square(diff).mean()


@register
class RMSE(_ElementwiseError):
    def __init__(self, name="rmse", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    @staticmethod
    def _error(diff):
        return math.sqrt(numpy.square(diff).mean())


@register
class PearsonCorrelation(EvalMetric):
    def __init__(self, name="pearsonr", output_names=None,
                 label_names=None):
        super().__init__(name, output_names, label_names)

    def _batch_stat(self, label, pred):
        check_label_shapes(label, pred, False, True)
        return numpy.corrcoef(pred.ravel(), label.ravel())[0, 1], 1


# ---------------------------------------------------------------------------
# loss passthrough + custom
# ---------------------------------------------------------------------------

@register
class Loss(EvalMetric):
    """Mean of raw loss outputs; ignores labels
    (reference: metric.py:1421)."""

    def __init__(self, name="loss", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def update(self, _, preds):
        for pred in _listify(preds):
            self.sum_metric += float(_host(pred).sum())
            self.num_inst += pred.size


@register
class Torch(Loss):
    def __init__(self, name="torch", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)


@register
class Caffe(Loss):
    def __init__(self, name="caffe", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)


@register
class CustomMetric(EvalMetric):
    """Wraps feval(label, pred) -> value or (sum, count)
    (reference: metric.py:1480)."""

    def __init__(self, feval, name=None, allow_extra_outputs=False,
                 output_names=None, label_names=None):
        if name is None:
            name = feval.__name__
            if "<" in name:
                name = "custom(%s)" % name
        super().__init__(name, output_names, label_names, feval=feval,
                         allow_extra_outputs=allow_extra_outputs)
        self._feval = feval
        self._allow_extra_outputs = allow_extra_outputs

    def update(self, labels, preds):
        if not self._allow_extra_outputs:
            labels, preds = check_label_shapes(labels, preds, True)
        for pred, label in zip(preds, labels):
            result = self._feval(_host(label), _host(pred))
            if isinstance(result, tuple):
                s, n = result
            else:
                s, n = result, 1
            self.sum_metric += s
            self.num_inst += n


def np(numpy_feval, name=None, allow_extra_outputs=False):
    """Lift a numpy feval into a CustomMetric (reference: metric.py:1566)."""

    def feval(label, pred):
        return numpy_feval(label, pred)

    feval.__name__ = numpy_feval.__name__
    return CustomMetric(feval, name, allow_extra_outputs)


_SHORTHAND = {"acc": "Accuracy", "ce": "CrossEntropy",
              "nll_loss": "NegativeLogLikelihood",
              "top_k_acc": "TopKAccuracy"}


def create(metric, *args, **kwargs):
    """Resolve str / callable / list / instance into an EvalMetric."""
    if isinstance(metric, EvalMetric):
        return metric
    if callable(metric):
        return CustomMetric(metric, *args, **kwargs)
    if isinstance(metric, list):
        bundle = CompositeEvalMetric()
        for item in metric:
            bundle.add(create(item, *args, **kwargs))
        return bundle
    if isinstance(metric, str):
        key = _SHORTHAND.get(metric.lower(), metric)
        cls = _REG.find(key)
        if cls is not None:
            return cls(*args, **kwargs)
        raise MXNetError(
            "Metric must be either callable or str; unknown: %s" % metric)
    raise TypeError("metric should be either str, callable or EvalMetric")
