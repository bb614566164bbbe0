"""BucketedPipeline: a ragged sample stream -> ladder-bucketed batches
(counterpart of ``mxnet_tpu/bucketing/iter.py``).

The training-side twin of the serving batcher: samples of arbitrary
length are grouped into the smallest ladder bucket that fits, padded to
the bucket's sequence length (labels with ``invalid_label`` so the
mask-aware losses/metrics ignore them; data with ``pad_value``), and
emitted as :class:`~mxnet_tpu_torch.io.io.DataBatch` objects carrying
``bucket_key`` (the bucket length — what ``BucketingModule`` switches
executors on), ``pad`` (row-padding count), and ``valid_lengths`` /
``valid_rows`` attributes (what the gluon path builds masks from).

Batching discipline:

- a bucket emits as soon as ``batch_size`` samples of its length class
  are waiting (full batch, row padding only from sentence-length
  variety inside the bucket);
- a partial bucket waits at most a **straggler window** of
  ``window`` subsequently drawn samples (``MXNET_BUCKET_WINDOW``,
  default ``4 * batch_size``) before it is flushed row-padded — a rare
  length class cannot indefinitely stall its samples nor force the
  pipeline to hold unbounded state;
- stream end flushes every pending bucket (row-padded), so no sample
  is ever silently dropped for arriving at the wrong time — only
  samples LONGER than the ladder's top bucket are discarded (counted
  in the ``bucketing`` telemetry record).

The class implements the async input pipeline's split protocol
(``next_raw`` = serialized draw/group — the bucketing decisions;
``decode_raw`` = thread-safe pad/stack into host tensors), so
``Module.fit``'s ``AsyncInputPipeline`` wrap gives bucketed batches the
same decode-pool and device-prefetch treatment as fixed-shape data,
unchanged per bucket; the eager ``next()`` places the batch on the
current context.
"""
from __future__ import annotations

import warnings

import numpy as np

from .. import envs
from ..base import MXNetError
from ..io.io import DataBatch, DataDesc, DataIter, host_array, to_context
from .ladder import BucketLadder, as_ladder, ladder_from_env
from .padding import pad_samples, position_mask
from .record import BucketingStats

__all__ = ["BucketedPipeline"]


def _host_nd(arr, dtype):
    """A host NDArray of ``arr`` in ``dtype``: ``decode_raw`` builds
    host batches and only the placer (or an eager ``next()``) moves
    them to the device."""
    return host_array(np.asarray(arr, dtype=dtype))


class BucketedPipeline(DataIter):
    """Group a ragged sample stream into ladder buckets.

    ``source`` is a list/tuple of samples, a callable returning a
    fresh iterator per epoch, or a one-shot iterable. Each sample is
    either a bare data array (variable along ``seq_axis``) or a
    ``(data, label)`` pair — labels may be per-position arrays (padded
    with ``invalid_label`` to the bucket, the LM layout) or scalars
    (one class per sample; pad rows get ``invalid_label``).

    ``ladder`` is a :class:`BucketLadder` / int list of sequence-length
    buckets (default: ``MXNET_BUCKET_LADDER``).
    """

    def __init__(self, source, batch_size, ladder=None, *, seq_axis=0,
                 window=None, data_name="data",
                 label_name="softmax_label", pad_value=0,
                 invalid_label=-1, dtype="float32", label_dtype=None,
                 layout="NT", label_mode="auto", name=None,
                 record_every=None):
        super().__init__(batch_size=int(batch_size))
        if ladder is None:
            ladder = ladder_from_env()
            if ladder is None:
                raise MXNetError(
                    "BucketedPipeline: pass ladder= or set "
                    "MXNET_BUCKET_LADDER (e.g. '8,16,32')")
        ladder = as_ladder(ladder)
        if not isinstance(ladder, BucketLadder):
            raise MXNetError(
                "BucketedPipeline buckets sequence length: pass a 1-D "
                "ladder (ints), got %r" % (ladder,))
        self.ladder = ladder
        self.seq_axis = int(seq_axis)
        self.window = int(window) if window is not None else max(
            1, envs.get_int("MXNET_BUCKET_WINDOW", 4 * int(batch_size)))
        self.data_name = data_name
        self.label_name = label_name
        self.pad_value = pad_value
        self.invalid_label = invalid_label
        self.dtype = dtype
        self.label_dtype = label_dtype or dtype
        if layout != "NT":
            raise MXNetError(
                "BucketedPipeline supports layout='NT' (batch-major); "
                "got %r" % layout)
        self.layout = layout
        # how labels pad: 'per_position' pads along the sequence to the
        # bucket (the LM layout); 'per_sample' only row-pads (scalar or
        # fixed-size labels); 'auto' decides ONCE from the first sample
        # (per-position iff the label's leading dim equals the data's
        # sequence length — pass the mode explicitly for fixed-size
        # vector labels that could coincide with a sequence length)
        if label_mode not in ("auto", "per_position", "per_sample"):
            raise MXNetError(
                "BucketedPipeline: label_mode must be 'auto', "
                "'per_position' or 'per_sample', got %r" % label_mode)
        self._label_mode = label_mode
        self.stats = BucketingStats(name=name or "BucketedPipeline",
                                    record_every=record_every)
        self._source = source
        self._iter = None
        self._exhausted = False
        self._warned_discard = False
        self._max_seen = 0        # longest sample length drawn so far
        self._pending = {}        # rung -> [(data, label), ...]
        self._age = {}            # rung -> samples drawn since first
        # peek one sample so provide_data knows the non-sequence dims
        self._sample_rest = None
        self._label_shape = None  # per-position label? rest dims
        self.reset()
        peek = self._draw()
        if peek is None:
            raise MXNetError("BucketedPipeline: empty sample stream")
        self._stash(peek)

    # -- stream plumbing ---------------------------------------------------
    def _fresh_iter(self):
        src = self._source
        if callable(src) and not hasattr(src, "__next__"):
            return iter(src())
        return iter(src)

    def _re_iterable(self):
        """A source we can restart per epoch: a callable factory or a
        materialized sequence. A bare one-shot iterator cannot rewind
        — its reset keeps the cursor (and any pending samples)."""
        src = self._source
        return (callable(src) and not hasattr(src, "__next__")) \
            or isinstance(src, (list, tuple))

    def reset(self):
        """Start a new epoch. Re-iterable sources (lists, callables)
        restart from the top; a one-shot iterator keeps its cursor AND
        its pending partial buckets — resetting must never drop
        samples (the peeked construction sample included). Counters
        accumulate (the cumulative record contract)."""
        self.stats.emit()
        if self._iter is None or self._re_iterable():
            self._iter = self._fresh_iter()
            self._exhausted = False
            self._pending = {}
            self._age = {}
        elif self._pending:
            # one-shot source: whatever is buffered stays emittable
            self._exhausted = False

    def _split_sample(self, sample):
        if isinstance(sample, tuple) and len(sample) == 2:
            # only TUPLES pair (data, label) — a bare python list is a
            # sample (a token-id sentence), even one of length 2
            data, label = sample
        else:
            data, label = sample, None
        data = np.asarray(data)
        if label is not None:
            label = np.asarray(label)
        return data, label

    def _draw(self):
        """Pull the next usable sample off the stream (discarding
        over-long ones, counted AND warned once); None at stream
        end."""
        while True:
            try:
                sample = next(self._iter)
            except StopIteration:
                return None
            data, label = self._split_sample(sample)
            length = int(data.shape[self.seq_axis])
            if length > self._max_seen:
                self._max_seen = length
            rung = self.ladder.bucket_for(length)
            if rung is None:
                self.stats.note_discard()
                if not self._warned_discard:
                    # dropping data silently is how a "converging"
                    # run quietly trains on a truncated distribution —
                    # say it once, with the numbers needed to size a
                    # taller ladder (the counter keeps the full tally)
                    self._warned_discard = True
                    top = self.ladder.max_batch
                    warnings.warn(
                        "%s: a length-%d sample exceeds the ladder "
                        "top %d and was DISCARDED (largest seen so "
                        "far: %d). Raise the ladder (e.g. a %d rung) "
                        "or pre-truncate; the bucketing telemetry "
                        "record counts every discard."
                        % (self.stats.name or "BucketedPipeline",
                           length, top, self._max_seen,
                           self._max_seen), stacklevel=3)
                    from .. import telemetry
                    telemetry.note("bucketing_overladder_discard")
                continue
            if self._sample_rest is None:
                rest = list(data.shape)
                del rest[self.seq_axis]
                self._sample_rest = tuple(rest)
                self._label_shape = None if label is None \
                    else tuple(label.shape)
                if self._label_mode == "auto":
                    # decided once, here, so the classification can
                    # never churn batch-to-batch
                    self._label_mode = "per_position" \
                        if label is not None and label.ndim >= 1 \
                        and int(label.shape[0]) == \
                        int(data.shape[self.seq_axis]) \
                        else "per_sample"
            return rung, data, label

    def _stash(self, drawn):
        rung, data, label = drawn
        self._pending.setdefault(rung, []).append((data, label))
        self._age.setdefault(rung, 0)
        for r in self._age:
            self._age[r] += 1

    def _due_rung(self, final=False):
        """A rung ready to emit: full first, then over-age partials,
        then (at stream end) anything pending — smallest first so the
        epoch's tail is deterministic."""
        for rung in sorted(self._pending):
            if len(self._pending[rung]) >= self.batch_size:
                return rung
        for rung in sorted(self._pending):
            if self._pending[rung] and (
                    final or self._age[rung] >= self.window):
                return rung
        return None

    # -- split protocol (AsyncInputPipeline) -------------------------------
    def next_raw(self):
        """Serialized half: draw/group until some bucket is due, then
        hand its samples to a decode worker."""
        while True:
            rung = self._due_rung(final=self._exhausted)
            if rung is not None:
                pending = self._pending.pop(rung)
                samples = pending[:self.batch_size]
                if pending[self.batch_size:]:
                    self._pending[rung] = pending[self.batch_size:]
                else:
                    self._age.pop(rung, None)
                return rung, samples
            if self._exhausted:
                self.stats.emit()
                raise StopIteration
            drawn = self._draw()
            if drawn is None:
                self._exhausted = True
                continue
            self._stash(drawn)

    def decode_raw(self, raw):
        """Thread-safe half: pad + stack one bucket's samples into the
        finished DataBatch."""
        rung, pairs = raw
        datas = [d for d, _ in pairs]
        labels = [l for _, l in pairs]
        B = self.batch_size
        padded, valid_lengths, n_valid = pad_samples(
            datas, B, seq_len=rung, seq_axis=self.seq_axis,
            pad_value=self.pad_value, dtype=self.dtype)
        roster_l = None
        label_descs = None
        if labels[0] is not None:
            if self._label_mode == "per_position":
                lab, _, _ = pad_samples(
                    labels, B, seq_len=rung, seq_axis=0,
                    pad_value=self.invalid_label,
                    dtype=self.label_dtype)
            else:
                lab, _, _ = pad_samples(
                    labels, B, seq_len=None,
                    pad_value=self.invalid_label,
                    dtype=self.label_dtype)
            roster_l = [_host_nd(lab, self.label_dtype)]
            label_descs = [DataDesc(self.label_name, lab.shape,
                                    layout=self.layout)]
        self.stats.note_batch(
            rung, n_valid, B,
            valid_elements=int(valid_lengths.sum())
            * int(np.prod(self._sample_rest, dtype=np.int64) or 1),
            total_elements=int(np.prod(padded.shape, dtype=np.int64)))
        batch = DataBatch(
            [_host_nd(padded, self.dtype)], roster_l,
            pad=B - n_valid, bucket_key=rung,
            provide_data=[DataDesc(self.data_name, padded.shape,
                                   layout=self.layout)],
            provide_label=label_descs)
        batch.valid_lengths = valid_lengths
        batch.valid_rows = n_valid
        return batch

    def next(self):
        return to_context(self.decode_raw(self.next_raw()))

    def mask_for(self, batch):
        """The ``(rows, bucket_len)`` 0/1 position mask of one emitted
        batch (``padding.position_mask`` of its ``valid_lengths``)."""
        return position_mask(batch.valid_lengths, batch.bucket_key)

    # -- DataIter surface --------------------------------------------------
    @property
    def default_bucket_key(self):
        return self.ladder.max_batch

    def _desc_shape(self, rung):
        rest = self._sample_rest or ()
        shape = [self.batch_size]
        pos = self.seq_axis
        dims = list(rest)
        dims.insert(pos, rung)
        return tuple(shape + dims)

    @property
    def provide_data(self):
        return [DataDesc(self.data_name,
                         self._desc_shape(self.default_bucket_key),
                         layout=self.layout)]

    @property
    def provide_label(self):
        if self._label_shape is None:
            return []
        # per-position labels mirror the data's (batch, length) shape;
        # per_sample labels (scalars or fixed-size vectors) only gain
        # the row dim — the mode was pinned at the first draw
        if self._label_mode == "per_position":
            shape = (self.batch_size, self.default_bucket_key) \
                + tuple(self._label_shape[1:])
        else:
            shape = (self.batch_size,) + tuple(self._label_shape)
        return [DataDesc(self.label_name, shape, layout=self.layout)]
