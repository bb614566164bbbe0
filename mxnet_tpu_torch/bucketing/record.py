"""Bucketing telemetry accounting, shared by every bucketed producer
(counterpart of ``mxnet_tpu/bucketing/record.py``).

One :class:`BucketingStats` per producer (a ``BucketedPipeline``, a
``BucketSentenceIter``) accumulates the facts the diagnose Bucketing
table renders: per-bucket batch counts, the padding-overhead share
(padded elements / total padded-batch elements — the price of the
bounded graph set), pad-row and discarded-sample counts. Snapshots
flow to the active telemetry run as cumulative ``bucketing`` records
(latest wins, exactly like ``serving`` records) every
``MXNET_BUCKETING_RECORD_EVERY`` batches and at epoch boundaries; with
no run active nothing is emitted and the sink stays byte-identical.
"""
from __future__ import annotations

import threading

from .. import envs
from .ladder import bucket_sort_key, format_bucket

__all__ = ["BucketingStats"]


class BucketingStats:
    """Cumulative bucketing counters + periodic telemetry emission."""

    def __init__(self, name=None, record_every=None):
        self.name = name
        self._record_every = int(record_every) if record_every \
            else envs.get_int("MXNET_BUCKETING_RECORD_EVERY")
        self._mu = threading.Lock()
        self._batches_since_record = 0
        self.reset()

    def reset(self):
        """Zero the counters (a NEW producer, not a new epoch — epochs
        accumulate, matching the cumulative record contract)."""
        with self._mu:
            self.batches = 0
            self.samples = 0
            self.discarded = 0
            self.pad_rows = 0
            self.padded_elements = 0
            self.total_elements = 0
            self.bucket_batches = {}

    def note_discard(self, n=1):
        with self._mu:
            self.discarded += int(n)

    def note_batch(self, bucket, n_valid, rows, valid_elements,
                   total_elements, segments=None):
        """Account one emitted bucket batch: ``rows - n_valid`` pad
        rows, ``total - valid`` padded elements. A PACKED batch holds
        more samples than valid rows — ``segments`` carries the true
        sample count (defaults to ``n_valid`` for padded batches)."""
        with self._mu:
            self.batches += 1
            self.samples += int(segments if segments is not None
                                else n_valid)
            self.pad_rows += int(rows) - int(n_valid)
            self.padded_elements += int(total_elements) \
                - int(valid_elements)
            self.total_elements += int(total_elements)
            key = format_bucket(bucket)
            self.bucket_batches[key] = \
                self.bucket_batches.get(key, 0) + 1
            self._batches_since_record += 1
            due = self._batches_since_record >= self._record_every
            if due:
                self._batches_since_record = 0
        if due:
            self.emit()

    def snapshot(self):
        """The cumulative fields of one ``bucketing`` record."""
        with self._mu:
            out = {
                "batches": self.batches,
                "samples": self.samples,
                "discarded": self.discarded,
                "pad_rows": self.pad_rows,
                "padded_elements": self.padded_elements,
                "total_elements": self.total_elements,
                "padding_share": round(
                    self.padded_elements / self.total_elements, 6)
                if self.total_elements else None,
                # the packing-efficiency figure: what fraction of the
                # emitted batches' elements was real work (padded
                # pipelines report it too — it is 1 - padding_share,
                # the baseline packing is measured against)
                "real_token_fraction": round(
                    1.0 - self.padded_elements / self.total_elements,
                    6) if self.total_elements else None,
                # numeric rung order ("4" < "8" < "16", "4x8" by dims)
                "buckets": dict(sorted(
                    self.bucket_batches.items(),
                    key=lambda kv: bucket_sort_key(kv[0]))),
            }
        if self.name:
            out["name"] = str(self.name)
        return out

    def emit(self):
        """Push the cumulative snapshot to the active telemetry run
        (no-op without one)."""
        from .. import telemetry
        telemetry.bucketing_event(self.snapshot())
