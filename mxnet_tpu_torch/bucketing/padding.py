"""Pad-to-bucket batch assembly with validity masks, and the exact
inverse (counterpart of ``mxnet_tpu/bucketing/padding.py``; numpy only,
the port's own copy).

The contract every consumer of this module leans on: padding is
**bit-exact by construction**. A padded row/position only ever reaches
compute multiplied by a zero mask (or carrying an ignored label), and
:func:`slice_rows` / :func:`slice_valid` recover each sample's values
untouched — a sample's result never depends on its batch-mates or on
how much padding rode along.

Two layers of padding compose here:

- **row padding** — fewer samples than the bucket's batch size: tail
  rows are zero-filled and ``n_valid`` marks where real rows end
  (:func:`pad_batch`);
- **position padding** — samples shorter than the bucket's sequence
  length: each is padded along ``seq_axis`` and ``valid_lengths``
  records the true per-sample lengths (:func:`pad_samples`).

:func:`position_mask` turns the validity info into the ``(rows, len)``
0/1 mask the mask-aware losses and metrics (``bucketing.masked``)
consume.
"""
from __future__ import annotations

import numpy as _np

from ..base import MXNetError

__all__ = ["pad_batch", "slice_rows", "pad_along", "pad_samples",
           "position_mask", "slice_valid"]


def pad_batch(samples, bucket):
    """Stack per-request sample arrays (one input's worth) into a
    ``(bucket, *sample_shape)`` batch, zero-padding the tail rows.
    Exact: the pad rows are sliced back off by :func:`slice_rows`."""
    stacked = _np.stack(samples)
    n = stacked.shape[0]
    if n == bucket:
        return stacked
    if n > bucket:
        raise MXNetError("pad_batch: %d samples exceed bucket %d"
                         % (n, bucket))
    pad = _np.zeros((bucket - n,) + stacked.shape[1:],
                    dtype=stacked.dtype)
    return _np.concatenate([stacked, pad])


def slice_rows(outputs, i):
    """Request ``i``'s response out of a batched result: row
    ``i`` of every output (tuple-normalized in, single-or-tuple out to
    mirror the Predictor's return convention)."""
    if isinstance(outputs, tuple):
        return tuple(o[i] for o in outputs)
    return outputs[i]


def pad_along(arr, length, axis, pad_value=0):
    """Pad one array to ``length`` along ``axis`` with ``pad_value``
    (no-op when already that long; over-length raises — a bucket can
    only grow a sample)."""
    have = arr.shape[axis]
    if have == length:
        return arr
    if have > length:
        raise MXNetError(
            "pad_along: sample length %d exceeds bucket length %d"
            % (have, length))
    widths = [(0, 0)] * arr.ndim
    widths[axis] = (0, length - have)
    return _np.pad(arr, widths, constant_values=pad_value)


def pad_samples(samples, rows, seq_len=None, seq_axis=0, pad_value=0,
                dtype=None):
    """Assemble variable-length samples into one bucket-shaped batch.

    ``samples`` are arrays that may differ along ``seq_axis`` (their
    own axis — BEFORE stacking adds the batch dim). Each is padded to
    ``seq_len`` with ``pad_value`` (``seq_len=None`` requires uniform
    shapes — row padding only), stacked, and row-padded to ``rows``.

    Returns ``(padded, valid_lengths, n_valid)``:

    - ``padded`` — ``(rows, ..., seq_len, ...)``;
    - ``valid_lengths`` — int32 ``(rows,)`` true per-sample length
      along ``seq_axis`` (0 for pad rows; 1 for 0-d scalar samples);
    - ``n_valid`` — how many leading rows are real samples.
    """
    if not samples:
        raise MXNetError("pad_samples: empty sample list")
    arrs = [_np.asarray(s, dtype=dtype) for s in samples]
    n_valid = len(arrs)
    if n_valid > rows:
        raise MXNetError("pad_samples: %d samples exceed bucket rows "
                         "%d" % (n_valid, rows))
    lengths = [1 if a.ndim == 0 else int(a.shape[seq_axis])
               for a in arrs]
    if seq_len is not None:
        if any(a.ndim == 0 for a in arrs):
            raise MXNetError(
                "pad_samples: scalar samples have no sequence axis to "
                "pad (pass seq_len=None)")
        arrs = [pad_along(a, int(seq_len), seq_axis, pad_value)
                for a in arrs]
    padded = _np.stack(arrs)
    if n_valid < rows:
        tail = _np.full((rows - n_valid,) + padded.shape[1:], pad_value,
                        dtype=padded.dtype)
        padded = _np.concatenate([padded, tail])
    valid_lengths = _np.zeros((rows,), _np.int32)
    valid_lengths[:n_valid] = lengths
    return padded, valid_lengths, n_valid


def position_mask(valid_lengths, seq_len, dtype=_np.float32):
    """The ``(rows, seq_len)`` validity mask: 1 where ``t <
    valid_lengths[i]``, else 0. Pad rows (length 0) are all-zero; for
    row-only padding pass ``seq_len=1`` and squeeze, or use the
    lengths directly."""
    valid_lengths = _np.asarray(valid_lengths)
    t = _np.arange(int(seq_len))
    return (t[None, :] < valid_lengths[:, None]).astype(dtype)


def slice_valid(padded, valid_lengths, n_valid, seq_axis=1):
    """The exact inverse of :func:`pad_samples`: the list of per-sample
    arrays with pad rows dropped and each sample truncated to its true
    length along ``seq_axis`` (an axis of the BATCHED array, so the
    default 1 matches ``seq_axis=0`` at pad time). Bit-exact — the
    returned views hold the identical values that went in."""
    valid_lengths = _np.asarray(valid_lengths)
    out = []
    for i in range(int(n_valid)):
        row = padded[i]
        if row.ndim >= seq_axis:        # seq axis of the row = axis-1
            sl = [slice(None)] * row.ndim
            if row.ndim > 0 and seq_axis >= 1:
                sl[seq_axis - 1] = slice(0, int(valid_lengths[i]))
            row = row[tuple(sl)]
        out.append(row)
    return out
