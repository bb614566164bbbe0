"""Sequence packing: put several short samples in ONE bucket row
(counterpart of ``mxnet_tpu/bucketing/packing.py``).

Bucketing bounds the set of graphs; padding pays for it in
FLOPs — at typical ragged length distributions 30–60% of every padded
batch is dead positions the hardware still computes. Packing removes
that tax: short samples are **concatenated into a single bucket row**
back to back, and two int32 planes describe what landed where:

- ``segment_ids`` — ``(rows, seq_len)``, the 1-based sample number at
  each position (0 = padding). Sample numbering is global across the
  batch in input order, so one id == one sample everywhere.
- ``positions`` — ``(rows, seq_len)``, each position's index *within
  its own sample* (0 at padding) — what a position embedding must
  consume instead of the raw row offset.

The exactness contract mirrors ``padding.py``'s: a packed sample's
values are the identical bytes, its batch-mates only ever touch it
through exact zeros, and :func:`unpack` recovers every sample
untouched. Downstream:

- **losses** — ``masked.PackedSoftmaxCELoss`` reduces the pointwise
  penalty per segment (via :func:`segment_masks`), so per-sample
  losses from a packed row equal the unpadded values bit-for-bit and
  ``masked_batch_loss`` composes unchanged;
- **attention** — :func:`segment_attention_mask` (and the segment
  plane of ``_contrib_flash_attention``, the 4th input the flash
  kernels read: ``parallel/csrc/flash_fwd.cu``) blocks
  cross-segment attention exactly: a blocked score is ``-1e30``, its
  softmax weight a true IEEE zero, so sample A provably never reads
  sample B;
- **telemetry** — the ``bucketing`` record's ``real_token_fraction``
  reports how much of each batch was real work (the figure padding
  burns and packing recovers).

:class:`PackedPipeline` is the :class:`~mxnet_tpu_torch.bucketing.iter.
BucketedPipeline` twin that emits packed batches: samples pool under
the same bounded straggler window, a greedy first-fit-decreasing
packer fills rows of the smallest ladder rung that fits the pool's
longest sample, and batches emit full-first exactly like the padded
pipeline.
"""
from __future__ import annotations

import numpy as np

from ..base import MXNetError
from ..io.io import DataBatch, DataDesc
from .iter import BucketedPipeline, _host_nd
from .padding import pad_along

__all__ = ["first_fit_decreasing", "pack_samples", "segment_masks",
           "segment_attention_mask", "unpack", "PackedPipeline"]


def first_fit_decreasing(lengths, capacity):
    """Greedy FFD bin packing: sample indices grouped into bins whose
    total length fits ``capacity``, longest samples placed first, each
    into the first bin with room. Deterministic (ties keep input
    order); a sample longer than ``capacity`` raises — the caller's
    ladder lookup should have bounded it."""
    lengths = [int(l) for l in lengths]
    capacity = int(capacity)
    order = sorted(range(len(lengths)), key=lambda i: (-lengths[i], i))
    bins = []                    # [[free, [idx, ...]], ...]
    for i in order:
        need = lengths[i]
        if need > capacity:
            raise MXNetError(
                "first_fit_decreasing: sample length %d exceeds row "
                "capacity %d" % (need, capacity))
        if need == 0:
            raise MXNetError("first_fit_decreasing: zero-length sample")
        for b in bins:
            if b[0] >= need:
                b[0] -= need
                b[1].append(i)
                break
        else:
            bins.append([capacity - need, [i]])
    # a row's samples sit in placement order; restore each bin's
    # members to input order so packed rows read left to right like
    # the stream did (the layout is deterministic either way)
    return [sorted(b[1]) for b in bins]


def pack_samples(samples, seq_len, rows=None, seq_axis=0, pad_value=0,
                 dtype=None, bins=None):
    """Concatenate variable-length samples into packed bucket rows.

    ``samples`` differ along ``seq_axis`` (their own axis, before the
    batch dim). Returns ``(packed, segment_ids, positions, bins)``:
    ``packed`` is ``(rows, ..., seq_len, ...)``; ``segment_ids`` /
    ``positions`` are the int32 ``(rows, seq_len)`` planes described in
    the module docstring; ``bins`` is the row layout (sample indices
    per row) — pass it back in to pack a second stream (labels) into
    the IDENTICAL layout. ``rows=None`` uses exactly as many rows as
    the packer needs; an explicit ``rows`` pads with all-zero rows (or
    raises when the packing needs more)."""
    if not samples:
        raise MXNetError("pack_samples: empty sample list")
    arrs = [np.asarray(s, dtype=dtype) for s in samples]
    if any(a.ndim == 0 for a in arrs):
        raise MXNetError(
            "pack_samples: scalar samples have no sequence axis to "
            "pack along")
    seq_len = int(seq_len)
    lengths = [int(a.shape[seq_axis]) for a in arrs]
    if bins is None:
        bins = first_fit_decreasing(lengths, seq_len)
    n_rows = len(bins)
    if rows is None:
        rows = n_rows
    elif n_rows > rows:
        raise MXNetError(
            "pack_samples: packing needs %d rows, only %d available"
            % (n_rows, rows))
    packed_rows = []
    segment_ids = np.zeros((int(rows), seq_len), np.int32)
    positions = np.zeros((int(rows), seq_len), np.int32)
    for r, members in enumerate(bins):
        parts = [arrs[i] for i in members]
        row = parts[0] if len(parts) == 1 \
            else np.concatenate(parts, axis=seq_axis)
        if row.shape[seq_axis] > seq_len:
            raise MXNetError(
                "pack_samples: row %d holds %d positions, bucket is %d"
                % (r, row.shape[seq_axis], seq_len))
        packed_rows.append(pad_along(row, seq_len, seq_axis,
                                     pad_value))
        at = 0
        for i in members:
            L = lengths[i]
            segment_ids[r, at:at + L] = i + 1
            positions[r, at:at + L] = np.arange(L, dtype=np.int32)
            at += L
    packed = np.stack(packed_rows)
    if len(packed_rows) < rows:
        tail = np.full((int(rows) - len(packed_rows),)
                       + packed.shape[1:], pad_value, packed.dtype)
        packed = np.concatenate([packed, tail])
    return packed, segment_ids, positions, bins


def segment_masks(segment_ids, n_segments=None, dtype=np.float32):
    """One 0/1 validity mask per sample: ``(n, rows, seq_len)`` where
    plane ``s`` is 1 exactly at sample ``s+1``'s positions — the
    packed analogue of :func:`~mxnet_tpu_torch.bucketing.padding.
    position_mask` for consumers that mask in place."""
    segment_ids = np.asarray(segment_ids)
    if n_segments is None:
        n_segments = int(segment_ids.max())
    ids = np.arange(1, int(n_segments) + 1, dtype=segment_ids.dtype)
    return (segment_ids[None] == ids[:, None, None]).astype(dtype)


def segment_gather(segment_ids, n_segments=None, dtype=np.float32,
                   n_pad=None):
    """The packed losses' layout bridge: ``(indices, mask)`` such that
    ``gather_nd(x, indices)`` rearranges any per-position ``(rows,
    seq_len)`` tensor of the packed batch into ``(n, seq_len)`` with
    sample ``s`` at row ``s``, **offset 0** — exactly the padded
    pipeline's layout. ``indices`` is int32 ``(2, n, seq_len)`` (row
    then column coordinates; the masked tail re-reads the sample's
    first position and is zeroed by ``mask``), ``mask`` is the ``(n,
    seq_len)`` validity mask of the rearranged view.

    Why a gather instead of masking in place: a large-row reduction is
    vectorized, and the grouping of one sample's terms then depends on
    its OFFSET in the row — summing at offset 11 is an ulp off summing
    at offset 0. Rearranged to the padded layout first, the packed
    reduction is the IDENTICAL computation, so per-sample losses and
    gradients are bit-exact, not merely close.

    ``n_pad`` pads the plane count past ``n_segments`` with fully
    masked planes (per-sample loss exactly 0): the sample count
    varies batch to batch, and a shape-stable gather keeps the packed
    loss ONE graph signature instead of one per distinct count —
    the bounded-graph discipline everything else here obeys. Pass a
    bound like ``batch_rows * (bucket_len // min_len)`` and keep
    dividing by the TRUE ``n_segments`` in ``masked_batch_loss``."""
    seg = np.asarray(segment_ids)
    if n_segments is None:
        n_segments = int(seg.max())
    n = int(n_segments)
    m = n if n_pad is None else int(n_pad)
    if m < n:
        raise MXNetError(
            "segment_gather: n_pad %d is below the batch's %d "
            "segments" % (m, n))
    L = int(seg.shape[-1])
    rows = np.zeros((m, L), np.int32)
    cols = np.zeros((m, L), np.int32)
    mask = np.zeros((m, L), dtype)
    if n:
        # one vectorized pass: row-major nonzero scan groups each
        # segment's positions contiguously and in order
        r_all, t_all = np.nonzero(seg > 0)
        s_all = seg[r_all, t_all].astype(np.int64) - 1
        order = np.argsort(s_all, kind="stable")
        s_sorted = s_all[order]
        lengths = np.bincount(s_sorted, minlength=n)
        if (lengths[:n] == 0).any():
            missing = int(np.nonzero(lengths[:n] == 0)[0][0]) + 1
            raise MXNetError("segment_gather: segment %d is absent"
                             % missing)
        starts = np.zeros(int(s_sorted.max()) + 1, np.int64)
        starts[1:] = np.cumsum(lengths[:int(s_sorted.max()) + 1])[:-1]
        pos = np.arange(s_sorted.size) - starts[s_sorted]
        r_sorted = r_all[order]
        t_sorted = t_all[order]
        first = starts[np.arange(n)]
        rows[:n] = r_sorted[first][:, None]     # tail re-reads t0
        cols[:n] = t_sorted[first][:, None]
        rows[s_sorted, pos] = r_sorted
        cols[s_sorted, pos] = t_sorted
        mask[s_sorted, pos] = 1
    return np.stack([rows, cols]), mask


def segment_attention_mask(segment_ids, causal=False):
    """The ``(rows, seq_len, seq_len)`` boolean attention mask of a
    packed batch: position ``i`` may attend to ``j`` iff both carry
    the SAME sample (and ``j <= i`` under ``causal``); padding (id 0)
    attends to nothing. Apply as ``where(mask, scores, -1e30)`` — a
    blocked weight underflows to an exact 0.0 after softmax, so
    cross-segment attention is provably zero, not merely small."""
    seg = np.asarray(segment_ids)
    allowed = (seg[:, :, None] == seg[:, None, :]) \
        & (seg[:, :, None] > 0)
    if causal:
        L = seg.shape[-1]
        allowed = allowed & (np.arange(L)[None, :, None]
                             >= np.arange(L)[None, None, :])
    return allowed


def unpack(packed, segment_ids, n_segments=None, seq_axis=1):
    """The exact inverse of :func:`pack_samples`: the per-sample
    arrays in input order, each holding the identical values that went
    in (``seq_axis`` indexes the BATCHED array, so the default 1
    matches ``seq_axis=0`` at pack time)."""
    packed = np.asarray(packed)
    seg = np.asarray(segment_ids)
    if int(seq_axis) == 0:
        raise MXNetError(
            "unpack: seq_axis indexes the BATCHED array, whose axis 0 "
            "is rows — a pack-time seq_axis of 0 is 1 here (the "
            "default)")
    if n_segments is None:
        n_segments = int(seg.max())
    out = []
    for s in range(1, int(n_segments) + 1):
        r_idx, t_idx = np.nonzero(seg == s)
        if r_idx.size == 0:
            raise MXNetError("unpack: segment %d is absent" % s)
        r = int(r_idx[0])
        t0, t1 = int(t_idx[0]), int(t_idx[-1]) + 1
        sl = [slice(None)] * packed.ndim
        sl[0] = r
        sl[seq_axis] = slice(t0, t1)
        out.append(packed[tuple(sl)])
    return out


class PackedPipeline(BucketedPipeline):
    """A ragged sample stream -> packed ladder-bucket batches.

    Same contract as :class:`BucketedPipeline` — ladder rungs, the
    bounded straggler window, full-batches-first emission, nothing
    silently dropped but over-ladder samples (counted AND warned) —
    except each emitted row may hold SEVERAL samples back to back.
    Samples pool until the window fills (or the stream ends), the FFD
    packer fills rows of the smallest rung that fits the pool's
    longest sample, and rows queue toward ``batch_size``-row batches.

    Emitted batches carry ``segment_ids`` / ``positions`` (the packing
    planes), ``n_segments`` (samples in the batch), ``valid_lengths``
    (per-row real-token counts — rows fill from position 0, so
    ``position_mask`` still describes validity), and ``bucket_key``.
    Labels must be per-position (the LM layout) — scalar per-sample
    labels have no packed representation and raise up front."""

    def __init__(self, source, batch_size, ladder=None, *, seq_axis=0,
                 window=None, data_name="data",
                 label_name="softmax_label", pad_value=0,
                 invalid_label=-1, dtype="float32", label_dtype=None,
                 layout="NT", name=None, record_every=None):
        self._pool = []
        super().__init__(
            source, batch_size, ladder, seq_axis=seq_axis,
            window=window, data_name=data_name, label_name=label_name,
            pad_value=pad_value, invalid_label=invalid_label,
            dtype=dtype, label_dtype=label_dtype, layout=layout,
            label_mode="per_position", name=name or "PackedPipeline",
            record_every=record_every)

    def reset(self):
        super().reset()
        if self._re_iterable():
            self._pool = []

    # -- pooling / packing -------------------------------------------------
    def _stash(self, drawn):
        """Pool instead of bucketing per rung; the window bounds the
        pool, so held-back samples and host memory stay bounded
        exactly as in the padded pipeline."""
        rung, data, label = drawn
        if label is not None and (
                label.ndim < 1
                or int(label.shape[0])
                != int(data.shape[self.seq_axis])):
            raise MXNetError(
                "PackedPipeline: labels must be per-position (one "
                "label per token, got label shape %s for a length-%d "
                "sample); scalar per-sample labels cannot ride a "
                "packed row — use BucketedPipeline"
                % (list(getattr(label, "shape", ())),
                   int(data.shape[self.seq_axis])))
        self._pool.append((data, label))
        for r in self._age:
            self._age[r] += 1
        if len(self._pool) >= self.window:
            self._pack_pool()

    def _pack_pool(self):
        """FFD-pack the pooled samples into rows of the smallest rung
        fitting the pool's longest sample, and queue the rows."""
        if not self._pool:
            return
        pool, self._pool = self._pool, []
        lengths = [int(d.shape[self.seq_axis]) for d, _ in pool]
        rung = self.ladder.bucket_for(max(lengths))
        for members in first_fit_decreasing(lengths, rung):
            row = [pool[i] for i in members]
            self._pending.setdefault(rung, []).append(row)
        self._age.setdefault(rung, 0)

    def next_raw(self):
        """Serialized half: draw/pool/pack until a full (or due)
        batch of packed rows exists, then hand its rows to decode."""
        while True:
            if self._exhausted:
                self._pack_pool()
            rung = self._due_rung(final=self._exhausted)
            if rung is not None:
                pending = self._pending.pop(rung)
                rows = pending[:self.batch_size]
                if pending[self.batch_size:]:
                    self._pending[rung] = pending[self.batch_size:]
                else:
                    self._age.pop(rung, None)
                return rung, rows
            if self._exhausted:
                self.stats.emit()
                raise StopIteration
            drawn = self._draw()
            if drawn is None:
                self._exhausted = True
                continue
            self._stash(drawn)

    def decode_raw(self, raw):
        """Thread-safe half: concatenate each row's samples, build the
        segment planes, pad rows to the batch."""
        rung, rows = raw
        B = self.batch_size
        datas, labels, bins, at = [], [], [], 0
        for row in rows:
            members = list(range(at, at + len(row)))
            bins.append(members)
            at += len(row)
            for d, l in row:
                datas.append(d)
                labels.append(l)
        packed, segment_ids, positions, _ = pack_samples(
            datas, rung, rows=B, seq_axis=self.seq_axis,
            pad_value=self.pad_value, dtype=self.dtype, bins=bins)
        roster_l = None
        label_descs = None
        if labels[0] is not None:
            lab, _, _, _ = pack_samples(
                labels, rung, rows=B, seq_axis=0,
                pad_value=self.invalid_label, dtype=self.label_dtype,
                bins=bins)
            roster_l = [_host_nd(lab, self.label_dtype)]
            label_descs = [DataDesc(self.label_name, lab.shape,
                                    layout=self.layout)]
        valid_lengths = (segment_ids > 0).sum(axis=1).astype(np.int32)
        real = int(valid_lengths.sum())
        self.stats.note_batch(
            rung, len(rows), B,
            valid_elements=real
            * int(np.prod(self._sample_rest, dtype=np.int64) or 1),
            total_elements=int(np.prod(packed.shape, dtype=np.int64)),
            segments=len(datas))
        batch = DataBatch(
            [_host_nd(packed, self.dtype)], roster_l,
            pad=B - len(rows), bucket_key=rung,
            provide_data=[DataDesc(self.data_name, packed.shape,
                                   layout=self.layout)],
            provide_label=label_descs)
        batch.valid_lengths = valid_lengths
        batch.valid_rows = len(rows)
        batch.segment_ids = segment_ids
        batch.positions = positions
        batch.n_segments = len(datas)
        return batch
