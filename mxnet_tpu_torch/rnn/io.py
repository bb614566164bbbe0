"""Bucketed sequence iterators (counterpart of ``mxnet_tpu/rnn/io.py``;
reference: python/mxnet/rnn/io.py).

``BucketSentenceIter`` feeds ``BucketingModule``: sentences are grouped
into the smallest bucket that fits, padded to the bucket length, and
each batch carries its ``bucket_key`` so the module switches to the
executor for that length (one fused-step graph per bucket, captured
once).

As in the JAX package, and unlike the reference (which silently drops
up to ``batch_size - 1`` sentences per bucket every epoch), the final
partial batch of each bucket is **padded mask-aware**: pad rows carry
``invalid_label`` in both data and label, the batch's ``pad`` field
counts them, and the loss/metric side ignores them through the usual
``ignore_label`` contract (``SoftmaxOutput(use_ignore=True)``,
``metric.Perplexity/Accuracy(ignore_label=...)``). For one corpus and
numpy seed the batches and their order are the JAX package's. Pad-row
and discarded-sentence counts surface through the cumulative
``bucketing`` telemetry record (``bucketing.record``), rendered by the
diagnose Bucketing table.
"""
from __future__ import annotations

import numpy as np

from ..base import MXNetError
from ..io.io import DataBatch, DataDesc, DataIter
from ..ndarray import array as _nd_array

__all__ = ["BucketSentenceIter", "encode_sentences"]


def encode_sentences(sentences, vocab=None, invalid_label=-1,
                     invalid_key="\n", start_label=0):
    """Map tokenised sentences to integer ids, building the vocab as
    needed (reference: rnn/io.py encode_sentences)."""
    idx = start_label
    if vocab is None:
        vocab = {invalid_key: invalid_label}
        new_vocab = True
    else:
        new_vocab = False
    res = []
    for sent in sentences:
        coded = []
        for word in sent:
            if word not in vocab:
                if not new_vocab:
                    raise MXNetError("word %s not in provided vocab" % word)
                if idx == invalid_label:
                    idx += 1
                vocab[word] = idx
                idx += 1
            coded.append(vocab[word])
        res.append(coded)
    return res, vocab


class BucketSentenceIter(DataIter):
    """Iterate encoded sentences in length buckets.

    Labels are the data shifted one step left (next-token prediction),
    padded with ``invalid_label`` — the PTB language-model contract.
    The last partial batch of each bucket is padded (``pad`` counts the
    rows), never dropped.
    """

    def __init__(self, sentences, batch_size, buckets=None,
                 invalid_label=-1, data_name="data",
                 label_name="softmax_label", dtype="float32", layout="NT"):
        super().__init__(batch_size=batch_size)
        if not buckets:
            lens = np.bincount([len(s) for s in sentences])
            buckets = [i for i, n in enumerate(lens)
                       if n >= batch_size and i > 0]
        buckets = sorted(buckets)
        if not buckets:
            raise MXNetError("no usable buckets for the given sentences")

        self.data_name = data_name
        self.label_name = label_name
        self.dtype = dtype
        self.layout = layout
        self.invalid_label = invalid_label
        self.buckets = buckets
        self.default_bucket_key = max(buckets)

        from ..bucketing.record import BucketingStats
        self.bucketing = BucketingStats(name="BucketSentenceIter")
        self._warned_tail_pad = False

        # place each sentence in the smallest bucket that fits
        self.data = [[] for _ in buckets]
        lengths = [[] for _ in buckets]
        ndiscard = 0
        for sent in sentences:
            pos = np.searchsorted(buckets, len(sent))
            if pos >= len(buckets):
                ndiscard += 1
                continue
            pad = np.full((buckets[pos],), invalid_label, dtype=dtype)
            pad[:len(sent)] = sent
            self.data[pos].append(pad)
            lengths[pos].append(len(sent))
        # keep 2-D shape even for buckets no sentence landed in
        self.data = [np.asarray(x, dtype=dtype) if x else
                     np.zeros((0, buckets[i]), dtype=dtype)
                     for i, x in enumerate(self.data)]
        self._lengths = [np.asarray(x, np.int64) for x in lengths]
        if ndiscard:
            import logging
            logging.warning("BucketSentenceIter discarded %d sentences "
                            "longer than the largest bucket", ndiscard)
            self.bucketing.note_discard(ndiscard)

        self.batch_axis = layout.find("N")
        shape = (batch_size, self.default_bucket_key) \
            if self.batch_axis == 0 else (self.default_bucket_key,
                                          batch_size)
        self.provide_data = [DataDesc(data_name, shape, layout=layout)]
        self.provide_label = [DataDesc(label_name, shape, layout=layout)]
        # batch index ranges cover the PADDED row count — the final
        # partial batch of each bucket is padded, not dropped (the
        # reference's range(0, n - batch_size + 1, ...) lost up to
        # batch_size - 1 sentences per bucket per epoch)
        self.idx = []
        for i, buck in enumerate(self.data):
            n = len(buck)
            padded_rows = ((n + batch_size - 1) // batch_size) \
                * batch_size
            self.idx.extend((i, j) for j in
                            range(0, padded_rows, batch_size))
        self.curr_idx = 0
        self.reset()

    def reset(self):
        self.curr_idx = 0
        np.random.shuffle(self.idx)
        # shuffle rows and their true lengths TOGETHER (lengths feed
        # the padding accounting in the bucketing telemetry record)
        for i, buck in enumerate(self.data):
            if len(buck) > 1:
                perm = np.random.permutation(len(buck))
                self.data[i] = buck[perm]
                self._lengths[i] = self._lengths[i][perm]
        # labels: next token; last position gets invalid_label
        self.nddata = []
        self.ndlabel = []
        bs = self.batch_size
        from ..bucketing.padding import pad_along
        for buck in self.data:
            n = len(buck)
            pad_rows = (-n) % bs
            if pad_rows:
                buck = pad_along(buck, n + pad_rows, axis=0,
                                 pad_value=self.invalid_label)
            label = np.full_like(buck, self.invalid_label)
            if buck.shape[1] > 1:
                label[:, :-1] = buck[:, 1:]
            self.nddata.append(_nd_array(buck, dtype=self.dtype))
            self.ndlabel.append(_nd_array(label, dtype=self.dtype))

    def next(self):
        if self.curr_idx == len(self.idx):
            # epoch end: push the cumulative pad/discard counts to the
            # active telemetry run (no-op without one)
            self.bucketing.emit()
            raise StopIteration
        i, j = self.idx[self.curr_idx]
        self.curr_idx += 1
        bs = self.batch_size
        if self.batch_axis == 0:
            data = self.nddata[i][j:j + bs]
            label = self.ndlabel[i][j:j + bs]
        else:
            data = self.nddata[i][j:j + bs].T
            label = self.ndlabel[i][j:j + bs].T
        L = self.buckets[i]
        n_rows = len(self.data[i])
        pad = max(0, j + bs - n_rows)
        if pad and not self._warned_tail_pad:
            # behavior change vs the reference: tails are padded, not
            # dropped — tell the operator ONCE which contract makes
            # the pad rows numerically inert
            self._warned_tail_pad = True
            import logging
            logging.info(
                "BucketSentenceIter: final partial batches are padded "
                "with invalid_label=%r instead of dropped; use "
                "ignore_label on the loss head (e.g. SoftmaxOutput("
                "use_ignore=True)) and metrics so pad rows — like the "
                "iterator's in-sentence padding — contribute nothing",
                self.invalid_label)
        valid_tokens = int(self._lengths[i][j:j + bs].sum())
        self.bucketing.note_batch(L, bs - pad, bs,
                                  valid_elements=valid_tokens,
                                  total_elements=bs * L)
        shape = (bs, L) if self.batch_axis == 0 else (L, bs)
        return DataBatch(
            [data], [label], pad=pad, bucket_key=L,
            provide_data=[DataDesc(self.data_name, shape,
                                   layout=self.layout)],
            provide_label=[DataDesc(self.label_name, shape,
                                    layout=self.layout)])
