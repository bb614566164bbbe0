"""Bucket ladders (counterpart of ``BucketLadder`` in
``mxnet_tpu/bucketing/ladder.py``).

A small geometric ladder of sizes: every input pads up to the smallest
bucket that fits, so the set of shapes a loop runs at is bounded by the
ladder size no matter the data mix. In the JAX package that bounds the
compiled-program cache; in eager torch it bounds the prompt lengths the
decode server's prefill runs at (and so the matmul algorithms cuBLAS
picks). The multi-dimensional ``ShapeLadder`` of the JAX package waits
for the training slice.
"""
from __future__ import annotations

from ..base import MXNetError

__all__ = ["BucketLadder", "bucket_sort_key"]


class BucketLadder:
    """An ascending list of integer bucket sizes.
    ``BucketLadder.geometric(8)`` -> buckets [1, 2, 4, 8]."""

    def __init__(self, buckets):
        try:
            bs = sorted({int(b) for b in buckets})
        except (TypeError, ValueError):
            raise MXNetError(
                "BucketLadder: buckets must be positive ints, got %r"
                % (buckets,))
        if not bs or bs[0] < 1:
            raise MXNetError(
                "BucketLadder: buckets must be positive ints, got %r"
                % (buckets,))
        self.buckets = bs

    @classmethod
    def geometric(cls, max_batch, min_batch=1, factor=2):
        """min_batch, min_batch*factor, ... capped at (and always
        including) max_batch."""
        max_batch = int(max_batch)
        b = int(min_batch)
        if b < 1 or max_batch < b:
            raise MXNetError(
                "BucketLadder.geometric: want 1 <= min_batch <= "
                "max_batch, got %s..%s" % (min_batch, max_batch))
        if int(factor) < 2:
            raise MXNetError("BucketLadder.geometric: factor must be "
                             ">= 2, got %s" % factor)
        buckets = []
        while b < max_batch:
            buckets.append(b)
            b *= int(factor)
        buckets.append(max_batch)
        return cls(buckets)

    @property
    def max_batch(self):
        return self.buckets[-1]

    def aligned(self, multiple):
        """A new ladder with every rung rounded UP to a multiple — the
        decode server's prompt rungs align to the KV page size so each
        prefill rung fills whole pages. Rungs that collide dedupe."""
        m = int(multiple)
        if m < 1:
            raise MXNetError(
                "BucketLadder.aligned: multiple must be positive, "
                "got %s" % multiple)
        return BucketLadder([-(-b // m) * m for b in self.buckets])

    def bucket_for(self, n):
        """The smallest bucket >= n (None when n exceeds the top)."""
        n = int(n)
        return next((b for b in self.buckets if b >= n), None)

    def __len__(self):
        return len(self.buckets)

    def __iter__(self):
        return iter(self.buckets)

    def __repr__(self):
        return "BucketLadder(%s)" % self.buckets


def bucket_sort_key(key):
    """Numeric sort key for encoded bucket keys ("8" < "16"; "4x8" by
    dims) — the diagnose tables sort per-bucket counts with it."""
    return tuple(int(p) for p in str(key).split("x"))
