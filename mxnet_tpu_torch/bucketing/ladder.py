"""Shape ladders (counterpart of ``mxnet_tpu/bucketing/ladder.py``): the
bounded graph-set contract for variable shapes.

A loop fed "whatever shape arrived" (a server batching however many
requests are waiting, a training loop on ragged text) runs at one shape
per distinct input: in the JAX package one compiled program each, here
one CUDA graph each (the fused step, the CachedOp and the executor
capture a graph per input signature) and one set of cuBLAS algorithm
choices. The fix is a small **geometric ladder** of shapes: every batch
pads up to the smallest bucket that fits, so the set of graphs is
bounded by the ladder size no matter the data mix.

:class:`ShapeLadder` is the general form — an explicit list of bucket
*shapes* (tuples covering any bucketed dims: batch size, sequence
length, spatial extents) with smallest-fitting-bucket lookup.
:class:`BucketLadder` is the 1-D view the decode server uses (integer
buckets); it is the same ladder with the tuple wrapper stripped.

``MXNET_BUCKET_LADDER`` names a process-default ladder for the
training-side consumers (``bucketing.BucketedPipeline``): a comma list
of rungs, each either an int (one bucketed dim) or an ``AxB``-style
shape (``"8,16,32"`` or ``"4x16,4x32,8x32"``).
"""
from __future__ import annotations

import numbers

from ..base import MXNetError

__all__ = ["ShapeLadder", "BucketLadder", "as_ladder",
           "ladder_from_env", "bucket_site", "format_bucket",
           "bucket_sort_key"]


def _volume(shape):
    v = 1
    for d in shape:
        v *= d
    return v


class ShapeLadder:
    """An explicit list of bucket shapes (tuples of positive ints, all
    the same rank), ordered by padded volume. ``bucket_for(shape)``
    returns the smallest bucket every dim of ``shape`` fits into —
    the whole graph budget is ``len(ladder)`` buckets, ever."""

    def __init__(self, buckets):
        shapes = []
        for b in buckets:
            if isinstance(b, numbers.Integral):   # numpy ints included
                b = (b,)
            shape = tuple(int(d) for d in b)
            if not shape or any(d < 1 for d in shape):
                raise MXNetError(
                    "ShapeLadder: bucket dims must be positive ints, "
                    "got %r" % (b,))
            shapes.append(shape)
        shapes = sorted(set(shapes), key=lambda s: (_volume(s), s))
        if not shapes:
            raise MXNetError("ShapeLadder: need at least one bucket")
        ranks = {len(s) for s in shapes}
        if len(ranks) != 1:
            raise MXNetError(
                "ShapeLadder: every bucket must have the same rank, "
                "got ranks %s" % sorted(ranks))
        self.shapes = shapes
        self.ndim = len(shapes[0])

    @classmethod
    def geometric(cls, max_shape, min_shape=None, factor=2, cap=None):
        """Per-dim geometric rungs (min, min*factor, ... capped at and
        always including max), crossed into the bucket set. With one
        dim this is exactly ``BucketLadder.geometric``.

        ``cap`` (an int for every dim, or a per-dim tuple) clamps the
        top rung: geometric growth from a generous ``max_shape``
        easily emits rungs far beyond anything the data contains, and
        every phantom rung is a graph a warm-up then captures for
        nothing — pass the observed maximum to stop the ladder there."""
        if isinstance(max_shape, numbers.Integral):
            max_shape = (max_shape,)
        max_shape = tuple(int(d) for d in max_shape)
        if cap is not None:
            if isinstance(cap, numbers.Integral):
                cap = (cap,) * len(max_shape)
            cap = tuple(int(c) for c in cap)
            if len(cap) != len(max_shape):
                raise MXNetError(
                    "ShapeLadder.geometric: cap rank %d does not "
                    "match max_shape rank %d"
                    % (len(cap), len(max_shape)))
            if any(c < 1 for c in cap):
                raise MXNetError(
                    "ShapeLadder.geometric: cap dims must be "
                    "positive, got %s" % (cap,))
            max_shape = tuple(min(d, c)
                              for d, c in zip(max_shape, cap))
        if min_shape is None:
            min_shape = (1,) * len(max_shape)
        elif isinstance(min_shape, numbers.Integral):
            min_shape = (min_shape,) * len(max_shape)
        min_shape = tuple(int(d) for d in min_shape)
        if len(min_shape) != len(max_shape):
            raise MXNetError(
                "ShapeLadder.geometric: min/max rank mismatch (%s vs "
                "%s)" % (min_shape, max_shape))
        factor = int(factor)
        if factor < 2:
            raise MXNetError("ShapeLadder.geometric: factor must be "
                             ">= 2, got %s" % factor)
        axes = []
        for lo, hi in zip(min_shape, max_shape):
            if lo < 1 or hi < lo:
                raise MXNetError(
                    "ShapeLadder.geometric: want 1 <= min <= max per "
                    "dim, got %s..%s" % (lo, hi))
            rungs = []
            d = lo
            while d < hi:
                rungs.append(d)
                d *= factor
            rungs.append(hi)
            axes.append(rungs)
        shapes = [()]
        for rungs in axes:
            shapes = [s + (r,) for s in shapes for r in rungs]
        return cls(shapes)

    @property
    def max_shape(self):
        """The largest bucket (by padded volume) — the default bucket
        a consumer binds first. Always an actual ladder bucket, so
        binding it never makes a graph outside the fixed set."""
        return self.shapes[-1]

    def bucket_for(self, shape):
        """The smallest-volume bucket that fits ``shape`` in every dim
        (None when no bucket does). ``shape`` may be an int for 1-D
        ladders."""
        if isinstance(shape, numbers.Integral):  # numpy ints included
            shape = (shape,)
        shape = tuple(int(d) for d in shape)
        if len(shape) != self.ndim:
            raise MXNetError(
                "ShapeLadder.bucket_for: shape %s has rank %d, ladder "
                "buckets have rank %d" % (shape, len(shape), self.ndim))
        for b in self.shapes:           # already volume-ascending
            if all(bd >= sd for bd, sd in zip(b, shape)):
                return b
        return None

    def __len__(self):
        return len(self.shapes)

    def __iter__(self):
        return iter(self.shapes)

    def __repr__(self):
        return "ShapeLadder(%s)" % (self.shapes,)


class BucketLadder(ShapeLadder):
    """An ascending list of integer bucket sizes — the 1-D ladder the
    decode server budgets its prompt lengths with and the sequence-dim
    ladder of the training pipeline. ``BucketLadder.geometric(8)`` ->
    buckets [1, 2, 4, 8]."""

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
        super().__init__(bs)
        self.buckets = bs               # the public integer view

    @classmethod
    def geometric(cls, max_batch, min_batch=1, factor=2, cap=None):
        """min_batch, min_batch*factor, ... capped at (and always
        including) max_batch; ``cap`` clamps the top rung (see
        :meth:`ShapeLadder.geometric`)."""
        max_batch = int(max_batch)
        if cap is not None:
            cap = int(cap)
            if cap < 1:
                raise MXNetError(
                    "BucketLadder.geometric: cap must be positive, "
                    "got %s" % cap)
            max_batch = min(max_batch, cap)
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
        """A new ladder with every rung rounded UP to a multiple —
        the decode server's prompt rungs align to the KV page size so
        each prefill rung fills whole pages (no rung ever splits a
        page with another rung's tokens, and the per-rung page count
        is exactly ``rung / page_size``). Rungs that collide after
        rounding dedupe."""
        m = int(multiple)
        if m < 1:
            raise MXNetError(
                "BucketLadder.aligned: multiple must be positive, "
                "got %s" % multiple)
        return BucketLadder([-(-b // m) * m for b in self.buckets])

    def bucket_for(self, n):
        """The smallest bucket >= n (None when n exceeds the top)."""
        b = super().bucket_for(n)
        return b[0] if b is not None else None

    def __iter__(self):
        return iter(self.buckets)

    def __repr__(self):
        return "BucketLadder(%s)" % self.buckets


def as_ladder(ladder):
    """Normalize ints / int-lists / shape-lists / ladders into a
    ShapeLadder (BucketLadder instances pass through untouched)."""
    if isinstance(ladder, ShapeLadder):
        return ladder
    if isinstance(ladder, numbers.Integral):
        return BucketLadder.geometric(int(ladder))
    ladder = list(ladder)
    if all(isinstance(b, numbers.Integral) for b in ladder):
        return BucketLadder(ladder)           # numpy ints included
    return ShapeLadder(ladder)


def ladder_from_env(var="MXNET_BUCKET_LADDER", default=None):
    """The process-default ladder: ``"8,16,32"`` -> a BucketLadder;
    ``"4x16,8x16,8x32"`` -> a ShapeLadder over (batch, length)-style
    tuples. Returns ``default`` (normalized) when the variable is
    unset/empty."""
    from .. import envs
    raw = (envs.get_raw(var) or "").strip()
    if not raw:
        return as_ladder(default) if default is not None else None
    rungs = []
    for tok in raw.split(","):
        tok = tok.strip().lower()
        if not tok:
            continue
        try:
            if "x" in tok:
                rungs.append(tuple(int(d) for d in tok.split("x")))
            else:
                rungs.append(int(tok))
        except ValueError:
            raise MXNetError(
                "%s: cannot parse rung %r (want ints like '8,16,32' "
                "or shapes like '4x16,8x32')" % (var, tok))
    if not rungs:
        raise MXNetError("%s: no rungs in %r" % (var, raw))
    try:
        return as_ladder(rungs)
    except MXNetError as exc:
        # a parsed-but-invalid ladder (mixed ranks "8,4x16", a zero
        # dim "0x8") must name the env var the operator has to fix,
        # not just the internal constructor's complaint
        raise MXNetError("%s=%r: %s" % (var, raw, exc))
    except (TypeError, ValueError) as exc:
        raise MXNetError(
            "%s=%r is not a valid ladder (%s: %s)"
            % (var, raw, type(exc).__name__, exc))


def format_bucket(key):
    """Canonical short form of a bucket key for site names and tables:
    int -> "12", tuple -> "4x12"."""
    if isinstance(key, (tuple, list)):
        return "x".join(str(int(d)) for d in key)
    return str(int(key))


def bucket_sort_key(key):
    """Numeric sort key for :func:`format_bucket`-encoded bucket keys
    ("8" < "16"; "4x8" by dims) — the ONE decoder matching the
    encoder, shared by the stats snapshots and the diagnose tables."""
    return tuple(int(p) for p in str(key).split("x"))


def bucket_site(key):
    """The site name of one bucket's graphs, ``bucketing:<shape>``: the
    JAX package's compile-watch site, and here the key of the bucket's
    counters in ``BucketingModule.stats()``, so the ladder reads as a
    FIXED graph set (captures == buckets seen, no recapture)."""
    return "bucketing:%s" % format_bucket(key)
