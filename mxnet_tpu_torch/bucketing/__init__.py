"""Shape bucketing (counterpart of ``mxnet_tpu/bucketing``): variable-
shape training and serving at a bounded set of shapes.

Each distinct input shape is a CUDA graph captured once (the fused
step's, the CachedOp's, the executor's predict graph) and a set of
cuBLAS algorithm choices; ragged workloads (text, variable batch tails)
would make one per distinct length. This package bounds that set to a
small **ladder** of shapes and makes the padding that buys it exact:

- :mod:`ladder` — :class:`ShapeLadder` (multi-dim bucket shapes,
  smallest-fitting lookup, ``geometric()`` or explicit lists,
  ``MXNET_BUCKET_LADDER``) and the 1-D :class:`BucketLadder` the
  decode server uses;
- :mod:`padding` — pad-to-bucket batch assembly returning validity
  masks (``valid_lengths`` per sample, ``position_mask``), with
  bit-exact row/position slicing back out;
- :mod:`masked` — mask-aware loss/metric adapters: padded positions
  contribute zero to loss, gradients, and metric denominators;
- :mod:`iter` — :class:`BucketedPipeline`, grouping any ragged sample
  stream into ladder buckets under a bounded straggler window,
  pluggable into the async input pipeline;
- :mod:`packing` — :class:`PackedPipeline` and the FFD packer: several
  short samples share ONE bucket row (segment-id/position planes,
  per-segment losses via :class:`PackedSoftmaxCELoss`, the segment
  plane the flash-attention kernels take), recovering the work padding
  burns while keeping the same exactness contract;
- :mod:`record` — the cumulative ``bucketing`` telemetry record
  (per-bucket step counts, padding-overhead share, discards) rendered
  by the diagnose Bucketing table.

``BucketingModule`` binds one executor per bucket; each bucket's fused
step captures its graph once, and ``BucketingModule.stats()`` reports
captures, replays and recaptures per :func:`bucket_site`: the port's
form of the JAX package's ``compile_watch.site_stats("bucketing")``
oracle (captures == buckets seen, none new in a steady epoch).
"""
from .ladder import (ShapeLadder, BucketLadder, as_ladder,
                     ladder_from_env, bucket_site, format_bucket,
                     bucket_sort_key)
from .padding import (pad_batch, slice_rows, pad_samples,
                      position_mask, slice_valid)
from .masked import (MaskedSoftmaxCELoss, MaskedL2Loss,
                     PackedSoftmaxCELoss, PackedL2Loss,
                     masked_batch_loss, MaskedMetric)
from .iter import BucketedPipeline
from .packing import (PackedPipeline, pack_samples, unpack,
                      first_fit_decreasing, segment_masks,
                      segment_gather, segment_attention_mask)
from .record import BucketingStats

__all__ = [
    "ShapeLadder", "BucketLadder", "as_ladder", "ladder_from_env",
    "bucket_site", "format_bucket", "bucket_sort_key",
    "pad_batch", "slice_rows", "pad_samples", "position_mask",
    "slice_valid",
    "MaskedSoftmaxCELoss", "MaskedL2Loss", "PackedSoftmaxCELoss",
    "PackedL2Loss", "masked_batch_loss", "MaskedMetric",
    "BucketedPipeline", "BucketingStats",
    "PackedPipeline", "pack_samples", "unpack", "first_fit_decreasing",
    "segment_masks", "segment_gather", "segment_attention_mask",
]
