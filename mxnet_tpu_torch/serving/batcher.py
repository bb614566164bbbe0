"""The bucket-ladder dynamic batcher primitives (counterpart of
``mxnet_tpu/serving/batcher.py``): re-exports of the shared
shape-bucketing subsystem (``mxnet_tpu_torch.bucketing``).

A program per distinct input signature — one CUDA graph per batch size
on the card — means a server that batched "however many requests are
waiting" would capture a graph per occupancy. A small geometric
**ladder** of batch shapes bounds the program set: every dispatch pads
the waiting requests up to the smallest bucket that fits, and the
padding is exact (a row's result never depends on its batch-mates).
"""
from __future__ import annotations

from ..bucketing.ladder import BucketLadder
from ..bucketing.padding import pad_batch, slice_rows

__all__ = ["BucketLadder", "pad_batch", "slice_rows"]
