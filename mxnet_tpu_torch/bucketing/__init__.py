"""Bucket ladders (counterpart of ``mxnet_tpu/bucketing``); this slice
ports the 1-D ladder only."""
from .ladder import BucketLadder

__all__ = ["BucketLadder"]
