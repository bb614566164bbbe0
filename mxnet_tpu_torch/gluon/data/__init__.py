"""Gluon data namespace (counterpart of ``mxnet_tpu/gluon/data``):
datasets, samplers, the DataLoader and ``vision.transforms``. The vision
datasets wait for ``image/`` (ROADMAP queue A item 13)."""
from .dataset import (Dataset, SimpleDataset, ArrayDataset,
                      RecordFileDataset)
from .sampler import (Sampler, SequentialSampler, RandomSampler,
                      BatchSampler)
from .dataloader import DataLoader
from . import vision
