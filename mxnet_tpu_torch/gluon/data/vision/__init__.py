"""Vision data namespace (counterpart of ``mxnet_tpu/gluon/data/vision``):
the datasets (read from local files only) and the transforms."""
from .datasets import (MNIST, FashionMNIST, CIFAR10, CIFAR100,
                       ImageFolderDataset, ImageRecordDataset)
from . import transforms
