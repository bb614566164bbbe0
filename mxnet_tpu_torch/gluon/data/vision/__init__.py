"""Vision data namespace (counterpart of ``mxnet_tpu/gluon/data/vision``):
the transforms. The datasets (MNIST, CIFAR, ImageFolderDataset,
ImageRecordDataset) decode through ``image.imread``/``imdecode`` and wait
for ``image/`` (ROADMAP queue A item 13)."""
from . import transforms
