"""Image utilities, ``mx.image`` (counterpart of ``mxnet_tpu/image``;
parity: python/mxnet/image/)."""
from .image import (imread, imdecode, imresize, fixed_crop, center_crop,
                    random_crop, resize_short, color_normalize,
                    CreateAugmenter, Augmenter, ResizeAug, ForceResizeAug,
                    RandomCropAug, CenterCropAug, HorizontalFlipAug,
                    CastAug, ColorNormalizeAug, BrightnessJitterAug,
                    ContrastJitterAug, SaturationJitterAug, ImageIter)
from .detection import (DetAugmenter, DetBorrowAug, DetRandomSelectAug,
                        DetHorizontalFlipAug, DetRandomCropAug,
                        DetRandomPadAug, CreateMultiRandCropAugmenter,
                        CreateDetAugmenter, ImageDetIter)
