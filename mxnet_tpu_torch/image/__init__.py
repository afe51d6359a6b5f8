"""Image module (ref: ``mxnet_tpu/image/``; python/mxnet/image/): decode,
resize and crop, the augmenters, ``ImageIter`` and the detection tier.
Images are NDArrays on ``cpu()``."""
from .image import (imdecode, imread, imresize, resize_short, fixed_crop,  # noqa: F401
                    center_crop, random_crop, random_size_crop,
                    color_normalize, Augmenter,
                    ResizeAug, CenterCropAug, RandomCropAug,
                    RandomSizedCropAug, HorizontalFlipAug, CastAug,
                    BrightnessJitterAug, ContrastJitterAug,
                    SaturationJitterAug, HueJitterAug, ColorJitterAug,
                    LightingAug, RandomGrayAug, ColorNormalizeAug,
                    ForceResizeAug, SequentialAug, RandomOrderAug,
                    CreateAugmenter, ImageIter,
                    IMAGENET_MEAN, IMAGENET_STD,
                    IMAGENET_PCA_EIGVAL, IMAGENET_PCA_EIGVEC)
from .detection import (DetAugmenter, DetBorrowAug,  # noqa: F401
                        DetHorizontalFlipAug, DetRandomCropAug,
                        DetRandomPadAug, DetRandomSelectAug,
                        CreateDetAugmenter, ImageDetIter)
