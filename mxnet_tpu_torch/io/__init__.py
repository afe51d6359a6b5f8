"""IO (ref: ``mxnet_tpu/io/``; src/io/ + python/mxnet/io/): the batch
descriptors, the iterators (``NDArrayIter``, ``MNISTIter``, ``CSVIter``,
``LibSVMIter``, ``ImageRecordIter``, ``ImageDetRecordIter``,
``PrefetchingIter``, ``ResizeIter``), ``DataIter.as_pipeline`` and
``recordio``."""
from .io import (DataBatch, DataDesc, DataIter, NDArrayIter, MNISTIter,  # noqa: F401
                 CSVIter, LibSVMIter, ImageRecordIter, PrefetchingIter,
                 ResizeIter)
from . import recordio  # noqa: F401


def ImageDetRecordIter(**kwargs):
    """Detection record iterator (ref: src/io/iter_image_det_recordio.cc,
    registered as io.ImageDetRecordIter).

    Alias onto `mx.image.ImageDetIter`: shares the label layout and core
    kwargs, and translates the C++ iterator's augmentation parameter
    names (rand_crop_prob, rand_pad_prob, rand_mirror_prob, mean_r/g/b,
    std_r/g/b, min/max_aspect_ratio, ...) into a CreateDetAugmenter
    chain. Unknown kwargs raise instead of being silently dropped."""
    from ..base import MXNetError
    from ..image.detection import (CreateDetAugmenter,
                                   DetHorizontalFlipAug, ImageDetIter)

    core_keys = ("batch_size", "data_shape", "path_imgrec", "path_imglist",
                 "path_root", "shuffle", "aug_list", "label_pad_width",
                 "label_pad_value", "data_name", "label_name",
                 "last_batch_handle", "num_parts", "part_index")
    core = {k: kwargs.pop(k) for k in core_keys if k in kwargs}
    if kwargs and "aug_list" in core:
        raise MXNetError(
            f"pass augmentation either as aug_list or as iterator kwargs, "
            f"not both (extra: {sorted(kwargs)})")
    if kwargs:
        aug = {}
        for src_key, dst_key in (("rand_crop_prob", "rand_crop"),
                                 ("rand_pad_prob", "rand_pad"),
                                 ("min_object_covered",
                                  "min_object_covered"),
                                 ("max_attempts", "max_attempts"),
                                 ("brightness", "brightness"),
                                 ("contrast", "contrast"),
                                 ("saturation", "saturation"),
                                 ("hue", "hue"),
                                 ("pca_noise", "pca_noise"),
                                 ("rand_gray", "rand_gray"),
                                 ("inter_method", "inter_method"),
                                 ("resize", "resize")):
            if src_key in kwargs:
                aug[dst_key] = kwargs.pop(src_key)
        if "min_aspect_ratio" in kwargs or "max_aspect_ratio" in kwargs:
            aug["aspect_ratio_range"] = (
                kwargs.pop("min_aspect_ratio", 0.75),
                kwargs.pop("max_aspect_ratio", 1.33))
        if "min_crop_scale" in kwargs or "max_crop_scale" in kwargs:
            aug["area_range"] = (kwargs.pop("min_crop_scale", 0.05),
                                 kwargs.pop("max_crop_scale", 1.0))
        mean = [kwargs.pop(k, None) for k in ("mean_r", "mean_g", "mean_b")]
        std = [kwargs.pop(k, None) for k in ("std_r", "std_g", "std_b")]
        if any(v is not None for v in mean):
            aug["mean"] = [v or 0.0 for v in mean]
        if any(v is not None for v in std):
            aug["std"] = [v or 1.0 for v in std]
        mirror_p = kwargs.pop("rand_mirror_prob", None)
        if mirror_p:
            aug["rand_mirror"] = True
        if kwargs:
            raise MXNetError(
                f"ImageDetRecordIter: unsupported kwargs {sorted(kwargs)}; "
                "use aug_list= with explicit augmenters for anything "
                "beyond the translated set")
        if aug or mirror_p:
            auglist = CreateDetAugmenter(
                core.get("data_shape", (3, 224, 224)), **aug)
            if mirror_p is not None:
                for a in auglist:
                    if isinstance(a, DetHorizontalFlipAug):
                        a.p = mirror_p
            core["aug_list"] = auglist
    return ImageDetIter(**core)
