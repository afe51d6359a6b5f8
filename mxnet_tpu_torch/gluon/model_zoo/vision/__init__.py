"""model_zoo.vision (ref: ``mxnet_tpu/gluon/model_zoo/vision/__init__.py``):
the ResNet builders and LeNet; the other networks come with slice 9."""
from .others import LeNet, lenet  # noqa: F401
from .resnet import (ResNetV1, ResNetV2, get_resnet,  # noqa: F401
                     resnet18_v1, resnet18_v2, resnet34_v1, resnet34_v2,
                     resnet50_v1, resnet50_v2, resnet101_v1, resnet101_v2,
                     resnet152_v1, resnet152_v2)

_models = {k: v for k, v in globals().items() if callable(v)
           and k.startswith("resnet")}
_models["lenet"] = lenet


def get_model(name, **kwargs):
    """Ref: model_zoo.vision.get_model."""
    name = name.lower()
    if name not in _models:
        raise ValueError(
            f"unknown model {name!r}; available: {sorted(_models)}")
    return _models[name](**kwargs)
