"""ResNet v1/v2 (ref: ``mxnet_tpu/gluon/model_zoo/vision/resnet.py``).

Structural parameter names and shapes are those of the JAX package, so
weights carry across by name (``convert.load_numpy_params``).  With
``MXTPU_CONV_EPILOGUE=pallas`` and the NHWC layout, ``BottleneckV1`` runs
its 1x1 convolutions through the fused ops (``ops/conv_fused_ops.py``):
the convolution's epilogue computes its BatchNorm's statistics, and the
previous BatchNorm's normalize and ReLU ride in the next 1x1 product's
input read.
"""
from __future__ import annotations

from .... import autograd
from ....base import MXNetError, getenv
from ...block import HybridBlock, commit_aux
from ...parameter import DeferredInitializationError
from ... import nn


class BasicBlockV1(HybridBlock):
    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 layout="NCHW", **kwargs):
        super().__init__(**kwargs)
        ax = -1 if layout[-1] == "C" else 1
        self.body = nn.HybridSequential()
        self.body.add(nn.Conv2D(channels, 3, stride, 1, use_bias=False,
                                in_channels=in_channels, layout=layout))
        self.body.add(nn.BatchNorm(axis=ax))
        self.body.add(nn.Activation("relu"))
        self.body.add(nn.Conv2D(channels, 3, 1, 1, use_bias=False,
                                layout=layout))
        self.body.add(nn.BatchNorm(axis=ax))
        if downsample:
            self.downsample = nn.HybridSequential()
            self.downsample.add(
                nn.Conv2D(channels, 1, stride, use_bias=False,
                          in_channels=in_channels, layout=layout))
            self.downsample.add(nn.BatchNorm(axis=ax))
        else:
            self.downsample = None

    def hybrid_forward(self, F, x):
        residual = x
        x_out = self.body(x)
        if self.downsample is not None:
            residual = self.downsample(residual)
        return F.Activation(residual + x_out, act_type="relu")


class BottleneckV1(HybridBlock):
    """1x1 -> 3x3 -> 1x1 bottleneck.

    ``MXTPU_CONV_EPILOGUE=pallas`` (read at construction) with the NHWC
    layout routes the forward through :meth:`_fused_forward`, which reads
    the same child blocks' parameters as the standard forward, so names,
    weights and checkpoints are the same on both paths.  The first call of
    a net with deferred shapes runs the standard path once (it initializes
    the children; in training it moves the BatchNorm averages once)."""

    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 layout="NCHW", **kwargs):
        super().__init__(**kwargs)
        ax = -1 if layout[-1] == "C" else 1
        self._stride = stride
        self._fuse = (layout == "NHWC"
                      and getenv("CONV_EPILOGUE", "") == "pallas")
        self.body = nn.HybridSequential()
        self.body.add(nn.Conv2D(channels // 4, 1, stride, use_bias=False,
                                layout=layout))
        self.body.add(nn.BatchNorm(axis=ax))
        self.body.add(nn.Activation("relu"))
        self.body.add(nn.Conv2D(channels // 4, 3, 1, 1, use_bias=False,
                                layout=layout))
        self.body.add(nn.BatchNorm(axis=ax))
        self.body.add(nn.Activation("relu"))
        self.body.add(nn.Conv2D(channels, 1, 1, use_bias=False,
                                layout=layout))
        self.body.add(nn.BatchNorm(axis=ax))
        if downsample:
            self.downsample = nn.HybridSequential()
            self.downsample.add(
                nn.Conv2D(channels, 1, stride, use_bias=False,
                          in_channels=in_channels, layout=layout))
            self.downsample.add(nn.BatchNorm(axis=ax))
        else:
            self.downsample = None

    def hybrid_forward(self, F, x):
        if self._fuse:
            try:
                return self._fused_forward(F, x)
            except DeferredInitializationError:
                pass  # first call with deferred shapes: one standard pass
        residual = x
        x_out = self.body(x)
        if self.downsample is not None:
            residual = self.downsample(residual)
        return F.Activation(residual + x_out, act_type="relu")

    @staticmethod
    def _bn_args(bn):
        """The BatchNorm layer's parameters and attributes, in the fused
        ops' order."""
        kw = bn._kwargs
        return ((bn.gamma.data(), bn.beta.data(), bn.running_mean.data(),
                 bn.running_var.data()),
                dict(eps=kw["eps"], momentum=kw["momentum"],
                     fix_gamma=kw["fix_gamma"]))

    @staticmethod
    def _commit(bn, new_mm, new_mv, train):
        if train:
            commit_aux(bn.running_mean.data(), new_mm)
            commit_aux(bn.running_var.data(), new_mv)

    def _conv1x1(self, F, x, conv, bn, train, **kw):
        args, bn_kw = self._bn_args(bn)
        y, s, h, mm, mv = F.contrib.conv1x1_bn_act(
            x, conv.weight.data(), *args, _train=train, **bn_kw, **kw)
        self._commit(bn, mm, mv, train)
        return y, s, h

    def _fused_forward(self, F, x):
        train = autograd.is_training()
        c1, b1, c2, b2, c3, b3 = (self.body[0], self.body[1], self.body[3],
                                  self.body[4], self.body[6], self.body[7])
        # conv1 (1x1, stride): raw output and its BN folded to (scale, shift)
        y1, s1, h1 = self._conv1x1(F, x, c1, b1, train, stride=self._stride)
        # the 3x3 stays a convolution; normalize + ReLU are written once
        a1 = F.Activation(y1 * s1.to(y1.dtype) + h1.to(y1.dtype),
                          act_type="relu")
        y2 = c2(a1)
        # bn2: statistics and fold only; conv3 reads the raw y2 through
        # bn2's normalize + ReLU and computes bn3's statistics
        args, bn_kw = self._bn_args(b2)
        s2, h2, mm, mv = F.contrib.bn_fold(y2, *args, _train=train, **bn_kw)
        self._commit(b2, mm, mv, train)
        y3, s3, h3 = self._conv1x1(F, y2, c3, b3, train, in_scale=s2,
                                   in_shift=h2, in_act=True)
        if self.downsample is not None:
            dc, db = self.downsample[0], self.downsample[1]
            yd, sd, hd = self._conv1x1(F, x, dc, db, train,
                                       stride=self._stride)
            residual = yd * sd.to(yd.dtype) + hd.to(yd.dtype)
        else:
            residual = x
        out = y3 * s3.to(y3.dtype) + h3.to(y3.dtype) + residual
        return F.Activation(out, act_type="relu")


class BasicBlockV2(HybridBlock):
    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 layout="NCHW", **kwargs):
        super().__init__(**kwargs)
        ax = -1 if layout[-1] == "C" else 1
        self.bn1 = nn.BatchNorm(axis=ax)
        self.conv1 = nn.Conv2D(channels, 3, stride, 1, use_bias=False,
                               in_channels=in_channels, layout=layout)
        self.bn2 = nn.BatchNorm(axis=ax)
        self.conv2 = nn.Conv2D(channels, 3, 1, 1, use_bias=False,
                               layout=layout)
        if downsample:
            self.downsample = nn.Conv2D(channels, 1, stride, use_bias=False,
                                        in_channels=in_channels,
                                        layout=layout)
        else:
            self.downsample = None

    def hybrid_forward(self, F, x):
        residual = x
        x = self.bn1(x)
        x = F.Activation(x, act_type="relu")
        if self.downsample is not None:
            residual = self.downsample(x)
        x = self.conv1(x)
        x = self.bn2(x)
        x = F.Activation(x, act_type="relu")
        x = self.conv2(x)
        return x + residual


class BottleneckV2(HybridBlock):
    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 layout="NCHW", **kwargs):
        super().__init__(**kwargs)
        ax = -1 if layout[-1] == "C" else 1
        self.bn1 = nn.BatchNorm(axis=ax)
        self.conv1 = nn.Conv2D(channels // 4, 1, 1, use_bias=False,
                               layout=layout)
        self.bn2 = nn.BatchNorm(axis=ax)
        self.conv2 = nn.Conv2D(channels // 4, 3, stride, 1, use_bias=False,
                               layout=layout)
        self.bn3 = nn.BatchNorm(axis=ax)
        self.conv3 = nn.Conv2D(channels, 1, 1, use_bias=False, layout=layout)
        if downsample:
            self.downsample = nn.Conv2D(channels, 1, stride, use_bias=False,
                                        in_channels=in_channels,
                                        layout=layout)
        else:
            self.downsample = None

    def hybrid_forward(self, F, x):
        residual = x
        x = self.bn1(x)
        x = F.Activation(x, act_type="relu")
        if self.downsample is not None:
            residual = self.downsample(x)
        x = self.conv1(x)
        x = self.bn2(x)
        x = F.Activation(x, act_type="relu")
        x = self.conv2(x)
        x = self.bn3(x)
        x = F.Activation(x, act_type="relu")
        x = self.conv3(x)
        return x + residual


resnet_spec = {
    18: ("basic_block", [2, 2, 2, 2], [64, 64, 128, 256, 512]),
    34: ("basic_block", [3, 4, 6, 3], [64, 64, 128, 256, 512]),
    50: ("bottle_neck", [3, 4, 6, 3], [64, 256, 512, 1024, 2048]),
    101: ("bottle_neck", [3, 4, 23, 3], [64, 256, 512, 1024, 2048]),
    152: ("bottle_neck", [3, 8, 36, 3], [64, 256, 512, 1024, 2048]),
}


class ResNetV1(HybridBlock):
    def __init__(self, block, layers, channels, classes=1000,
                 thumbnail=False, layout="NCHW", **kwargs):
        super().__init__(**kwargs)
        ax = -1 if layout[-1] == "C" else 1
        self.features = nn.HybridSequential()
        if thumbnail:
            self.features.add(nn.Conv2D(channels[0], 3, 1, 1,
                                        use_bias=False, layout=layout))
        else:
            self.features.add(nn.Conv2D(channels[0], 7, 2, 3,
                                        use_bias=False, layout=layout))
            self.features.add(nn.BatchNorm(axis=ax))
            self.features.add(nn.Activation("relu"))
            self.features.add(nn.MaxPool2D(3, 2, 1, layout=layout))
        for i, num_layer in enumerate(layers):
            stride = 1 if i == 0 else 2
            self.features.add(self._make_layer(
                block, num_layer, channels[i + 1], stride,
                in_channels=channels[i], layout=layout))
        self.features.add(nn.GlobalAvgPool2D(layout=layout))
        self.output = nn.Dense(classes)

    def _make_layer(self, block, num_layers, channels, stride,
                    in_channels=0, layout="NCHW"):
        layer = nn.HybridSequential()
        layer.add(block(channels, stride,
                        downsample=(channels != in_channels or stride != 1),
                        in_channels=in_channels, layout=layout))
        for _ in range(num_layers - 1):
            layer.add(block(channels, 1, False, in_channels=channels,
                            layout=layout))
        return layer

    def hybrid_forward(self, F, x):
        x = self.features(x)
        return self.output(F.flatten(x))


class ResNetV2(HybridBlock):
    def __init__(self, block, layers, channels, classes=1000,
                 thumbnail=False, layout="NCHW", **kwargs):
        super().__init__(**kwargs)
        ax = -1 if layout[-1] == "C" else 1
        self.features = nn.HybridSequential()
        self.features.add(nn.BatchNorm(axis=ax, scale=False, center=False))
        if thumbnail:
            self.features.add(nn.Conv2D(channels[0], 3, 1, 1,
                                        use_bias=False, layout=layout))
        else:
            self.features.add(nn.Conv2D(channels[0], 7, 2, 3,
                                        use_bias=False, layout=layout))
            self.features.add(nn.BatchNorm(axis=ax))
            self.features.add(nn.Activation("relu"))
            self.features.add(nn.MaxPool2D(3, 2, 1, layout=layout))
        for i, num_layer in enumerate(layers):
            stride = 1 if i == 0 else 2
            self.features.add(self._make_layer(
                block, num_layer, channels[i + 1], stride,
                in_channels=channels[i], layout=layout))
        self.features.add(nn.BatchNorm(axis=ax))
        self.features.add(nn.Activation("relu"))
        self.features.add(nn.GlobalAvgPool2D(layout=layout))
        self.output = nn.Dense(classes)

    _make_layer = ResNetV1._make_layer

    def hybrid_forward(self, F, x):
        x = self.features(x)
        return self.output(F.flatten(x))


_blocks = {1: {"basic_block": BasicBlockV1, "bottle_neck": BottleneckV1},
           2: {"basic_block": BasicBlockV2, "bottle_neck": BottleneckV2}}
_nets = {1: ResNetV1, 2: ResNetV2}


def get_resnet(version, num_layers, pretrained=False, ctx=None,
               classes=1000, **kwargs):
    """A ResNet of ``num_layers`` (18, 34, 50, 101, 152), version 1 or 2;
    weights are initialized by the caller (no pretrained download)."""
    if num_layers not in resnet_spec:
        raise MXNetError(f"unsupported resnet depth {num_layers}")
    if pretrained:
        raise MXNetError("pretrained weights are not downloaded; load them "
                         "with convert.load_numpy_params")
    block_type, layers, channels = resnet_spec[num_layers]
    return _nets[version](_blocks[version][block_type], layers, channels,
                          classes=classes, **kwargs)


def resnet18_v1(**kw):
    return get_resnet(1, 18, **kw)


def resnet34_v1(**kw):
    return get_resnet(1, 34, **kw)


def resnet50_v1(**kw):
    return get_resnet(1, 50, **kw)


def resnet101_v1(**kw):
    return get_resnet(1, 101, **kw)


def resnet152_v1(**kw):
    return get_resnet(1, 152, **kw)


def resnet18_v2(**kw):
    return get_resnet(2, 18, **kw)


def resnet34_v2(**kw):
    return get_resnet(2, 34, **kw)


def resnet50_v2(**kw):
    return get_resnet(2, 50, **kw)


def resnet101_v2(**kw):
    return get_resnet(2, 101, **kw)


def resnet152_v2(**kw):
    return get_resnet(2, 152, **kw)
