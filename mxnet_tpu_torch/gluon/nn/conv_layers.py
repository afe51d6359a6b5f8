"""Convolution and pooling Gluon layers (ref: python/mxnet/gluon/nn/
conv_layers.py; ``mxnet_tpu/gluon/nn/conv_layers.py``): ``Conv2D`` and the
2-D pooling layers.  Weights keep the JAX package's shapes, OHWI for a
channel-last layout and OIHW otherwise, so they carry across as they are."""
from __future__ import annotations

import math

from ..block import HybridBlock


def _pair(x, n):
    if isinstance(x, (tuple, list)):
        return tuple(x)
    return (x,) * n


class _Conv(HybridBlock):
    def __init__(self, channels, kernel_size, strides, padding, dilation,
                 groups, layout, in_channels=0, activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", **kwargs):
        super().__init__(**kwargs)
        self._channels = channels
        self._kwargs = {
            "kernel": kernel_size, "stride": strides, "dilate": dilation,
            "pad": padding, "num_filter": channels, "num_group": groups,
            "no_bias": not use_bias, "layout": layout}
        self._activation = activation
        self._channel_last = bool(layout) and layout.endswith("C")
        cin = in_channels // groups if in_channels else 0
        wshape = (channels,) + kernel_size + (cin,) if self._channel_last \
            else (channels, cin) + kernel_size
        self.weight = self.params.get(
            "weight", shape=wshape, init=weight_initializer,
            allow_deferred_init=True)
        if self._channel_last and cin:
            self._set_fan_hint(cin)
        self.bias = self.params.get(
            "bias", shape=(channels,), init=bias_initializer,
            allow_deferred_init=True) if use_bias else None

    def _set_fan_hint(self, c_in):
        """The exact fans for fan-based initializers: an OHWI shape alone
        is ambiguous (see ``initializer.InitDesc``)."""
        k = math.prod(self._kwargs["kernel"])
        self.weight._init_attrs = {
            "__init_fan__": (c_in * k, self._channels * k)}

    def infer_shape(self, x, *args):
        g = self._kwargs["num_group"]
        k = tuple(self._kwargs["kernel"])
        if self._channel_last:
            c_in = x.shape[-1] // g
            self.weight.shape = (self._channels,) + k + (c_in,)
            self._set_fan_hint(c_in)
        else:
            self.weight.shape = (self._channels, x.shape[1] // g) + k

    def hybrid_forward(self, F, x, weight, bias=None):
        out = F.Convolution(x, weight, bias, **self._kwargs)
        if self._activation:
            out = F.Activation(out, act_type=self._activation)
        return out


class Conv2D(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1), padding=(0, 0),
                 dilation=(1, 1), groups=1, layout="NCHW", **kwargs):
        super().__init__(channels, _pair(kernel_size, 2), _pair(strides, 2),
                         _pair(padding, 2), _pair(dilation, 2), groups,
                         layout, **kwargs)


class _Pooling(HybridBlock):
    def __init__(self, pool_size, strides, padding, ceil_mode, global_pool,
                 pool_type, count_include_pad=None, layout=None, **kwargs):
        super().__init__(**kwargs)
        if strides is None:
            strides = pool_size
        self._kwargs = {
            "kernel": pool_size, "stride": strides, "pad": padding,
            "pool_type": pool_type, "global_pool": global_pool,
            "pooling_convention": "full" if ceil_mode else "valid",
            "layout": layout}
        if count_include_pad is not None:
            self._kwargs["count_include_pad"] = count_include_pad

    def hybrid_forward(self, F, x):
        return F.Pooling(x, **self._kwargs)


class MaxPool2D(_Pooling):
    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout="NCHW", ceil_mode=False, **kwargs):
        super().__init__(_pair(pool_size, 2),
                         _pair(strides, 2) if strides else None,
                         _pair(padding, 2), ceil_mode, False, "max",
                         layout=layout, **kwargs)


class AvgPool2D(_Pooling):
    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout="NCHW", ceil_mode=False, count_include_pad=True,
                 **kwargs):
        super().__init__(_pair(pool_size, 2),
                         _pair(strides, 2) if strides else None,
                         _pair(padding, 2), ceil_mode, False, "avg",
                         count_include_pad, layout=layout, **kwargs)


class GlobalAvgPool2D(_Pooling):
    def __init__(self, layout="NCHW", **kwargs):
        super().__init__((1, 1), None, (0, 0), False, True, "avg",
                         layout=layout, **kwargs)
