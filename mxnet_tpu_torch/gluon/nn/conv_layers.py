"""Convolution and pooling Gluon layers (ref: python/mxnet/gluon/nn/
conv_layers.py; ``mxnet_tpu/gluon/nn/conv_layers.py``): the 1-D, 2-D and 3-D
convolutions and transposed convolutions, the pooling layers and
``ReflectionPad2D``.  Weights keep the JAX package's shapes, OHWI for a
channel-last convolution, OIHW for a channel-first one and ``(in, out/groups,
*k)`` for a transposed one, so they carry across as they are."""
from __future__ import annotations

import math

from ..block import HybridBlock


def _pair(x, n):
    if isinstance(x, (tuple, list)):
        return tuple(x)
    return (x,) * n


class _Conv(HybridBlock):
    """A convolution (``op_name="Convolution"``) or a transposed one
    (``"Deconvolution"``, with ``adj`` its output padding)."""

    def __init__(self, channels, kernel_size, strides, padding, dilation,
                 groups, layout, in_channels=0, activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", op_name="Convolution",
                 adj=None, **kwargs):
        super().__init__(**kwargs)
        self._channels = channels
        self._op_name = op_name
        self._kwargs = {
            "kernel": kernel_size, "stride": strides, "dilate": dilation,
            "pad": padding, "num_filter": channels, "num_group": groups,
            "no_bias": not use_bias, "layout": layout}
        if adj is not None:
            self._kwargs["adj"] = adj
        self._activation = activation
        self._channel_last = bool(layout) and layout.endswith("C")
        cin = in_channels // groups if in_channels else 0
        if op_name == "Convolution":
            wshape = (channels,) + kernel_size + (cin,) \
                if self._channel_last else (channels, cin) + kernel_size
        else:
            wshape = (in_channels, channels // groups) + kernel_size
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
        if self._op_name != "Convolution":
            self.weight.shape = (x.shape[1], self._channels // g) + k
        elif self._channel_last:
            c_in = x.shape[-1] // g
            self.weight.shape = (self._channels,) + k + (c_in,)
            self._set_fan_hint(c_in)
        else:
            self.weight.shape = (self._channels, x.shape[1] // g) + k

    def hybrid_forward(self, F, x, weight, bias=None):
        out = getattr(F, self._op_name)(x, weight, bias, **self._kwargs)
        if self._activation:
            out = F.Activation(out, act_type=self._activation)
        return out


class Conv1D(_Conv):
    def __init__(self, channels, kernel_size, strides=1, padding=0,
                 dilation=1, groups=1, layout="NCW", **kwargs):
        super().__init__(channels, _pair(kernel_size, 1), _pair(strides, 1),
                         _pair(padding, 1), _pair(dilation, 1), groups,
                         layout, **kwargs)


class Conv2D(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1), padding=(0, 0),
                 dilation=(1, 1), groups=1, layout="NCHW", **kwargs):
        super().__init__(channels, _pair(kernel_size, 2), _pair(strides, 2),
                         _pair(padding, 2), _pair(dilation, 2), groups,
                         layout, **kwargs)


class Conv3D(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1, 1),
                 padding=(0, 0, 0), dilation=(1, 1, 1), groups=1,
                 layout="NCDHW", **kwargs):
        super().__init__(channels, _pair(kernel_size, 3), _pair(strides, 3),
                         _pair(padding, 3), _pair(dilation, 3), groups,
                         layout, **kwargs)


class Conv1DTranspose(_Conv):
    def __init__(self, channels, kernel_size, strides=1, padding=0,
                 output_padding=0, dilation=1, groups=1, layout="NCW",
                 **kwargs):
        super().__init__(channels, _pair(kernel_size, 1), _pair(strides, 1),
                         _pair(padding, 1), _pair(dilation, 1), groups,
                         layout, op_name="Deconvolution",
                         adj=_pair(output_padding, 1), **kwargs)


class Conv2DTranspose(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1), padding=(0, 0),
                 output_padding=(0, 0), dilation=(1, 1), groups=1,
                 layout="NCHW", **kwargs):
        super().__init__(channels, _pair(kernel_size, 2), _pair(strides, 2),
                         _pair(padding, 2), _pair(dilation, 2), groups,
                         layout, op_name="Deconvolution",
                         adj=_pair(output_padding, 2), **kwargs)


class Conv3DTranspose(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1, 1),
                 padding=(0, 0, 0), output_padding=(0, 0, 0),
                 dilation=(1, 1, 1), groups=1, layout="NCDHW", **kwargs):
        super().__init__(channels, _pair(kernel_size, 3), _pair(strides, 3),
                         _pair(padding, 3), _pair(dilation, 3), groups,
                         layout, op_name="Deconvolution",
                         adj=_pair(output_padding, 3), **kwargs)


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


def _pool(n, pool_type, default_layout):
    """The windowed ``n``-D pooling layer of ``pool_type``; the average
    pools also take ``count_include_pad`` (default True)."""

    def __init__(self, pool_size=(2,) * n, strides=None, padding=0,
                 layout=default_layout, ceil_mode=False, **kwargs):
        include = kwargs.pop("count_include_pad", True) \
            if pool_type == "avg" else None
        _Pooling.__init__(
            self, _pair(pool_size, n),
            _pair(strides, n) if strides else None, _pair(padding, n),
            ceil_mode, False, pool_type, include, layout=layout, **kwargs)

    return __init__


def _global_pool(n, pool_type, default_layout):
    """The global ``n``-D pooling layer of ``pool_type``."""

    def __init__(self, layout=default_layout, **kwargs):
        _Pooling.__init__(self, (1,) * n, None, (0,) * n, False, True,
                          pool_type, layout=layout, **kwargs)

    return __init__


_LAYOUTS = {1: "NCW", 2: "NCHW", 3: "NCDHW"}


class MaxPool1D(_Pooling):
    __init__ = _pool(1, "max", _LAYOUTS[1])


class MaxPool2D(_Pooling):
    __init__ = _pool(2, "max", _LAYOUTS[2])


class MaxPool3D(_Pooling):
    __init__ = _pool(3, "max", _LAYOUTS[3])


class AvgPool1D(_Pooling):
    __init__ = _pool(1, "avg", _LAYOUTS[1])


class AvgPool2D(_Pooling):
    __init__ = _pool(2, "avg", _LAYOUTS[2])


class AvgPool3D(_Pooling):
    __init__ = _pool(3, "avg", _LAYOUTS[3])


class GlobalMaxPool1D(_Pooling):
    __init__ = _global_pool(1, "max", _LAYOUTS[1])


class GlobalMaxPool2D(_Pooling):
    __init__ = _global_pool(2, "max", _LAYOUTS[2])


class GlobalMaxPool3D(_Pooling):
    __init__ = _global_pool(3, "max", _LAYOUTS[3])


class GlobalAvgPool1D(_Pooling):
    __init__ = _global_pool(1, "avg", _LAYOUTS[1])


class GlobalAvgPool2D(_Pooling):
    __init__ = _global_pool(2, "avg", _LAYOUTS[2])


class GlobalAvgPool3D(_Pooling):
    __init__ = _global_pool(3, "avg", _LAYOUTS[3])


class ReflectionPad2D(HybridBlock):
    """NCHW data padded by reflection on its spatial axes (ref:
    nn.ReflectionPad2D): ``padding`` one width for all four sides, or
    ``(top, bottom, left, right)``."""

    def __init__(self, padding=0, **kwargs):
        super().__init__(**kwargs)
        p = padding if isinstance(padding, (tuple, list)) else (padding,) * 4
        self._pad = (0, 0, 0, 0) + tuple(p)

    def hybrid_forward(self, F, x):
        return F.pad(x, mode="reflect", pad_width=self._pad)
