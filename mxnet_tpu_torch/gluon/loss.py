"""Gluon losses (ref: python/mxnet/gluon/loss.py; ``mxnet_tpu/gluon/
loss.py``).  Each returns one value per sample, the mean over every axis
but ``batch_axis``, except ``PoissonNLLLoss`` (the mean over everything),
and ``TripletLoss``, ``CosineEmbeddingLoss`` and ``CTCLoss`` (one value a
sample by construction)."""
from __future__ import annotations

from .block import HybridBlock


def _apply_weighting(F, loss, weight=None, sample_weight=None):
    if sample_weight is not None:
        loss = F.broadcast_mul(loss, sample_weight)
    if weight is not None:
        loss = loss * weight
    return loss


def _reshape_like(pred, label):
    return label.reshape(pred.shape) if label.shape != pred.shape else label


class Loss(HybridBlock):
    def __init__(self, weight, batch_axis, **kwargs):
        super().__init__(**kwargs)
        self._weight = weight
        self._batch_axis = batch_axis


class L2Loss(Loss):
    """``weight/2 * (label - pred)^2``."""

    def __init__(self, weight=1.0, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        label = _reshape_like(pred, label)
        loss = F.square(label - pred)
        loss = _apply_weighting(F, loss, self._weight / 2, sample_weight)
        return F.mean(loss, axis=self._batch_axis, exclude=True)


class L1Loss(Loss):
    """``weight * |label - pred|``."""

    def __init__(self, weight=1.0, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        label = _reshape_like(pred, label)
        loss = F.abs(label - pred)
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return F.mean(loss, axis=self._batch_axis, exclude=True)


class SigmoidBinaryCrossEntropyLoss(Loss):
    """Binary cross-entropy of logits (``from_sigmoid=False``, the stable
    log-sum-exp form) or of probabilities, with an optional ``pos_weight``
    on the positive term."""

    def __init__(self, from_sigmoid=False, weight=None, batch_axis=0,
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._from_sigmoid = from_sigmoid

    def hybrid_forward(self, F, pred, label, sample_weight=None,
                       pos_weight=None):
        label = _reshape_like(pred, label)
        if not self._from_sigmoid:
            if pos_weight is None:
                loss = F.relu(pred) - pred * label + \
                    F.Activation(-F.abs(pred), act_type="softrelu")
            else:
                loss = (F.broadcast_mul(label, pos_weight)
                        * F.Activation(-pred, act_type="softrelu")
                        + (1.0 - label)
                        * F.Activation(pred, act_type="softrelu"))
        else:
            eps = 1e-12
            if pos_weight is None:
                loss = -(F.log(pred + eps) * label
                         + F.log(1.0 - pred + eps) * (1.0 - label))
            else:
                loss = -(F.broadcast_mul(F.log(pred + eps) * label,
                                         pos_weight)
                         + F.log(1.0 - pred + eps) * (1.0 - label))
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return F.mean(loss, axis=self._batch_axis, exclude=True)


SigmoidBCELoss = SigmoidBinaryCrossEntropyLoss


class SoftmaxCrossEntropyLoss(Loss):
    """Cross-entropy of ``log_softmax(pred)`` (or of ``pred`` itself with
    ``from_logits``) against class indices (``sparse_label``) or a
    distribution."""

    def __init__(self, axis=-1, sparse_label=True, from_logits=False,
                 weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._axis = axis
        self._sparse_label = sparse_label
        self._from_logits = from_logits

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        if not self._from_logits:
            pred = F.log_softmax(pred, axis=self._axis)
        if self._sparse_label:
            loss = -F.pick(pred, label, axis=self._axis, keepdims=True)
        else:
            label = _reshape_like(pred, label)
            loss = -F.sum(pred * label, axis=self._axis, keepdims=True)
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return F.mean(loss, axis=self._batch_axis, exclude=True)


SoftmaxCELoss = SoftmaxCrossEntropyLoss


class KLDivLoss(Loss):
    """``label * (log(label) - pred)``, ``pred`` log-probabilities
    (``from_logits``) or logits put through ``log_softmax``."""

    def __init__(self, from_logits=True, axis=-1, weight=None, batch_axis=0,
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._from_logits = from_logits
        self._axis = axis

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        if not self._from_logits:
            pred = F.log_softmax(pred, axis=self._axis)
        loss = label * (F.log(label + 1e-12) - pred)
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return F.mean(loss, axis=self._batch_axis, exclude=True)


class HuberLoss(Loss):
    """``|d| - rho/2`` where ``|d| > rho``, else ``d^2 / (2 rho)``, with
    ``d = label - pred``."""

    def __init__(self, rho=1.0, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._rho = rho

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        label = _reshape_like(pred, label)
        loss = F.abs(label - pred)
        loss = F.where(loss > self._rho, loss - 0.5 * self._rho,
                       (0.5 / self._rho) * F.square(loss))
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return F.mean(loss, axis=self._batch_axis, exclude=True)


class HingeLoss(Loss):
    """``max(0, margin - pred*label)``, labels -1 or 1."""

    def __init__(self, margin=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        label = _reshape_like(pred, label)
        loss = F.relu(self._margin - pred * label)
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return F.mean(loss, axis=self._batch_axis, exclude=True)


class SquaredHingeLoss(Loss):
    """``max(0, margin - pred*label)^2``, labels -1 or 1."""

    def __init__(self, margin=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        label = _reshape_like(pred, label)
        loss = F.square(F.relu(self._margin - pred * label))
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return F.mean(loss, axis=self._batch_axis, exclude=True)


class LogisticLoss(Loss):
    """The logistic loss of logits, in the stable form; ``label_format``
    ``signed`` (labels -1 or 1) or ``binary`` (0 or 1)."""

    def __init__(self, weight=None, batch_axis=0, label_format="signed",
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._label_format = label_format

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        label = _reshape_like(pred, label)
        if self._label_format == "signed":
            label = (label + 1.0) / 2.0
        loss = F.relu(pred) - pred * label + \
            F.Activation(-F.abs(pred), act_type="softrelu")
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return F.mean(loss, axis=self._batch_axis, exclude=True)


class TripletLoss(Loss):
    """``max(0, |pos - pred|^2 - |neg - pred|^2 + margin)``, the squared
    distances summed over every axis but ``batch_axis``."""

    def __init__(self, margin=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def hybrid_forward(self, F, pred, positive, negative, sample_weight=None):
        positive = _reshape_like(pred, positive)
        negative = _reshape_like(pred, negative)
        loss = F.sum(F.square(positive - pred) - F.square(negative - pred),
                     axis=self._batch_axis, exclude=True)
        loss = F.relu(loss + self._margin)
        return _apply_weighting(F, loss, self._weight, sample_weight)


class PoissonNLLLoss(Loss):
    """The Poisson negative log-likelihood of ``target``: ``e^pred -
    target*pred`` for log-rates (``from_logits``), else ``pred -
    target*log(pred + epsilon)``; ``compute_full`` adds Stirling's
    approximation of ``log(target!)`` where ``target > 1``.  The mean over
    every element."""

    def __init__(self, weight=None, from_logits=True, batch_axis=0,
                 compute_full=False, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._from_logits = from_logits
        self._compute_full = compute_full

    def hybrid_forward(self, F, pred, target, sample_weight=None,
                       epsilon=1e-08):
        target = _reshape_like(pred, target)
        if self._from_logits:
            loss = F.exp(pred) - target * pred
        else:
            loss = pred - target * F.log(pred + epsilon)
        if self._compute_full:
            stirling = (target * F.log(target + 1e-12) - target
                        + 0.5 * F.log(2 * 3.1415926535 * (target + 1e-12)))
            stirling = F.where(target <= 1, F.zeros_like(target), stirling)
            loss = loss + stirling
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return F.mean(loss)


class CosineEmbeddingLoss(Loss):
    """``1 - cos(input1, input2)`` where ``label`` is 1, else
    ``max(0, cos - margin)``, the cosine over the last axis."""

    def __init__(self, weight=None, batch_axis=0, margin=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def hybrid_forward(self, F, input1, input2, label, sample_weight=None):
        eps = 1e-12
        prod = F.sum(input1 * input2, axis=-1)
        n1 = F.sqrt(F.sum(F.square(input1), axis=-1) + eps)
        n2 = F.sqrt(F.sum(F.square(input2), axis=-1) + eps)
        cos = prod / (n1 * n2)
        label = label.reshape(cos.shape)
        loss = F.where(label == 1, 1.0 - cos, F.relu(cos - self._margin))
        return _apply_weighting(F, loss, self._weight, sample_weight)


class CTCLoss(Loss):
    """Connectionist temporal classification loss (ref: gluon.loss.CTCLoss
    over src/operator/contrib/ctc_loss.cc): the ``CTCLoss`` op with the
    blank the last class and labels padded with -1.

    ``layout``: ``'NTC'`` (default) or ``'TNC'``; ``label_layout``:
    ``'NT'`` or ``'TN'``.  ``pred_lengths`` and ``label_lengths``, where
    given, are each row's lengths."""

    def __init__(self, layout="NTC", label_layout="NT", weight=None,
                 **kwargs):
        if layout not in ("NTC", "TNC"):
            raise ValueError(f"unsupported pred layout {layout!r}")
        if label_layout not in ("NT", "TN"):
            raise ValueError(f"unsupported label layout {label_layout!r}")
        super().__init__(weight, 0 if label_layout == "NT" else 1, **kwargs)
        self._layout = layout
        self._label_layout = label_layout

    def hybrid_forward(self, F, pred, label, pred_lengths=None,
                       label_lengths=None, sample_weight=None):
        if self._layout == "NTC":
            pred = F.swapaxes(pred, dim1=0, dim2=1)
        if self._label_layout == "TN":
            label = F.swapaxes(label, dim1=0, dim2=1)
        loss = F.CTCLoss(pred, label, pred_lengths, label_lengths,
                         use_data_lengths=pred_lengths is not None,
                         use_label_lengths=label_lengths is not None,
                         blank_label="last")
        return _apply_weighting(F, loss, self._weight, sample_weight)
