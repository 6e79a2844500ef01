"""The loss layers.  Counterpart of ``paddle_tpu/nn/loss.py``: thin
``Layer`` s over ``nn.functional``'s losses, with the reference's
constructors."""
from __future__ import annotations

from . import functional as F
from .layers import Layer


class CrossEntropyLoss(Layer):
    def __init__(self, weight=None, ignore_index=-100, reduction="mean",
                 soft_label=False, axis=-1, use_softmax=True,
                 label_smoothing=0.0, name=None):
        super().__init__()
        self.weight = weight
        self.ignore_index = ignore_index
        self.reduction = reduction
        self.soft_label = soft_label
        self.axis = axis
        self.label_smoothing = label_smoothing

    def forward(self, input, label):
        return F.cross_entropy(input, label, weight=self.weight,
                               ignore_index=self.ignore_index,
                               reduction=self.reduction,
                               soft_label=self.soft_label, axis=self.axis,
                               label_smoothing=self.label_smoothing)


class MSELoss(Layer):
    def __init__(self, reduction="mean"):
        super().__init__()
        self.reduction = reduction

    def forward(self, input, label):
        return F.mse_loss(input, label, self.reduction)


class L1Loss(Layer):
    def __init__(self, reduction="mean", name=None):
        super().__init__()
        self.reduction = reduction

    def forward(self, input, label):
        return F.l1_loss(input, label, self.reduction)


class SmoothL1Loss(Layer):
    def __init__(self, reduction="mean", delta=1.0, name=None):
        super().__init__()
        self.reduction = reduction
        self.delta = delta

    def forward(self, input, label):
        return F.smooth_l1_loss(input, label, self.reduction, self.delta)


class NLLLoss(Layer):
    def __init__(self, weight=None, ignore_index=-100, reduction="mean",
                 name=None):
        super().__init__()
        self.weight = weight
        self.ignore_index = ignore_index
        self.reduction = reduction

    def forward(self, input, label):
        return F.nll_loss(input, label, weight=self.weight,
                          ignore_index=self.ignore_index,
                          reduction=self.reduction)


class BCELoss(Layer):
    def __init__(self, weight=None, reduction="mean", name=None):
        super().__init__()
        self.weight = weight
        self.reduction = reduction

    def forward(self, input, label):
        return F.binary_cross_entropy(input, label, self.weight,
                                      self.reduction)


class BCEWithLogitsLoss(Layer):
    def __init__(self, weight=None, reduction="mean", pos_weight=None,
                 name=None):
        super().__init__()
        self.weight = weight
        self.reduction = reduction
        self.pos_weight = pos_weight

    def forward(self, logit, label):
        return F.binary_cross_entropy_with_logits(
            logit, label, self.weight, self.reduction, self.pos_weight)


class KLDivLoss(Layer):
    def __init__(self, reduction="mean", log_target=False):
        super().__init__()
        self.reduction = reduction
        self.log_target = log_target

    def forward(self, input, label):
        return F.kl_div(input, label, self.reduction, self.log_target)


def _fn_loss(name, fn_name, params, inputs):
    """A loss layer whose constructor takes ``params`` (name, default)
    in order, plus ``name``, and whose forward passes ``inputs`` and
    those settings to ``F.<fn_name>``."""
    keys = [k for k, _ in params]

    def __init__(self, *args, **kwargs):
        Layer.__init__(self)
        kw = dict(params)
        kw.update(zip(keys, args))
        kw.update({k: v for k, v in kwargs.items() if k != "name"})
        self._kw = kw

    def forward(self, *args, **kwargs):
        return getattr(F, fn_name)(*args, **kwargs, **self._kw)

    forward.__doc__ = f"``F.{fn_name}({', '.join(inputs)}, ...)``."
    return type(name, (Layer,), {"__init__": __init__, "forward": forward,
                                 "__module__": __name__})


CTCLoss = _fn_loss("CTCLoss", "ctc_loss",
                   [("blank", 0), ("reduction", "mean")],
                   ["log_probs", "labels", "input_lengths", "label_lengths",
                    "norm_by_times=False"])
MarginRankingLoss = _fn_loss("MarginRankingLoss", "margin_ranking_loss",
                             [("margin", 0.0), ("reduction", "mean")],
                             ["input", "other", "label"])
TripletMarginLoss = _fn_loss(
    "TripletMarginLoss", "triplet_margin_loss",
    [("margin", 1.0), ("p", 2.0), ("epsilon", 1e-6), ("swap", False),
     ("reduction", "mean")], ["input", "positive", "negative"])
CosineEmbeddingLoss = _fn_loss("CosineEmbeddingLoss",
                               "cosine_embedding_loss",
                               [("margin", 0.0), ("reduction", "mean")],
                               ["input1", "input2", "label"])
HingeEmbeddingLoss = _fn_loss("HingeEmbeddingLoss", "hinge_embedding_loss",
                              [("margin", 1.0), ("reduction", "mean")],
                              ["input", "label"])
SoftMarginLoss = _fn_loss("SoftMarginLoss", "soft_margin_loss",
                          [("reduction", "mean")], ["input", "label"])
MultiLabelSoftMarginLoss = _fn_loss(
    "MultiLabelSoftMarginLoss", "multi_label_soft_margin_loss",
    [("weight", None), ("reduction", "mean")], ["input", "label"])
PoissonNLLLoss = _fn_loss(
    "PoissonNLLLoss", "poisson_nll_loss",
    [("log_input", True), ("full", False), ("epsilon", 1e-8),
     ("reduction", "mean")], ["input", "label"])
GaussianNLLLoss = _fn_loss(
    "GaussianNLLLoss", "gaussian_nll_loss",
    [("full", False), ("epsilon", 1e-6), ("reduction", "mean")],
    ["input", "label", "variance"])
