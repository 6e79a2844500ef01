"""``ParamAttr``: per-parameter settings (name, initializer,
learning-rate multiplier, regularizer, trainable, need_clip).
Counterpart of ``paddle_tpu/nn/param_attr.py``;
``Layer.create_parameter`` reads it."""
from __future__ import annotations


class ParamAttr:
    def __init__(self, name=None, initializer=None, learning_rate=1.0,
                 regularizer=None, trainable=True, do_model_average=True,
                 need_clip=True):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.do_model_average = do_model_average
        self.need_clip = need_clip

    @staticmethod
    def _to_attr(attr):
        """``None`` and ``False`` (no parameter) pass through; a string is
        a name, an ``Initializer`` an initializer."""
        if attr is None or attr is False or isinstance(attr, ParamAttr):
            return attr
        if isinstance(attr, str):
            return ParamAttr(name=attr)
        from .initializer import Initializer

        if isinstance(attr, Initializer):
            return ParamAttr(initializer=attr)
        raise TypeError(f"Cannot convert {attr!r} to ParamAttr")
