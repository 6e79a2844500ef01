"""paddle.regularizer (counterpart of ``paddle_tpu/regularizer.py``):
``L1Decay`` / ``L2Decay``, taken by the optimizers' ``weight_decay``
argument and applied inside the update (``optimizer/optimizer.py``)."""
from .optimizer import L1Decay, L2Decay  # noqa: F401

__all__ = ["L1Decay", "L2Decay"]
