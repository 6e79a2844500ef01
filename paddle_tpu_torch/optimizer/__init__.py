"""Optimizers of the port.  Counterpart of ``paddle_tpu/optimizer``: the
base ``Optimizer`` with ``L1Decay`` / ``L2Decay`` (``optimizer``), the
core family (``optimizers``: SGD, Momentum, Adagrad, RMSProp, Adam,
AdamW, Lamb, LarsMomentum) and the LR schedulers (``lr``).  ``extra``'s
optimizers and ``LBFGS`` raise (ROADMAP.md Queue 1, item 9).
``models.CompiledTrainStep`` keeps its own fused AdamW for the compiled
train step."""
from . import lr  # noqa: F401
from .extra import ASGD, Adadelta, Adamax, NAdam, RAdam, Rprop  # noqa: F401
from .lbfgs import LBFGS  # noqa: F401
from .lr import (  # noqa: F401
    CosineAnnealingDecay, CosineAnnealingWarmRestarts, CyclicLR,
    ExponentialDecay, InverseTimeDecay, LambdaDecay, LinearLR, LinearWarmup,
    LRScheduler, MultiplicativeDecay, MultiStepDecay, NaturalExpDecay,
    NoamDecay, OneCycleLR, PiecewiseDecay, PolynomialDecay, ReduceOnPlateau,
    StepDecay,
)
from .optimizer import L1Decay, L2Decay, Optimizer  # noqa: F401
from .optimizers import (  # noqa: F401
    SGD, Adagrad, Adam, AdamW, Lamb, Lars, LarsMomentum, Momentum,
    RMSProp,
)
