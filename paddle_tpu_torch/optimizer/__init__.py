"""Optimizer pieces of the port: the LR schedulers (``optimizer.lr``).
The AdamW update itself lives in ``models.training.CompiledTrainStep``."""
from . import lr  # noqa: F401
from .lr import (  # noqa: F401
    CosineAnnealingDecay, CosineAnnealingWarmRestarts, CyclicLR,
    ExponentialDecay, InverseTimeDecay, LambdaDecay, LinearLR, LinearWarmup,
    LRScheduler, MultiplicativeDecay, MultiStepDecay, NaturalExpDecay,
    NoamDecay, OneCycleLR, PiecewiseDecay, PolynomialDecay, ReduceOnPlateau,
    StepDecay,
)
