"""Training-loop robustness (the guardian).  Counterpart of
``paddle_tpu/training``.

``TrainingGuardian`` watches per-step training health (NaN/Inf loss,
NaN/Inf global grad norm, loss spikes against a rolling median+MAD
window) and enforces an escalation policy: skip-step, then automatic
rollback to the last committed checkpoint, then abort with a
diagnostic bundle.  ``GuardedTrainStep`` wraps
``models.training.CompiledTrainStep`` under that policy.
"""
from .guardian import (  # noqa: F401
    Decision, GuardedTrainStep, GuardianAbort, GuardianPolicy,
    TrainingGuardian,
)
