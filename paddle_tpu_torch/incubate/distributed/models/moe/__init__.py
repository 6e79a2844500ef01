"""The MoE layer and its gates (counterpart of ``paddle_tpu/incubate/
distributed/models/moe``)."""
from .gate import BaseGate, GShardGate, NaiveGate, SwitchGate  # noqa: F401
from .moe_layer import ExpertFFN, MoELayer  # noqa: F401
