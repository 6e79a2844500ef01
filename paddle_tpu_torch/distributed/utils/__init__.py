"""MoE routing: counterpart of ``paddle_tpu/distributed/utils``."""
from .moe_utils import (  # noqa: F401
    dispatch_masks, ep_moe_local, fused_combine, fused_dispatch,
    global_gather, global_scatter, resolve_moe_impl, sort_dispatch,
)
