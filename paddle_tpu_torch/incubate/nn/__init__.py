"""Counterpart of ``paddle_tpu/incubate/nn``: the fused transformer
layers (``layer``) and the fused functional ops (``functional``)."""
from . import functional  # noqa: F401
from .layer import (  # noqa: F401
    FusedFeedForward, FusedMultiHeadAttention,
    FusedTransformerEncoderLayer,
)
