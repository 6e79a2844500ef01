"""Layers of the port.  Counterpart of ``paddle_tpu/nn`` for what the
Llama, BERT and vision training paths use: ``Linear`` (weight ``[in,
out]``, the paddle layout, optional bias), ``Embedding``, ``Dropout``
(explicit generator), ``RMSNorm``, ``LayerNorm``, the transformer encoder
(``MultiHeadAttention``, ``TransformerEncoderLayer``,
``TransformerEncoder``), ``Conv2D``, the pools, the batch norms, and
``ReLU``, ``Sequential`` and ``Identity`` (torch's own: ``Sequential``
names its children ``0``, ``1``, ... as ``paddle_tpu``'s does, so state
dict keys such as ``layer1.0.downsample.0.weight`` match)."""
from torch.nn import Identity, ReLU, Sequential  # noqa: F401

from .common import Dropout, Embedding, Linear  # noqa: F401
from .conv import Conv2D  # noqa: F401
from .norm import (  # noqa: F401
    BatchNorm, BatchNorm1D, BatchNorm2D, BatchNorm3D, LayerNorm, RMSNorm,
    running_stats_frozen,
)
from .pooling import AdaptiveAvgPool2D, AvgPool2D, MaxPool2D  # noqa: F401
from .transformer import (  # noqa: F401
    MultiHeadAttention, TransformerEncoder, TransformerEncoderLayer,
)
