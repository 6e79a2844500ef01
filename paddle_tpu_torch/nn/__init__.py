"""Layers of the port.  Counterpart of ``paddle_tpu/nn`` for what the
Llama, BERT, vision (ResNet and the zoo) and diffusion paths and the
eager training loop use: ``Linear`` (weight ``[in, out]``, the paddle
layout, optional bias), ``Embedding``, ``Dropout`` (explicit
generator), ``RMSNorm``, ``LayerNorm``, ``GroupNorm``,
``InstanceNorm2D``, the transformer layers (``MultiHeadAttention`` with
its decode caches, ``TransformerEncoderLayer``, ``TransformerEncoder``,
``TransformerDecoderLayer``, ``TransformerDecoder``, ``Transformer``),
``Conv2D``, the pools, the batch norms, the activations ``Silu``,
``GELU``, ``Softmax``, ``ReLU6``, ``Hardswish``, ``Hardsigmoid`` and
``Swish``, ``Upsample``, gradient clipping (``ClipGradByValue``,
``ClipGradByNorm``, ``ClipGradByGlobalNorm``, ``clip_grad_norm_``), and
``ReLU``, ``Sequential``, ``LayerList`` and ``Identity`` (torch's own
``ReLU``, ``Sequential``, ``ModuleList`` and ``Identity``:
``Sequential`` and ``LayerList`` name their children ``0``, ``1``, ...
as ``paddle_tpu``'s do, so state dict keys such as
``layer1.0.downsample.0.weight`` and
``down_blocks.0.1.1.attn2.to_k.weight`` match)."""
from torch.nn import Identity, ReLU, Sequential  # noqa: F401
from torch.nn import ModuleList as LayerList  # noqa: F401

from .clip import (  # noqa: F401
    ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue, clip_grad_norm_,
)
from .common import (  # noqa: F401
    GELU, Dropout, Embedding, Hardsigmoid, Hardswish, Linear, ReLU6, Silu,
    Softmax, Swish, Upsample,
)
from .conv import Conv2D  # noqa: F401
from .norm import (  # noqa: F401
    BatchNorm, BatchNorm1D, BatchNorm2D, BatchNorm3D, GroupNorm,
    InstanceNorm2D, LayerNorm, RMSNorm, running_stats_frozen,
)
from .pooling import AdaptiveAvgPool2D, AvgPool2D, MaxPool2D  # noqa: F401
from .transformer import (  # noqa: F401
    MultiHeadAttention, Transformer, TransformerDecoder,
    TransformerDecoderLayer, TransformerEncoder, TransformerEncoderLayer,
)
