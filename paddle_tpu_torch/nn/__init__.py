"""Layers of the port.  Counterpart of ``paddle_tpu/nn`` for what the
Llama and BERT training paths use: ``Linear`` (weight ``[in, out]``, the
paddle layout, optional bias), ``Embedding``, ``Dropout`` (explicit
generator), ``RMSNorm``, ``LayerNorm`` and the transformer encoder
(``MultiHeadAttention``, ``TransformerEncoderLayer``,
``TransformerEncoder``)."""
from .common import Dropout, Embedding, Linear  # noqa: F401
from .norm import LayerNorm, RMSNorm  # noqa: F401
from .transformer import (  # noqa: F401
    MultiHeadAttention, TransformerEncoder, TransformerEncoderLayer,
)
