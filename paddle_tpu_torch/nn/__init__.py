"""Layers of the port.  Counterpart of ``paddle_tpu/nn`` for what the
Llama training path uses: ``Linear`` (weight ``[in, out]``, the paddle
layout), ``Embedding`` and ``RMSNorm``."""
from .common import Embedding, Linear  # noqa: F401
from .norm import RMSNorm  # noqa: F401
