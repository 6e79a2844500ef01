"""Ops of the port: plain PyTorch versions (``nn_ops``, ``manipulation``),
int8 quantization (``quant``) and the hand-written kernels
(``kernels``)."""
from .kernels.grouped_gemm import grouped_ffn  # noqa: F401
