"""paddle_tpu_torch — the PyTorch/CUDA port of ``paddle_tpu``.

A second package beside the JAX one, written for one NVIDIA H100.  Its
layout mirrors ``paddle_tpu`` so each module's counterpart is found by
path; inside, it is plain PyTorch: tensors on an explicit ``device``,
an explicit ``torch.Generator`` for every random draw, and every kernel
that ``paddle_tpu`` wrote in Pallas written again by hand for Hopper
(``csrc/``), built with ``nvcc`` on first use.

Covered so far: greedy Llama serving through the paged engine
(``inference.server.ServingEngine``), whose decode attention is the
hand-written CUDA kernel ``ops.kernels.paged_decode``, and its int8
mode (``quant="int8"``: ``ops.quant``, with the hand-written
``ops.kernels.quant_matmul`` and ``paged_decode_quant``); and Llama
training (``models.LlamaForCausalLM`` with ``models.CompiledTrainStep``,
AdamW), whose fused RMSNorm and causal attention, forward and backward,
are the hand-written CUDA kernels ``ops.kernels.rms_norm`` and
``ops.kernels.long_attention``; and BERT (``models.BertModel`` and its
QA, classification and MLM heads, on the ``nn`` transformer encoder),
fine-tuned through the same train step, whose attention for S <= 1024
(forward and backward, with ``paddle_tpu``'s hash dropout) is the
hand-written CUDA kernel ``ops.kernels.short_attention``.

Importing the package is light: it pulls in neither ``triton`` nor the
kernel build, and never ``jax`` or ``paddle_tpu``.
"""
from __future__ import annotations

__version__ = "0.1.0"

from .device import resolve_device  # noqa: F401
