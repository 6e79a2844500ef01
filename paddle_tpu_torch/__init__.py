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
hand-written CUDA kernel ``ops.kernels.short_attention``; and the MoE
block (``incubate.distributed.models.moe.MoELayer`` with its gates, and
``distributed.utils.moe_utils`` with the sort dispatch and the
single-device ``ep_moe_local`` body), trained through the same step and
run forward with int8 experts, whose grouped expert FFN
(``ops.grouped_ffn``) is the hand-written CUDA kernel
``ops.kernels.grouped_gemm``, for dense and for int8 expert weights;
and the conv/BN vision path (``vision.models``: the ResNet family, over
``nn.Conv2D``, the pools and the batch norms), trained through the same
step with the batch norms' running statistics left as they were, as in
``paddle_tpu``'s compiled step.  No Pallas kernel lies on that path: the
convolution is cuDNN's (fp32 held to fp32, TF32 off), batch norm and the
cross entropy are ``torch.autograd.Function`` s with the reference's
rounding points and hand-written backward; and the SD v1.5 diffusion
UNet (``models.UNet2DConditionModel`` over ``nn.GroupNorm``,
``nn.functional.interpolate``, ``nn.Silu``, ``nn.GELU`` and
``nn.LayerList``), trained through the same step.  No Pallas kernel
lies on that path either: GroupNorm, the resize and the attention (an
einsum, a softmax, an einsum) are plain PyTorch, the convs cuDNN's, and
under ``compute_dtype="bfloat16"`` the step computes in fp32 over
bf16-rounded weights, as ``paddle_tpu``'s does.

Importing the package is light: it pulls in neither ``triton`` nor the
kernel build, and never ``jax`` or ``paddle_tpu``.
"""
from __future__ import annotations

__version__ = "0.1.0"

from .device import resolve_device  # noqa: F401
