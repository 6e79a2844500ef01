"""The fused functional ops (counterpart of
``paddle_tpu/incubate/nn/functional``).  ``fused_rms_norm`` is
``nn.functional.rms_norm``: under ``FLAGS_use_fused_rms_norm`` it takes
the fused RMSNorm kernel (``ops/kernels/rms_norm.py``) for any hidden
size and for fp32, bf16 and fp16 x, as the reference sends any of them
to its kernel."""
from ....nn.functional import rms_norm as fused_rms_norm  # noqa: F401
from ....nn.functional import (  # noqa: F401
    fused_rotary_position_embedding,
)
from ....ops import swiglu  # noqa: F401


def fused_linear(x, weight, bias=None, transpose_weight=False, name=None):
    from .... import ops

    out = ops.matmul(x, weight, transpose_y=transpose_weight)
    if bias is not None:
        out = ops.add(out, bias)
    return out


def fused_bias_act(x, bias=None, act_method="gelu", name=None, **kwargs):
    from .... import ops

    if bias is not None:
        x = ops.add(x, bias)
    return getattr(ops, act_method)(x)
