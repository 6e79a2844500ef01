"""Analytic cost model.  Counterpart of ``paddle_tpu/analysis/cost.py``
``transformer_flops_per_token``, the MFU convention of the repo's
training benchmarks."""
from __future__ import annotations


def transformer_flops_per_token(num_params, num_layers, hidden_size,
                                seq_len):
    """Megatron-style forward + backward FLOPs per token: ``6·N`` for the
    parameter GEMMs plus ``12·L·h·S`` for the attention score and value
    products.  Remat's extra forward is overhead, not counted as useful
    work."""
    return (6 * int(num_params)
            + 12 * int(num_layers) * int(hidden_size) * int(seq_len))
