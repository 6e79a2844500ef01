"""Layer-stacking helper shared by the serving executor and the weight
converter.  Counterpart of ``paddle_tpu/models/generation.py``
``_stack_layer_params``."""
from __future__ import annotations

import torch

from .llama import LAYER_WEIGHTS


def stack_layer_params(state: dict, n_layers: int,
                       prefix="llama.layers") -> dict:
    """{name: [L, ...] tensor} from a flat state dict whose per-layer
    entries are keyed ``{prefix}.{i}.{name}`` and hold tensors."""
    return {n: torch.stack([state[f"{prefix}.{i}.{n}"]
                            for i in range(n_layers)])
            for n in LAYER_WEIGHTS}
