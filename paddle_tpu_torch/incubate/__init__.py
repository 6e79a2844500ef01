"""Counterpart of ``paddle_tpu/incubate``: the MoE layer
(``incubate.distributed.models.moe``)."""
