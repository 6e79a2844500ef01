"""Counterpart of ``paddle_tpu/distributed`` for one device: the MoE
routing utilities (``utils.moe_utils``).  Collectives, meshes and expert
parallelism over ``torch.distributed`` are not ported yet (ROADMAP.md
Queue 1)."""
