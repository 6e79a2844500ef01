"""Counterpart of ``paddle_tpu/distributed`` for one process: the MoE
routing utilities (``utils.moe_utils``), checkpoint files
(``checkpoint``: ``save_state_dict`` / ``load_state_dict``), the commit
protocol (``ckpt_commit.CheckpointManager``) and the comm watchdog
(``watchdog.CommWatchdog``).  Collectives, meshes, multi-rank
checkpoints and expert parallelism over ``torch.distributed`` are not
ported yet (ROADMAP.md Queue 1, item 8)."""
from .checkpoint import (  # noqa: F401
    ChecksumError, load_state_dict, save_state_dict,
)
