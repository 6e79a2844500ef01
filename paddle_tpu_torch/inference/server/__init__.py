"""Continuous-batching serving over the paged KV cache (PyTorch port of
``paddle_tpu.inference.server``: greedy serving with the prefix cache,
n-gram speculative decode and the double-buffered scheduler; the
write-ahead journal, and the fleet with its routing, failover and crash
recovery)."""
from .cluster import (  # noqa: F401
    DEAD_STATES, Replica, ReplicaSupervisor, Router, ServingCluster,
)
from .engine import ServingEngine  # noqa: F401
from .executor import PagedExecutor  # noqa: F401
from .metrics import EngineMetrics  # noqa: F401
from .prefix_cache import PrefixCache, check_pool_invariants  # noqa: F401
from .request import (  # noqa: F401
    Request, RequestHandle, RequestRejected, RequestState, TERMINAL,
)
from .scheduler import Scheduler, StepPlan  # noqa: F401
from .spec_decode import NGramProposer, SpecDecode, spec_mode  # noqa: F401
from .wal import (  # noqa: F401
    WriteAheadLog, compact, replay, stream_crc, wal_enabled,
)
