"""Continuous-batching serving over the paged KV cache (PyTorch port of
``paddle_tpu.inference.server``, synchronous greedy path)."""
from .engine import ServingEngine  # noqa: F401
from .executor import PagedExecutor  # noqa: F401
from .metrics import EngineMetrics  # noqa: F401
from .request import Request, RequestHandle, RequestState  # noqa: F401
from .scheduler import Scheduler  # noqa: F401
