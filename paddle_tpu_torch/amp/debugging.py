"""Numeric debugging (``paddle_tpu/amp/debugging.py``): the tensor
checker and the operator statistics hook the reference's op registry,
which the port does not have yet (ROADMAP.md Queue 1, item 9).  Every
entry point raises; ``amp.state.op_dtypes`` tallies the (op, dtype)
pairs the AMP policy sees, for tests."""
from __future__ import annotations

_WHY = ("amp.debugging needs the op registry, which is not ported yet "
        "(ROADMAP.md Queue 1, item 9)")


def _missing(*args, **kwargs):
    raise NotImplementedError(_WHY)


class TensorCheckerConfig:
    def __init__(self, *args, **kwargs):
        _missing()


enable_tensor_checker = disable_tensor_checker = _missing
enable_operator_stats_collection = _missing
disable_operator_stats_collection = collect_operator_stats = _missing
