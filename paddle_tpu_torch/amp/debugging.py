"""Numeric debugging: the tensor checker and the operator statistics.

Counterpart of ``paddle_tpu/amp/debugging.py`` (reference
``python/paddle/amp/debugging.py``: ``TensorCheckerConfig``,
``enable_operator_stats_collection``, ``collect_operator_stats``).  Both
hook the op registry's dispatch wrapper (``ops/registry.py``), the one
funnel every named op and every torch function between them runs
through: the checker there checks each op's floating outputs for NaN
or Inf (skipped inside a CUDA graph capture), and the statistics count
one entry per dispatched op and output tensor, keyed by (op, output
dtype), none for an op run inside another op's body.
"""
from __future__ import annotations

import contextlib
from enum import Enum

from ..core import flags
from ..ops import registry as _registry
from . import state as _state


class DebugMode(Enum):
    CHECK_NAN_INF_AND_ABORT = 0
    CHECK_NAN_INF = 1
    CHECK_ALL = 2  # log every op's output stats


class TensorCheckerConfig:
    """enable + per-op include/skip lists + abort-vs-log behavior."""

    def __init__(self, enable, debug_mode=DebugMode.CHECK_NAN_INF_AND_ABORT,
                 output_dir=None, checked_op_list=None,
                 skipped_op_list=None, debug_step=None,
                 stack_height_limit=1):
        self.enable = enable
        self.debug_mode = debug_mode
        self.output_dir = output_dir
        self.checked_op_list = set(checked_op_list or [])
        self.skipped_op_list = set(skipped_op_list or [])
        self.debug_step = debug_step
        self.stack_height_limit = stack_height_limit

    def _applies_to(self, op_name):
        if self.skipped_op_list and op_name in self.skipped_op_list:
            return False
        if self.checked_op_list:
            return op_name in self.checked_op_list
        return True


def enable_tensor_checker(checker_config: TensorCheckerConfig):
    """Turn on per-op NaN/Inf checking per the config."""
    if not checker_config.enable:
        return
    _registry._CHECKER_CFG = checker_config
    level = 0 if checker_config.debug_mode == \
        DebugMode.CHECK_NAN_INF_AND_ABORT else 1
    flags.set_flags({"FLAGS_check_nan_inf": True,
                     "FLAGS_check_nan_inf_level": level})


def disable_tensor_checker():
    _registry._CHECKER_CFG = None
    flags.set_flags({"FLAGS_check_nan_inf": False})


_collecting = {"on": False}


def enable_operator_stats_collection():
    """Start counting op calls by (op, output dtype)."""
    if not _collecting["on"]:
        _registry.acquire_mode()
        _collecting["on"] = True
    _state.amp_state().tally = {}


def disable_operator_stats_collection():
    """Stop counting; print the table and return it ({(op, dtype):
    calls}, or None when collection was off)."""
    st = _state.amp_state()
    stats, st.tally = st.tally, None
    if _collecting["on"]:
        _registry.release_mode()
        _collecting["on"] = False
    if stats is not None:
        _print_operator_stats(stats)
    return stats


@contextlib.contextmanager
def collect_operator_stats():
    enable_operator_stats_collection()
    try:
        yield
    finally:
        disable_operator_stats_collection()


def _print_operator_stats(stats):
    """Reference debugging.py table: op, dtype, count."""
    print("<------------------------------ op list "
          "------------------------------->")
    if not stats:
        print("(no ops collected)")
        return
    w = max(len(k[0]) for k in stats) + 2
    print(f"{'op':<{w}}{'dtype':<12}{'calls':>8}")
    for (op, dt), n in sorted(stats.items()):
        print(f"{op:<{w}}{dt:<12}{n:>8}")
    print("<----------------------------------- end "
          "---------------------------------->")
