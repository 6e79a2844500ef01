"""The telemetry gate, ``PT_OBS={off,on}``: the off path only.

Counterpart of the gate in ``paddle_tpu/obs/__init__.py``.  The
producers that the reference instruments (the journal, the fleet and
the scheduler) ask :func:`handle` once, at construction, so a run under
``PT_OBS=on`` fails at build instead of running without the telemetry it
asked for.  The telemetry plane itself (the metric registry, the trace
spans, the flight recorder, the event log and the health plane) and the
producers' spans and counters are not ported: ``PT_OBS=on`` and
``configure("on")`` raise ``NotImplementedError``, and a value other
than off/on raises ``ValueError``.
"""
from __future__ import annotations

import os
import threading

__all__ = ["configure", "enabled", "handle", "reset"]

_MODES = ("off", "on")
_TODO = ("PT_OBS=on: the telemetry plane is not ported yet "
         "(ROADMAP.md Queue 1, item 9); only PT_OBS=off runs")

_lock = threading.Lock()
_initialized = False  # PT_OBS read yet?


def _env_mode():
    mode = os.environ.get("PT_OBS", "off").lower()
    if mode not in _MODES:
        raise ValueError(f"PT_OBS={mode!r}: expected off|on")
    return mode


def handle():
    """The live telemetry bundle, or ``None`` when telemetry is off —
    the single branch every producer pays on the off path.  Under
    ``PT_OBS=on`` it raises: the bundle is not ported."""
    global _initialized
    if not _initialized:
        with _lock:
            if not _initialized:
                if _env_mode() == "on":
                    raise NotImplementedError(_TODO)
                _initialized = True
    return None


def enabled():
    return handle() is not None


def configure(mode="on", **_kw):
    """Programmatic gate: ``"off"`` returns None, ``"on"`` raises."""
    global _initialized
    if mode not in _MODES:
        raise ValueError(f"obs.configure mode={mode!r}: expected off|on")
    if mode == "on":
        raise NotImplementedError(_TODO)
    with _lock:
        _initialized = True
    return None


def reset():
    """Forget the gate; the next :func:`handle` re-reads ``PT_OBS``."""
    global _initialized
    with _lock:
        _initialized = False
