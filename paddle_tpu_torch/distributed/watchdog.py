"""Comm watchdog — hang detection with diagnosis for rendezvous and
collective operations.  Counterpart of
``paddle_tpu/distributed/watchdog.py``.

Reference: ``paddle/phi/core/distributed/comm_task_manager.h:37``
(``CommTaskManager``: an async watchdog thread that stamps each comm
task, detects ``IsTimeout()`` and aborts with a diagnostic instead of
hanging forever) and the store-based barrier diagnostics.

In the port, as in the reference, what can hang is the host-side
control plane: a process-group rendezvous waiting for a rank that never
arrives, a barrier, a checkpoint's commit barrier.
``CommWatchdog.task(...)`` wraps those blocking host calls: a timer
thread fires after ``timeout`` seconds (``PADDLE_COMM_TIMEOUT``, default
300), prints a diagnosis and aborts the process (the reference
behavior), or records the event when ``abort=False`` (tests).  The
per-rank roll call from the launcher's KV store waits for the launcher
(ROADMAP.md Queue 1, item 8); without it the diagnosis names the
expected world size only.
"""
from __future__ import annotations

import os
import sys
import threading
import time


class CommWatchdog:
    """Watchdog over blocking host-side comm operations."""

    def __init__(self, timeout=None, abort=True, world_size=None,
                 rank=None):
        if timeout is None:
            timeout = float(os.environ.get("PADDLE_COMM_TIMEOUT", "300"))
        self.timeout = float(timeout)
        self.abort = abort
        self.world_size = world_size
        self.rank = rank
        self.fired = []  # (desc, diagnosis) records when abort=False

    # -- evidence gathering --------------------------------------------------
    def _registered_ranks(self):
        """NODE ranks visible in the launch rendezvous scope, or None.

        The roll call reads the launcher's KV store
        (``launch.master.KVClient``), which the port does not have yet
        (ROADMAP.md Queue 1, item 8).  So it returns None, as the
        reference's does whenever no store is reachable: a failed probe
        must not masquerade as an empty roll call, which would report
        every rank, this one included, missing."""
        return None

    def diagnose(self, desc, waited):
        world = self.world_size
        if world is None:
            world = int(os.environ.get("PADDLE_TRAINERS_NUM", "0")) or None
        rank = self.rank
        if rank is None:
            rank = os.environ.get("PADDLE_TRAINER_ID", "?")
        present = self._registered_ranks()
        # The KV store registers NODE ranks (one entry per launch
        # invocation) — roll-call against nnodes, not the trainer world
        # (with nproc_per_node > 1 they differ and comparing trainer
        # ranks against node registrations would mark healthy trainers
        # missing).
        nnodes = int(os.environ.get("PADDLE_NNODES", "0")) or world
        lines = [
            f"[comm-watchdog] '{desc}' exceeded {self.timeout:.0f}s "
            f"(waited {waited:.0f}s) on rank {rank}"]
        if present is not None and nnodes:
            missing = [r for r in range(nnodes) if r not in present]
            lines.append(
                f"[comm-watchdog] registered node ranks: {present} / "
                f"nnodes {nnodes}; MISSING: {missing or 'none'}")
            if missing:
                lines.append(
                    "[comm-watchdog] likely cause: the missing node(s) "
                    "never started, crashed before rendezvous, or cannot "
                    "reach the master — check their worker logs")
        elif world:
            lines.append(
                f"[comm-watchdog] expected world size {world}; no "
                "rendezvous store reachable for a per-rank roll call")
        return "\n".join(lines)

    # -- the guard -----------------------------------------------------------
    def task(self, desc):
        """Context manager guarding one blocking operation."""
        return _Task(self, desc)


class _Task:
    def __init__(self, wd, desc):
        self.wd = wd
        self.desc = desc
        self._done = threading.Event()
        self._t0 = None

    def __enter__(self):
        self._t0 = time.time()
        self._thread = threading.Thread(target=self._watch, daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._done.set()
        return False

    def _watch(self):
        if self._done.wait(self.wd.timeout):
            return
        waited = time.time() - self._t0
        diag = self.wd.diagnose(self.desc, waited)
        print(diag, file=sys.stderr, flush=True)
        if self.wd.abort:
            # The blocked call sits in C code and cannot be interrupted
            # from Python — abort the process like the reference's
            # CommTaskManager (comm_task_manager.h watchdog abort).
            os._exit(124)
        self.wd.fired.append((self.desc, diag))
