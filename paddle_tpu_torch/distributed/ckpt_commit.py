"""Crash-safe checkpoint commit protocol — ``CheckpointManager``.
Counterpart of ``paddle_tpu/distributed/ckpt_commit.py``.

Reference: the fleet elastic/restart loop (``fleet/elastic/manager.py``)
and the dist-checkpoint coordinator assume a *committed-or-absent*
invariant: after any kill, a checkpoint directory either holds a
complete step or does not exist.  Layout under ``root``::

    step-12/COMMIT        committed — loaders may use it
    step-12/...           shard .npy files + *.metadata.json + rank done
    step-13.tmp/          in-flight (or torn by a kill) — ignored
    step-13/              renamed but no COMMIT yet — ignored

Protocol per save of step N:

1. every rank writes its shards + metadata into ``step-N.tmp/``
   (``save_state_dict`` — fsync'd writes, fault-point instrumented);
2. each rank drops a ``rank-K.done`` marker (fsync'd);
3. the coordinator rank waits for all ``world_size`` markers — the wait
   runs under ``CommWatchdog.task`` so a rank that never finishes
   produces a named diagnosis, not a silent hang;
4. the coordinator atomically renames ``step-N.tmp`` → ``step-N`` and
   then writes the ``COMMIT`` sentinel (tmp file + fsync +
   ``os.replace``), fsyncing the parent dir.

A kill at ANY instant therefore leaves either ``step-N.tmp`` (ignored),
``step-N`` without ``COMMIT`` (ignored), or a fully committed step —
loaders always see the previous committed step, never a torn one.

Extras: async save on a non-daemon thread whose handle re-raises worker
errors; an overlap guard (a new save first joins the in-flight one);
keep-last-k retention pruned only *after* a successful commit; and a
SIGTERM preemption hook that finishes the in-flight save, writes a
final checkpoint, and exits cleanly (the elastic manager's
grace-period contract).
"""
from __future__ import annotations

import os
import re
import shutil
import signal
import sys
import time

from ..testing import faults
from .checkpoint import AsyncSaveHandle, _prepare_save, load_state_dict
from .watchdog import CommWatchdog

COMMIT_FILE = "COMMIT"
_STEP_RE = re.compile(r"^step-(\d+)$")
_TMP_RE = re.compile(r"^step-(\d+)\.tmp$")


def _fsync_dir(path):
    """Best-effort directory fsync (rename durability on real FS)."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _write_file_atomic(path, text):
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        f.write(text)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def is_committed(step_dir):
    return os.path.isfile(os.path.join(step_dir, COMMIT_FILE))


def committed_steps(root):
    """Sorted step numbers with a COMMIT sentinel under ``root``."""
    if not os.path.isdir(root):
        return []
    out = []
    for name in os.listdir(root):
        m = _STEP_RE.match(name)
        if m and is_committed(os.path.join(root, name)):
            out.append(int(m.group(1)))
    return sorted(out)


def latest_step(root):
    steps = committed_steps(root)
    return steps[-1] if steps else None


class _DoneHandle:
    """Handle for a save that already completed synchronously."""

    def __init__(self, exc=None):
        self._exc = exc

    def done(self):
        return True

    def is_alive(self):
        return False

    def result(self, timeout=None):
        if self._exc is not None:
            raise self._exc

    join = result


class CheckpointManager:
    """Commit-protocol checkpoint saves/loads under one root directory.

    Parameters
    ----------
    root : str
        Directory holding ``step-N/`` checkpoints.
    keep_last_k : int or None
        Committed steps retained after each successful commit (None =
        keep everything).
    world_size / rank / coordinator_rank :
        Commit-barrier membership; ``world_size`` defaults to 1 and
        ``rank`` to 0 (one process: the multi-rank launcher is ROADMAP.md
        Queue 1, item 8).
    barrier_timeout : float
        Seconds the coordinator waits for all ``rank-K.done`` markers.
    watchdog : CommWatchdog, optional
        Injected guard for the commit barrier (tests); by default a
        non-aborting watchdog with ``barrier_timeout`` is used — the
        barrier itself raises with the missing ranks named.
    aot_warmup : callable, optional
        Run after every :meth:`load` (a failure in it is swallowed).
        Without it nothing runs: the reference then sweeps its registered
        programs (``analysis.aot_warmup``), which the port does not have
        (ROADMAP.md Queue 1, item 9).  The port's captured graphs read the
        state at fixed addresses, which a load fills in place, so they
        stay valid; a program not captured yet is captured lazily at its
        first call.
    """

    def __init__(self, root, keep_last_k=3, world_size=None, rank=None,
                 coordinator_rank=0, barrier_timeout=300.0,
                 watchdog=None, aot_warmup=None):
        self.root = root
        self.keep_last_k = keep_last_k
        self.world_size = world_size if world_size is not None else 1
        self.rank = rank if rank is not None else 0
        self.coordinator_rank = coordinator_rank
        self.barrier_timeout = float(barrier_timeout)
        self._watchdog = watchdog
        self._inflight = None
        self._prev_sigterm = None
        self._aot_warmup = aot_warmup
        os.makedirs(root, exist_ok=True)

    # -- paths ---------------------------------------------------------------
    def step_dir(self, step):
        return os.path.join(self.root, f"step-{step}")

    def _tmp_dir(self, step):
        return os.path.join(self.root, f"step-{step}.tmp")

    def committed_steps(self):
        return committed_steps(self.root)

    def latest_step(self):
        return latest_step(self.root)

    # -- save ----------------------------------------------------------------
    def save(self, state_dict, step, async_save=False):
        """Save ``state_dict`` as step ``step`` under the commit
        protocol.  Returns a handle; ``.result()`` re-raises any worker
        failure.  A save of an already-committed step is a no-op."""
        self.wait()  # overlap guard: join (and surface) the in-flight save
        if is_committed(self.step_dir(step)):
            return _DoneHandle()
        tmp = self._tmp_dir(step)
        # Leftovers from a torn prior attempt: remove only THIS rank's
        # files.  A blanket rmtree would race a multi-rank save — a
        # late-arriving rank would delete shard files and done markers
        # faster ranks already wrote into the shared tmp, and the commit
        # could then reference deleted shards.
        self._clear_rank_files(tmp)
        # The state is snapshotted here, synchronously — an async save
        # cannot mix in parameter values from later training steps.
        write = _prepare_save(state_dict, tmp, rank=self.rank)

        def _job():
            write()
            done = os.path.join(tmp, f"rank-{self.rank}.done")
            _write_file_atomic(done, "1")
            if self.rank == self.coordinator_rank:
                self._commit(step)

        if async_save:
            handle = AsyncSaveHandle(_job)
            self._inflight = handle
            return handle
        _job()
        return _DoneHandle()

    def _clear_rank_files(self, tmp):
        """Delete this rank's files under a leftover ``tmp`` — done
        marker first, so the coordinator can never count a stale marker
        while the shard files behind it are being replaced."""
        if not os.path.isdir(tmp):
            return
        done = f"rank-{self.rank}.done"
        names = os.listdir(tmp)
        mine = [n for n in names if n.startswith(done)]
        mine += [n for n in names
                 if n == f"{self.rank}.metadata.json"
                 or n.endswith(f".r{self.rank}.npy")]
        for name in mine:
            try:
                os.remove(os.path.join(tmp, name))
            except OSError:
                pass

    def wait(self):
        """Join the in-flight async save, re-raising its error."""
        handle, self._inflight = self._inflight, None
        if handle is not None:
            handle.result()

    def _wait_done_markers(self, tmp, step):
        deadline = time.time() + self.barrier_timeout
        need = {f"rank-{r}.done" for r in range(self.world_size)}
        while True:
            have = {n for n in need
                    if os.path.isfile(os.path.join(tmp, n))}
            if have == need:
                return
            if time.time() >= deadline:
                missing = sorted(
                    int(n.split("-")[1].split(".")[0])
                    for n in need - have)
                raise RuntimeError(
                    f"checkpoint commit barrier for step {step} timed "
                    f"out after {self.barrier_timeout:.0f}s; ranks "
                    f"missing done markers: {missing}")
            time.sleep(0.01)

    def _commit(self, step):
        tmp = self._tmp_dir(step)
        wd = self._watchdog or CommWatchdog(
            timeout=self.barrier_timeout, abort=False,
            world_size=self.world_size, rank=self.rank)
        with wd.task(f"ckpt commit barrier step-{step}"):
            self._wait_done_markers(tmp, step)
        final = self.step_dir(step)
        # A stale UNcommitted final dir (kill between rename and COMMIT
        # on a previous life) would block the rename; it holds nothing a
        # loader may use, so clear it.
        if os.path.isdir(final) and not is_committed(final):
            shutil.rmtree(final)
        faults.fire("ckpt.commit", "before", path=tmp)
        os.rename(tmp, final)
        _fsync_dir(self.root)
        # Between the rename and the sentinel the dir exists but is
        # still invisible to loaders — exactly what the "after" fault
        # phase exercises.
        faults.fire("ckpt.commit", "after", path=final)
        _write_file_atomic(os.path.join(final, COMMIT_FILE), str(step))
        _fsync_dir(final)
        self._prune(step)

    def _prune(self, just_committed):
        keep = self.keep_last_k
        steps = committed_steps(self.root)
        if keep is not None and keep > 0:
            for s in steps[:-keep]:
                shutil.rmtree(self.step_dir(s), ignore_errors=True)
        # Garbage from dead attempts: torn tmp dirs and uncommitted
        # step dirs OLDER than the step just committed (the current
        # in-flight tmp, if any, has a larger step number).
        for name in os.listdir(self.root):
            full = os.path.join(self.root, name)
            m = _TMP_RE.match(name)
            if m and int(m.group(1)) <= just_committed:
                shutil.rmtree(full, ignore_errors=True)
                continue
            m = _STEP_RE.match(name)
            if m and int(m.group(1)) < just_committed \
                    and not is_committed(full):
                shutil.rmtree(full, ignore_errors=True)

    # -- load ----------------------------------------------------------------
    def load(self, state_dict, step=None):
        """Fill ``state_dict`` from a COMMITTED step (latest by
        default).  Directories without the sentinel are never selected.
        Returns the step loaded."""
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(
                    f"no committed checkpoint under {self.root}")
        d = self.step_dir(step)
        if not is_committed(d):
            raise FileNotFoundError(
                f"step {step} under {self.root} is not committed")
        load_state_dict(state_dict, d)
        try:
            if self._aot_warmup is not None:
                self._aot_warmup()
        except Exception:
            # warmup is an optimization: a failing hook must never turn
            # a good restore into a failed one
            pass
        return step

    # -- preemption ----------------------------------------------------------
    def install_preemption_hook(self, state_fn, step_fn,
                                signum=signal.SIGTERM, exit_code=0):
        """On ``signum`` (default SIGTERM — the preemption notice):
        finish the in-flight async save, write a final checkpoint from
        ``state_fn()`` at step ``step_fn()``, and exit cleanly.

        Must be called from the main thread (signal delivery rule).
        Returns an ``uninstall()`` callable restoring the previous
        handler.
        """

        def _handler(sig, frame):
            try:
                try:
                    self.wait()
                except Exception as e:  # in-flight save died; still
                    print(f"[ckpt] in-flight save failed during "
                          f"preemption: {e}", file=sys.stderr)
                step = step_fn()
                if not is_committed(self.step_dir(step)):
                    self.save(state_fn(), step)
                print(f"[ckpt] preemption: committed final checkpoint "
                      f"step-{step}", file=sys.stderr, flush=True)
            finally:
                if exit_code is not None:
                    sys.exit(exit_code)

        self._prev_sigterm = signal.signal(signum, _handler)

        def uninstall():
            signal.signal(signum, self._prev_sigterm
                          if self._prev_sigterm is not None
                          else signal.SIG_DFL)

        return uninstall
