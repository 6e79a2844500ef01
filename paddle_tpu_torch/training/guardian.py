"""Training-loop guardian: anomaly detection, skip-step escalation, and
automatic rollback to the last committed checkpoint.  Counterpart of
``paddle_tpu/training/guardian.py``.

Reference analogs: ``amp/debugging.py``'s TensorCheckerConfig
(check-nan-inf-and-abort), GradScaler's found_inf skip-step, and the
elastic-training restart-from-known-good pattern (Varuna-style) — here
combined into one escalation ladder a train loop drives per step:

1. **Monitors** — loss NaN/Inf, global grad-norm NaN/Inf, and loss
   spike against a rolling median + MAD window.  On the compiled path
   the checks run on the device inside the train step
   (``CompiledTrainStep.guarded_step``): every write of the state is
   gated by ``torch.where`` on a device verdict, so a poisoned step
   never touches state and the loop pays no host sync beyond the loss
   fetch it already does.
2. **Skip-step** — an anomalous step is dropped with GradScaler
   found_inf semantics: parameters, optimizer moments, and the Adam
   step counter stay exactly as before the step.
3. **Rollback** — past the tolerated-anomaly budget the guardian
   restores model + optimizer state from the last COMMIT-sentinel
   checkpoint (``ckpt_commit.CheckpointManager`` + the shard-wise,
   checksum-verified loader) and resumes; each rollback *tightens* the
   skip budget exponentially (backoff on tolerance) so persistent
   trouble escalates faster.
4. **Abort** — past the rollback budget, :class:`GuardianAbort` is
   raised carrying a diagnostic bundle (step, recent loss window,
   offending monitor, rank), reported CommWatchdog.diagnose-style on
   stderr first.

Fault points ``guard.nan_loss`` / ``guard.nan_grad`` /
``guard.loss_spike`` (``PT_FAULTS``, action ``inject``) poison the
values inside the real monitoring path, so harness tests prove the
whole ladder end-to-end.

The port's train step keeps the reference's parameter names
(``models/convert.py``), so the flat checkpoint names
(``params/…``, ``master/…``, ``m/…``, ``v/…`` and ``t``) are the
reference's and either package rolls back from the other's commits.
The telemetry (the reference's counters and flight recorder; ROADMAP.md
Queue 1, item 9) is left out, and so is :func:`guardian_for_model`,
which needs ``hapi`` (item 9).
"""
from __future__ import annotations

import enum
import math
import sys
from collections import deque

import numpy as np
import torch


class Decision(enum.Enum):
    OK = "ok"
    SKIP = "skip"
    ROLLBACK = "rollback"


class GuardianAbort(RuntimeError):
    """Escalation exhausted: anomalies persisted past the rollback
    budget.  ``bundle`` holds the diagnostic evidence."""

    def __init__(self, message, bundle):
        super().__init__(message)
        self.bundle = bundle


class GuardianPolicy:
    """Escalation policy knobs.

    Parameters
    ----------
    window : int
        Rolling window of accepted losses for the spike monitor.
    min_history : int
        Accepted losses required before spike-checking starts (early
        training legitimately moves fast; the monitor stays open until
        the window has signal).
    spike_factor : float
        A loss is a spike when it exceeds
        ``median + spike_factor * max(1.4826 * MAD, floor)`` — the
        robust-z-score rule; ``floor`` guards the MAD collapsing to 0
        on a flat window (``spike_floor_frac * |median|``).
    spike_floor_frac : float
        Relative floor for the MAD scale (see above).
    skip_budget : int
        Consecutive anomalous steps tolerated via skip-step before the
        guardian escalates to rollback.
    budget_backoff : float
        Multiplier (<= 1.0) applied to the skip budget after every
        rollback — exponential backoff on the tolerated-anomaly budget,
        floor 1: persistent trouble escalates faster each round.
    rollback_budget : int
        Rollbacks allowed before the guardian aborts the run.
    checkpoint_every : int or None
        Auto-commit a checkpoint every N accepted steps (None = the
        caller commits manually via :meth:`TrainingGuardian.commit`).
    check_grad_norm : bool
        Whether the eager (hapi) path computes the global grad norm
        monitor (the compiled path always gets it in-graph for free).
    """

    def __init__(self, window=32, min_history=8, spike_factor=10.0,
                 spike_floor_frac=0.05, skip_budget=3,
                 budget_backoff=0.5, rollback_budget=2,
                 checkpoint_every=None, check_grad_norm=True):
        if window < 2 or min_history < 2:
            raise ValueError("window/min_history must be >= 2")
        if not (0.0 < budget_backoff <= 1.0):
            raise ValueError("budget_backoff must be in (0, 1]")
        self.window = int(window)
        self.min_history = int(min_history)
        self.spike_factor = float(spike_factor)
        self.spike_floor_frac = float(spike_floor_frac)
        self.skip_budget = int(skip_budget)
        self.budget_backoff = float(budget_backoff)
        self.rollback_budget = int(rollback_budget)
        self.checkpoint_every = checkpoint_every
        self.check_grad_norm = bool(check_grad_norm)


class TrainingGuardian:
    """Per-step anomaly state machine + rollback executor.

    Parameters
    ----------
    policy : GuardianPolicy
    manager : ckpt_commit.CheckpointManager, optional
        Rollback source/sink.  Without one the guardian can still
        skip-step but escalation past the skip budget aborts directly.
    state_fn : callable() -> {name: array}, optional
        Flat snapshot of everything a rollback must restore (model
        params + optimizer state).  Used both to SAVE (commit) and as
        the template the shard-wise loader fills on rollback.
    apply_fn : callable({name: array}), optional
        Writes a loaded flat state back into the live training objects.
    reseed_fn : callable(committed_step), optional
        Called after a rollback so the data pipeline can skip past the
        poisoned batch window (e.g. re-seed / fast-forward the
        iterator).
    rank : int, optional
        Reported in the diagnostic bundle; defaults to 0 (one process).
    """

    def __init__(self, policy=None, manager=None, state_fn=None,
                 apply_fn=None, reseed_fn=None, rank=None):
        self.policy = policy or GuardianPolicy()
        self.manager = manager
        self.state_fn = state_fn
        self.apply_fn = apply_fn
        self.reseed_fn = reseed_fn
        self._rank = rank
        self._window = deque(maxlen=self.policy.window)
        self._anomaly_run = 0         # consecutive anomalous steps
        self._skip_budget = self.policy.skip_budget
        self.rollbacks = 0
        self.skips = 0
        self.total_anomalies = 0
        self.steps_seen = 0
        self._accepted_since_commit = 0
        self.events = []  # (step, kind, detail) audit log

    # -- monitors ------------------------------------------------------------
    def spike_threshold(self):
        """Finite loss ceiling from the rolling median + MAD window, or
        ``inf`` while the window is still warming up.  This is the
        scalar the compiled path feeds into the in-graph gate — the
        whole spike monitor costs one f32 operand, no host sync."""
        if len(self._window) < self.policy.min_history:
            return float("inf")
        arr = np.asarray(self._window, np.float64)
        med = float(np.median(arr))
        mad = float(np.median(np.abs(arr - med)))
        scale = max(1.4826 * mad,
                    self.policy.spike_floor_frac * abs(med), 1e-12)
        return med + self.policy.spike_factor * scale

    def classify(self, loss, grad_norm=None, threshold=None):
        """Name the offending monitor for one step's observables, or
        None when the step is healthy.  ``threshold`` defaults to the
        current window's :meth:`spike_threshold` — pass the value that
        was actually used for an in-graph gate so host bookkeeping and
        device gating can never disagree."""
        if not math.isfinite(loss):
            return "nan_loss"
        if grad_norm is not None and not math.isfinite(grad_norm):
            return "nan_grad"
        if threshold is None:
            threshold = self.spike_threshold()
        if loss > threshold:
            return "loss_spike"
        return None

    # -- state machine -------------------------------------------------------
    def observe(self, loss, grad_norm=None, threshold=None, step=None):
        """Record one step's observables; returns the guardian's
        :class:`Decision`.  On ``ROLLBACK`` the caller (or
        :class:`GuardedTrainStep`) must invoke :meth:`rollback`.
        Raises :class:`GuardianAbort` when escalation is exhausted."""
        self.steps_seen += 1
        step = self.steps_seen if step is None else step
        monitor = self.classify(loss, grad_norm, threshold)
        if monitor is None:
            self._window.append(float(loss))
            self._anomaly_run = 0
            self._accepted_since_commit += 1
            return Decision.OK
        self.total_anomalies += 1
        self._anomaly_run += 1
        self.events.append((step, monitor, float(loss)))
        if self._anomaly_run <= self._skip_budget:
            self.skips += 1
            return Decision.SKIP
        if self.rollbacks >= self.policy.rollback_budget \
                or not self._can_rollback():
            self._abort(step, monitor, loss)
        return Decision.ROLLBACK

    def _can_rollback(self):
        return (self.manager is not None and self.state_fn is not None
                and self.apply_fn is not None
                and self.manager.latest_step() is not None)

    def rollback(self):
        """Restore model+optimizer state from the last committed
        checkpoint (shard-wise, checksum-verified load into a template
        from ``state_fn`` — a failed load leaves live state untouched),
        tighten the skip budget (exponential backoff on tolerance), and
        reset the anomaly run.  Returns the committed step restored."""
        template = self.state_fn()
        committed = self.manager.load(template)
        self.apply_fn(template)
        if self.reseed_fn is not None:
            self.reseed_fn(committed)
        self.rollbacks += 1
        self._skip_budget = max(
            1, int(self._skip_budget * self.policy.budget_backoff))
        self._anomaly_run = 0
        # The window predates the anomaly burst; after restoring to a
        # committed step those losses are the right baseline again.
        self.events.append((self.steps_seen, "rollback", committed))
        print(f"[guardian] rolled back to committed step {committed} "
              f"(rollback {self.rollbacks}/"
              f"{self.policy.rollback_budget}; skip budget now "
              f"{self._skip_budget})", file=sys.stderr, flush=True)
        return committed

    # -- checkpointing -------------------------------------------------------
    def commit(self, step):
        """Commit the current state as checkpoint ``step`` (no-op
        without a manager/state_fn)."""
        if self.manager is None or self.state_fn is None:
            return None
        handle = self.manager.save(self.state_fn(), step)
        self._accepted_since_commit = 0
        return handle

    def maybe_commit(self, step):
        """Auto-commit per ``policy.checkpoint_every`` accepted steps."""
        every = self.policy.checkpoint_every
        if every and self._accepted_since_commit >= every:
            return self.commit(step)
        return None

    # -- diagnostics ---------------------------------------------------------
    @property
    def rank(self):
        return 0 if self._rank is None else self._rank

    def diagnose(self, step, monitor, loss):
        """CommWatchdog.diagnose-style multi-line report."""
        window = [round(float(x), 6) for x in self._window]
        lines = [
            f"[guardian] training anomaly escalation exhausted at step "
            f"{step} on rank {self.rank}",
            f"[guardian] offending monitor: {monitor} "
            f"(loss {loss!r}, spike ceiling "
            f"{self.spike_threshold():.6g})",
            f"[guardian] budget: {self.skips} skip(s), "
            f"{self.rollbacks}/{self.policy.rollback_budget} "
            f"rollback(s) used",
            f"[guardian] recent accepted losses ({len(window)}): "
            f"{window}",
            f"[guardian] anomaly log (last 10): {self.events[-10:]}",
        ]
        return "\n".join(lines)

    def _abort(self, step, monitor, loss):
        diag = self.diagnose(step, monitor, loss)
        print(diag, file=sys.stderr, flush=True)
        bundle = {
            "step": step,
            "rank": self.rank,
            "monitor": monitor,
            "loss": float(loss) if loss == loss else float("nan"),
            "loss_window": [float(x) for x in self._window],
            "skips": self.skips,
            "rollbacks": self.rollbacks,
            "events": list(self.events),
        }
        raise GuardianAbort(diag, bundle)


# -- CompiledTrainStep bridge ------------------------------------------------

def _flatten_train_state(sd):
    """CompiledTrainStep.state_dict() -> flat {name: tensor} the
    checkpoint writer/loader understands.  The scalar Adam step counter
    rides along as a 0-d int64 entry."""
    flat = {}
    for tree in ("params", "master", "m", "v"):
        for k, v in sd.get(tree, {}).items():
            flat[f"{tree}/{k}"] = v
    flat["t"] = torch.tensor(int(sd["t"]), dtype=torch.int64)
    return flat


def _unflatten_train_state(flat):
    sd = {"params": {}, "master": {}, "m": {}, "v": {},
          "t": int(np.asarray(flat["t"]))}
    for name, v in flat.items():
        if name == "t":
            continue
        tree, k = name.split("/", 1)
        sd[tree][k] = v
    return sd


class GuardedTrainStep:
    """Drive a ``CompiledTrainStep`` under the guardian escalation
    policy.  ``step(*batch)`` behaves like the inner step's but the
    update is anomaly-gated in-graph, skip/rollback/abort happen
    automatically, and checkpoints commit on the policy cadence.

    ``step`` returns ``(loss, decision)`` — the raw (possibly
    anomalous) loss and the guardian's :class:`Decision` for it.
    """

    def __init__(self, inner, manager=None, policy=None,
                 reseed_fn=None, commit_initial=True, start_step=0):
        self.inner = inner
        self.guardian = TrainingGuardian(
            policy=policy, manager=manager,
            state_fn=lambda: _flatten_train_state(inner.state_dict()),
            apply_fn=lambda flat: inner.set_state_dict(
                _unflatten_train_state(flat)),
            reseed_fn=self._on_restore(reseed_fn),
        )
        self.global_step = int(start_step)
        if commit_initial and manager is not None \
                and manager.latest_step() is None:
            # Rollback must always have a committed source, even before
            # the first cadence commit.
            self.guardian.commit(self.global_step)

    def _on_restore(self, reseed_fn):
        def _hook(committed_step):
            # Training resumes from the committed step's state; the
            # host step counter follows so cadence commits stay aligned.
            self.global_step = int(committed_step)
            if reseed_fn is not None:
                reseed_fn(committed_step)
        return _hook

    def step(self, *batch):
        g = self.guardian
        # Round to f32 so the host's spike comparison and the in-graph
        # f32 gate see bit-identical ceilings and can never disagree.
        threshold = float(np.float32(g.spike_threshold()))
        loss, gnorm, ok = self.inner.guarded_step(threshold, *batch)
        decision = g.observe(loss, gnorm, threshold=threshold,
                             step=self.global_step + 1)
        # The in-graph gate and the host state machine must agree on
        # every skip: a gate-passed step the guardian flags (or vice
        # versa) would desync optimizer state from the escalation
        # ledger.
        assert ok == (decision is Decision.OK), (ok, decision)
        if decision is Decision.OK:
            self.global_step += 1
            g.maybe_commit(self.global_step)
        elif decision is Decision.ROLLBACK:
            g.rollback()  # resets self.global_step via the restore hook
        return loss, decision

    def commit(self, step=None):
        return self.guardian.commit(
            self.global_step if step is None else step)


# -- hapi (eager) bridge -----------------------------------------------------

def guardian_for_model(model, manager, policy=None, reseed_fn=None):
    """A :class:`TrainingGuardian` over a ``hapi.Model``'s network and
    optimizer (the eager fit path).  The port has no ``hapi`` yet."""
    raise NotImplementedError(
        "guardian_for_model needs hapi, which is not ported yet "
        "(ROADMAP.md Queue 1, item 9)")
