"""Request lifecycle for the continuous-batching server.

Counterpart of ``paddle_tpu/inference/server/request.py`` (a copy: the
port imports nothing of the JAX package).  State machine::

    QUEUED -> PREFILLING -> RUNNING -> {FINISHED, TRUNCATED}
       ^          |            |
       +----------+------------+   (preemption: pages freed, request
                                    re-queued for recompute)
    terminal anywhere: CANCELLED (user), EVICTED (policy drop),
                       FAILED (exception confined to this request)

``finish_reason`` narrows the terminal state: "eos" (FINISHED),
"length"/"deadline" (TRUNCATED), "cancelled", "too_large"/
"preempt_budget" (EVICTED), or the exception repr (FAILED).
"""
from __future__ import annotations

import enum
import time

import numpy as np


class RequestState(enum.Enum):
    QUEUED = "queued"
    PREFILLING = "prefilling"
    RUNNING = "running"
    FINISHED = "finished"      # hit the eos token
    TRUNCATED = "truncated"    # hit max_new_tokens or its deadline
    CANCELLED = "cancelled"    # user cancellation
    EVICTED = "evicted"        # dropped by admission/preemption policy
    FAILED = "failed"          # an exception confined to this request


#: states from which a request never leaves.
TERMINAL = frozenset({
    RequestState.FINISHED, RequestState.TRUNCATED,
    RequestState.CANCELLED, RequestState.EVICTED, RequestState.FAILED,
})


class Request:
    """One inference request inside the scheduler.  Host-side control
    state only — the KV lives in the executor's page pool under
    ``sid`` while the request holds a slot."""

    __slots__ = (
        "rid", "prompt_ids", "max_new_tokens", "priority", "deadline",
        "on_token", "arrival_seq", "state", "finish_reason", "error",
        "sid", "prefill_done", "resume_ids", "generated", "cancel_flag",
        "preempt_count", "submit_step", "submit_time", "sched_step",
        "first_token_step", "first_token_time", "finish_step",
        "finish_time", "last_token_time", "cached_tokens",
        "draft_proposed", "draft_accepted", "clock",
    )

    def __init__(self, rid, prompt_ids, max_new_tokens=16, priority=0,
                 deadline=None, on_token=None, arrival_seq=0,
                 clock=None):
        self.clock = time.perf_counter if clock is None else clock
        self.rid = rid
        self.prompt_ids = np.asarray(prompt_ids, np.int32).reshape(-1)
        self.max_new_tokens = int(max_new_tokens)
        self.priority = int(priority)
        self.deadline = None if deadline is None else int(deadline)
        self.on_token = on_token
        self.arrival_seq = int(arrival_seq)

        self.state = RequestState.QUEUED
        self.finish_reason = None
        self.error = None
        self.sid = None            # executor slot while admitted
        self.prefill_done = 0      # tokens of resume_ids already prefilled
        self.resume_ids = self.prompt_ids  # prompt (+ generated on resume)
        self.generated = []        # streamed output tokens
        self.cancel_flag = False
        self.preempt_count = 0
        self.cached_tokens = 0     # prompt tokens attached from cache
        self.draft_proposed = 0    # speculative draft tokens offered
        self.draft_accepted = 0    # ...committed by verification

        self.submit_step = None
        self.submit_time = None
        self.sched_step = None       # first admitted (queue-wait end)
        self.first_token_step = None
        self.first_token_time = None
        self.finish_step = None
        self.finish_time = None
        self.last_token_time = None

    @property
    def terminal(self) -> bool:
        return self.state in TERMINAL

    def emit(self, tok: int) -> None:
        """Record one generated token and stream it to the callback."""
        self.generated.append(int(tok))
        now = self.clock()
        if self.first_token_time is None:
            self.first_token_time = now
        self.last_token_time = now
        if self.on_token is not None:
            self.on_token(self.rid, int(tok))

    def __repr__(self):
        return (f"Request(rid={self.rid}, state={self.state.value}, "
                f"prompt={len(self.prompt_ids)}, "
                f"generated={len(self.generated)})")


class RequestHandle:
    """What ``ServingEngine.submit`` returns: a live view of one request
    plus pull-style streaming.  The engine is single-threaded, so
    ``stream()`` and ``result()`` drive ``engine.step()`` themselves."""

    def __init__(self, engine, request: Request):
        self._engine = engine
        self._req = request

    @property
    def rid(self):
        return self._req.rid

    @property
    def state(self) -> RequestState:
        return self._req.state

    @property
    def finish_reason(self):
        return self._req.finish_reason

    @property
    def tokens(self):
        return list(self._req.generated)

    @property
    def num_preemptions(self):
        return self._req.preempt_count

    def cancel(self):
        self._engine.cancel(self._req.rid)

    def result(self):
        """Step the engine until terminal; return the generated tokens.
        Raises the confined exception on FAILED."""
        while not self._req.terminal:
            self._engine.step()
        if self._req.state is RequestState.FAILED:
            raise self._req.error
        return list(self._req.generated)

    def stream(self):
        """Yield tokens as they are produced, stepping the engine while
        this request is alive."""
        sent = 0
        while True:
            while sent < len(self._req.generated):
                yield self._req.generated[sent]
                sent += 1
            if self._req.terminal:
                if self._req.state is RequestState.FAILED:
                    raise self._req.error
                return
            self._engine.step()

    def metrics(self) -> dict:
        r = self._req
        return {
            "state": r.state.value,
            "finish_reason": r.finish_reason,
            "queue_wait_steps": (None if r.sched_step is None
                                 else r.sched_step - r.submit_step),
            "ttft_steps": (None if r.first_token_step is None
                           else r.first_token_step - r.submit_step),
            "ttft_s": (None if r.first_token_time is None
                       else r.first_token_time - r.submit_time),
            "tpot_s": (None if len(r.generated) < 2
                       or r.last_token_time is None
                       or r.first_token_time is None
                       else (r.last_token_time - r.first_token_time)
                       / (len(r.generated) - 1)),
            "tokens": len(r.generated),
            "preemptions": r.preempt_count,
            "cached_tokens": r.cached_tokens,
            "draft_proposed": r.draft_proposed,
            "draft_accepted": r.draft_accepted,
        }

    def __repr__(self):
        return f"RequestHandle({self._req!r})"
