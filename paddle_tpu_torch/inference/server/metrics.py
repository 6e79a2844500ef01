"""SLO statistics for the serving engine.

Counterpart of ``paddle_tpu/inference/server/metrics.py`` without the
telemetry registry, with its prefix-cache and speculative-decode
counters.  Two clocks run side by side: the logical clock
(scheduler iterations, what deterministic tests assert on) and the
injectable wall clock (what a benchmark reports as ms percentiles).
Occupancy and page utilisation are averaged over the steps where a
request was in flight.
"""
from __future__ import annotations

import time

import numpy as np

from .request import RequestState


def _pct(values, q):
    vals = [v for v in values if v is not None]
    if not vals:
        return None
    return float(np.percentile(np.asarray(vals, np.float64), q))


def _ms(seconds):
    return None if seconds is None else round(seconds * 1e3, 3)


class EngineMetrics:
    """Accumulates per-request and engine-level serving statistics;
    ``clock`` defaults to ``time.perf_counter``."""

    def __init__(self, max_seqs: int, num_pages: int, clock=None):
        self.max_seqs = max_seqs
        self.num_pages = num_pages
        self.clock = time.perf_counter if clock is None else clock
        self.steps = 0
        self.busy_steps = 0           # steps with >= 1 in-flight request
        self.decode_tokens = 0
        self.decode_steps = 0         # batched decode dispatches
        self.decode_slot_steps = 0    # sum of decode batch sizes
        self.prefill_tokens = 0
        self.preemptions = 0
        self.draft_proposed = 0       # speculative draft tokens offered
        self.draft_accepted = 0       # ...committed by verification
        self.spec_steps = 0           # verify dispatches
        self.submitted = 0
        self.prefix_hits = 0          # admissions that attached pages
        self.cached_tokens = 0        # prompt tokens served from cache
        self.evicted_pages = 0        # prefix-tree pages LRU-evicted
        self.occupancy_sum = 0.0      # decode-batch fill over busy steps
        self.page_util_sum = 0.0      # pool occupancy over busy steps
        self.state_counts = {s.value: 0 for s in RequestState
                             if s.value not in ("queued", "prefilling",
                                                "running")}
        self._completed = []          # per-request metric dicts
        self._t_start = self.clock()
        self._t_last = self._t_start

    # -- event hooks (called by the scheduler) --------------------------

    def on_submit(self, req, step):
        self.submitted += 1
        req.submit_step = step
        req.submit_time = self.clock()

    def on_sched(self, req, step):
        if req.sched_step is None:
            req.sched_step = step

    def on_first_token(self, req, step):
        if req.first_token_step is None:
            req.first_token_step = step

    def on_decode_tokens(self, n):
        # one-token-per-slot decode: slots == tokens
        self.on_decode_step(slots=n, tokens=n)

    def on_decode_step(self, slots, tokens):
        self.decode_tokens += tokens
        self.decode_slot_steps += slots
        self.decode_steps += 1

    def on_spec(self, proposed, accepted):
        self.spec_steps += 1
        self.draft_proposed += int(proposed)
        self.draft_accepted += int(accepted)

    def on_prefill_tokens(self, n):
        self.prefill_tokens += n

    def on_preempt(self, req):
        self.preemptions += 1

    def on_prefix_hit(self, tokens):
        self.prefix_hits += 1
        self.cached_tokens += int(tokens)

    def on_prefix_evict(self, n_pages):
        self.evicted_pages += int(n_pages)

    def on_terminal(self, req, step):
        req.finish_step = step
        req.finish_time = self.clock()
        self.state_counts[req.state.value] += 1
        n = len(req.generated)
        self._completed.append({
            "queue_wait_steps": (None if req.sched_step is None
                                 or req.submit_step is None
                                 else req.sched_step - req.submit_step),
            "ttft_steps": (None if req.first_token_step is None
                           else req.first_token_step - req.submit_step),
            "ttft_s": (None if req.first_token_time is None
                       else req.first_token_time - req.submit_time),
            "tpot_s": (None if n < 2 or req.last_token_time is None
                       else (req.last_token_time - req.first_token_time)
                       / (n - 1)),
            # scheduler iterations per generated token: 1.0 for plain
            # decode, below 1.0 once verify steps commit several tokens
            "tpot_steps": (None if n < 2 or req.first_token_step is None
                           else (req.finish_step - req.first_token_step)
                           / (n - 1)),
            "tokens": n,
        })

    def on_step(self, decode_batch: int, pages_used: int,
                in_flight: int):
        self.steps += 1
        self._t_last = self.clock()
        if in_flight:
            self.busy_steps += 1
            self.occupancy_sum += decode_batch / max(self.max_seqs, 1)
            self.page_util_sum += pages_used / max(self.num_pages, 1)

    # -- report ---------------------------------------------------------

    def stats(self) -> dict:
        wall = max(self._t_last - self._t_start, 1e-9)
        done = self._completed
        busy = max(self.busy_steps, 1)
        return {
            "steps": self.steps,
            "wall_s": wall,
            "requests": dict(self.state_counts, submitted=self.submitted),
            "preemptions": self.preemptions,
            "decode_tokens": self.decode_tokens,
            "decode_steps": self.decode_steps,
            "prefill_tokens": self.prefill_tokens,
            # prefix cache: the share of prompt tokens served from
            # shared pages instead of prefilled
            "cached_tokens": self.cached_tokens,
            "prefix_hit_rate": round(
                self.cached_tokens
                / max(self.cached_tokens + self.prefill_tokens, 1), 4),
            "evicted_pages": self.evicted_pages,
            "throughput_tok_s": self.decode_tokens / wall,
            # speculative decode: the share of drafted tokens committed,
            # and tokens a sequence advances per decode slot-step
            "draft_acceptance_rate": round(
                self.draft_accepted / max(self.draft_proposed, 1), 4),
            "tokens_per_decode_step": round(
                self.decode_tokens / max(self.decode_slot_steps, 1), 4),
            "batch_occupancy": self.occupancy_sum / busy,
            "page_utilization": self.page_util_sum / busy,
            "queue_wait_steps_p50": _pct(
                [d["queue_wait_steps"] for d in done], 50),
            "queue_wait_steps_p99": _pct(
                [d["queue_wait_steps"] for d in done], 99),
            "ttft_steps_p50": _pct([d["ttft_steps"] for d in done], 50),
            "ttft_ms_p50": _ms(_pct([d["ttft_s"] for d in done], 50)),
            "ttft_ms_p99": _ms(_pct([d["ttft_s"] for d in done], 99)),
            "tpot_ms_p50": _ms(_pct([d["tpot_s"] for d in done], 50)),
            "tpot_ms_p99": _ms(_pct([d["tpot_s"] for d in done], 99)),
            "tpot_steps_p50": _pct([d["tpot_steps"] for d in done], 50),
            "tpot_steps_p99": _pct([d["tpot_steps"] for d in done], 99),
        }
