"""Iteration-level (continuous-batching) scheduler.

Counterpart of the synchronous path of
``paddle_tpu/inference/server/scheduler.py``.  Each :meth:`step`:

  1. sweeps cancellations and logical deadlines,
  2. runs ONE batched decode over every RUNNING sequence — preempting
     the lowest-priority / latest-arrival victim when the page pool
     cannot cover the batch's next token (pages freed, request
     re-queued for recompute),
  3. admits queued requests while slots AND pages fit,
  4. advances every PREFILLING request by one chunk, so a long prompt
     costs each iteration at most ``prefill_chunk`` tokens of prefill.

An exception inside one request's prefill fails THAT request only.

Under an armed AOT ladder (``executor.aot_ladder``) prefill chunks are
floored onto its rungs and whole prompts go through ``prefill_chunk``.

Not ported yet (later slices): speculative decode, double-buffered
async execution, the prefix cache, the write-ahead journal, fault
points and sequence-parallel prefill.
"""
from __future__ import annotations

import numpy as np

from .request import RequestState

_POOL_EXHAUSTED = "KV page pool exhausted"


class Scheduler:
    def __init__(self, executor, metrics, policy="fifo",
                 prefill_chunk=None, eos_token_id=None,
                 max_preemptions=4):
        if policy not in ("fifo", "priority"):
            raise ValueError(
                f"policy must be 'fifo' or 'priority', got {policy!r}")
        self.executor = executor
        self.metrics = metrics
        self.policy = policy
        self.prefill_chunk = (None if prefill_chunk is None
                              else int(prefill_chunk))
        self.eos_token_id = eos_token_id
        self.max_preemptions = int(max_preemptions)
        self.requests: dict = {}     # rid -> Request (all ever seen)
        self.queue: list = []        # QUEUED, admission order
        self.prefilling: list = []   # hold a slot, prompt KV partial
        self.running: list = []      # hold a slot, decoding
        self.tick = 0                # logical clock (iterations)
        self._last_decode_batch = 0

    # -- submission boundary (called by the engine) ---------------------

    def add(self, req) -> None:
        self.requests[req.rid] = req
        self.metrics.on_submit(req, self.tick)
        ex = self.executor
        budget_tokens = ex.cache.max_pages_per_seq * ex.cache.page_size
        # +1: the first decode step writes the token AFTER the prompt
        if (len(req.prompt_ids) + 1 > min(ex.max_len, budget_tokens)
                or ex.pages_for(len(req.prompt_ids) + 1)
                > ex.cache.num_pages):
            self._finish(req, RequestState.EVICTED, "too_large")
            return
        self.queue.append(req)

    def has_work(self) -> bool:
        return bool(self.queue or self.prefilling or self.running)

    # -- the iteration --------------------------------------------------

    def step(self) -> dict:
        """One scheduler iteration.  Returns {rid: [tokens emitted]}."""
        self.tick += 1
        emitted: dict = {}
        self._sweep_cancelled()
        self._sweep_deadlines()
        self._decode(emitted)
        self._admit()
        self._prefill(emitted)
        self.metrics.on_step(
            decode_batch=self._last_decode_batch,
            pages_used=(self.executor.cache.num_pages
                        - self.executor.free_pages),
            in_flight=len(self.queue) + len(self.prefilling)
            + len(self.running))
        return emitted

    # -- sweeps ---------------------------------------------------------

    def _sweep_cancelled(self):
        for r in [r for r in self.requests.values()
                  if r.cancel_flag and not r.terminal]:
            self._finish(r, RequestState.CANCELLED, "cancelled")

    def _sweep_deadlines(self):
        for r in [r for r in self.requests.values()
                  if not r.terminal and r.deadline is not None
                  and self.tick - r.submit_step > r.deadline]:
            self._finish(r, RequestState.TRUNCATED, "deadline")

    # -- decode with preemption under page pressure ---------------------

    def _reserve_decode_batch(self):
        """Reserve each RUNNING sequence's next token, preempting the
        victim policy's pick while the pool cannot cover the batch.
        Returns the surviving run list."""
        run = list(self.running)
        while run:
            sids = sorted(r.sid for r in run)
            try:
                self.executor.cache.reserve(sids, extra_tokens=1)
                return run
            except RuntimeError as e:
                if _POOL_EXHAUSTED not in str(e):
                    raise
                victim = self._pick_victim()
                if victim is None or (len(run) == 1 and victim is run[0]
                                      and not self.prefilling):
                    # the lone sequence cannot grow even with the whole
                    # pool free: the pool is undersized for one request
                    self._finish(
                        run[0], RequestState.FAILED, "pool_exhausted",
                        error=RuntimeError(
                            f"{_POOL_EXHAUSTED} for a single sequence "
                            f"(pool {self.executor.cache.num_pages} "
                            f"pages)"))
                    run = list(self.running)
                    continue
                self._preempt(victim)
                run = list(self.running)
        return run

    def _decode(self, emitted):
        self._last_decode_batch = 0
        run = self._reserve_decode_batch()
        if not run:
            return
        sids = sorted(r.sid for r in run)
        by_sid = {r.sid: r for r in run}
        toks = self.executor.decode(sids)
        self._last_decode_batch = len(sids)
        self.metrics.on_decode_tokens(len(sids))
        for sid in sids:
            self._on_token(by_sid[sid], toks[sid], emitted)

    # -- page-aware admission -------------------------------------------

    def _committed_pages(self) -> int:
        """Pages promised to in-progress prefills but not yet assigned:
        admission subtracts what admitted prompts will still take."""
        ex = self.executor
        total = 0
        for r in self.prefilling:
            held = int((ex.cache.page_table[r.sid] >= 0).sum())
            total += max(0, ex.pages_for(
                self._token_target(len(r.resume_ids))) - held)
        return total

    def _token_target(self, prompt_tokens: int) -> int:
        """Tokens a request must hold right after prefill: the prompt
        plus the first decode token, clamped to the per-seq budget."""
        ex = self.executor
        budget = ex.cache.max_pages_per_seq * ex.cache.page_size
        return min(prompt_tokens + 1, budget)

    def _admit(self):
        ex = self.executor
        while self.queue:
            req = self._pick_next()
            need = ex.pages_for(self._token_target(len(req.resume_ids)))
            avail = ex.free_pages - self._committed_pages()
            if ex.free_slots < 1 or avail < need:
                if self.policy == "priority":
                    victim = self._pick_victim(below=req.priority)
                    if victim is not None:
                        self._preempt(victim)
                        continue
                break  # FIFO: head-of-line blocking keeps arrival order
            req.sid = ex.alloc_slot()
            req.prefill_done = 0
            req.state = RequestState.PREFILLING
            self.queue.remove(req)
            self.prefilling.append(req)
            self.metrics.on_sched(req, self.tick)

    def _pick_next(self):
        if self.policy == "priority":
            return max(self.queue,
                       key=lambda r: (r.priority, -r.arrival_seq))
        return self.queue[0]

    def _pick_victim(self, below=None):
        """Lowest-priority, latest-arrival slot holder (running or
        prefilling); ``below`` restricts to strictly lower priority."""
        cands = self.running + self.prefilling
        if below is not None:
            cands = [r for r in cands if r.priority < below]
        if not cands:
            return None
        return min(cands, key=lambda r: (r.priority, -r.arrival_seq))

    # -- chunked prefill -------------------------------------------------

    def _prefill(self, emitted):
        # a warmed executor publishes its AOT bucket ladder: chunks are
        # floored onto the rungs (any prompt decomposes into descending
        # rungs) and whole prompts route through prefill_chunk, as in the
        # reference, whose serve.prefill has an unbounded [1, S] shape
        ladder = self.executor.aot_ladder
        for req in list(self.prefilling):
            ids = req.resume_ids
            total = len(ids)
            start = req.prefill_done
            chunk = (total - start if self.prefill_chunk is None
                     else min(self.prefill_chunk, total - start))
            if ladder is not None:
                chunk = ladder.floor(chunk)
            final = start + chunk == total
            try:
                # page work first: a pool-exhausted raise preempts (not
                # fails) the request
                self.executor.prepare_write(req.sid, start, chunk)
            except RuntimeError as e:
                if _POOL_EXHAUSTED not in str(e):
                    raise
                self._preempt(req)
                continue
            try:
                if start == 0 and final and ladder is None:
                    tok = self.executor.prefill(req.sid, ids)
                else:
                    tok = self.executor.prefill_chunk(
                        req.sid, ids[start:start + chunk], start, final)
            except RuntimeError as e:
                if _POOL_EXHAUSTED in str(e):
                    self._preempt(req)
                    continue
                self._fail(req, e)
                continue
            except Exception as e:  # a poisoned request fails alone
                self._fail(req, e)
                continue
            req.prefill_done = start + chunk
            self.metrics.on_prefill_tokens(chunk)
            if final:
                self.prefilling.remove(req)
                self.running.append(req)
                req.state = RequestState.RUNNING
                self._on_token(req, tok, emitted)

    # -- request transitions --------------------------------------------

    def _on_token(self, req, tok, emitted):
        req.emit(tok)
        emitted.setdefault(req.rid, []).append(int(tok))
        if req.first_token_step is None:
            self.metrics.on_first_token(req, self.tick)
        if (self.eos_token_id is not None
                and int(tok) == int(self.eos_token_id)):
            self._finish(req, RequestState.FINISHED, "eos")
            return
        cap = min(req.max_new_tokens,
                  self.executor.max_len - len(req.prompt_ids))
        if len(req.generated) >= cap:
            if cap < req.max_new_tokens:
                self._finish(req, RequestState.TRUNCATED, "length")
            else:
                self._finish(req, RequestState.FINISHED, "length")

    def _preempt(self, req):
        """Free the victim's pages and re-queue it for recompute: on
        re-admission the prompt PLUS the already-streamed tokens are
        prefilled again and decoding resumes where it left off."""
        self.metrics.on_preempt(req)
        req.preempt_count += 1
        self._release(req)
        if req.preempt_count > self.max_preemptions:
            self._finish(req, RequestState.EVICTED, "preempt_budget")
            return
        req.resume_ids = np.concatenate(
            [req.prompt_ids,
             np.asarray(req.generated, np.int32)]).astype(np.int32)
        req.prefill_done = 0
        req.state = RequestState.QUEUED
        self.queue.insert(0, req)  # seniority: re-admitted first

    def _release(self, req):
        if req.sid is not None:
            self.executor.free_slot(req.sid)
            req.sid = None
        for pool in (self.queue, self.prefilling, self.running):
            if req in pool:
                pool.remove(req)

    def _fail(self, req, error):
        self._finish(req, RequestState.FAILED,
                     f"{type(error).__name__}: {error}", error=error)

    def _finish(self, req, state, reason, error=None):
        if error is not None:
            req.error = error
        self._release(req)
        req.state = state
        req.finish_reason = reason
        self.metrics.on_terminal(req, self.tick)
