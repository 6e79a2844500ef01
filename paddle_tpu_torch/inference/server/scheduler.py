"""Iteration-level (continuous-batching) scheduler.

Counterpart of ``paddle_tpu/inference/server/scheduler.py``.  Each
:meth:`step`:

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

With a prefix cache, admission matches ``resume_ids`` against the radix
tree, attaches the hit pages and pays only for the novel ones (plus one
page for the copy of a page hit mid-way; cold tree pages count as
available), and a prompt's full pages are published to the tree at its
final prefill chunk.  With speculative decode (``spec``), the decode
step drafts from each request's n-gram index, verifies every window in
one ``serve.verify`` call, emits ``1 + accepted`` tokens a sequence and
trims the pages the rejected tail had reserved.

Double-buffered execution (``async_exec``): the step is split into a
host ``plan`` (a :class:`StepPlan`) and a ``commit`` of the device
results, with the dispatch left unread in between; while step N runs on
the card the scheduler plans step N+1 against the predicted post-N
state.  If the commit invalidates the prediction (a request finished,
failed or was cancelled) the plan is rebuilt and ``replans`` counts it.
The interleaving stays deterministic on the logical clock: the async
stream equals the sync one token for token.

Not ported: the fault points, the obs spans, the write-ahead journal and
the sequence-parallel prefill.
"""
from __future__ import annotations

import numpy as np

from .request import RequestState

_POOL_EXHAUSTED = "KV page pool exhausted"


class StepPlan:
    """The host half of one scheduler iteration, split out so the
    double-buffered path can build step N+1's plan while step N is in
    flight.  ``fingerprint`` is the predicted sorted
    ``(rid, sid, generated)`` tuple the running set must match when the
    plan is adopted; any divergence re-plans from live state."""

    __slots__ = ("tick", "sids", "by_sid", "fingerprint", "kind",
                 "drafts")

    def __init__(self, tick, sids, by_sid, fingerprint=None,
                 kind="decode", drafts=None):
        self.tick = tick
        self.sids = sids
        self.by_sid = by_sid
        self.fingerprint = fingerprint
        self.kind = kind
        self.drafts = drafts


class Scheduler:
    def __init__(self, executor, metrics, policy="fifo",
                 prefill_chunk=None, eos_token_id=None,
                 max_preemptions=4, prefix_cache=None, spec=None,
                 async_exec=False):
        if policy not in ("fifo", "priority"):
            raise ValueError(
                f"policy must be 'fifo' or 'priority', got {policy!r}")
        self.executor = executor
        self.metrics = metrics
        self.prefix = prefix_cache   # radix prefix index (None = off)
        self.spec = spec             # SpecDecode bundle (None = off)
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
        # double-buffered execution: the plan built while the previous
        # step was in flight, the replan counter and the host-overlap
        # accounting (seconds on the metrics clock)
        self.async_mode = bool(async_exec)
        self._pending = None     # StepPlan parked for the next step
        self.replans = 0
        self.overlapped_s = 0.0  # host seconds hidden behind the card
        self.device_s = 0.0      # dispatch-to-fence wall seconds
        self.last_phase_seconds = {}
        self.phase_totals = {}

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
        if self.async_mode:
            self._step_async(emitted)
        else:
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

    def _reserve_decode_batch(self, extra_fn):
        """Reserve each RUNNING sequence's lookahead
        (``extra_fn(sids, by_sid)`` gives reserve()'s extra_tokens),
        preempting the victim policy's pick while the pool cannot cover
        the batch.  Returns the surviving run list.  The reservation is
        idempotent, so the executor's own reserve() re-checks without
        re-allocating."""
        run = list(self.running)
        while run:
            sids = sorted(r.sid for r in run)
            by_sid = {r.sid: r for r in run}
            try:
                self.executor.cache.reserve(
                    sids, extra_tokens=extra_fn(sids, by_sid))
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
        if self.spec is not None:
            self._decode_spec(emitted)
            return
        self._last_decode_batch = 0
        run = self._reserve_decode_batch(lambda sids, by_sid: 1)
        if not run:
            return
        sids = sorted(r.sid for r in run)
        by_sid = {r.sid: r for r in run}
        toks = self.executor.decode(sids)
        self._last_decode_batch = len(sids)
        self.metrics.on_decode_tokens(len(sids))
        for sid in sids:
            self._on_token(by_sid[sid], toks[sid], emitted)

    # -- speculative decode (draft -> batched verify -> rollback) -------

    def _spec_limit(self, req, draft_len):
        """How many window tokens this sequence may commit this step: 1
        plus at most ``draft_len`` accepted drafts, clamped to the
        per-seq page budget and the remaining generation cap."""
        ex = self.executor
        budget = ex.cache.max_pages_per_seq * ex.cache.page_size
        cap = min(req.max_new_tokens,
                  ex.max_len - len(req.prompt_ids))
        return max(1, min(self.spec.k + 1, int(draft_len) + 1,
                          cap - len(req.generated),
                          budget - int(ex.cache.lengths[req.sid])))

    def _spec_batch(self):
        """Drafts for the running set, then the preemption-aware
        reservation of each sequence's clamped window.  Returns (sids,
        by_sid, limits, drafts), or None when nothing runs."""
        run = list(self.running)
        if not run:
            return None
        drafts = {r.rid: self.spec.propose(r) for r in run}

        def extras(sids, by_sid):
            return [self._spec_limit(by_sid[s], len(drafts[by_sid[s].rid]))
                    for s in sids]

        run = self._reserve_decode_batch(extras)
        if not run:
            return None
        sids = sorted(r.sid for r in run)
        by_sid = {r.sid: r for r in run}
        lims = extras(sids, by_sid)
        dr = [drafts[by_sid[s].rid][:lim - 1]
              for s, lim in zip(sids, lims)]
        return sids, by_sid, lims, dr

    def _decode_spec(self, emitted):
        """Spec-mode decode: draft from each request's n-gram index,
        reserve each window (preempting under pressure as plain decode
        does), verify every window in one call, emit ``1 + accepted``
        tokens a sequence, then trim the rejected tail's pages."""
        self._last_decode_batch = 0
        batch = self._spec_batch()
        if batch is None:
            return
        sids, by_sid, lims, dr = batch
        toks, accepted = self.executor.verify(sids, dr, lims, self.spec.k)
        self._emit_verify(StepPlan(self.tick, sids, by_sid, kind="verify",
                                   drafts=dr), toks, accepted, emitted)

    def _emit_verify(self, plan, toks, accepted, emitted):
        """The tail of a verify step: emission, spec metrics, rollback."""
        sids, by_sid, dr = plan.sids, plan.by_sid, plan.drafts
        self._last_decode_batch = len(sids)
        self.metrics.on_decode_step(
            slots=len(sids), tokens=sum(len(v) for v in toks.values()))
        self.metrics.on_spec(proposed=sum(len(d) for d in dr),
                             accepted=sum(accepted.values()))
        for i, sid in enumerate(sids):
            req = by_sid[sid]
            req.draft_proposed += len(dr[i])
            req.draft_accepted += accepted[sid]
            for tok in toks[sid]:
                if req.terminal:
                    break   # tokens past eos / the cap are dropped
                self._on_token(req, tok, emitted)
        self.executor.rollback(
            [r.sid for r in by_sid.values() if r.sid is not None])

    # -- double-buffered execution --------------------------------------

    @property
    def host_overlap_ratio(self) -> float:
        """Overlapped host seconds / device seconds over the scheduler's
        lifetime (0.0 before the first async decode)."""
        return (self.overlapped_s / self.device_s
                if self.device_s > 0 else 0.0)

    def _step_async(self, emitted):
        """One double-buffered iteration: adopt (or rebuild) the plan
        parked while the previous step was in flight, dispatch without
        reading the result, plan the next step against the predicted
        post-step state while the card runs, then fence and commit."""
        clk = self.metrics.clock
        ph = {}
        t0 = clk()
        self._sweep_cancelled()
        self._sweep_deadlines()
        if self.spec is not None:
            t1 = self._step_async_spec(emitted, clk, ph, t0)
        else:
            t1 = self._step_async_plain(emitted, clk, ph, t0)
        self._admit()
        self._prefill(emitted)
        ph["commit"] = ph.get("commit", 0.0) + (clk() - t1)
        self._publish_phases(ph)

    def _step_async_plain(self, emitted, clk, ph, t0):
        self._last_decode_batch = 0
        plan = self._obtain_plan()
        t1 = clk()
        ph["plan"] = t1 - t0
        if plan is None:
            return t1
        pending = self.executor.decode_async(plan.sids)
        t2 = clk()
        ph["dispatch"] = t2 - t1
        self._plan_ahead(plan)
        t3 = clk()
        ph["overlap"] = t3 - t2
        pending.wait()
        t4 = clk()
        ph["fence"] = t4 - t3
        self._commit_decode(plan, pending, emitted)
        self.overlapped_s += ph["overlap"]
        self.device_s += ph["dispatch"] + ph["overlap"] + ph["fence"]
        return t4

    def _step_async_spec(self, emitted, clk, ph, t0):
        self._last_decode_batch = 0
        batch = self._spec_batch()
        t1 = clk()
        ph["plan"] = t1 - t0
        if batch is None:
            return t1
        sids, by_sid, lims, dr = batch
        plan = StepPlan(self.tick, sids, by_sid, kind="verify", drafts=dr)
        pending = self.executor.verify_async(sids, dr, lims, self.spec.k)
        t2 = clk()
        ph["dispatch"] = t2 - t1
        pending.wait()
        t3 = clk()
        ph["fence"] = t3 - t2
        self._commit_verify(plan, pending, emitted)
        self.device_s += ph["dispatch"] + ph["fence"]
        return t3

    def _obtain_plan(self):
        """The parked plan if its prediction survived the commit, else a
        fresh one from live state (the replan path, counted)."""
        plan, self._pending = self._pending, None
        if plan is not None and not self._plan_valid(plan):
            self.replans += 1
            plan = None
        if plan is None:
            plan = self._build_plan()
        return plan

    def _build_plan(self):
        run = self._reserve_decode_batch(lambda sids, by_sid: 1)
        if not run:
            return None
        return StepPlan(self.tick, sorted(r.sid for r in run),
                        {r.sid: r for r in run})

    def _plan_valid(self, plan) -> bool:
        if plan.tick != self.tick or self.prefilling:
            return False
        actual = tuple(sorted((r.rid, r.sid, len(r.generated))
                              for r in self.running))
        return actual == plan.fingerprint

    def _plan_ahead(self, plan):
        """The overlapped host work: while the dispatched step runs,
        reserve the next step's decode pages against the predicted
        post-step state (the executor advanced the lengths at dispatch)
        and fingerprint the prediction.  Strictly speculative: no
        preemption, no failure and no prefix eviction (the reclaimer is
        off, so the reserve draws from free pages only; a shortfall just
        drops the speculation).  Page identity never changes the
        numbers, so an early reservation cannot move the stream."""
        self._pending = None
        if self.queue or self.prefilling:
            return  # admissions / prefills this step would shift state
        ex = self.executor
        survivors = []
        for sid in plan.sids:
            r = plan.by_sid[sid]
            cap = min(r.max_new_tokens, ex.max_len - len(r.prompt_ids))
            if len(r.generated) + 1 >= cap:
                continue  # finishes this step on the length cap
            survivors.append(r)
        if not survivors:
            return
        sids = sorted(r.sid for r in survivors)
        cache = ex.cache
        saved, cache.reclaimer = cache.reclaimer, None
        try:
            cache.reserve(sids, extra_tokens=1)
        except RuntimeError as e:
            if _POOL_EXHAUSTED not in str(e):
                raise
            return  # pool too tight to speculate
        finally:
            cache.reclaimer = saved
        fp = tuple(sorted((r.rid, r.sid, len(r.generated) + 1)
                          for r in survivors))
        self._pending = StepPlan(self.tick + 1, sids,
                                 {r.sid: r for r in survivors},
                                 fingerprint=fp)

    def _commit_decode(self, plan, pending, emitted):
        """Apply one async decode's results: the sync tail of
        :meth:`_decode`, fed from the pending object's fence."""
        toks = pending.wait()
        self._last_decode_batch = len(plan.sids)
        self.metrics.on_decode_tokens(len(plan.sids))
        for sid in plan.sids:
            self._on_token(plan.by_sid[sid], toks[sid], emitted)

    def _commit_verify(self, plan, pending, emitted):
        """Apply one async verify's results: the sync tail of
        :meth:`_decode_spec` (emission, spec metrics, rollback)."""
        toks, accepted = pending.wait()
        self._emit_verify(plan, toks, accepted, emitted)

    def _publish_phases(self, ph):
        """Fold one async step's phase seconds into the totals."""
        if not ph:
            return
        self.last_phase_seconds = dict(ph)
        for k, v in ph.items():
            self.phase_totals[k] = self.phase_totals.get(k, 0.0) + v

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
        plus the first decode token (plus the worst-case ``k + 1`` window
        under speculative decode), clamped to the per-seq budget."""
        ex = self.executor
        lookahead = 1 if self.spec is None else self.spec.k + 1
        budget = ex.cache.max_pages_per_seq * ex.cache.page_size
        return min(prompt_tokens + lookahead, budget)

    def _admit(self):
        ex = self.executor
        while self.queue:
            req = self._pick_next()
            hit_tokens, hit_pages = 0, []
            if self.prefix is not None:
                hit_tokens, hit_pages = self.prefix.match(req.resume_ids)
            # admission pays only for novel pages: hit pages are attached
            # by reference; a mid-page hit budgets one page for the copy
            # of the partial page, and cold cached pages count as
            # available (eviction frees them)
            need = (ex.pages_for(self._token_target(len(req.resume_ids)))
                    - len(hit_pages))
            if hit_tokens % ex.cache.page_size:
                need += 1
            avail = ex.free_pages - self._committed_pages()
            if self.prefix is not None:
                avail += max(
                    0, self.prefix.evictable_pages() - len(hit_pages))
            if ex.free_slots < 1 or avail < need:
                if self.policy == "priority":
                    victim = self._pick_victim(below=req.priority)
                    if victim is not None:
                        self._preempt(victim)
                        continue
                break  # FIFO: head-of-line blocking keeps arrival order
            req.sid = ex.alloc_slot()
            req.prefill_done = 0
            if hit_tokens:
                ex.attach_prefix(req.sid, hit_pages, hit_tokens)
                req.prefill_done = hit_tokens
                req.cached_tokens = hit_tokens
                self.metrics.on_prefix_hit(hit_tokens)
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
                if self.prefix is not None:
                    # publish before the first token can finish the
                    # request: the tree's reference keeps the pages alive
                    # past the slot's release
                    self.prefix.insert(
                        ids, self.executor.cache.page_table[req.sid])
                if self.spec is not None:
                    # seed the draft index from prompt + generated before
                    # the first token extends it
                    self.spec.on_running(req)
                self._on_token(req, tok, emitted)

    # -- request transitions --------------------------------------------

    def _on_token(self, req, tok, emitted):
        req.emit(tok)
        if self.spec is not None:
            self.spec.on_token(req, tok)
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
        if self.spec is not None:
            self.spec.on_release(req)
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
