"""User-facing continuous-batching serving engine.

Counterpart of ``paddle_tpu/inference/server/engine.py``, with the
arguments this port implements so far plus ``device``.  Single-threaded
by design: ``submit()`` enqueues, ``step()`` runs one scheduler
iteration, and handles pull results by driving ``step()`` themselves,
so the logical clock IS the iteration count.

    params = init_llama_params(cfg, seed=0, device="cuda",
                               dtype=torch.bfloat16)
    engine = ServingEngine(cfg, params, max_seqs=8, page_size=16,
                           max_len=2048, prefill_chunk=512,
                           dtype=torch.bfloat16)
    h = engine.submit(prompt_ids, max_new_tokens=32)
    for tok in h.stream():
        ...
    engine.stats()

``device=None`` means CUDA and raises where there is none; pass
``device="cpu"`` for the plain PyTorch path (decode attention then
takes the kernel's plain version).  ``quant="int8"`` serves with int8
weights and an int8 KV pool; ``quant=None`` follows ``PT_QUANT``
(default ``none``), and a bad value fails here, at build.

``aot`` is ``"off"``, ``"warm"``, ``"strict"`` or ``None`` (follow
``PT_AOT``, default ``off``; a bad value fails at build).  Decode always
runs as captured CUDA graphs on the card, one per batch size, captured
at the first step of that size when ``off``.  ``warm`` captures every
decode rung (and every ``decode_n`` rung for n in ``decode_n_steps``) at
build and arms the prefill chunk ladder; ``strict`` also seals the
programs, so a rung the warmup missed raises ``AotMissError`` instead of
capturing mid-traffic.  There is no ``compile_cache=`` argument: a CUDA
graph holds the addresses of the process that captured it and cannot
be kept on disk.
"""
from __future__ import annotations

import torch

from ...core import aot as aot_mod
from .executor import PagedExecutor
from .metrics import EngineMetrics
from .request import Request, RequestHandle
from .scheduler import Scheduler


class ServingEngine:
    def __init__(self, config, params, max_seqs=4, page_size=16,
                 max_len=256, dtype=torch.float32, num_pages=None,
                 policy="fifo", prefill_chunk=None, eos_token_id=None,
                 max_preemptions=4, clock=None, device=None, quant=None,
                 aot=None, decode_n_steps=()):
        if aot is None:
            aot = aot_mod.mode()
        if aot not in aot_mod.MODES:
            raise ValueError(f"aot={aot!r}: expected one of "
                             f"{aot_mod.MODES} (as PT_AOT)")
        self.executor = PagedExecutor(
            config, params, max_seqs=max_seqs, page_size=page_size,
            max_len=max_len, dtype=dtype, num_pages=num_pages,
            device=device, quant=quant)
        self.device = self.executor.device
        self.metrics = EngineMetrics(
            max_seqs=max_seqs, num_pages=self.executor.cache.num_pages,
            clock=clock)
        self.scheduler = Scheduler(
            self.executor, self.metrics, policy=policy,
            prefill_chunk=prefill_chunk, eos_token_id=eos_token_id,
            max_preemptions=max_preemptions)
        self._next_rid = 0
        self.aot_mode = aot
        self._aot_report = None
        if aot != "off":
            self._aot_report = self.executor.aot_warmup(
                prefill_chunk=prefill_chunk, decode_n_steps=decode_n_steps)
            if aot == "strict":
                self.executor.seal()

    # -- submission ------------------------------------------------------

    def submit(self, prompt_ids, max_new_tokens=16, priority=0,
               deadline=None, on_token=None, rid=None) -> RequestHandle:
        """Enqueue a request; admission happens at the next step().

        ``deadline`` is in scheduler iterations from submission;
        ``on_token(rid, tok)`` streams tokens as they land.  A ``rid``
        already seen returns the original request's handle."""
        if rid is None:
            rid = f"req-{self._next_rid}"
            while rid in self.scheduler.requests:
                self._next_rid += 1
                rid = f"req-{self._next_rid}"
        elif rid in self.scheduler.requests:
            return RequestHandle(self, self.scheduler.requests[rid])
        req = Request(rid, prompt_ids, max_new_tokens=max_new_tokens,
                      priority=priority, deadline=deadline,
                      on_token=on_token, arrival_seq=self._next_rid,
                      clock=self.metrics.clock)
        self._next_rid += 1
        if len(req.prompt_ids) == 0:
            raise ValueError("prompt_ids must be non-empty")
        if req.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        self.scheduler.add(req)
        return RequestHandle(self, req)

    def cancel(self, rid) -> None:
        """Flag a request for cancellation; it turns CANCELLED at the
        start of the next step()."""
        req = self.scheduler.requests.get(rid)
        if req is not None and not req.terminal:
            req.cancel_flag = True

    # -- driving ---------------------------------------------------------

    def step(self) -> dict:
        """One scheduler iteration; returns {rid: [new tokens]}."""
        return self.scheduler.step()

    def run(self, max_steps=100000) -> dict:
        """Step until no request is in flight; returns stats()."""
        while self.scheduler.has_work():
            if self.scheduler.tick >= max_steps:
                raise RuntimeError(
                    f"serving engine did not drain in {max_steps} steps")
            self.step()
        return self.stats()

    # -- introspection ---------------------------------------------------

    @property
    def tick(self) -> int:
        return self.scheduler.tick

    @property
    def in_flight(self) -> int:
        s = self.scheduler
        return len(s.queue) + len(s.prefilling) + len(s.running)

    def stats(self) -> dict:
        return self.metrics.stats()
