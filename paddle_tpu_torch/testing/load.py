"""Deterministic load harness for the serving engine.

Counterpart of ``paddle_tpu/testing/load.py`` (a copy of its default
workload shape): ``generate_load`` makes the same numpy draws in the
same order, so both packages replay byte-identical requests from one
seed, and ``run_load`` submits each request when the engine's logical
clock reaches its arrival tick.

Not ported yet: the shared-prefix, repetitive and Zipf traffic shapes
(they feed the prefix cache and speculative decode) and the fault
hooks.
"""
from __future__ import annotations

import numpy as np


class LoadSpec:
    """Workload shape for :func:`generate_load` (all draws seeded)."""

    def __init__(self, n_requests=8, mean_interarrival=2.0,
                 prompt_len=(4, 24), max_new=(4, 12), priorities=(0,),
                 vocab=256, seed=0):
        self.n_requests = int(n_requests)
        self.mean_interarrival = float(mean_interarrival)
        self.prompt_len = tuple(prompt_len)
        self.max_new = tuple(max_new)
        self.priorities = tuple(priorities)
        self.vocab = int(vocab)
        self.seed = int(seed)


def generate_load(spec: LoadSpec) -> list:
    """Seeded workload: [{rid, arrival_tick, prompt_ids, max_new_tokens,
    priority}, ...] sorted by arrival tick (geometric inter-arrival gaps
    keep ticks integral)."""
    rng = np.random.RandomState(spec.seed)
    work, tick = [], 0
    p_step = 1.0 / max(spec.mean_interarrival, 1e-9)
    for i in range(spec.n_requests):
        if i:
            tick += int(rng.geometric(min(p_step, 1.0)))
        plen = int(rng.randint(spec.prompt_len[0], spec.prompt_len[1] + 1))
        prompt = rng.randint(1, spec.vocab, size=plen).astype(np.int32)
        work.append({
            "rid": f"load-{i}",
            "arrival_tick": tick,
            "prompt_ids": prompt,
            "max_new_tokens": int(rng.randint(
                spec.max_new[0], spec.max_new[1] + 1)),
            "priority": int(spec.priorities[
                rng.randint(len(spec.priorities))]),
        })
    return work


def run_load(engine, workload, max_steps=10000) -> dict:
    """Replay ``workload`` against ``engine`` on the logical clock: per
    iteration, submit every request whose arrival tick has come, then
    ``engine.step()``.  Returns ``{"handles": {rid: RequestHandle},
    "stats": engine.stats()}``."""
    pending = sorted(workload, key=lambda w: (w["arrival_tick"],
                                              w["rid"]))
    handles = {}
    while pending or engine.in_flight:
        if engine.tick >= max_steps:
            raise RuntimeError(
                f"load did not drain in {max_steps} steps "
                f"({len(pending)} unsubmitted, {engine.in_flight} "
                f"in flight)")
        while pending and pending[0]["arrival_tick"] <= engine.tick:
            w = pending.pop(0)
            handles[w["rid"]] = engine.submit(
                w["prompt_ids"], max_new_tokens=w["max_new_tokens"],
                priority=w["priority"], rid=w["rid"])
        engine.step()
    return {"handles": handles, "stats": engine.stats()}
