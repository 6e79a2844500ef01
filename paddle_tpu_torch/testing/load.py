"""Deterministic load harness for the serving engine.

Counterpart of ``paddle_tpu/testing/load.py`` (a copy of its workload
shapes): ``generate_load`` makes the same numpy draws in the same order,
so both packages replay byte-identical requests from one seed, and
``run_load`` submits each request when the engine's (or the fleet's)
logical clock reaches its arrival tick.  The shared-prefix shape (``prefix_share``,
``prefix_len``, ``prefix_pool``, optionally Zipf-skewed by ``zipf_s``)
feeds the prefix cache, the repetitive one (``repeat_share``,
``repeat_period``) speculative decode; with both shares 0 no extra draw
is made, so earlier seeds replay byte-identically.
"""
from __future__ import annotations

import numpy as np

from . import faults


class LoadSpec:
    """Workload shape for :func:`generate_load` (all draws seeded)."""

    def __init__(self, n_requests=8, mean_interarrival=2.0,
                 prompt_len=(4, 24), max_new=(4, 12), priorities=(0,),
                 vocab=256, seed=0, prefix_share=0.0, prefix_len=16,
                 prefix_pool=2, repeat_share=0.0, repeat_period=4,
                 zipf_s=None):
        self.n_requests = int(n_requests)
        self.mean_interarrival = float(mean_interarrival)
        self.prompt_len = tuple(prompt_len)
        self.max_new = tuple(max_new)
        self.priorities = tuple(priorities)
        self.vocab = int(vocab)
        self.seed = int(seed)
        # shared prefixes: a `prefix_share` fraction of requests prepend
        # one of `prefix_pool` seeded prefixes of `prefix_len` tokens
        self.prefix_share = float(prefix_share)
        self.prefix_len = int(prefix_len)
        self.prefix_pool = int(prefix_pool)
        # repetition: a `repeat_share` fraction of requests tile their
        # prompt from its first `repeat_period` tokens
        self.repeat_share = float(repeat_share)
        self.repeat_period = int(repeat_period)
        # Zipf(s) prefix popularity instead of uniform when set
        self.zipf_s = None if zipf_s is None else float(zipf_s)


def generate_load(spec: LoadSpec) -> list:
    """Seeded workload: [{rid, arrival_tick, prompt_ids, max_new_tokens,
    priority}, ...] sorted by arrival tick (geometric inter-arrival gaps
    keep ticks integral)."""
    rng = np.random.RandomState(spec.seed)
    # the prefix pool is drawn first and only when enabled
    prefixes = None
    if spec.prefix_share > 0.0:
        prefixes = [rng.randint(1, spec.vocab,
                                size=spec.prefix_len).astype(np.int32)
                    for _ in range(spec.prefix_pool)]
    work, tick = [], 0
    p_step = 1.0 / max(spec.mean_interarrival, 1e-9)
    for i in range(spec.n_requests):
        if i:
            tick += int(rng.geometric(min(p_step, 1.0)))
        plen = int(rng.randint(spec.prompt_len[0], spec.prompt_len[1] + 1))
        prompt = rng.randint(1, spec.vocab, size=plen).astype(np.int32)
        if spec.repeat_share > 0.0 and rng.rand() < spec.repeat_share:
            period = max(1, min(spec.repeat_period, plen))
            prompt = np.tile(prompt[:period],
                             -(-plen // period))[:plen].astype(np.int32)
        if prefixes is not None and rng.rand() < spec.prefix_share:
            if spec.zipf_s is not None:
                w = 1.0 / np.arange(1, len(prefixes) + 1,
                                    dtype=np.float64) ** spec.zipf_s
                idx = min(int(np.searchsorted(np.cumsum(w / w.sum()),
                                              rng.rand())),
                          len(prefixes) - 1)
            else:
                idx = int(rng.randint(len(prefixes)))
            prompt = np.concatenate([prefixes[idx], prompt])
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


def run_load(engine, workload, max_steps=10000, on_error="raise") -> dict:
    """Replay ``workload`` against ``engine`` on the logical clock: per
    iteration, submit every request whose arrival tick has come, then
    ``engine.step()``.  ``on_error="continue"`` records an
    :class:`~.faults.InjectedFault` escaping a step and keeps driving
    (the fault-under-load mode); anything else re-raises.  Returns
    ``{"handles": {rid: RequestHandle}, "errors": [InjectedFault...],
    "stats": engine.stats()}``."""
    pending = sorted(workload, key=lambda w: (w["arrival_tick"],
                                              w["rid"]))
    handles, errors = {}, []
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
        try:
            engine.step()
        except faults.InjectedFault as e:
            if on_error != "continue":
                raise
            errors.append(e)
    return {"handles": handles, "errors": errors,
            "stats": engine.stats()}
