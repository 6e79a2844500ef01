"""A serving process to kill: the subject of the crash-recovery checks.

    python -m paddle_tpu_torch.testing.durability_worker <wal_dir> \\
        [fault_spec] [--device cuda|cpu] [--config tiny|parity|7b]

Builds a seeded fleet (:func:`build`: the weights, a two-replica
``ServingCluster`` journaling into ``wal_dir`` with an fsync after every
record, and the seeded load), serves the load on the logical clock and
prints ``tick N appended M`` after every step, so that a parent can kill
it with SIGKILL at a chosen journal depth.  ``fault_spec`` (the
``PT_FAULTS`` grammar) is armed through ``faults.reset``: its ``crash``
and ``truncate`` actions end the process with ``faults.EXIT_CODE`` (53)
at a precise point.  A run that drains prints ``DRAINED`` and exits 0.

A parent rebuilds the same weights and load with :func:`build` and
recovers the directory with ``ServingCluster.recover``; its streams must
then equal an uninterrupted run's.  ``tiny`` is the tests' Llama (vocab
256, hidden 64, 2 layers, fp32 weights drawn on the CPU from seed 11, so
that a CPU and a card process hold the same bits); ``parity`` is
Llama-2-7B's width at 2 layers in fp32 (the card-vs-CPU parity cut),
its weights drawn on the device from seed 0, serving 4 requests of 8
tokens; ``7b`` is Llama-2-7B at full width and depth in bf16, its
weights drawn on the device from seed 0, serving 8 requests of 128-1024
prompt tokens.  A setup whose weights are drawn on the device holds the
same bits in every process on that device type.
"""
from __future__ import annotations

import argparse
import sys

import torch

#: the tests' load and engine shape (``tests/test_durability.py``'s)
TINY_LOAD = dict(n_requests=8, mean_interarrival=1.0, prompt_len=(4, 14),
                 max_new=(4, 8), vocab=256, seed=3)
TINY_KW = dict(max_seqs=4, page_size=4, max_len=64, prefill_chunk=8)
#: the card-vs-CPU parity cut's
PARITY_KW = dict(max_seqs=4, page_size=16, max_len=256, prefill_chunk=32)
PARITY_LOAD = dict(n_requests=4, mean_interarrival=1.0,
                   prompt_len=(16, 64), max_new=(8, 8), vocab=32000,
                   seed=1)
#: the card's: the serving phases' engine shape and a cut of their load
SERVE_KW = dict(max_seqs=8, page_size=16, max_len=2048, prefill_chunk=512)
SERVE_LOAD = dict(n_requests=8, mean_interarrival=2.0,
                  prompt_len=(128, 1024), max_new=(16, 32), vocab=32000,
                  seed=0)


def tiny_config():
    from ..models import LlamaConfig

    return LlamaConfig(vocab_size=256, hidden_size=64,
                       intermediate_size=128, num_hidden_layers=2,
                       num_attention_heads=4, num_key_value_heads=2,
                       max_position_embeddings=128)


def build(name, device):
    """(config, params, engine kwargs, workload sorted by arrival) of
    setup ``name`` on ``device``."""
    from ..models import LlamaConfig, init_llama_params, params_to
    from .load import LoadSpec, generate_load

    device = torch.device(device)
    if name == "tiny":
        cfg = tiny_config()
        params = params_to(init_llama_params(cfg, seed=11, device="cpu"),
                           device=device)
        kw = dict(TINY_KW, dtype=torch.float32, device=device)
        load = TINY_LOAD
    elif name == "parity":
        cfg = LlamaConfig.llama2_7b(num_hidden_layers=2)
        params = init_llama_params(cfg, seed=0, device=device,
                                   dtype=torch.float32)
        kw = dict(PARITY_KW, dtype=torch.float32, device=device)
        load = PARITY_LOAD
    elif name == "7b":
        cfg = LlamaConfig.llama2_7b()
        params = init_llama_params(cfg, seed=0, device=device,
                                   dtype=torch.bfloat16)
        kw = dict(SERVE_KW, dtype=torch.bfloat16, device=device)
        load = SERVE_LOAD
    else:
        raise ValueError(f"config {name!r}: expected tiny|parity|7b")
    work = sorted(generate_load(LoadSpec(**load)),
                  key=lambda w: (w["arrival_tick"], w["rid"]))
    return cfg, params, kw, work


def serve(cl, work, max_ticks=400, log=None):
    """Submit each request at its arrival tick and step ``cl`` until it
    drains; ``log(cl)`` after every step.  Returns False when the fleet
    did not drain in ``max_ticks`` steps."""
    i = 0
    while i < len(work) or cl.in_flight:
        while i < len(work) and work[i]["arrival_tick"] <= cl.tick:
            w = work[i]
            i += 1
            cl.submit(w["prompt_ids"], max_new_tokens=w["max_new_tokens"],
                      rid=w["rid"])
        cl.step()
        if log is not None:
            log(cl)
        if cl.tick > max_ticks:
            return False
    return True


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("wal_dir")
    ap.add_argument("fault_spec", nargs="?", default="")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--config", default="tiny",
                    choices=("tiny", "parity", "7b"))
    args = ap.parse_args(argv)
    from ..inference.server import ServingCluster
    from . import faults

    cfg, params, kw, work = build(args.config, args.device)
    cl = ServingCluster(cfg, params, n_replicas=2, cluster=True,
                        wal=args.wal_dir, **kw)
    del params
    cl.wal.fsync_every = 1   # every record durable before the next step
    faults.reset(args.fault_spec)

    def log(c):
        # the parent reads this to pick its SIGKILL moment
        print(f"tick {c.tick} appended {c.wal.appended}", flush=True)

    if not serve(cl, work, log=log):
        print("STUCK", flush=True)
        return 2
    print("DRAINED", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
