"""Where does a train step's time go, eager and replayed?

Runs two of chip_smoke's training configurations through
``CompiledTrainStep`` of the ``paddle_tpu_torch`` found on ``sys.path``
first: phase 6's (Llama-2-7B width cut to 8 layers, B=4, S=2048, bf16
compute, fp32 master, bf16 moments, full recompute, the fused RMSNorm)
and phase 8's (BERT-base QA, B=48, S=384, bf16 compute, fp32 master and
moments, dropout 0.1).  For each: two warm-up steps, the host wall of
four untraced eager steps (synchronised), one eager step traced with
torch.profiler with the update and the clipping norm marked as one range
(the device time of the kernels launched under it) and the 12 kernels
with the most device time; then, where the tree has ``multi_step``, the
ms per step of two replays of ``multi_step(4)`` after its capture, and
one traced replay's device busy time.  Run it from the root of one tree
and then of another (``python3 path/to/train_profile.py`` with the other
tree as the working directory, which comes first on ``sys.path``) to
hold two versions of the step in one call.  Prints the card's name and
power limit last.

    python3 -m paddle_tpu_torch.testing.train_profile [llama] [bert]

Needs the card and ``nvcc``.
"""
from __future__ import annotations

import gc
import os
import subprocess
import sys
import time

import numpy as np
import torch


def _llama(device):
    from paddle_tpu_torch.core.flags import set_flags
    from paddle_tpu_torch.models import (
        CompiledTrainStep, LlamaConfig, LlamaForCausalLM,
    )

    set_flags({"FLAGS_use_fused_rms_norm": True})
    cfg = LlamaConfig.llama2_7b(num_hidden_layers=8, recompute=True,
                                recompute_policy="full",
                                attention_impl="auto")
    model = LlamaForCausalLM(cfg, device=device, seed=0)
    step = CompiledTrainStep(model, lr=1e-4, compute_dtype="bfloat16",
                             moments_dtype="bfloat16", device=device)
    ids = torch.as_tensor(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (4, 2048)), device=device)
    return step, (ids, ids)


class _QA(torch.nn.Module):
    """``(ids, starts, ends) -> loss`` over BERT's QA head."""

    def __init__(self, cfg, device):
        super().__init__()
        from paddle_tpu_torch.models import BertForQuestionAnswering

        self.qa = BertForQuestionAnswering(cfg, device=device, seed=0)

    def forward(self, ids, starts, ends):
        return self.qa(ids, start_positions=starts, end_positions=ends)


def _bert(device):
    from paddle_tpu_torch.models import BertConfig, CompiledTrainStep

    cfg = BertConfig.base()
    model = _QA(cfg, device)
    model.train()
    step = CompiledTrainStep(model, lr=3e-5, compute_dtype="bfloat16",
                             device=device)
    rng = np.random.RandomState(0)
    B, S = 48, 384
    arrays = (rng.randint(0, cfg.vocab_size, (B, S)),
              rng.randint(0, S, (B,)), rng.randint(0, S, (B,)))
    return step, tuple(torch.as_tensor(a.astype(np.int32), device=device)
                       for a in arrays)


def _busy(prof):
    """Device busy ms of a trace and its kernels [(ms, calls, name)]."""
    busy, rows = 0.0, []
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA \
                or ev.key == "train::update":
            continue
        busy += ev.self_device_time_total / 1e3
        rows.append((ev.self_device_time_total / 1e3, ev.count, ev.key[:80]))
    return busy, rows


def profile(tag, build, device):
    from torch.profiler import ProfilerActivity, profile as trace
    from torch.profiler import record_function

    tree = os.getcwd()
    step, batch = build(device)
    for _ in range(2):
        float(step.step(*batch))
    walls = []
    for _ in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        float(step.step(*batch))
        walls.append((time.perf_counter() - t0) * 1e3)

    def ranged(fn):
        def call(*args, **kwargs):
            with record_function("train::update"):
                return fn(*args, **kwargs)
        return call

    # the clipping norm counts with the update (its own method in a tree
    # that has one, inside ``_update`` otherwise)
    names = [n for n in ("_update", "_global_norm") if hasattr(step, n)]
    for name in names:
        setattr(step, name, ranged(getattr(step, name)))
    torch.cuda.synchronize()
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with trace(activities=acts) as prof:
        t0 = time.perf_counter()
        float(step.step(*batch))
        wall = (time.perf_counter() - t0) * 1e3
    update_ms = float("nan")
    for ev in prof.key_averages():
        if ev.key == "train::update" and \
                ev.device_type == torch.autograd.DeviceType.CPU:
            update_ms = ev.device_time_total / 1e3
    busy, rows = _busy(prof)
    for name in names:
        delattr(step, name)
    print(f"[{tree}] {tag} eager: untraced step ms "
          f"{', '.join(f'{w:.1f}' for w in walls)} | traced {wall:.1f} ms, "
          f"device busy {busy:.1f}, update {update_ms:.1f}", flush=True)
    for ms, calls, name in sorted(rows, reverse=True)[:12]:
        print(f"[{tree}]   {ms:9.2f} ms {calls:6d}  {name}", flush=True)
    try:
        step.multi_step(4, *batch)
    except NotImplementedError as e:
        print(f"[{tree}] {tag} multi_step: {e}", flush=True)
    else:
        replays = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            float(step.multi_step(4, *batch))
            replays.append((time.perf_counter() - t0) * 1e3 / 4)
        torch.cuda.synchronize()
        with trace(activities=acts) as prof:
            t0 = time.perf_counter()
            float(step.multi_step(4, *batch))
            wall = (time.perf_counter() - t0) * 1e3 / 4
        busy = _busy(prof)[0] / 4
        print(f"[{tree}] {tag} multi_step(4) replayed: ms a step "
              f"{', '.join(f'{w:.1f}' for w in replays)} | traced "
              f"{wall:.1f} ms a step, device busy {busy:.1f}, idle share "
              f"{1 - busy / wall:.3f}", flush=True)
    del step, batch
    gc.collect()
    torch.cuda.empty_cache()


def main(argv=None):
    sys.path.insert(0, os.getcwd())
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", 0)
    which = (argv if argv is not None else sys.argv[1:]) or ["llama", "bert"]
    builds = {"llama": _llama, "bert": _bert}
    for tag in which:
        profile(tag, builds[tag], device)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
