"""The PyTorch port's DataLoader transports, A/B, at steady state.

BASELINE config 1's eager loop as ``chip_smoke.py`` phase 17 runs it:
ResNet-50 O1 (``auto_cast``, ``GradScaler``, ``Momentum`` with
``L2Decay(1e-4)``) at B = 256 and 224 px over
``DataLoader(num_workers=4, shuffle=True, drop_last=True)``.  The
dataset holds 768 seeded fp32 [3, 224, 224] images (462 MB) and is
indexed modulo 768 to an epoch of ``--batches`` batches (24 by
default), so that what a batch costs once the pool runs shows apart
from an epoch's first batch.  Each round runs one epoch with each
transport: the default collate (the batch comes back as CPU tensors
through shared memory) and a collate that returns numpy arrays (pickled
down the pool's pipe, as the reference's workers return them), in the
order pipe, shm, shm, pipe over two rounds.

Printed for each epoch: the first batch's wait (the pool's fork
included), then over the batches after the first ``--skip``: the median
and the 90th percentile of the time the training thread spends in the
loader (the wait, the move to the card, synchronised) and of the step,
and the epoch's images a second.  Needs the card:

    python3 tools/torch_loader_ab.py [--batches 24] [--skip 4]
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batches", type=int, default=24)
    ap.add_argument("--skip", type=int, default=4)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_loader_ab: needs a CUDA device", file=sys.stderr)
        return 2
    from paddle_tpu_torch import amp, io, optimizer
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.vision.models import resnet50

    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    B, n_img = 256, 768
    rng = np.random.default_rng(0)
    imgs = rng.standard_normal((n_img, 3, 224, 224), dtype=np.float32)
    labels = rng.integers(0, 1000, n_img, dtype=np.int64)

    class Cycled(io.Dataset):
        def __len__(self):
            return B * args.batches

        def __getitem__(self, i):
            return imgs[i % n_img], labels[i % n_img]

    model = resnet50(num_classes=1000, device=dev)
    model.train()
    opt = optimizer.Momentum(learning_rate=0.1, momentum=0.9,
                             parameters=model.parameters(),
                             weight_decay=optimizer.L2Decay(1e-4))
    scaler = amp.GradScaler()

    def step(x, y):
        with amp.auto_cast(level="O1", dtype="bfloat16"):
            loss = F.cross_entropy(model(x), y)
        scaler.scale(loss).backward()
        scaler.step(opt)
        scaler.update()
        opt.clear_grad()
        return float(loss.detach())

    # cuDNN's first calls, outside the epochs timed
    x0 = torch.as_tensor(imgs[:B], device=dev)
    y0 = torch.as_tensor(labels[:B], device=dev)
    for _ in range(2):
        step(x0, y0)
    del x0, y0

    def as_numpy(batch):
        return [t.numpy() for t in io.default_collate_fn(batch)]

    results = []
    for rnd, order in enumerate(((False, True), (True, False))):
        for shared in order:
            loader = io.DataLoader(Cycled(), batch_size=B, shuffle=True,
                                   drop_last=True, num_workers=4,
                                   collate_fn=None if shared else as_numpy,
                                   places=dev)
            np.random.seed(rnd)
            gets, steps = [], []
            t_epoch = time.perf_counter()
            it = iter(loader)
            while True:
                t0 = time.perf_counter()
                try:
                    x, y = next(it)
                except StopIteration:
                    break
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                step(x, y)
                t2 = time.perf_counter()
                gets.append((t1 - t0) * 1e3)
                steps.append((t2 - t1) * 1e3)
            wall = time.perf_counter() - t_epoch
            g, s = np.array(gets[args.skip:]), np.array(steps[args.skip:])
            row = {"round": rnd, "transport": "shm" if shared else "pipe",
                   "batches": len(gets), "first_batch_ms": gets[0],
                   "loader_ms_median": float(np.median(g)),
                   "loader_ms_p90": float(np.percentile(g, 90)),
                   "step_ms_median": float(np.median(s)),
                   "step_ms_p90": float(np.percentile(s, 90)),
                   "epoch_s": wall,
                   "imgs_per_s": B * len(gets) / wall}
            results.append(row)
            print(f"[loader-ab] round {rnd} "
                  f"{'shm (tensors)' if shared else 'pipe (numpy)'}: "
                  f"{len(gets)} batches, first {gets[0]:.1f} ms; batches "
                  f"{args.skip}+ in the loader median {row['loader_ms_median']:.1f}"
                  f" p90 {row['loader_ms_p90']:.1f} ms, step median "
                  f"{row['step_ms_median']:.1f} p90 {row['step_ms_p90']:.1f} "
                  f"ms; epoch {wall:.2f} s, {row['imgs_per_s']:.1f} imgs/s | "
                  f"{card}", flush=True)
            print(f"[loader-ab]   in the loader, ms: "
                  f"{[round(v, 1) for v in gets]}", flush=True)
            del loader, it
    print(json.dumps({"card": card, "epochs": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
