"""What does the train step's AdamW update cost, and which part of it?

Times ``CompiledTrainStep._update`` (the one body that ``step``,
``multi_step`` and ``guarded_step`` run: per tensor, fp32 device scalars,
every write gated by ``torch.where`` on a device bool) on random
gradients, beside two ungated versions of the same arithmetic: with the
same device scalars (what the gate costs) and with host floats (the
per-tensor loop of the port before ``multi_step``: what the device
scalars cost), each alone with CUDA events, five times, and once more
replayed from a CUDA graph.  Two parameter sets: chip_smoke's phase 6
(Llama-2-7B width cut to 8 layers, bf16 compute, fp32 master, bf16
moments) and phase 8 (BERT-base QA, bf16 compute, fp32 master and
moments).  Prints the card's name and power limit last.

    python3 -m paddle_tpu_torch.testing.update_variants

Needs the card.
"""
from __future__ import annotations

import subprocess
import sys

import numpy as np
import torch


def _ungated(step, grads, scale, t, lr, host):
    """The update's arithmetic written in place with no gate; ``host``
    takes the step count and the learning rate as host floats."""
    beta1, beta2, eps, wd = step._hyper
    if host:
        t, lr = float(t), float(lr)
        c1, c2 = 1 - beta1 ** t, 1 - beta2 ** t
        decay = float(np.float32(1) - np.float32(lr) * np.float32(wd))
    else:
        c = step._coefficients(t, lr)
        c1, c2, decay = c["c1"], c["c2"], c["decay"]
    for k, p in step.params.items():
        g = grads[k] * scale.to(grads[k].dtype)
        g = g.float()
        mk = beta1 * step._m[k].float() + (1 - beta1) * g
        vk = beta2 * step._v[k].float() + (1 - beta2) * g * g
        upd = lr * (mk / c1)
        upd /= torch.sqrt(vk / c2) + eps
        w = step._master[k]
        if not step._no_decay(k):
            w.mul_(decay)
        w.sub_(upd)
        p.copy_(w)
        step._m[k].copy_(mk)
        step._v[k].copy_(vk)


def _llama(device):
    from paddle_tpu_torch.models import (
        CompiledTrainStep, LlamaConfig, LlamaForCausalLM,
    )

    cfg = LlamaConfig.llama2_7b(num_hidden_layers=8, recompute=True)
    model = LlamaForCausalLM(cfg, device=device, seed=0)
    return CompiledTrainStep(model, lr=1e-4, compute_dtype="bfloat16",
                             moments_dtype="bfloat16", device=device)


def _bert(device):
    from paddle_tpu_torch.models import (
        BertConfig, BertForQuestionAnswering, CompiledTrainStep,
    )

    model = BertForQuestionAnswering(BertConfig.base(), device=device,
                                     seed=0)
    return CompiledTrainStep(model, lr=3e-5, compute_dtype="bfloat16",
                             device=device)


def _ms(fn, reps=5):
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    out = []
    for _ in range(reps):
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        out.append(e0.elapsed_time(e1))
    return out


def run(tag, build, device):
    step = build(device)
    gen = torch.Generator(device=device).manual_seed(0)
    grads = {k: torch.randn(p.shape, device=device, generator=gen)
             .mul_(1e-3).to(p.dtype) for k, p in step.params.items()}
    n = sum(p.numel() for p in step.params.values())
    t, lr = step._scalar(3), step._scalar(1e-4)
    scale = step._scalar(0.5)
    variants = {
        "gated, device scalars (the step's body)":
            lambda: step._update(grads, scale, t, lr, step._live),
        "ungated, device scalars":
            lambda: _ungated(step, grads, scale, t, lr, host=False),
        "ungated, host floats (the loop before multi_step)":
            lambda: _ungated(step, grads, scale, 3, 1e-4, host=True),
    }
    with torch.no_grad():
        for name, fn in variants.items():
            ms = _ms(fn)
            print(f"[update] {tag} ({len(grads)} tensors, {n / 1e9:.4f} B "
                  f"parameters): {name}: ms {', '.join(f'{m:.2f}' for m in ms)}",
                  flush=True)
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            variants["gated, device scalars (the step's body)"]()
        torch.cuda.current_stream(device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            step._update(grads, scale, t, lr, step._live)
        ms = _ms(graph.replay)
        print(f"[update] {tag}: the step's body replayed from a CUDA graph: "
              f"ms {', '.join(f'{m:.2f}' for m in ms)}", flush=True)
    del graph, step, grads


def main():
    device = torch.device("cuda", 0)
    for tag, build in (("llama 8 layers", _llama), ("bert-base", _bert)):
        run(tag, build, device)
        torch.cuda.empty_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
