"""Where does a ResNet train step's device time go, by kernel family?

``families(step, batch, steps=2)`` traces ``steps`` eager steps of a
``models.CompiledTrainStep`` over a vision model with ``torch.profiler``
and splits the device time of each step into:

- ``conv fwd``: kernels launched inside the port's ``conv2d`` (cuDNN);
- ``conv dgrad`` / ``conv wgrad``: kernels of the convolution's backward
  (the ``_Conv2dBackward`` node) whose names say ``dgrad`` / ``wgrad``,
  and ``conv bwd other`` for the rest of that node (kernels named
  neither, layout conversions);
- ``bn``: batch norm's statistics and elementwise passes, forward
  (``batch_norm_train``) and backward (``_BatchNormTrainBackward``);
- ``pools``: the max pool forward and backward and the adaptive average
  pool's forward (its backward, a broadcast divide, lands in ``other``);
- ``ce``: the softmax cross entropy forward and backward;
- ``adamw``: the update and the clipping norm;
- ``other``: the rest of the device time (ReLUs, residual adds, ``fc``'s
  GEMMs, the loss mean, casts).

Forward families are ``record_function`` ranges put around the port's
ops (``ops.nn_ops``) and the step's update for the traced steps only;
backward families are the autograd engine's ranges of each node.  A
range's device time is that of the kernels launched inside it.  The
profiler also draws each forward range on the device's timeline, from
its first kernel to its last: that span (``spans``) counts the device's
waits for the host inside the range, and is kept apart from the kernel
times.

    python3 -m paddle_tpu_torch.testing.vision_profile [batch]

traces ResNet-50 at bench.py's config 1 shape (B = 256 unless given,
224 x 224 bf16, bf16 compute, lr 0.1) after two warm-up steps, and
prints the families, the idle share, the 15 kernels with the most device
time and the card's name and power limit.  Needs the card.
"""
from __future__ import annotations

import contextlib
import subprocess
import sys
import time

import numpy as np
import torch

#: forward ranges: (family, the ``ops.nn_ops`` function wrapped)
FORWARD = (("conv fwd", "conv2d"), ("bn", "batch_norm_train"),
           ("pools", "max_pool2d"), ("pools", "adaptive_avg_pool2d"),
           ("ce", "softmax_with_cross_entropy"))
#: backward nodes: (family, the node's name)
BACKWARD = (("conv bwd", "_Conv2dBackward"),
            ("bn", "_BatchNormTrainBackward"),
            ("pools", "MaxPool2DWithIndicesBackward0"),
            ("ce", "_SoftmaxCrossEntropyBackward"))
FAMILIES = ("conv fwd", "conv dgrad", "conv wgrad", "conv bwd other", "bn",
            "pools", "ce", "adamw", "other")


def _ranged(label, fn):
    from torch.profiler import record_function

    def call(*args, **kwargs):
        with record_function(label):
            return fn(*args, **kwargs)
    return call


@contextlib.contextmanager
def _marked(step):
    """The forward ops and the step's update wrapped in ranges named
    ``vision::<family>``, put back on exit."""
    from ..ops import nn_ops

    with contextlib.ExitStack() as stack:
        for family, name in FORWARD:
            fn = getattr(nn_ops, name)
            setattr(nn_ops, name, _ranged(f"vision::{family}", fn))
            stack.callback(setattr, nn_ops, name, fn)
        for name in ("_update", "_global_norm"):
            setattr(step, name, _ranged("vision::adamw", getattr(step, name)))
            stack.callback(delattr, step, name)
        yield


def families(step, batch, steps=2):
    """Trace ``steps`` eager steps; returns ``(per_step, wall_ms, busy_ms,
    kernels, spans)``: device ms a step by family, the host wall and the
    device busy time a step, ``[(ms a step, launches, name)]`` of every
    kernel, longest first, and the device-timeline span a step of each
    forward range (``vision::<family>``)."""
    from torch.profiler import ProfilerActivity, profile

    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    torch.cuda.synchronize()
    with _marked(step), profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step.step(*batch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / steps
    fam = dict.fromkeys(FAMILIES + ("conv bwd",), 0.0)
    busy, kernels, named = 0.0, [], {"dgrad": 0.0, "wgrad": 0.0}
    spans = {}
    nodes = {f"autograd::engine::evaluate_function: {n}": f
             for f, n in BACKWARD}
    for ev in prof.key_averages():
        ms = ev.device_time_total / 1e3 / steps
        if ev.device_type == cpu:
            if ev.key.startswith("vision::"):
                fam[ev.key[8:]] += ms
            elif ev.key in nodes:
                fam[nodes[ev.key]] += ms
            continue
        if ev.device_type != cuda:
            continue
        if ev.key.startswith("vision::"):      # a range's device span
            spans[ev.key[8:]] = ev.self_device_time_total / 1e3 / steps
            continue
        own = ev.self_device_time_total / 1e3 / steps
        busy += own
        kernels.append((own, ev.count // steps, ev.key))
        for part in named:
            if part in ev.key.lower():
                named[part] += own
    # the dgrad / wgrad kernels run only in the conv's backward node
    fam["conv dgrad"], fam["conv wgrad"] = named["dgrad"], named["wgrad"]
    fam["conv bwd other"] = max(fam.pop("conv bwd") - named["dgrad"]
                                - named["wgrad"], 0.0)
    fam["other"] = max(busy - sum(v for k, v in fam.items()
                                  if k != "other"), 0.0)
    kernels.sort(key=lambda k: -k[0])
    return fam, wall, busy, kernels, spans


def report(tag, fam, wall, busy, kernels, spans, log=print, top=15):
    log(f"[{tag}] traced eager step: {wall:.1f} ms wall, device busy "
        f"{busy:.1f} ms, idle share {1 - busy / wall:.3f} | by family (ms a "
        f"step, share of busy): " + ", ".join(
            f"{k} {v:.2f} ({v / busy:.3f})" for k, v in fam.items()))
    log(f"[{tag}] device-timeline span a step of each forward range "
        f"(kernels and the waits for the host between them): " + ", ".join(
            f"{k} {v:.2f}" for k, v in spans.items()))
    for ms, calls, name in kernels[:top]:
        log(f"[{tag}]   {ms:9.3f} ms {calls:5d} launches  {name[:100]}")


def resnet50_step(device, batch=256, memory_format=torch.channels_last,
                  image=224, classes=1000, lr=0.1):
    """bench.py's config 1: resnet50 (1000 classes) in training mode,
    random weights from seed 0, its conv weights in ``memory_format``,
    bf16 compute, AdamW at lr 0.1 over cross entropy, and B seeded bf16
    images (224 px) with int labels."""
    from ..models import CompiledTrainStep
    from ..nn import functional as F
    from ..vision.models import resnet50

    model = resnet50(num_classes=classes, device=device, seed=0)
    model.to(memory_format=memory_format)
    model.train()
    step = CompiledTrainStep(model, lr=lr, compute_dtype="bfloat16",
                             loss_fn=F.cross_entropy, device=device)
    rng = np.random.RandomState(0)
    imgs = torch.as_tensor(rng.randn(batch, 3, image, image).astype(
        np.float32), device=device).to(torch.bfloat16)
    labels = torch.as_tensor(rng.randint(0, classes, (batch,)),
                             device=device)
    return step, (imgs, labels)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    device = torch.device("cuda", 0)
    step, batch = resnet50_step(device, int(argv[0]) if argv else 256)
    for _ in range(2):
        float(step.step(*batch))
    report("vision-profile", *families(step, batch))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
