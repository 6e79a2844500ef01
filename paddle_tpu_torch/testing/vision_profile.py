"""Where does a vision or diffusion train step's device time go, by
kernel family?

``families(step, batch, steps=2)`` traces ``steps`` eager steps of a
``models.CompiledTrainStep`` over a ResNet with ``torch.profiler`` and
splits the device time of each step into:

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

``families(step, batch, plan=UNET)`` splits a UNet step (``unet_step``)
into ``group norm``, the four conv families, ``attention`` (the two
einsums and the softmax), ``linear`` (the Linear layers' GEMMs, bias
adds and the casts of bf16 weights up to the fp32 stream), ``adamw``
and ``other`` (SiLU, GELU, LayerNorm, residual adds, upsampling, the
loss, the conv biases).  Group norm, attention and linear are plain ops
with the library's backward: their backward is found by the autograd
sequence number of each backward node, which names the forward op
(inside the family's range) that made it.

Forward families are ``record_function`` ranges put around the port's
ops (``ops.nn_ops``, ``nn.Linear.forward``) and the step's update for
the traced steps only; backward families are the autograd engine's
ranges of each node.  A range's device time is that of the kernels
launched inside it.  The profiler also draws each forward range on the
device's timeline, from its first kernel to its last: that span
(``spans``) counts the device's waits for the host inside the range,
and is kept apart from the kernel times.

    python3 -m paddle_tpu_torch.testing.vision_profile [batch]
    python3 -m paddle_tpu_torch.testing.vision_profile unet [batch [latent]]

traces ResNet-50 at bench.py's config 1 shape (B = 256 unless given,
224 x 224 bf16, bf16 compute, lr 0.1), or the SD v1.5 UNet at config 5's
(B = 4, 32 x 32 latents unless given), after two warm-up steps, and
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

#: the ResNet's families.  ``forward``: (family, the ``ops.nn_ops``
#: function wrapped in its range); ``backward``: (family, the backward
#: node's name); ``by_sequence``: families whose backward nodes are found
#: by the forward op that made them; ``layers``: (family, a layer class
#: of ``nn`` whose ``forward`` is wrapped)
RESNET = {
    "forward": (("conv fwd", "conv2d"), ("bn", "batch_norm_train"),
                ("pools", "max_pool2d"), ("pools", "adaptive_avg_pool2d"),
                ("ce", "softmax_with_cross_entropy")),
    "backward": (("conv bwd", "_Conv2dBackward"),
                 ("bn", "_BatchNormTrainBackward"),
                 ("pools", "MaxPool2DWithIndicesBackward0"),
                 ("ce", "_SoftmaxCrossEntropyBackward")),
    "by_sequence": (), "layers": (),
    "families": ("conv fwd", "conv dgrad", "conv wgrad", "conv bwd other",
                 "bn", "pools", "ce", "adamw", "other")}
#: the UNet's families
UNET = {
    "forward": (("group norm", "group_norm"), ("conv fwd", "conv2d"),
                ("attention", "einsum"), ("attention", "softmax")),
    "backward": (("conv bwd", "_Conv2dBackward"),),
    "by_sequence": ("group norm", "attention", "linear"),
    "layers": (("linear", "Linear"),),
    "families": ("group norm", "conv fwd", "conv dgrad", "conv wgrad",
                 "conv bwd other", "attention", "linear", "adamw",
                 "other")}


def _ranged(label, fn):
    from torch.profiler import record_function

    def call(*args, **kwargs):
        with record_function(label):
            return fn(*args, **kwargs)
    return call


@contextlib.contextmanager
def _marked(step, plan):
    """The forward ops, the layers' ``forward`` and the step's update
    wrapped in ranges named ``vision::<family>``, put back on exit."""
    from .. import nn
    from ..ops import nn_ops

    with contextlib.ExitStack() as stack:
        for family, name in plan["forward"]:
            fn = getattr(nn_ops, name)
            setattr(nn_ops, name, _ranged(f"vision::{family}", fn))
            stack.callback(setattr, nn_ops, name, fn)
        for family, name in plan["layers"]:
            cls = getattr(nn, name)
            fn = cls.forward
            cls.forward = _ranged(f"vision::{family}", fn)
            stack.callback(setattr, cls, "forward", fn)
        for name in ("_update", "_global_norm"):
            setattr(step, name, _ranged("vision::adamw", getattr(step, name)))
            stack.callback(delattr, step, name)
        yield


def _family_of(ev):
    """The family of the innermost ``vision::`` range around a CPU event,
    or None."""
    p = ev.cpu_parent
    while p is not None:
        if p.name.startswith("vision::"):
            return p.name[8:]
        p = p.cpu_parent
    return None


def backward_by_sequence(events, wanted):
    """{family: device ms} of the backward nodes made by forward ops inside
    a ``vision::<family>`` range, for the families in ``wanted``.  A
    backward node's autograd engine range carries the sequence number of
    the forward op that recorded it."""
    seq = {}
    for ev in events:
        if ev.sequence_nr >= 0 and not ev.name.startswith("autograd::"):
            family = _family_of(ev)
            if family in wanted:
                seq.setdefault(ev.sequence_nr, family)
    out = dict.fromkeys(wanted, 0.0)
    for ev in events:
        if ev.name.startswith("autograd::engine::evaluate_function: ") \
                and ev.sequence_nr in seq:
            out[seq[ev.sequence_nr]] += ev.device_time_total / 1e3
    return out


def families(step, batch, steps=2, plan=RESNET):
    """Trace ``steps`` eager steps; returns ``(per_step, wall_ms, busy_ms,
    kernels, spans)``: device ms a step by family (and ``<family> bwd``,
    the backward's share, for the families of ``plan["by_sequence"]``),
    the host wall and the device busy time a step, ``[(ms a step,
    launches, name)]`` of every kernel, longest first, and the
    device-timeline span a step of each forward range
    (``vision::<family>``)."""
    from torch.profiler import ProfilerActivity, profile

    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    torch.cuda.synchronize()
    with _marked(step, plan), profile(activities=[
            ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step.step(*batch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / steps
    fam = dict.fromkeys(plan["families"] + ("conv bwd",), 0.0)
    busy, kernels, named = 0.0, [], {"dgrad": 0.0, "wgrad": 0.0}
    spans = {}
    nodes = {f"autograd::engine::evaluate_function: {n}": f
             for f, n in plan["backward"]}
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
    bwd = backward_by_sequence(prof.events(), plan["by_sequence"])
    for family, ms in bwd.items():
        fam[family] += ms / steps
        fam[f"{family} bwd"] = ms / steps
    # the dgrad / wgrad kernels run only in the conv's backward node
    fam["conv dgrad"], fam["conv wgrad"] = named["dgrad"], named["wgrad"]
    fam["conv bwd other"] = max(fam.pop("conv bwd") - named["dgrad"]
                                - named["wgrad"], 0.0)
    fam["other"] = max(busy - sum(v for k, v in fam.items()
                                  if k != "other"
                                  and not k.endswith(" bwd")), 0.0)
    kernels.sort(key=lambda k: -k[0])
    return fam, wall, busy, kernels, spans


def report(tag, fam, wall, busy, kernels, spans, log=print, top=15):
    log(f"[{tag}] traced eager step: {wall:.1f} ms wall, device busy "
        f"{busy:.1f} ms, idle share {1 - busy / wall:.3f} | by family (ms a "
        f"step, share of busy; a family's backward part beside it): "
        + ", ".join(f"{k} {v:.2f} ({v / busy:.3f})" for k, v in fam.items()))
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


class UNetTrain(torch.nn.Module):
    """bench.py's ``UNetTrain`` (``_bench_unet``): the MSE of the UNet's
    predicted noise."""

    def __init__(self, unet):
        super().__init__()
        self.unet = unet

    def forward(self, latents, t, ctx, noise):
        pred = self.unet(latents, t, ctx)
        return ((pred - noise) ** 2).mean()


def unet_step(device, batch=4, latent=32, seed=0, unet=None):
    """bench.py's config 5: ``UNet2DConditionModel()`` (SD v1.5's widths,
    random weights from ``seed``; or the given ``unet``) under
    ``UNetTrain``, ``CompiledTrainStep(lr=1e-4, compute_dtype=
    "bfloat16", moments_dtype="bfloat16")``, and the batch bench.py draws
    from ``RandomState(0)``: latents ``[B, 4, latent, latent]`` fp32, int32
    timesteps in [0, 1000), a ``[B, 77, 768]`` fp32 text context (the
    model's cross-attention width) and fp32 noise, on ``device``."""
    from ..models import CompiledTrainStep, UNet2DConditionModel

    unet = unet or UNet2DConditionModel(device=device, seed=seed)
    model = UNetTrain(unet)
    step = CompiledTrainStep(model, lr=1e-4, compute_dtype="bfloat16",
                             moments_dtype="bfloat16", device=device)
    ctx_dim = unet.mid_attn.attn2.to_k.weight.shape[0]
    rng = np.random.RandomState(0)
    arrays = (rng.randn(batch, 4, latent, latent).astype(np.float32),
              rng.randint(0, 1000, (batch,)).astype(np.int32),
              rng.randn(batch, 77, ctx_dim).astype(np.float32),
              rng.randn(batch, 4, latent, latent).astype(np.float32))
    return step, tuple(torch.as_tensor(a, device=device) for a in arrays)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    device = torch.device("cuda", 0)
    if argv and argv[0] == "unet":
        dims = [int(a) for a in argv[1:3]]
        step, batch = unet_step(device, *dims)
        plan = UNET
    else:
        step, batch = resnet50_step(device, int(argv[0]) if argv else 256)
        plan = RESNET
    for _ in range(2):
        float(step.step(*batch))
    report("vision-profile", *families(step, batch, plan=plan))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
