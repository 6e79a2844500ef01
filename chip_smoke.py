"""Smoke run of the PyTorch port on one NVIDIA GPU (written for the H100).

    python3 chip_smoke.py

Phases, each fatal on failure (the script exits non-zero and prints no
result):

1. device  — name and power limit; TF32 off for matmuls and cuDNN, so
             fp32 means fp32 in every comparison below.
2. build   — every kernel under paddle_tpu_torch/csrc, one nvcc each,
             all started together; registers, shared memory and spills
             of every kernel as ptxas reports them.
3. kernels — each kernel against its plain PyTorch version on the same
             CUDA tensors, at the shapes the serving and training paths
             give it (and at S=1024, in fp32, and with fused RoPE for
             attention), then its time (CUDA events, L2 flushed before
             each launch) beside its bound, the plain version's time and
             one library call's.
3c. quant kernels — the int8-weight matmul at every Llama-2-7B
             projection shape for M = 8 (decode) and M = 512 (prefill),
             bf16 and f32 x, and paged decode over int8 pages at the
             decode shapes of 3, each against its plain version, then
             timed as in 3.
3e. short kernels — short-sequence attention forward (out, its fp32
             copy, lse) and backward against the plain version at the
             BERT-base shape [48, 12, 384, 64] bf16 with p = 0.1 and 0,
             [4, 12, 384, 64] fp32, Llama's [4, 32, 512, 128] bf16 causal
             and the edges S = 1024 and S = 128; then the dropout mask
             itself (S = D = 128, p = 0.5, v = I and g = I: the zero
             patterns of out and dv equal the plain version's exactly);
             timed at the BERT shape beside the bound, the plain version
             and SDPA with dropout.
4. serve   — Llama-2-7B at full width and depth in bf16, random weights
             from seed 0 made on the card, 16 seeded requests through
             ServingEngine (8 slots, 16-token pages, 2048-token window,
             512-token prefill chunks).  Every request must finish, and
             the kernel must have launched once per layer per decode step.
             4b profiles decode steps with torch.profiler.
4c. int8 serve — the same model and load with quant="int8": every
             request finishes, paged_decode_quant launches once per layer
             per decode step, quant_matmul 7 times per layer per forward
             (decode steps + prefill forwards), the bf16 paged_decode
             never; 4d profiles its decode steps.
5. parity  — the same model cut to 2 layers, in fp32: 4 requests on the
             card (the kernels) and on the CPU (the plain versions) must
             give identical greedy streams and first-token logits within
             atol 1e-3, plain (5) and with quant="int8" (5b).
6. train   — Llama-2-7B width cut to 8 layers (the only cut: 32 layers of
             fp32 master plus bf16 moments would not fit 80 GB), B=4,
             S=2048, bf16 compute, fp32 master, bf16 moments, full
             recompute, FLAGS_use_fused_rms_norm, lr 1e-4: one warm-up
             step and 5 timed steps through CompiledTrainStep.  Losses
             must be finite and fall; each kernel must launch exactly as
             often per step as full recompute implies.  6b profiles one
             step with torch.profiler.
6c. train S=512 — Llama-2-7B width x 2 layers at B=4, S=512 (the short
             kernel's causal region), full recompute: 2 timed steps with
             exactly 2L forward and L backward short-attention launches
             per step and none of the long kernel.
7. train parity — 2 layers at a narrow width that still takes the
             attention kernel (S=1024, D=128, H == KV), fp32: 3 steps on
             the card (kernels) and on the CPU (plain versions) from the
             same weights give losses within 1e-4 relative.
8. bert train — BERT-base SQuAD fine-tuning as bench.py's BASELINE
             config 2 sets it: BertForQuestionAnswering(BertConfig.base())
             at full width and depth, B=48, S=384, bf16 compute, fp32
             master and moments, lr 3e-5, remat off, dropout 0.1 / 0.1,
             ids and spans from RandomState(0): one warm-up step and 5
             timed ones, every loss finite, exactly 12 forward and 12
             backward short-attention launches per step and no long ones.
             8b profiles one step with torch.profiler.
9. bert parity — 2 layers, hidden 256, 4 heads (D = 64), S = 256, B = 2,
             fp32, dropout 0: 3 steps on the card (the short kernel) and
             on the CPU (the einsum path) from the same weights give
             losses within 1e-4 relative.

The line before the last is one JSON object with a row per kernel; the
last line is {"ok": true, "device": {...}}.  Imports nothing of JAX or
of paddle_tpu.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
FP32_FLOPS = 67e12             # H100 SXM fp32 outside the tensor cores
BF16_FLOPS = 989e12            # H100 SXM bf16 tensor cores, dense


def log(*a):
    print(*a, flush=True)


# -- phase 1 -----------------------------------------------------------------

def phase_device():
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    limit = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 \
        else f"nvidia-smi failed: {smi.stderr.strip()}"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[device] {name} | {limit} | torch {torch.__version__} "
        f"cuda {torch.version.cuda} | TF32 off for matmul and cuDNN")
    return name, limit


# -- phase 2 -----------------------------------------------------------------

def phase_build():
    from paddle_tpu_torch.ops.kernels import _build

    t0 = time.perf_counter()
    info = _build.build_all()
    wall = time.perf_counter() - t0
    for name, rec in info.items():
        entries = _ptxas_entries(rec["log"])
        log(f"[build] {name}: {rec['seconds']:.1f} s; {len(entries)} "
            f"kernel instantiations; max registers "
            f"{max((e['regs'] for e in entries), default=None)}; "
            f"spilling instantiations "
            f"{sum(1 for e in entries if e['spill'])}")
        for e in entries:
            log(f"[build]   {e['name']}: {e['regs']} registers, "
                f"{e['smem']} bytes static shared memory, spill stores/"
                f"loads {e['spill_st']}/{e['spill_ld']} bytes")
    log(f"[build] all kernels in {wall:.1f} s")
    from paddle_tpu_torch.ops.kernels import long_attention, rms_norm

    log(f"[build] dynamic shared memory per block: "
        f"{long_attention.smem_bytes()} (long_attention), "
        f"{rms_norm.smem_bytes(4096)} (rms_norm at h=4096)")


def _ptxas_entries(text):
    """One record per kernel instantiation from ``nvcc -Xptxas -v``."""
    import re

    out, cur = [], None
    for ln in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            # <len><name>_kernel<template args>Ev: keep name and args
            short = re.search(r"\d((?:attn|sattn|rms_norm|paged_decode|qmm)"
                              r"\w*?_kernel)(I\w*?E)?E", m.group(1))
            cur = {"name": (short.group(1) + (short.group(2) or ""))
                   if short else m.group(1),
                   "regs": None, "smem": 0, "spill_st": 0, "spill_ld": 0,
                   "spill": False}
            out.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if m:
            cur["spill_st"], cur["spill_ld"] = int(m[1]), int(m[2])
            cur["spill"] = cur["spill_st"] + cur["spill_ld"] > 0
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            cur["regs"] = int(m[1])
            m = re.search(r"(\d+) bytes smem", ln)
            cur["smem"] = int(m[1]) if m else 0
    return out


# -- phase 3 -----------------------------------------------------------------

def _flush_l2(buf):
    buf.zero_()


def time_ms(fn, flush, iters=50, warmup=5):
    """Mean milliseconds of ``fn`` over ``iters`` launches, each timed by
    its own CUDA events after an L2 flush (the serving loop finds the
    layer's pool cold: the other 31 layers ran in between)."""
    for _ in range(warmup):
        fn()
    total = 0.0
    for _ in range(iters):
        _flush_l2(flush)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        total += e0.elapsed_time(e1)
    return total / iters


BF16_WHY = "bf16 output: the two fp32 results may round to neighbouring " \
    "bf16 values, one ulp <= 2^-7 |want|"


def _hold(label, got, want, atol, rtol, why):
    """Fail unless ``got`` (a kernel's output) is finite, has ``want``'s
    dtype and shape, and |got - want| <= atol + rtol * |want| everywhere.
    Returns the largest absolute error."""
    if got.dtype != want.dtype or got.shape != want.shape:
        raise AssertionError(f"[kernels] {label}: got {got.dtype} "
                             f"{tuple(got.shape)}, want {want.dtype} "
                             f"{tuple(want.shape)}")
    if not torch.isfinite(got).all():
        raise AssertionError(f"[kernels] {label}: non-finite output")
    diff = (got.float() - want.float()).abs()
    err = diff.max().item()
    over = (diff - (atol + rtol * want.float().abs())).max().item()
    log(f"[kernels] {label}: max_abs_err {err:.3e} (atol {atol:g} + rtol "
        f"{rtol:g} * |want|: {why})")
    if not over <= 0:
        raise AssertionError(f"[kernels] {label}: max_abs_err {err}, "
                             f"{over} over atol {atol} + rtol {rtol} * "
                             "|want|")
    return err


def make_paged_case(gen, B, KV, G, D, ps, pps, lengths, q_dtype, kv_dtype,
                    device):
    """Pool with one distinct page per (sequence, window slot) plus one
    NaN page that every slot past a sequence's cover points at; the
    unwritten tail of each last page is NaN too."""
    P = B * pps + 1
    nan_page = P - 1
    kp = torch.randn(KV, P, ps, D, generator=gen, device=device)
    vp = torch.randn(KV, P, ps, D, generator=gen, device=device)
    table = torch.arange(B * pps, device=device,
                         dtype=torch.int32).reshape(B, pps)
    for b, n in enumerate(lengths):
        cover = -(-n // ps)
        table[b, cover:] = nan_page
        last = int(table[b, cover - 1])
        if n % ps:
            kp[:, last, n % ps:] = float("nan")
            vp[:, last, n % ps:] = float("nan")
    kp[:, nan_page] = float("nan")
    vp[:, nan_page] = float("nan")
    q = torch.randn(B, KV * G, D, generator=gen, device=device)
    lens = torch.tensor(lengths, dtype=torch.int32, device=device)
    return (q.to(q_dtype), kp.to(kv_dtype), vp.to(kv_dtype), lens, table)


def paged_decode_bound(q, k_pages, lengths, page_indices):
    """(bound_ms, bound_by): bytes that must move — K and V rows under
    each length, the table entries of the covering pages, lengths, q in,
    out — over HBM rate, against 4 flops per (query row, token, dim)
    over the fp32 rate the kernel computes at."""
    B, H, D = q.shape
    KV, _, ps, _ = k_pages.shape
    lens = [int(x) for x in lengths.cpu()]
    tokens = sum(lens)
    nbytes = (2 * tokens * KV * D * k_pages.element_size()
              + sum(-(-n // ps) for n in lens) * 4 + B * 4
              + 2 * q.numel() * q.element_size())
    flops = 4 * tokens * H * D
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_kernels(device):
    from paddle_tpu_torch.ops.kernels import paged_decode as pdmod

    gen = torch.Generator(device=device)
    gen.manual_seed(1234)
    f32, bf16 = torch.float32, torch.bfloat16
    # ragged lengths: 1 token, mid-page, the full 2048 window, and more
    l7b = [1, 8, 2048, 17, 500, 1024, 1999, 333]
    # (label, shape, (q dtype, pool dtype), atol, rtol, reason); an
    # element passes when |got - want| <= atol + rtol * |want|
    cases = [
        ("llama2-7b serving (q f32, pool bf16)",
         dict(B=8, KV=32, G=1, D=128, ps=16, pps=128, lengths=l7b),
         (f32, bf16), 2e-5, 0.0, "fp32 math on bf16-exact values, other "
         "summation order"),
        ("llama2-7b fp32", dict(B=8, KV=32, G=1, D=128, ps=16, pps=128,
                                lengths=l7b),
         (f32, f32), 2e-5, 0.0, "fp32 throughout, other summation order"),
        ("llama2-7b bf16", dict(B=8, KV=32, G=1, D=128, ps=16, pps=128,
                                lengths=l7b),
         (bf16, bf16), 1e-4, 2 ** -7, BF16_WHY),
        ("gqa G=4 D=128", dict(B=4, KV=8, G=4, D=128, ps=16, pps=128,
                               lengths=[2048, 1, 40, 777]),
         (f32, bf16), 2e-5, 0.0, "fp32 math, other summation order"),
        ("gqa G=2 D=64", dict(B=3, KV=4, G=2, D=64, ps=16, pps=32,
                              lengths=[512, 9, 100]),
         (f32, f32), 2e-5, 0.0, "fp32 throughout, other summation order"),
    ]
    main_row = None
    for label, shape, (qd, kd), atol, rtol, why in cases:
        args = make_paged_case(gen, q_dtype=qd, kv_dtype=kd, device=device,
                               **shape)
        got = pdmod.paged_decode(*args)
        torch.cuda.synchronize()
        want = pdmod.paged_decode_reference(*args)
        # a non-finite output would mean NaN pages leaked in
        err = _hold(f"paged_decode {label}", got, want, atol, rtol, why)
        if main_row is None:
            main_row = (args, err)

    # timing at the serving path's shapes and dtypes
    args, err = main_row
    q, kp, vp, lens, table = args
    flush = torch.empty(256 * 1024 * 1024, dtype=torch.uint8,
                        device=device)
    before = pdmod.paged_decode.launches
    ms = time_ms(lambda: pdmod.paged_decode(*args), flush)
    plain_ms = time_ms(lambda: pdmod.paged_decode_reference(*args), flush)
    # library yardstick: SDPA over the dense cache ALREADY gathered
    # (the gather is excluded), bf16 q, boolean length mask
    B, H, D = q.shape
    T = table.shape[1] * kp.shape[2]
    kd = kp[:, table.long()].transpose(0, 1).reshape(B, -1, T, D)
    vd = vp[:, table.long()].transpose(0, 1).reshape(B, -1, T, D)
    valid = torch.arange(T, device=device)[None] < lens[:, None]
    kd = torch.where(valid[:, None, :, None], kd, 0)
    vd = torch.where(valid[:, None, :, None], vd, 0)
    qs = q.to(kd.dtype)[:, :, None]
    mask = valid[:, None, None, :]
    F = torch.nn.functional
    library_ms = time_ms(
        lambda: F.scaled_dot_product_attention(qs, kd, vd, attn_mask=mask),
        flush)
    pdmod.paged_decode.launches = before   # timing launches do not count
    bound_ms, bound_by = paged_decode_bound(q, kp, lens, table)
    log(f"[kernels] paged_decode time at B=8 KV=32 D=128 ps=16 pps=128, "
        f"lengths {[int(x) for x in lens.cpu()]}, q f32 / pool bf16: "
        f"kernel {ms:.4f} ms | bound {bound_ms:.4f} ms ({bound_by}: "
        f"K/V read over {HBM_BYTES_PER_S / 1e12:g} TB/s) | plain "
        f"{plain_ms:.4f} ms | library_ms {library_ms:.4f} ms "
        f"(scaled_dot_product_attention, bf16, over the gathered dense "
        f"cache, gather excluded) | {100 * bound_ms / ms:.1f}% of bound")
    del flush, kd, vd
    return {"name": "paged_decode", "route": "cuda",
            "source": "paddle_tpu_torch/csrc/paged_decode.cu",
            "replaces": "paddle_tpu/ops/pallas_kernels/paged_decode.py:118",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms}


# -- phase 3b: the training kernels -------------------------------------------

TRAIN_SHAPE = dict(B=4, H=32, S=2048, D=128, h=4096)
def rms_norm_bounds(N, h, x_bytes, w_bytes):
    """(fwd, bwd) (bound_ms, bound_by): each input read once, each output
    written once, over HBM rate, against ~4 flops per element (fwd) and
    ~8 (bwd) over the fp32 rate."""
    fwd_b = 2 * N * h * x_bytes + h * w_bytes + 4 * N
    bwd_b = 3 * N * h * x_bytes + h * w_bytes + 4 * N
    out = []
    for nbytes, flops in ((fwd_b, 4 * N * h), (bwd_b, 8 * N * h)):
        tb = nbytes / HBM_BYTES_PER_S * 1e3
        to = flops / FP32_FLOPS * 1e3
        out.append((tb, "bytes") if tb >= to else (to, "operations"))
    return out


def attention_bounds(B, H, S, D, elem_bytes, causal=True):
    """(fwd, bwd) (bound_ms, bound_by): the multiply-adds of the causal
    (i, j <= i) pairs, two products forward and five backward, over the
    bf16 tensor-core rate (fp32 inputs: the fp32 rate), against q, k, v,
    out (and g, dq, dk, dv) moved once over HBM rate."""
    pairs = S * (S + 1) // 2 if causal else S * S
    rate = BF16_FLOPS if elem_bytes == 2 else FP32_FLOPS
    one = B * H * S * D * elem_bytes
    out = []
    for n_products, nbytes in ((2, 4 * one + 4 * B * H * S),
                               (5, 8 * one + 4 * B * H * S)):
        to = n_products * 2 * B * H * pairs * D / rate * 1e3
        tb = nbytes / HBM_BYTES_PER_S * 1e3
        out.append((to, "operations") if to >= tb else (tb, "bytes"))
    return out


def phase_train_kernels(device, iters=20):
    """The four training kernels against their plain versions, then timed
    at the training path's shapes.  Returns their rows (no launches)."""
    from paddle_tpu_torch.ops.kernels import long_attention as la
    from paddle_tpu_torch.ops.kernels import rms_norm as rn

    F = torch.nn.functional
    gen = torch.Generator(device=device)
    gen.manual_seed(4321)
    f32, bf16 = torch.float32, torch.bfloat16
    B, H, S, D, h = (TRAIN_SHAPE[k] for k in "BHSDh")
    before = {f: f.launches for f in (rn.rms_norm_fwd, rn.rms_norm_bwd,
                                      la.attention_fwd, la.attention_bwd)}
    eps = 1e-5

    # RMSNorm: (rows, x dtype, w dtype, atol, rtol, why)
    norm_cases = [
        (B * S, bf16, f32, 1e-6, 2 ** -7, BF16_WHY),
        (B * 1024, bf16, f32, 1e-6, 2 ** -7, BF16_WHY),
        (B * S, bf16, bf16, 1e-6, 2 ** -7, BF16_WHY),
        (B * S, f32, f32, 1e-5, 0.0, "fp32 throughout, other summation "
         "order"),
    ]
    norm_err = {}
    for N, xd, wd, atol, rtol, why in norm_cases:
        x = torch.randn(N, h, generator=gen, device=device).to(xd)
        w = (1 + 0.1 * torch.randn(h, generator=gen, device=device)).to(wd)
        dy = torch.randn(N, h, generator=gen, device=device).to(xd)
        out, rstd = rn.rms_norm_fwd(x, w, eps)
        dx = rn.rms_norm_bwd(x, w, rstd, dy)
        torch.cuda.synchronize()
        want, wrstd = rn.rms_norm_fwd_reference(x, w, eps)
        wdx = rn.rms_norm_bwd_reference(x, w, wrstd, dy)
        tag = f"N={N} h={h} x {xd} w {wd}"
        e1 = _hold(f"rms_norm_fwd {tag}", out, want, atol, rtol, why)
        _hold(f"rms_norm_fwd rstd {tag}", rstd, wrstd, 1e-6, 1e-5,
              "fp32, other summation order")
        e2 = _hold(f"rms_norm_bwd {tag}", dx, wdx, atol, rtol, why)
        norm_err.setdefault("fwd", e1)
        norm_err.setdefault("bwd", e2)

    # attention: (B, H, S, dtype, rope_base)
    attn_cases = [(B, H, S, bf16, None), (B, H, 1024, bf16, None),
                  (B, H, S, f32, None), (B, H, S, bf16, 10000.0)]
    attn_err = {}
    scale = 1.0 / np.sqrt(D)
    for b, hh, s, dt, rb in attn_cases:
        q, k, v, g = (torch.randn(b, hh, s, D, generator=gen,
                                  device=device).to(dt) for _ in range(4))
        out, lse = la.attention_fwd(q, k, v, scale, True, rb)
        grads = la.attention_bwd(q, k, v, out, lse, g, scale, True, rb)
        torch.cuda.synchronize()
        wout, wlse = la.attention_fwd_reference(q, k, v, scale, True, rb)
        tag = f"B={b} H={hh} S={s} D={D} {dt} rope_base={rb}"
        if dt == f32:
            tol = dict(out=(2e-5, 0.0), lse=(2e-5, 0.0), grad=(1e-4, 0.0))
            why = "fp32 throughout, other summation order"
            gwhy = why
        else:
            tol = dict(out=(2e-3, 2 ** -7), lse=(1e-3, 0.0),
                       grad=(5e-3, 2 ** -6))
            why = BF16_WHY
            gwhy = "bf16 outputs of sums over up to 2048 fp32 terms"
        e1 = _hold(f"attention_fwd out {tag}", out, wout, *tol["out"], why)
        _hold(f"attention_fwd lse {tag}", lse, wlse, *tol["lse"],
              "fp32, other summation order")
        del wout, wlse
        torch.cuda.empty_cache()
        wgrads = la.attention_bwd_reference(q, k, v, out, lse, g, scale,
                                            True, rb)
        errs = [_hold(f"attention_bwd {n} {tag}", a, w_, *tol["grad"], gwhy)
                for n, a, w_ in zip(("dq", "dk", "dv"), grads, wgrads)]
        attn_err.setdefault("fwd", e1)
        attn_err.setdefault("bwd", max(errs))
        del wgrads, grads, q, k, v, g, out, lse
        torch.cuda.empty_cache()

    # timing at the training path's shapes and dtypes
    flush = torch.empty(256 * 1024 * 1024, dtype=torch.uint8, device=device)
    x = torch.randn(B * S, h, generator=gen, device=device).to(bf16)
    w = torch.ones(h, device=device)
    dy = torch.randn(B * S, h, generator=gen, device=device).to(bf16)
    _, rstd = rn.rms_norm_fwd(x, w, eps)
    xl = x.detach().requires_grad_(True)
    wb = w.to(bf16)
    yl = F.rms_norm(xl, (h,), wb, eps)
    t = {
        "rms_norm_fwd": (
            lambda: rn.rms_norm_fwd(x, w, eps),
            lambda: rn.rms_norm_fwd_reference(x, w, eps),
            lambda: F.rms_norm(x, (h,), wb, eps)),
        "rms_norm_bwd": (
            lambda: rn.rms_norm_bwd(x, w, rstd, dy),
            lambda: rn.rms_norm_bwd_reference(x, w, rstd, dy),
            lambda: torch.autograd.grad(yl, xl, dy, retain_graph=True)),
    }
    times = {name: [time_ms(f, flush, iters=iters) for f in fns]
             for name, fns in t.items()}
    del x, dy, xl, yl
    q, k, v, g = (torch.randn(B, H, S, D, generator=gen,
                              device=device).to(bf16) for _ in range(4))
    out, lse = la.attention_fwd(q, k, v, scale, True)
    ql, kl, vl = (a.detach().requires_grad_(True) for a in (q, k, v))
    ol = F.scaled_dot_product_attention(ql, kl, vl, is_causal=True)
    t = {
        "attention_fwd": (
            lambda: la.attention_fwd(q, k, v, scale, True),
            lambda: la.attention_fwd_reference(q, k, v, scale, True),
            lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True)),
        "attention_bwd": (
            lambda: la.attention_bwd(q, k, v, out, lse, g, scale, True),
            lambda: la.attention_bwd_reference(q, k, v, out, lse, g, scale,
                                               True),
            lambda: torch.autograd.grad(ol, (ql, kl, vl), g,
                                        retain_graph=True)),
    }
    for name, fns in t.items():
        times[name] = [time_ms(f, flush, iters=iters) for f in fns]
    del q, k, v, g, out, lse, ql, kl, vl, ol, flush
    torch.cuda.empty_cache()
    for f, n in before.items():        # checks and timing do not count
        f.launches = n

    nb = rms_norm_bounds(B * S, h, 2, 4)
    ab = attention_bounds(B, H, S, D, 2)
    meta = {
        "rms_norm_fwd": ("csrc/rms_norm.cu", "rms_norm.py:72", nb[0],
                         norm_err["fwd"], "F.rms_norm, bf16 weight",
                         f"x [{B * S}, {h}] bf16, w fp32"),
        "rms_norm_bwd": ("csrc/rms_norm.cu", "rms_norm.py:103", nb[1],
                         norm_err["bwd"], "autograd of F.rms_norm, dx only",
                         f"x, dy [{B * S}, {h}] bf16, w fp32"),
        "attention_fwd": ("csrc/long_attention.cu", "long_attention.py:147",
                          ab[0], attn_err["fwd"],
                          "scaled_dot_product_attention(is_causal=True)",
                          f"q/k/v [{B}, {H}, {S}, {D}] bf16, causal"),
        "attention_bwd": ("csrc/long_attention.cu", "long_attention.py:168",
                          ab[1], attn_err["bwd"],
                          "autograd of scaled_dot_product_attention",
                          f"q/k/v/g [{B}, {H}, {S}, {D}] bf16, causal"),
    }
    rows = []
    for name, (src, rep, (bound, by), err, lib, shape) in meta.items():
        ms, plain_ms, library_ms = times[name]
        log(f"[kernels] {name} time at {shape}: kernel {ms:.4f} ms | "
            f"bound {bound:.4f} ms ({by}) | plain {plain_ms:.4f} ms | "
            f"library_ms {library_ms:.4f} ms ({lib}) | "
            f"{100 * bound / ms:.1f}% of bound")
        rows.append({"name": name, "route": "cuda",
                     "source": f"paddle_tpu_torch/{src}",
                     "replaces": f"paddle_tpu/ops/pallas_kernels/{rep}",
                     "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bound, "bound_by": by,
                     "library_ms": library_ms})
    return rows


# -- phase 3c: the int8 serving kernels ----------------------------------------

#: (K, N) of the Llama-2-7B projections: q/k/v/o (32 kv heads), gate/up,
#: down
QMM_SHAPES = {"q/k/v/o_proj": (4096, 4096), "gate/up_proj": (4096, 11008),
              "down_proj": (11008, 4096)}


def quant_matmul_bound(M, K, N, x_bytes):
    """(bound_ms, bound_by): x, the int8 weight, the scales and out moved
    once over HBM rate, against 2MKN flops at x's rate (bf16 tensor cores
    for bf16 x, the fp32 rate for f32 x)."""
    nbytes = M * K * x_bytes + K * N + 4 * N + M * N * x_bytes
    rate = BF16_FLOPS if x_bytes == 2 else FP32_FLOPS
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    to = 2 * M * K * N / rate * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def quantize_pages(pages):
    """Per-page symmetric int8 of float pools [KV, P, ps, D]: (int8
    pages, f32 scales [KV, P]), amax / 127 as ``kv_write`` settles it."""
    amax = pages.float().abs().amax(dim=(2, 3))
    scales = amax / 127.0
    q = torch.round(pages.float() / torch.where(scales > 0, scales, 1.0)
                    [..., None, None])
    return q.clamp_(-127, 127).to(torch.int8), scales


def make_quant_paged_case(gen, B, KV, G, D, ps, pps, lengths, q_dtype,
                          device):
    """As ``make_paged_case`` over int8 pages: every slot past a
    sequence's cover points at one page whose scales are NaN, so a read
    of it would poison the output; the unwritten tail of each last page
    holds garbage at its page's scale."""
    q, kp, vp, lens, table = make_paged_case(
        gen, B, KV, G, D, ps, pps, lengths, q_dtype, torch.float32, device)
    nan_page = kp.shape[1] - 1
    kp, vp = (torch.nan_to_num(t, nan=3.0) for t in (kp, vp))
    (kq, ks), (vq, vs) = quantize_pages(kp), quantize_pages(vp)
    ks[:, nan_page] = float("nan")
    vs[:, nan_page] = float("nan")
    return q, kq, vq, lens, table, ks, vs


def paged_decode_quant_bound(q, k_pages, lengths, page_indices):
    """(bound_ms, bound_by): the int8 K and V rows under each length, one
    K and one V scale per covered page, the table entries, lengths, q in
    and out, over HBM rate, against the dots (4 flops per query row,
    token and dim) and the dequantizing multiplies (2 per kv head, token
    and dim) over the fp32 rate."""
    B, H, D = q.shape
    KV, _, ps, _ = k_pages.shape
    lens = [int(x) for x in lengths.cpu()]
    tokens = sum(lens)
    pages = sum(-(-n // ps) for n in lens)
    nbytes = (2 * tokens * KV * D + 2 * pages * KV * 4 + pages * 4 + B * 4
              + 2 * q.numel() * q.element_size())
    flops = 4 * tokens * H * D + 2 * tokens * KV * D
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_quant_kernels(device, iters=50):
    """Both int8 serving kernels against their plain versions at the
    int8 serving path's shapes, then timed.  Returns their rows."""
    from paddle_tpu_torch.ops import quant as tq
    from paddle_tpu_torch.ops.kernels import paged_decode as pdmod
    from paddle_tpu_torch.ops.kernels import quant_matmul as qm

    gen = torch.Generator(device=device)
    gen.manual_seed(2468)
    f32, bf16 = torch.float32, torch.bfloat16
    before = (qm.quant_matmul.launches, pdmod.paged_decode_quant.launches)
    flush = torch.empty(256 * 1024 * 1024, dtype=torch.uint8, device=device)

    # kernel A: every projection shape, decode and prefill M, both x dtypes
    qmm_err, timed = {}, {}
    for label, (K, N) in QMM_SHAPES.items():
        w = torch.randn(K, N, generator=gen, device=device) * 0.02
        qw, sc = tq.quantize_per_channel(w)
        sc = sc.reshape(N)
        w_bf16 = tq.dequantize(qw, sc, bf16)      # the library's weight
        del w
        for M in (8, 512):
            x = torch.randn(M, K, generator=gen, device=device)
            for xd in (bf16, f32):
                xs = x.to(xd)
                got = qm.quant_matmul(xs, qw, sc)
                torch.cuda.synchronize()
                want = qm.quant_matmul_reference(xs, qw, sc)
                if xd == f32:
                    tol = (2e-4, 0.0, "fp32 sums of up to 11008 products "
                           "in other orders, |out| ~ 2")
                else:
                    tol = (2e-4, 2 ** -7, BF16_WHY)
                err = _hold(f"quant_matmul {label} M={M} K={K} N={N} x "
                            f"{xd}", got, want, *tol)
                qmm_err.setdefault((M, xd), 0.0)
                qmm_err[(M, xd)] = max(qmm_err[(M, xd)], err)
            xb = x.to(bf16)
            timed[(label, M)] = (
                [time_ms(f, flush, iters=iters) for f in (
                    lambda: qm.quant_matmul(xb, qw, sc),
                    lambda: qm.quant_matmul_reference(xb, qw, sc),
                    lambda: torch.matmul(xb, w_bf16))],
                quant_matmul_bound(M, K, N, 2))
            del x, xb
        del qw, sc, w_bf16
        torch.cuda.empty_cache()
    for (label, M), ((ms, plain_ms, lib_ms), (bound, by)) in timed.items():
        log(f"[kernels] quant_matmul time at {label} M={M} x bf16: kernel "
            f"{ms:.4f} ms | bound {bound:.4f} ms ({by}) | plain "
            f"{plain_ms:.4f} ms | library_ms {lib_ms:.4f} ms (torch.matmul "
            f"over the weight dequantized to bf16 beforehand) | "
            f"{100 * bound / ms:.1f}% of bound")

    # kernel B: int8 pages at the decode shapes of phase 3
    l7b = [1, 8, 2048, 17, 500, 1024, 1999, 333]
    cases = [
        ("llama2-7b serving (q f32, pool int8)",
         dict(B=8, KV=32, G=1, D=128, ps=16, pps=128, lengths=l7b), f32,
         2e-5, 0.0, "fp32 math on the same dequantized values, other "
         "summation order"),
        ("llama2-7b q bf16, pool int8",
         dict(B=8, KV=32, G=1, D=128, ps=16, pps=128, lengths=l7b), bf16,
         1e-4, 2 ** -7, BF16_WHY),
        ("gqa G=4 ps=32", dict(B=4, KV=8, G=4, D=128, ps=32, pps=64,
                               lengths=[2048, 1, 40, 777]), f32, 2e-5, 0.0,
         "fp32 math, other summation order"),
        ("gqa G=2 D=64", dict(B=3, KV=4, G=2, D=64, ps=16, pps=32,
                              lengths=[512, 9, 100]), f32, 2e-5, 0.0,
         "fp32 math, other summation order"),
    ]
    main_case = None
    for label, shape, qd, atol, rtol, why in cases:
        args = make_quant_paged_case(gen, q_dtype=qd, device=device, **shape)
        got = pdmod.paged_decode_quant(*args)
        torch.cuda.synchronize()
        want = pdmod.paged_decode_quant_reference(*args)
        err = _hold(f"paged_decode_quant {label}", got, want, atol, rtol,
                    why)
        if main_case is None:
            main_case = (args, err)
    args, pdq_err = main_case
    q, kq, vq, lens, table, ks, vs = args
    ms = time_ms(lambda: pdmod.paged_decode_quant(*args), flush, iters=iters)
    plain_ms = time_ms(lambda: pdmod.paged_decode_quant_reference(*args),
                       flush, iters=iters)
    B, H, D = q.shape
    T = table.shape[1] * kq.shape[2]
    idx = table.long()

    def dense(pages, scales):
        w = pages[:, idx].float() * scales[:, idx][..., None, None]
        return w.transpose(0, 1).reshape(B, -1, T, D)

    valid = torch.arange(T, device=device)[None] < lens[:, None]
    kd, vd = (torch.where(valid[:, None, :, None], dense(p, sc_), 0)
              .to(bf16) for p, sc_ in ((kq, ks), (vq, vs)))
    qs, mask = q.to(bf16)[:, :, None], valid[:, None, None, :]
    F = torch.nn.functional
    library_ms = time_ms(
        lambda: F.scaled_dot_product_attention(qs, kd, vd, attn_mask=mask),
        flush, iters=iters)
    pdq_bound, pdq_by = paged_decode_quant_bound(q, kq, lens, table)
    log(f"[kernels] paged_decode_quant time at B=8 KV=32 D=128 ps=16 "
        f"pps=128, lengths {l7b}, q f32 / pool int8: kernel {ms:.4f} ms | "
        f"bound {pdq_bound:.4f} ms ({pdq_by}) | plain {plain_ms:.4f} ms | "
        f"library_ms {library_ms:.4f} ms (scaled_dot_product_attention, "
        f"bf16, over the gathered and dequantized cache, gather and "
        f"dequantization excluded) | {100 * pdq_bound / ms:.1f}% of bound")
    del flush, kd, vd, args, q, kq, vq
    torch.cuda.empty_cache()
    qm.quant_matmul.launches, pdmod.paged_decode_quant.launches = before

    (qmm_ms, qmm_plain, qmm_lib), (qmm_bound, qmm_by) = \
        timed[("gate/up_proj", 8)]
    return [
        {"name": "quant_matmul", "route": "cuda",
         "source": "paddle_tpu_torch/csrc/quant_matmul.cu",
         "replaces": "paddle_tpu/ops/pallas_kernels/quant_matmul.py:85",
         "max_abs_err": max(qmm_err.values()), "ms": qmm_ms,
         "plain_ms": qmm_plain, "bound_ms": qmm_bound, "bound_by": qmm_by,
         "library_ms": qmm_lib},
        {"name": "paged_decode_quant", "route": "cuda",
         "source": "paddle_tpu_torch/csrc/paged_decode.cu",
         "replaces": "paddle_tpu/ops/pallas_kernels/paged_decode.py:240",
         "max_abs_err": pdq_err, "ms": ms, "plain_ms": plain_ms,
         "bound_ms": pdq_bound, "bound_by": pdq_by,
         "library_ms": library_ms},
    ]


# -- phase 4 -----------------------------------------------------------------

SERVE_KW = dict(max_seqs=8, page_size=16, max_len=2048, prefill_chunk=512)
SERVE_LOAD = dict(n_requests=16, mean_interarrival=2.0,
                  prompt_len=(128, 1024), max_new=(32, 64), vocab=32000,
                  seed=0)


def _serve_counters():
    from paddle_tpu_torch.ops.kernels import paged_decode as pdmod
    from paddle_tpu_torch.ops.kernels import quant_matmul as qm

    return {"paged_decode": pdmod.paged_decode,
            "paged_decode_quant": pdmod.paged_decode_quant,
            "quant_matmul": qm.quant_matmul}


def phase_serve(device, cfg=None, load=None, dtype=torch.bfloat16,
                engine_kw=None, quant="none"):
    """Serve ``load`` through ServingEngine.  Returns ({kernel: launches
    in the run}, engine)."""
    from paddle_tpu_torch.inference.server import RequestState, ServingEngine
    from paddle_tpu_torch.models import LlamaConfig, init_llama_params
    from paddle_tpu_torch.testing.load import (
        LoadSpec, generate_load, run_load,
    )

    cfg = LlamaConfig.llama2_7b() if cfg is None else cfg
    load = SERVE_LOAD if load is None else load
    engine_kw = SERVE_KW if engine_kw is None else engine_kw
    tag = "serve" if quant == "none" else f"serve-{quant}"
    t0 = time.perf_counter()
    params = init_llama_params(cfg, seed=0, device=device, dtype=dtype)
    nparams = (sum(t.numel() for t in params["layers"].values())
               + params["embed"].numel()
               + (0 if params["lm_head"] is None
                  else params["lm_head"].numel()))
    engine = ServingEngine(cfg, params, dtype=dtype, device=device,
                           quant=quant, **engine_kw)
    del params          # an int8 engine keeps no dense projection
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated() / 2**30
    else:
        resident = float("nan")
    log(f"[{tag}] {cfg.num_hidden_layers} layers, hidden "
        f"{cfg.hidden_size}, {cfg.num_attention_heads} heads, D "
        f"{cfg.head_dim}, intermediate {cfg.intermediate_size}, vocab "
        f"{cfg.vocab_size}: {nparams / 1e9:.3f} B parameters in {dtype}, "
        f"quant={quant}, built in {time.perf_counter() - t0:.1f} s; "
        f"{resident:.2f} GiB resident (weights and KV pool)")
    work = generate_load(LoadSpec(**dict(load, vocab=cfg.vocab_size)))
    counters = _serve_counters()
    for f in counters.values():
        f.launches = 0
    ex = engine.executor
    ex.prefill_events.clear()
    t0 = time.perf_counter()
    out = run_load(engine, work)
    if device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = {k: f.launches for k, f in counters.items()}
    st = out["stats"]
    for w in work:
        h = out["handles"][w["rid"]]
        toks = h.tokens
        if h.state is not RequestState.FINISHED \
                or len(toks) != w["max_new_tokens"] \
                or not all(0 <= t < cfg.vocab_size for t in toks):
            raise AssertionError(
                f"[serve] {w['rid']}: {h.state.value}, {len(toks)} of "
                f"{w['max_new_tokens']} tokens")
    L, steps = cfg.num_hidden_layers, st["decode_steps"]
    forwards = len(ex.prefill_events)
    if quant == "int8":
        want = {"paged_decode": 0, "paged_decode_quant": L * steps,
                "quant_matmul": 7 * L * (steps + forwards)}
        rule = (f"paged_decode_quant {L} layers x {steps} decode steps; "
                f"quant_matmul 7 x {L} layers x ({steps} decode steps + "
                f"{forwards} prefill forwards); paged_decode 0")
    else:
        want = {"paged_decode": L * steps, "paged_decode_quant": 0,
                "quant_matmul": 0}
        rule = f"paged_decode {L} layers x {steps} decode steps"
    if device.type == "cuda" and got != want:
        raise AssertionError(f"[{tag}] launches {got}, expected {want} "
                             f"({rule})")
    peak = (torch.cuda.max_memory_allocated() / 2**30
            if device.type == "cuda" else float("nan"))
    log(f"[{tag}] {len(work)} requests finished in {wall:.3f} s, "
        f"{st['steps']} steps, {steps} decode steps, {forwards} prefill "
        f"forwards, {st['decode_tokens']} decode tokens, "
        f"{st['prefill_tokens']} prefill tokens, {st['preemptions']} "
        f"preemptions | {st['decode_tokens'] / wall:.2f} decode tok/s | "
        f"TTFT p50 {st['ttft_ms_p50']} ms p99 {st['ttft_ms_p99']} ms | "
        f"TPOT p50 {st['tpot_ms_p50']} ms p99 {st['tpot_ms_p99']} ms | "
        f"launches {got} ({rule}) | peak memory {peak:.2f} GiB")
    return got, engine


def phase_profile(engine, device, n_steps=5, prompt=512):
    """Where a decode step's time goes: fill every slot with a
    ``prompt``-token request, then time ``n_steps`` decode-only steps on
    the host clock (synchronised) and trace ``n_steps`` more with
    torch.profiler, summing device kernel time by kind."""
    from torch.profiler import ProfilerActivity, profile

    ex = engine.executor
    cfg = ex.config
    rng = np.random.RandomState(7)
    handles = [engine.submit(rng.randint(1, cfg.vocab_size, prompt),
                             max_new_tokens=4 * n_steps + 4)
               for _ in range(ex.cache.max_seqs)]
    while engine.scheduler.queue or engine.scheduler.prefilling:
        engine.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_steps):
        engine.step()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / n_steps * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            engine.step()
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t0) / n_steps * 1e3
    # kinds by kernel name, first match wins
    patterns = (("quant_matmul", ("qmm_",)),
                ("paged_decode_quant", ("paged_decode_quant",)),
                ("paged_decode", ("paged_decode",)),
                ("gemm", ("gemm", "cutlass", "xmma", "nvjet")))
    kinds = {k: 0.0 for k, _ in patterns}
    kinds["other"] = 0.0
    per_kernel = {}
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        ms = ev.self_device_time_total / 1e3 / n_steps
        name = ev.key.lower()
        kind = next((k for k, pats in patterns
                     if any(p in name for p in pats)), "other")
        kinds[kind] += ms
        per_kernel[ev.key[:60]] = (ms, ev.count / n_steps)
    busy = sum(kinds.values())

    def nbytes(w):
        if isinstance(w, dict):
            return sum(nbytes(t) for t in w.values())
        return w.numel() * w.element_size()

    weight_bytes = sum(nbytes(w) for w in ex.layers.values()) \
        + nbytes(ex.tops["head_w"])
    lens = [int(ex.cache.lengths[h._req.sid]) for h in handles]
    tag = "profile" if ex.quant == "none" else f"profile-{ex.quant}"
    log(f"[{tag}] decode step at batch {len(handles)}, lengths "
        f"{min(lens)}-{max(lens)}: {step_ms:.3f} ms untraced, "
        f"{traced_ms:.3f} ms traced | device busy {busy:.3f} ms/step ("
        + ", ".join(f"{k} {v:.3f}" for k, v in kinds.items() if v or
                    k in ("gemm", "other"))
        + f") | idle share {1 - busy / traced_ms:.3f} | weight-read bound "
        f"{weight_bytes / HBM_BYTES_PER_S * 1e3:.3f} ms/step "
        f"({weight_bytes / 1e9:.3f} GB of layer and head weights)")
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1][0])[:8]
    for name, (ms, calls) in top:
        log(f"[{tag}]   {ms:8.3f} ms/step  {calls:6.1f} launches/step  "
            f"{name}")
    for h in handles:
        h.cancel()
    engine.step()


# -- phase 5 -----------------------------------------------------------------

PARITY_KW = dict(max_seqs=4, page_size=16, max_len=256, prefill_chunk=32)
PARITY_LOAD = dict(n_requests=4, mean_interarrival=1.0,
                   prompt_len=(16, 64), max_new=(8, 8), vocab=32000,
                   seed=1)


def phase_parity(device, cfg=None, quant="none"):
    from paddle_tpu_torch.inference.server import PagedExecutor, ServingEngine
    from paddle_tpu_torch.models import (
        LlamaConfig, init_llama_params, params_to,
    )
    from paddle_tpu_torch.testing.load import (
        LoadSpec, generate_load, run_load,
    )

    tag = "parity" if quant == "none" else f"parity-{quant}"
    counters = {k: f for k, f in _serve_counters().items()
                if (k == "paged_decode") == (quant == "none")}
    cfg = LlamaConfig.llama2_7b(num_hidden_layers=2) if cfg is None else cfg
    params = init_llama_params(cfg, seed=0, device=device,
                               dtype=torch.float32)
    cpu_params = params_to(params, device="cpu")
    work = generate_load(LoadSpec(**dict(PARITY_LOAD,
                                           vocab=cfg.vocab_size)))
    logits = []
    for dev, p in ((device, params), (torch.device("cpu"), cpu_params)):
        ex = PagedExecutor(cfg, p, dtype=torch.float32, device=dev,
                           max_seqs=1, page_size=16, max_len=256,
                           quant=quant)
        with torch.no_grad():
            logits.append([ex._prefill_fwd(torch.as_tensor(
                w["prompt_ids"][None], dtype=torch.long, device=dev))[0]
                .cpu() for w in work])
    max_err = max((a - b).abs().max().item()
                  for a, b in zip(*logits))
    log(f"[{tag}] first-token logits card vs CPU: max_abs_err "
        f"{max_err:.3e} (atol 1e-3: fp32 on both, TF32 off, other "
        f"summation order through 2 layers of width 4096)")
    if not max_err <= 1e-3:
        raise AssertionError(f"[{tag}] logits differ by {max_err}")
    streams = {}
    for dev, p in ((device, params), (torch.device("cpu"), cpu_params)):
        before = {k: f.launches for k, f in counters.items()}
        eng = ServingEngine(cfg, p, dtype=torch.float32, device=dev,
                            quant=quant, **PARITY_KW)
        out = run_load(eng, work)
        streams[dev.type] = {rid: h.tokens
                             for rid, h in out["handles"].items()}
        launched = {k: f.launches - before[k] for k, f in counters.items()}
        log(f"[{tag}] {dev.type}: {out['stats']['decode_steps']} decode "
            f"steps, kernel launches {launched}")
        if dev.type == "cuda" and not all(launched.values()):
            raise AssertionError(f"[{tag}] the card run missed a kernel: "
                                 f"{launched}")
    if streams[device.type] != streams["cpu"]:
        raise AssertionError(f"[{tag}] greedy streams differ: "
                             f"{streams}")
    log(f"[{tag}] greedy streams identical on {device.type} and cpu "
        f"for {len(work)} requests ({sum(map(len, streams['cpu'].values()))}"
        f" tokens)")


# -- phase 6 -----------------------------------------------------------------

TRAIN_RUN = dict(batch=4, seq=2048, steps=5, lr=1e-4)


def _train_counters():
    from paddle_tpu_torch.ops.kernels import long_attention as la
    from paddle_tpu_torch.ops.kernels import rms_norm as rn
    from paddle_tpu_torch.ops.kernels import short_attention as sa

    return {"rms_norm_fwd": rn.rms_norm_fwd, "rms_norm_bwd": rn.rms_norm_bwd,
            "attention_fwd": la.attention_fwd,
            "attention_bwd": la.attention_bwd,
            "short_attention_fwd": sa.short_attention_fwd,
            "short_attention_bwd": sa.short_attention_bwd}


def phase_train(device, limit, cfg=None, run=None, tag="train"):
    """Llama-2-7B width x 8 layers: one warm-up step and ``steps`` timed
    ones.  Returns ({kernel: launches over all steps}, step, batch).
    Attention takes the long kernel at S >= 1024 and the short one
    below, 2L forward and L backward launches per step either way."""
    from paddle_tpu_torch.core.flags import set_flags
    from paddle_tpu_torch.models import (
        CompiledTrainStep, LlamaConfig, LlamaForCausalLM,
    )

    cfg = cfg or LlamaConfig.llama2_7b(num_hidden_layers=8, recompute=True,
                                       recompute_policy="full",
                                       attention_impl="auto")
    run = dict(TRAIN_RUN, **(run or {}))
    B, S, n = run["batch"], run["seq"], run["steps"]
    L = cfg.num_hidden_layers
    on_card = device.type == "cuda"
    set_flags({"FLAGS_use_fused_rms_norm": True})
    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg, device=device, seed=0)
    step = CompiledTrainStep(model, lr=run["lr"], compute_dtype="bfloat16",
                             moments_dtype="bfloat16", device=device)
    nparams = model.num_params()
    ids = np.random.RandomState(0).randint(0, cfg.vocab_size, (B, S))
    batch = (torch.as_tensor(ids, device=device),) * 2  # inputs = labels
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    log(f"[{tag}] {L} layers, hidden {cfg.hidden_size}, "
        f"{cfg.num_attention_heads} heads, D {cfg.head_dim}, intermediate "
        f"{cfg.intermediate_size}, vocab {cfg.vocab_size}: "
        f"{nparams / 1e9:.3f} B parameters, bf16 compute, fp32 master, "
        f"bf16 moments, built in {time.perf_counter() - t0:.1f} s")
    counters = _train_counters()
    long = S >= 1024
    per_step = {"rms_norm_fwd": 4 * L + 1, "rms_norm_bwd": 2 * L + 1,
                "attention_fwd": 2 * L if long else 0,
                "attention_bwd": L if long else 0,
                "short_attention_fwd": 0 if long else 2 * L,
                "short_attention_bwd": 0 if long else L}
    for f in counters.values():
        f.launches = 0
    losses, step_ms = [], []
    for i in range(n + 1):
        before = {k: f.launches for k, f in counters.items()}
        t1 = time.perf_counter()
        loss = float(step.step(*batch))       # float() synchronises
        ms = (time.perf_counter() - t1) * 1e3
        losses.append(loss)
        if i:
            step_ms.append(ms)
        got = {k: f.launches - before[k] for k, f in counters.items()}
        log(f"[{tag}] step {i}{' (warm-up)' if i == 0 else ''}: loss "
            f"{loss:.6f}, {ms:.1f} ms, launches {got}")
        if on_card and got != per_step:
            raise AssertionError(f"[{tag}] step {i} launched {got}, expected "
                                 f"{per_step} (full recompute: every layer "
                                 f"forward runs twice)")
    launches = {k: f.launches for k, f in counters.items()}
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"[{tag}] losses {losses}: not finite and "
                             "falling")
    mean_ms = float(np.mean(step_ms))
    tokens = B * S
    mfu = model.flops_per_token(S) * tokens / (mean_ms / 1e3) / BF16_FLOPS
    peak = (torch.cuda.max_memory_allocated() / 2**30 if on_card
            else float("nan"))
    log(f"[{tag}] B={B} S={S}: step {mean_ms:.1f} ms (mean of {n}; "
        f"{', '.join(f'{m:.1f}' for m in step_ms)}) | "
        f"{tokens / (mean_ms / 1e3):.1f} tokens/s | MFU {mfu:.4f} "
        f"(6N + 12LhS = {model.flops_per_token(S):.4e} flops/token over "
        f"{BF16_FLOPS / 1e12:g} TFLOP/s bf16) | peak memory {peak:.2f} GiB | "
        f"losses {losses} | {limit}")
    return launches, step, batch


def phase_train_profile(step, batch, device):
    """One traced training step: device time by kind and the idle share."""
    from torch.profiler import ProfilerActivity, profile

    counters = _train_counters()
    saved = {k: f.launches for k, f in counters.items()}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step.step(*batch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    for k, f in counters.items():        # the traced step does not count
        f.launches = saved[k]
    kinds = {"rms_norm_fwd": 0.0, "rms_norm_bwd": 0.0, "attention_fwd": 0.0,
             "attention_bwd": 0.0, "gemm": 0.0, "other": 0.0}
    per_kernel = {}
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        ms = ev.self_device_time_total / 1e3
        name = ev.key.lower()
        kind = ("rms_norm_fwd" if "rms_norm_fwd" in name else
                "rms_norm_bwd" if "rms_norm_bwd" in name else
                "attention_fwd" if "attn_fwd" in name else
                "attention_bwd" if ("attn_bwd" in name
                                    or "attn_delta" in name) else
                "gemm" if any(k in name for k in ("gemm", "cutlass", "xmma",
                                                  "nvjet", "sm90_"))
                else "other")
        kinds[kind] += ms
        per_kernel[ev.key[:60]] = (ms, ev.count)
    busy = sum(kinds.values())
    log(f"[profile-train] one step traced: {wall:.1f} ms wall | device busy "
        f"{busy:.1f} ms ({', '.join(f'{k} {v:.1f}' for k, v in kinds.items())}"
        f") | idle share {1 - busy / wall:.3f}")
    for name, (ms, calls) in sorted(per_kernel.items(),
                                    key=lambda kv: -kv[1][0])[:10]:
        log(f"[profile-train]   {ms:9.2f} ms  {calls:5d} launches  {name}")


# -- phase 7 -----------------------------------------------------------------

def phase_train_parity(device, steps=3):
    """The same weights trained on the card (kernels) and on the CPU
    (plain versions), fp32, at a width that takes the attention kernel."""
    from paddle_tpu_torch.core.flags import set_flags
    from paddle_tpu_torch.models import (
        CompiledTrainStep, LlamaConfig, LlamaForCausalLM,
    )

    set_flags({"FLAGS_use_fused_rms_norm": True})
    cfg = LlamaConfig(vocab_size=4096, hidden_size=256,
                      intermediate_size=688, num_hidden_layers=2,
                      num_attention_heads=2, num_key_value_heads=2,
                      max_position_embeddings=1024, recompute=True)
    ids = np.random.RandomState(1).randint(0, cfg.vocab_size, (2, 1024))
    counters = _train_counters()
    losses = {}
    for dev in (device, torch.device("cpu")):
        model = LlamaForCausalLM(cfg, device="cpu", seed=3)
        step = CompiledTrainStep(model, lr=1e-3, device=dev)
        before = {k: f.launches for k, f in counters.items()}
        batch = (torch.as_tensor(ids, device=dev),) * 2
        losses[dev.type] = [float(step.step(*batch)) for _ in range(steps)]
        launched = {k: f.launches - before[k] for k, f in counters.items()}
        log(f"[train-parity] {dev.type}: losses {losses[dev.type]}, kernel "
            f"launches {launched}")
        used = ("rms_norm_fwd", "rms_norm_bwd", "attention_fwd",
                "attention_bwd")
        if dev.type == "cuda" and not all(launched[k] for k in used):
            raise AssertionError("[train-parity] the card run missed a "
                                 f"kernel: {launched}")
    got, want = np.array(losses[device.type]), np.array(losses["cpu"])
    rel = float(np.max(np.abs(got - want) / np.abs(want)))
    log(f"[train-parity] {steps} fp32 steps, 2 layers, hidden 256, S=1024: "
        f"max relative loss difference card vs CPU {rel:.3e} (limit 1e-4: "
        f"fp32 on both, TF32 off, other summation orders)")
    if not rel <= 1e-4:
        raise AssertionError(f"[train-parity] losses differ: {losses}")


# -- phase 3e: the short-attention kernels -------------------------------------

def short_attention_bounds(B, H, S, D, elem_bytes, causal=False):
    """(fwd, bwd) (bound_ms, bound_by): 4·B·H·S²·D flops forward and
    10·B·H·S²·D backward (two and five [S, S, D] products), halved when
    causal, over the bf16 tensor-core rate (fp32 inputs: the fp32 rate),
    against the function's inputs read and outputs written once (fwd: q,
    k, v in, out and lse out; bwd: q, k, v, g and lse in, dq, dk, dv
    out) over HBM rate."""
    rate = BF16_FLOPS if elem_bytes == 2 else FP32_FLOPS
    one = B * H * S * D * elem_bytes
    frac = 0.5 if causal else 1.0
    out = []
    for flops, nbytes in ((4, 4 * one + 4 * B * H * S),
                          (10, 7 * one + 4 * B * H * S)):
        to = flops * B * H * S * S * D * frac / rate * 1e3
        tb = nbytes / HBM_BYTES_PER_S * 1e3
        out.append((to, "operations") if to >= tb else (tb, "bytes"))
    return out


#: (label, B, H, S, D, dtype, causal, dropout_p)
SHORT_CASES = [
    ("bert-base p=0.1", 48, 12, 384, 64, torch.bfloat16, False, 0.1),
    ("bert-base p=0", 48, 12, 384, 64, torch.bfloat16, False, 0.0),
    ("bert-width fp32 p=0.1", 4, 12, 384, 64, torch.float32, False, 0.1),
    ("llama S=512 causal", 4, 32, 512, 128, torch.bfloat16, True, 0.0),
    ("S=1024 causal p=0.1", 2, 4, 1024, 128, torch.bfloat16, True, 0.1),
    ("S=128 causal p=0.5 fp32", 2, 4, 128, 64, torch.float32, True, 0.5),
]


def phase_short_kernels(device, iters=20):
    """Both short-attention kernels against their plain versions on the
    card at the BERT, Llama S=512 and edge shapes, the dropout mask held
    exactly, then timed at the BERT shape.  Returns their two rows."""
    from paddle_tpu_torch.ops.kernels import short_attention as sa

    F = torch.nn.functional
    gen = torch.Generator(device=device)
    gen.manual_seed(8642)
    f32 = torch.float32
    before = (sa.short_attention_fwd.launches,
              sa.short_attention_bwd.launches)
    seed = torch.tensor([-1234567891], dtype=torch.int32, device=device)
    errs = {"fwd": 0.0, "bwd": 0.0}
    kernel_ms = {}
    flush = torch.empty(256 * 1024 * 1024, dtype=torch.uint8, device=device)
    for label, B, H, S, D, dt, causal, p in SHORT_CASES:
        q, k, v, g = (torch.randn(B, H, S, D, generator=gen, device=device)
                      .to(dt) for _ in range(4))
        scale = 1.0 / np.sqrt(D)
        out, lse, out32 = sa.short_attention_fwd(q, k, v, seed, scale, p,
                                                 causal)
        grads = sa.short_attention_bwd(q, k, v, out32, lse, g, seed, scale,
                                       p, causal)
        torch.cuda.synchronize()
        wout, wlse, wout32 = sa.short_attention_fwd_reference(
            q, k, v, seed, scale, p, causal)
        tag = f"{label} [{B}, {H}, {S}, {D}] {dt}"
        if not torch.equal(out == 0, wout == 0):
            raise AssertionError(f"[kernels] short_attention_fwd {tag}: the "
                                 "zeros of out differ from the plain "
                                 "version's (another dropout mask)")
        if dt == f32:
            tol, why = (2e-5, 0.0), "fp32 throughout, other summation order"
            gtol, gwhy = (1e-4, 0.0), why
        else:
            tol, why = (2e-3, 2 ** -7), BF16_WHY
            gtol = (5e-3, 2 ** -6)
            gwhy = f"bf16 outputs of sums over up to {S} fp32 terms"
        e = _hold(f"short_attention_fwd out {tag}", out, wout, *tol, why)
        _hold(f"short_attention_fwd out32 {tag}", out32, wout32, 2e-5, 0.0,
              "fp32 from the same widened inputs, other summation order")
        _hold(f"short_attention_fwd lse {tag}", lse, wlse, 2e-5, 0.0,
              "fp32, other summation order")
        errs["fwd"] = max(errs["fwd"], e)
        del wout, wlse, wout32
        torch.cuda.empty_cache()
        wgrads = sa.short_attention_bwd_reference(q, k, v, out32, lse, g,
                                                  seed, scale, p, causal)
        for n, a, w_ in zip(("dq", "dk", "dv"), grads, wgrads):
            errs["bwd"] = max(errs["bwd"], _hold(
                f"short_attention_bwd {n} {tag}", a, w_, *gtol, gwhy))
        del wgrads
        kernel_ms[label] = (
            time_ms(lambda: sa.short_attention_fwd(q, k, v, seed, scale, p,
                                                   causal), flush, iters),
            time_ms(lambda: sa.short_attention_bwd(q, k, v, out32, lse, g,
                                                   seed, scale, p, causal),
                    flush, iters))
        fb, bb = short_attention_bounds(B, H, S, D, q.element_size(), causal)
        log(f"[kernels] short_attention time at {tag} causal={causal} "
            f"p={p}: fwd {kernel_ms[label][0]:.4f} ms (bound {fb[0]:.4f}, "
            f"{100 * fb[0] / kernel_ms[label][0]:.1f}%), bwd "
            f"{kernel_ms[label][1]:.4f} ms (bound {bb[0]:.4f}, "
            f"{100 * bb[0] / kernel_ms[label][1]:.1f}%)")
        del q, k, v, g, out, lse, out32, grads
        torch.cuda.empty_cache()

    # the mask itself: v = I makes out the dropped probability matrix, and
    # g = I makes dv its transpose
    S = D = 128
    q, k = (torch.randn(2, 4, S, D, generator=gen, device=device)
            for _ in range(2))
    eye = torch.eye(S, device=device).expand(2, 4, S, S).contiguous()
    out, lse, out32 = sa.short_attention_fwd(q, k, eye, seed, 1 / np.sqrt(D),
                                             0.5, False)
    _, _, dv = sa.short_attention_bwd(q, k, eye, out32, lse, eye, seed,
                                      1 / np.sqrt(D), 0.5, False)
    torch.cuda.synchronize()
    wout, _, _ = sa.short_attention_fwd_reference(q, k, eye, seed,
                                                  1 / np.sqrt(D), 0.5, False)
    _, _, wdv = sa.short_attention_bwd_reference(q, k, eye, out32, lse, eye,
                                                 seed, 1 / np.sqrt(D), 0.5,
                                                 False)
    keep = sa.keep_mask(seed, 2, 4, S, 0.5)
    ok = (torch.equal(out == 0, wout == 0) and torch.equal(out == 0, ~keep)
          and torch.equal(dv == 0, wdv == 0)
          and torch.equal(dv == 0, ~keep.transpose(-1, -2)))
    log(f"[kernels] short_attention dropout mask at S = D = 128, p = 0.5, "
        f"seed {int(seed)}: zeros of out (v = I) and of dv (g = I) equal "
        f"the plain version's exactly: {ok} (kept share "
        f"{keep.float().mean().item():.4f})")
    if not ok:
        raise AssertionError("[kernels] short_attention: the kernel's "
                             "dropout mask differs from the plain version's")

    # timing at the BERT shape, bf16, p = 0.1: kernel, plain, SDPA
    label, B, H, S, D, dt, causal, p = SHORT_CASES[0]
    q, k, v, g = (torch.randn(B, H, S, D, generator=gen, device=device)
                  .to(dt) for _ in range(4))
    scale = 1.0 / np.sqrt(D)
    out, lse, out32 = sa.short_attention_fwd(q, k, v, seed, scale, p, causal)
    ql, kl, vl = (a.detach().requires_grad_(True) for a in (q, k, v))
    ol = F.scaled_dot_product_attention(ql, kl, vl, dropout_p=p)
    times = {
        "short_attention_fwd": [time_ms(f, flush, iters) for f in (
            lambda: sa.short_attention_fwd(q, k, v, seed, scale, p, causal),
            lambda: sa.short_attention_fwd_reference(q, k, v, seed, scale, p,
                                                     causal),
            lambda: F.scaled_dot_product_attention(q, k, v, dropout_p=p))],
        "short_attention_bwd": [time_ms(f, flush, iters) for f in (
            lambda: sa.short_attention_bwd(q, k, v, out32, lse, g, seed,
                                           scale, p, causal),
            lambda: sa.short_attention_bwd_reference(
                q, k, v, out32, lse, g, seed, scale, p, causal),
            lambda: torch.autograd.grad(ol, (ql, kl, vl), g,
                                        retain_graph=True))],
    }
    del q, k, v, g, out, lse, out32, ql, kl, vl, ol, flush
    torch.cuda.empty_cache()
    sa.short_attention_fwd.launches, sa.short_attention_bwd.launches = before

    bounds = short_attention_bounds(B, H, S, D, 2, causal)
    lib = {"short_attention_fwd": "scaled_dot_product_attention, "
                                  f"dropout_p={p}, its own RNG",
           "short_attention_bwd": "autograd of scaled_dot_product_attention"
                                  f" with dropout_p={p}"}
    rows = []
    for (name, (ms, plain_ms, library_ms)), (bound, by), line in zip(
            times.items(), bounds, (139, 163)):
        log(f"[kernels] {name} time at [{B}, {H}, {S}, {D}] bf16 p={p}: "
            f"kernel {ms:.4f} ms | bound {bound:.4f} ms ({by}) | plain "
            f"{plain_ms:.4f} ms | library_ms {library_ms:.4f} ms "
            f"({lib[name]}) | {100 * bound / ms:.1f}% of bound")
        rows.append({"name": name, "route": "cuda",
                     "source": "paddle_tpu_torch/csrc/short_attention.cu",
                     "replaces": "paddle_tpu/ops/pallas_kernels/"
                                 f"short_attention.py:{line}",
                     "max_abs_err": errs[name[-3:]], "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": bound,
                     "bound_by": by, "library_ms": library_ms})
    return rows


# -- phase 8: BERT-base SQuAD fine-tuning ---------------------------------------

BERT_RUN = dict(batch=48, seq=384, steps=5, lr=3e-5)


class QATrain(torch.nn.Module):
    """bench.py's QA wrapper: ``(ids, starts, ends) -> loss``."""

    def __init__(self, cfg, device, seed=0):
        super().__init__()
        from paddle_tpu_torch.models import BertForQuestionAnswering

        self.qa = BertForQuestionAnswering(cfg, device=device, seed=seed)

    def forward(self, ids, starts, ends):
        return self.qa(ids, start_positions=starts, end_positions=ends)


def _bert_batch(vocab, B, S, device, seed=0):
    """ids and span labels as bench.py draws them (int32)."""
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, vocab, (B, S)).astype(np.int32)
    starts = rng.randint(0, S, (B,)).astype(np.int32)
    ends = rng.randint(0, S, (B,)).astype(np.int32)
    return tuple(torch.as_tensor(a, device=device)
                 for a in (ids, starts, ends))


def phase_bert_train(device, limit, cfg=None, run=None):
    """BERT-base QA fine-tuning at bench.py's settings: one warm-up step
    and ``steps`` timed ones.  Returns ({kernel: launches over all
    steps}, step, batch)."""
    from paddle_tpu_torch.models import BertConfig, CompiledTrainStep

    cfg = cfg or BertConfig.base()
    run = dict(BERT_RUN, **(run or {}))
    B, S, n = run["batch"], run["seq"], run["steps"]
    L = cfg.num_hidden_layers
    on_card = device.type == "cuda"
    t0 = time.perf_counter()
    model = QATrain(cfg, device)
    model.train()
    step = CompiledTrainStep(model, lr=run["lr"], compute_dtype="bfloat16",
                             device=device)
    bert = model.qa.bert
    batch = _bert_batch(cfg.vocab_size, B, S, device)
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    log(f"[bert] {L} layers, hidden {cfg.hidden_size}, "
        f"{cfg.num_attention_heads} heads, D "
        f"{cfg.hidden_size // cfg.num_attention_heads}, intermediate "
        f"{cfg.intermediate_size}, vocab {cfg.vocab_size}: "
        f"{bert.num_params() / 1e6:.3f} M encoder parameters, bf16 compute, "
        f"fp32 master and moments, dropout {cfg.hidden_dropout_prob} / "
        f"{cfg.attention_probs_dropout_prob}, remat off, built in "
        f"{time.perf_counter() - t0:.1f} s")
    counters = _train_counters()
    per_step = {k: 0 for k in counters}
    per_step.update(short_attention_fwd=L, short_attention_bwd=L)
    for f in counters.values():
        f.launches = 0
    losses, step_ms = [], []
    for i in range(n + 1):
        before = {k: f.launches for k, f in counters.items()}
        t1 = time.perf_counter()
        loss = float(step.step(*batch))       # float() synchronises
        ms = (time.perf_counter() - t1) * 1e3
        losses.append(loss)
        if i:
            step_ms.append(ms)
        got = {k: f.launches - before[k] for k, f in counters.items()}
        log(f"[bert] step {i}{' (warm-up)' if i == 0 else ''}: loss "
            f"{loss:.6f}, {ms:.1f} ms, short-attention launches "
            f"{got['short_attention_fwd']} fwd / {got['short_attention_bwd']}"
            f" bwd")
        if on_card and got != per_step:
            raise AssertionError(f"[bert] step {i} launched {got}, expected "
                                 f"{per_step} (one short-attention forward "
                                 f"and backward per layer, no remat)")
    launches = {k: f.launches for k, f in counters.items()}
    if not all(np.isfinite(losses)):
        raise AssertionError(f"[bert] losses {losses}: not all finite")
    mean_ms = float(np.mean(step_ms))
    tokens = B * S
    fpt = bert.flops_per_token(S)
    mfu = fpt * tokens / (mean_ms / 1e3) / BF16_FLOPS
    peak = (torch.cuda.max_memory_allocated() / 2**30 if on_card
            else float("nan"))
    log(f"[bert] B={B} S={S}: step {mean_ms:.1f} ms (mean of {n}; "
        f"{', '.join(f'{m:.1f}' for m in step_ms)}) | "
        f"{B / (mean_ms / 1e3):.1f} sequences/s | "
        f"{tokens / (mean_ms / 1e3):.1f} tokens/s | MFU {mfu:.4f} "
        f"(6N + 12LhS = {fpt:.4e} flops/token over "
        f"{BF16_FLOPS / 1e12:g} TFLOP/s bf16) | peak memory {peak:.2f} GiB | "
        f"losses {losses} | {limit}")
    return launches, step, batch


def phase_bert_profile(step, batch):
    """One traced BERT step: device time of the short kernels, cuBLAS,
    the forward's LayerNorms and dropouts, AdamW and the rest, and the
    idle share.  LayerNorm, dropout and the AdamW update are marked with
    ``record_function`` ranges for the traced step only."""
    import contextlib

    from torch.profiler import ProfilerActivity, profile, record_function

    from paddle_tpu_torch.ops import nn_ops

    counters = _train_counters()
    saved = {k: f.launches for k, f in counters.items()}
    real = {"layer_norm": nn_ops.layer_norm, "dropout": nn_ops.dropout}

    def ranged(name, fn):
        def f(*a, **kw):
            with record_function(f"smoke::{name}"):
                return fn(*a, **kw)
        return f

    update = step._update
    torch.cuda.synchronize()
    with contextlib.ExitStack() as stack:
        for name, fn in real.items():
            setattr(nn_ops, name, ranged(name, fn))
            stack.callback(setattr, nn_ops, name, fn)
        step._update = ranged("adamw", update)
        stack.callback(delattr, step, "_update")
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            step.step(*batch)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
    for k, f in counters.items():        # the traced step does not count
        f.launches = saved[k]
    kinds = {"short_attention_fwd": 0.0, "short_attention_bwd": 0.0,
             "gemm": 0.0, "other": 0.0}
    ranges = {"layer_norm": 0.0, "dropout": 0.0, "adamw": 0.0}
    per_kernel = {}
    for ev in prof.key_averages():
        if ev.key.startswith("smoke::"):     # the CPU-side range only
            if ev.device_type == torch.autograd.DeviceType.CPU:
                ranges[ev.key[7:]] += ev.device_time_total / 1e3
            continue
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        ms = ev.self_device_time_total / 1e3
        name = ev.key.lower()
        kind = ("short_attention_fwd" if "sattn_fwd" in name else
                "short_attention_bwd" if ("sattn_bwd" in name
                                          or "sattn_delta" in name) else
                "gemm" if any(k in name for k in ("gemm", "cutlass", "xmma",
                                                  "nvjet", "sm90_"))
                else "other")
        kinds[kind] += ms
        per_kernel[ev.key[:60]] = (ms, ev.count)
    busy = sum(kinds.values())
    log(f"[profile-bert] one step traced: {wall:.1f} ms wall | device busy "
        f"{busy:.1f} ms ({', '.join(f'{k} {v:.1f}' for k, v in kinds.items())}"
        f"; of 'other': forward LayerNorm {ranges['layer_norm']:.1f}, "
        f"forward dropout {ranges['dropout']:.1f}, AdamW "
        f"{ranges['adamw']:.1f}) | idle share {1 - busy / wall:.3f}")
    for name, (ms, calls) in sorted(per_kernel.items(),
                                    key=lambda kv: -kv[1][0])[:12]:
        log(f"[profile-bert]   {ms:9.2f} ms  {calls:5d} launches  {name}")


def phase_bert_parity(device, steps=3):
    """The same BERT weights trained on the card (the short kernel) and
    on the CPU (the einsum path), fp32, dropout 0."""
    from paddle_tpu_torch.models import BertConfig, CompiledTrainStep

    cfg = BertConfig(vocab_size=4096, hidden_size=256, num_hidden_layers=2,
                     num_attention_heads=4, intermediate_size=1024,
                     hidden_dropout_prob=0.0,
                     attention_probs_dropout_prob=0.0)
    counters = _train_counters()
    losses = {}
    for dev in (device, torch.device("cpu")):
        model = QATrain(cfg, "cpu", seed=3)
        step = CompiledTrainStep(model, lr=1e-3, device=dev)
        before = {k: f.launches for k, f in counters.items()}
        batch = _bert_batch(cfg.vocab_size, 2, 256, dev, seed=1)
        losses[dev.type] = [float(step.step(*batch)) for _ in range(steps)]
        launched = {k: f.launches - before[k] for k, f in counters.items()}
        log(f"[bert-parity] {dev.type}: losses {losses[dev.type]}, kernel "
            f"launches {launched}")
        if dev.type == "cuda" and not (
                launched["short_attention_fwd"]
                == launched["short_attention_bwd"]
                == steps * cfg.num_hidden_layers):
            raise AssertionError("[bert-parity] the card run did not take "
                                 f"the short kernel: {launched}")
    got, want = np.array(losses[device.type]), np.array(losses["cpu"])
    rel = float(np.max(np.abs(got - want) / np.abs(want)))
    log(f"[bert-parity] {steps} fp32 steps, 2 layers, hidden 256, 4 heads, "
        f"S=256: max relative loss difference card vs CPU {rel:.3e} (limit "
        f"1e-4: fp32 on both, TF32 off, other summation orders)")
    if not rel <= 1e-4:
        raise AssertionError(f"[bert-parity] losses differ: {losses}")


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this "
              "script runs only on an NVIDIA GPU", file=sys.stderr)
        return 2
    import paddle_tpu_torch  # noqa: F401  (fails outside the repo)
    from paddle_tpu_torch.models import LlamaConfig

    t0 = time.perf_counter()
    device = torch.device("cuda", 0)
    name, limit = phase_device()
    phase_build()
    rows = [phase_kernels(device)]
    train_rows = phase_train_kernels(device)
    quant_rows = phase_quant_kernels(device)
    short_rows = phase_short_kernels(device)
    launches, engine = phase_serve(device)
    rows[0]["launches"] = launches["paged_decode"]
    phase_profile(engine, device)
    del engine
    torch.cuda.empty_cache()
    launches, engine = phase_serve(device, quant="int8")
    for row in quant_rows:
        row["launches"] = launches[row["name"]]
    phase_profile(engine, device)
    del engine
    torch.cuda.empty_cache()
    phase_parity(device)
    phase_parity(device, quant="int8")
    launches, step, batch = phase_train(device, limit)
    for row in train_rows:
        row["launches"] = launches[row["name"]]
    rows += train_rows + quant_rows
    phase_train_profile(step, batch, device)
    del step, batch
    torch.cuda.empty_cache()
    phase_train(device, limit, tag="train-s512",
                cfg=LlamaConfig.llama2_7b(num_hidden_layers=2,
                                          recompute=True),
                run=dict(batch=4, seq=512, steps=2))
    torch.cuda.empty_cache()
    phase_train_parity(device)
    launches, step, batch = phase_bert_train(device, limit)
    for row in short_rows:
        row["launches"] = launches[row["name"]]
    rows += short_rows
    phase_bert_profile(step, batch)
    del step, batch
    torch.cuda.empty_cache()
    phase_bert_parity(device)
    log(f"[done] all phases in {time.perf_counter() - t0:.1f} s")
    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}))
    print(limit)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
