"""Smoke run of the PyTorch port on one NVIDIA GPU (written for the H100).

    python3 chip_smoke.py

Phases, each fatal on failure (the script exits non-zero and prints no
result):

1. device  — name and power limit, torch's CUDA and the NVIDIA driver
             version; TF32 off for matmuls and cuDNN, so fp32 means fp32
             in every comparison below.
2. build   — every kernel under paddle_tpu_torch/csrc, one nvcc each,
             all started together; registers, shared memory and spills
             of every kernel as ptxas reports them; then cuobjdump -sass
             must show HGMMA (wgmma) in each of the six bf16 tensor-core
             attention instantiations, in each of the twelve bf16
             short-attention ones (forward, dK/dV and dQ; D = 64 and 128;
             causal or not) and in each of the four grouped expert FFN
             GEMMs (GEMM 1 and GEMM 2, bf16 and int8 weights), and
             UBLKCP (cp.async.bulk, the page copies) in each of the 55
             paged-decode split-kernel instantiations (bf16 and int8
             pools, D = 64, 128, 256, q-row tiles of 1 to 8); HGMMA in
             the int8-weight matmul's prefill GEMM and HMMA in its four
             decode GEMV instantiations, with no I2F in either.
3. kernels — each kernel against its plain PyTorch version on the same
             CUDA tensors, at the shapes the serving and training paths
             give it, then its time (CUDA events, L2 flushed before each
             launch) beside its bound, the plain version's time and one
             library call's.  Paged decode also at the shapes its first
             kernel refused (G = 8 at an 8192-token window, MQA G = 32,
             D = 256), with 128-token pages (streamed in tiles), at
             lengths on, one past and inside the 256-token split
             boundary and 0, and timed at phase 4b's decode step (B = 8,
             every length 522) too.  3b holds attention at [4, 32, 2048,
             128] bf16 causal, at S=1024, in fp32, with fused RoPE, with
             GQA 32/8 at S=4096, not causal, and at S=4096, and times it
             at the training shape and in the flash region (S=4096
             causal, with and without GQA 32/8; SDPA with enable_gqa
             beside it).
3c. quant kernels — the int8-weight matmul at every Llama-2-7B
             projection shape for M = 8 (decode) and M = 512 (prefill),
             bf16 and f32 x, at gate/up also M = 1, 3, 9, 16, 32, 33, 64
             and 188 (bf16), with NaN in x's rows past M and garbage past K
             and N in the same allocations, and off the TMA shape rule
             (the SIMT kernels); each call must take its route, match
             the plain version and give the same bits twice.  Then
             paged decode over int8 pages at the decode shapes of 3 and
             its new shapes, each against its plain version; timed as
             in 3 (the matmul at all six shape and M pairs, with its
             route).
3e. short kernels — short-sequence attention forward (out, its fp32
             copy, lse) and backward against the plain version at the
             BERT-base shape [48, 12, 384, 64] bf16 with p = 0.1 and 0,
             [4, 12, 384, 64] fp32, Llama's [4, 32, 512, 128] bf16 causal
             and the edges S = 1024 and S = 128; then the dropout mask
             itself (S = D = 128, p = 0.5, v = I and g = I: the zero
             patterns of out and dv equal the plain version's exactly);
             timed at the BERT shape beside the bound, the plain version
             and SDPA with dropout, and the BERT shape's times at p = 0.1
             beside p = 0 (the cost of the mask).
4. serve   — Llama-2-7B at full width and depth in bf16, random weights
             from seed 0 made on the card, 16 seeded requests through
             ServingEngine (8 slots, 16-token pages, 2048-token window,
             512-token prefill chunks), served twice: decode eager (the
             forward launched op by op, the A/B baseline) and decode as
             replayed CUDA graphs (the port's path; one graph per batch
             size, captured at its first step).  Every request must
             finish, the kernel must have run once per layer per decode
             step (replays counted by each graph's capture tally), and
             the two runs must give identical greedy streams and KV pools
             bit for bit; TTFT / TPOT p50 and p99 of both, the graphs
             captured, the replays and the capture seconds.  4b profiles
             decode steps of each with torch.profiler.
4c. int8 serve — the same model and load, both ways, with
             quant="int8": every request finishes, paged_decode_quant
             launches once per layer per decode step, quant_matmul 7
             times per layer per forward (decode steps + prefill
             forwards), the bf16 paged_decode never; the matmul's calls by
             route; 4d profiles its decode steps both ways, quant_matmul's
             device ms apart from cuBLAS's.
4e. aot    — engines with aot="warm" and aot="strict" at phase 4's shape
             (every decode batch and decode_n at n = 8 captured at
             build): no failed warmup entry, phase 4's streams from both,
             AotMissError at a rung with no graph after seal(), and
             decode_n(8) at batch 8 equal to 8 decode steps, each timed.
5. parity  — the same model cut to 2 layers, in fp32: 4 requests on the
             card (the kernels) and on the CPU (the plain versions) must
             give identical greedy streams and first-token logits within
             atol 1e-3, plain (5) and with quant="int8" (5b), with
             aot="off" and with aot="warm" (the card's decode replayed).
6. train   — Llama-2-7B width cut to 8 layers (the only cut: 32 layers of
             fp32 master plus bf16 moments would not fit 80 GB), B=4,
             S=2048, bf16 compute, fp32 master, bf16 moments, full
             recompute, FLAGS_use_fused_rms_norm, lr 1e-4: one warm-up
             step and 5 timed steps through CompiledTrainStep.  Losses
             must be finite and fall; each kernel must launch exactly as
             often per step as full recompute implies.  6b profiles one
             step with torch.profiler.
6d. train S=4096 — Llama-2-7B width x 4 layers at its published 4096-token
             context, B=2 (the same 8192 tokens a step as 6), bf16
             compute, fp32 master, full recompute, attention_impl="auto"
             (the stock-flash region: S > 2048 takes long_attention): 3
             timed steps, exactly 2L forward and L backward attention
             launches per step.
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

3f. grouped kernels — the grouped expert FFN (kernel 10, dense weights)
             and its int8 twin (kernel 11) against their plain versions
             at the MoE bench bucket [8, 2560, 2048] x F = 5504 bf16, at
             C = 20 (a 64-token decode batch), fp32 [4, 256, 256] x 512,
             relu and silu, C = 130, [2, 7, 8, 8], H and F off the
             multiples of 128 through impl="pallas", H above 2048; int8
             at [8, 2560, 2048] and [8, 20, 2048] x 5504, and int8 with H
             and F off the multiples of 128 (and 16) through
             impl="pallas".  Timed beside the bound, the plain version
             and the einsum route; at the bench bucket also GEMM 1 and
             GEMM 2 of the tensor-core route alone.
10. moe train — bench.py's `moe` config (bench.py:1832-1939): its body,
             ep_moe_local forward and backward at T = 8192, H = 2048,
             E = 8, top-2, F = 5504, C = 2560, bf16 tokens and experts,
             fp32 gate; then MoELayer with the same shape on a
             [4, 2048, 2048] bf16 input through CompiledTrainStep (bf16
             compute, fp32 master, lr 1e-4, remat off).  One warm-up and
             5 timed steps each, losses finite, exactly one kernel-10
             launch per step and no kernel-11 launch.  10b profiles one
             MoELayer step with torch.profiler.
10c. moe int8 — ep_moe_local with int8 expert weights at T = 8192 and
             T = 64: one kernel-11 launch per forward, output within a
             relative RMS of 0.05 of the bf16 forward.
11. moe parity — MoELayer at H = 256, F = 512, E = 8, top-2, T = 512,
             fp32: 3 steps on the card (kernel 10) and on the CPU (its
             plain version) give losses within 1e-4 relative.

The line before the last is one JSON object with a row per kernel; the
last line is {"ok": true, "device": {...}}.  Imports nothing of JAX or
of paddle_tpu.
"""
from __future__ import annotations

import gc
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
    drv = subprocess.run(
        ["nvidia-smi", "--query-gpu=driver_version", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[device] {name} | {limit} | torch {torch.__version__} "
        f"cuda {torch.version.cuda} | NVIDIA driver {drv} (stream capture "
        f"keeps programmatic dependent launches from CUDA 12.3) | TF32 off "
        f"for matmul and cuDNN")
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
    check_sass(_build)


def check_sass(build):
    """What the built libraries' SASS (cuobjdump -sass) must hold:
    ``HGMMA`` (wgmma) in every instantiation of ``attn_wg_*``
    (attention), ``sattn_*_wg_kernel`` (short attention),
    ``gffn_wg_kernel`` (the grouped expert FFN's two GEMMs, bf16 and int8
    weights) and ``qmm_wg_kernel`` (the int8-weight matmul's prefill
    GEMM), ``HMMA`` (mma.sync) in every ``qmm_dec_kernel`` (its decode
    GEMV), and ``UBLKCP`` (cp.async.bulk, the page copies) in every
    instantiation of ``paged_decode_split_kernel`` and
    ``paged_decode_quant_split_kernel``; no ``I2F`` (int-to-float) in the
    two ``qmm_`` tensor-core kernels.  Raises if one holds none, or if
    there are not six attention, twelve short-attention, four grouped,
    55 paged-decode, one prefill and four decode instantiations."""
    import re
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    # (library, kernel pattern, instantiations, instruction that each must
    # hold, instruction that none may hold)
    expect = [("long_attention", r"(attn_wg_\w+?_kernel)I(Lb[01])E", 6,
               "HGMMA", None),
              ("short_attention", r"(sattn_\w+?_wg_kernel)I(Li\d+ELb[01])E",
               12, "HGMMA", None),
              ("grouped_gemm", r"(gffn_wg_kernel)I(\w+?Li[12])E", 4,
               "HGMMA", None),
              ("paged_decode", r"\d(paged_decode\w*?_split_kernel)I(\w+?)EEv",
               55, "UBLKCP", None),
              # the int8-weight matmul's tensor-core routes: wgmma in the
              # prefill GEMM, mma.sync in the decode GEMV, and no
              # quarter-rate int-to-float conversion in either
              ("quant_matmul", r"\d(qmm_wg_kernel)()E", 1, "HGMMA", "I2F"),
              ("quant_matmul", r"\d(qmm_dec_kernel)I(Li\d+)E", 4, "HMMA",
               "I2F")]
    sass_of = {}
    for lib, pattern, count, instr, forbid in expect:
        if lib not in sass_of:
            sass_of[lib] = subprocess.run(
                [tool, "-sass", str(build._target(lib))],
                capture_output=True, text=True, timeout=120,
                check=True).stdout
        found, banned = {}, {}
        for chunk in sass_of[lib].split("Function : ")[1:]:
            m = re.search(pattern, chunk.split()[0])
            if m:
                key = f"{m.group(1)}<{_template_args(m.group(2))}>"
                found[key] = chunk.count(instr)
                if forbid:
                    banned[key] = chunk.count(forbid)
        log(f"[build] {instr} instructions per instantiation of {lib} "
            f"(cuobjdump -sass): {found}"
            + (f"; {forbid}: {banned}" if forbid else ""))
        if len(found) != count or not all(found.values()):
            raise AssertionError(f"[build] expected {instr} in the {count} "
                                 f"instantiations of {lib}, found {found}")
        if any(banned.values()):
            raise AssertionError(f"[build] {forbid} in {lib}: {banned}")


def _template_args(mangled):
    """'f13__nv_bfloat16Li128ELi1' -> 'f32,bf16,128,1' (Itanium
    mangling of the types and integers our kernels are templated on)."""
    import re

    names = {"13__nv_bfloat16": "bf16", "f": "f32", "a": "int8"}
    out = []
    while mangled:
        tok = next((t for t in names if mangled.startswith(t)), None)
        if tok:
            out.append(names[tok])
            mangled = mangled[len(tok):]
            continue
        m = re.match(r"S\d*_", mangled)     # a type named before
        if m and out:
            out.append(out[-1])
            mangled = mangled[m.end():]
            continue
        m = re.match(r"L[ib](\d+)E?", mangled)
        if not m:
            out.append(mangled)
            break
        out.append(m.group(1))
        mangled = mangled[m.end():]
    return ",".join(out)


def _ptxas_entries(text):
    """One record per kernel instantiation from ``nvcc -Xptxas -v``."""
    import re

    out, cur = [], None
    for ln in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            # <len><name>_kernel<template args>Ev: keep name and args
            short = re.search(r"\d((?:attn|sattn|rms_norm|paged_decode|qmm|gffn)"
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


#: shapes the first paged-decode kernel refused, and lengths on, one past
#: and inside the 256-token split boundary and 0 (phases 3 and 3c)
PAGED_NEW_CASES = [
    ("G=8 window 8192", dict(B=2, KV=4, G=8, D=128, ps=16, pps=512,
                             lengths=[8192, 6500])),
    ("MQA G=32 window 4096", dict(B=4, KV=1, G=32, D=128, ps=16, pps=256,
                                  lengths=[4096, 3000, 17, 1])),
    ("D=256 G=2", dict(B=3, KV=4, G=2, D=256, ps=16, pps=64,
                       lengths=[1024, 700, 5])),
    ("split boundaries, length 0", dict(B=6, KV=8, G=1, D=128, ps=16,
                                        pps=64, lengths=[256, 257, 512, 513,
                                                         0, 255])),
    # pages wider than a ring stage's 16 KB stream in tiles of rows
    ("pages of 128 tokens, D=256", dict(B=2, KV=2, G=2, D=256, ps=128,
                                        pps=4, lengths=[500, 129])),
]
#: phase 4b's decode step: batch 8, every sequence 522 tokens long
PAGED_SERVING = dict(B=8, KV=32, G=1, D=128, ps=16, pps=128,
                     lengths=[522] * 8)


def _paged_library_ms(q, kd, vd, lens, flush, iters=50):
    """SDPA (bf16) over dense caches kd / vd [B, KV, T, D] already
    gathered, masked to the lengths: the library yardstick."""
    B, _, T, _ = kd.shape
    valid = torch.arange(T, device=q.device)[None] < lens[:, None]
    kd = torch.where(valid[:, None, :, None], kd, 0).to(torch.bfloat16)
    vd = torch.where(valid[:, None, :, None], vd, 0).to(torch.bfloat16)
    qs, mask = q.to(torch.bfloat16)[:, :, None], valid[:, None, None, :]
    F = torch.nn.functional
    return time_ms(
        lambda: F.scaled_dot_product_attention(qs, kd, vd, attn_mask=mask),
        flush, iters=iters)


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
    ] + [(label, shape, (f32, bf16), 2e-5, 0.0, "fp32 math on bf16-exact "
          "values, other summation order")
         for label, shape in PAGED_NEW_CASES] + [
        ("D=256 G=2 bf16", dict(B=3, KV=4, G=2, D=256, ps=16, pps=64,
                                lengths=[1024, 700, 5]),
         (bf16, bf16), 1e-4, 2 ** -7, BF16_WHY),
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

    def dense(pages):
        B, _, D = q.shape
        T = table.shape[1] * pages.shape[2]
        return pages[:, table.long()].transpose(0, 1).reshape(B, -1, T, D)

    ms = time_ms(lambda: pdmod.paged_decode(*args), flush)
    plain_ms = time_ms(lambda: pdmod.paged_decode_reference(*args), flush)
    # library yardstick: SDPA over the dense cache ALREADY gathered
    # (the gather is excluded), bf16 q, boolean length mask
    library_ms = _paged_library_ms(q, dense(kp), dense(vp), lens, flush)
    bound_ms, bound_by = paged_decode_bound(q, kp, lens, table)
    plan = pdmod.split_plan(8, 32, 1, 128, 16, 128)
    log(f"[kernels] paged_decode time at B=8 KV=32 D=128 ps=16 pps=128, "
        f"lengths {[int(x) for x in lens.cpu()]}, q f32 / pool bf16 "
        f"({plan['n_split']} splits of {plan['split_pages']} pages): "
        f"kernel {ms:.4f} ms | bound {bound_ms:.4f} ms ({bound_by}: "
        f"K/V read over {HBM_BYTES_PER_S / 1e12:g} TB/s) | plain "
        f"{plain_ms:.4f} ms | library_ms {library_ms:.4f} ms "
        f"(scaled_dot_product_attention, bf16, over the gathered dense "
        f"cache, gather excluded) | {100 * bound_ms / ms:.1f}% of bound | "
        f"{library_ms / ms:.2f}x faster than the library")
    sargs = make_paged_case(gen, q_dtype=f32, kv_dtype=bf16, device=device,
                            **PAGED_SERVING)
    s_ms = time_ms(lambda: pdmod.paged_decode(*sargs), flush)
    s_bound, _ = paged_decode_bound(sargs[0], sargs[1], sargs[3], sargs[4])
    log(f"[kernels] paged_decode time at phase 4b's decode step (B=8, every "
        f"length 522, q f32 / pool bf16): kernel {s_ms:.4f} ms | bound "
        f"{s_bound:.4f} ms | {100 * s_bound / s_ms:.1f}% of bound")
    pdmod.paged_decode.launches = before   # timing launches do not count
    del flush, sargs
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


def attention_bounds(B, H, S, D, elem_bytes, causal=True, Hkv=None):
    """(fwd, bwd) (bound_ms, bound_by): the multiply-adds of the causal
    (i, j <= i) pairs (all pairs when not causal), two products forward
    and five backward, over the bf16 tensor-core rate (fp32 inputs: the
    fp32 rate), against q, k, v, out (and g, dq, dk, dv) moved once over
    HBM rate; k, v, dk, dv have Hkv heads."""
    Hkv = H if Hkv is None else Hkv
    pairs = S * (S + 1) // 2 if causal else S * S
    rate = BF16_FLOPS if elem_bytes == 2 else FP32_FLOPS
    one = B * H * S * D * elem_bytes
    kv = B * Hkv * S * D * elem_bytes
    out = []
    for n_products, nbytes in ((2, 2 * one + 2 * kv + 4 * B * H * S),
                               (5, 4 * one + 4 * kv + 4 * B * H * S)):
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

    # attention: (B, H, Hkv, S, dtype, rope_base, causal); bf16 without
    # RoPE takes the tensor-core kernels, the rest the fp32-core ones
    attn_cases = [(B, H, H, S, bf16, None, True),
                  (B, H, H, 1024, bf16, None, True),
                  (B, H, H, S, f32, None, True),
                  (B, H, H, S, bf16, 10000.0, True),
                  (2, H, 8, 4096, bf16, None, True),     # GQA 32/8
                  (B, H, H, S, bf16, None, False),       # not causal
                  (2, H, H, 4096, bf16, None, True)]     # S = 4096
    attn_err = {}
    scale = 1.0 / np.sqrt(D)
    for b, hh, hkv, s, dt, rb, causal in attn_cases:
        q, g = (torch.randn(b, hh, s, D, generator=gen,
                            device=device).to(dt) for _ in range(2))
        k, v = (torch.randn(b, hkv, s, D, generator=gen,
                            device=device).to(dt) for _ in range(2))
        out, lse = la.attention_fwd(q, k, v, scale, causal, rb)
        grads = la.attention_bwd(q, k, v, out, lse, g, scale, causal, rb)
        torch.cuda.synchronize()
        wout, wlse = la.attention_fwd_plain(q, k, v, scale, causal, rb)
        tag = (f"B={b} H={hh} Hkv={hkv} S={s} D={D} {dt} rope_base={rb} "
               f"causal={causal}")
        if dt == f32:
            tol = dict(out=(2e-5, 0.0), lse=(2e-5, 0.0), grad=(1e-4, 0.0))
            why = "fp32 throughout, other summation order"
            gwhy = why
        else:
            tol = dict(out=(2e-3, 2 ** -7), lse=(1e-3, 0.0),
                       grad=(5e-3, 2 ** -6))
            why = BF16_WHY
            gwhy = ("bf16 outputs of sums over up to 4 x 4096 fp32 terms "
                    "(P and dS enter the tensor cores as bf16 hi + lo)")
        e1 = _hold(f"attention_fwd out {tag}", out, wout, *tol["out"], why)
        _hold(f"attention_fwd lse {tag}", lse, wlse, *tol["lse"],
              "fp32, other summation order")
        del wout, wlse
        torch.cuda.empty_cache()
        wgrads = la.attention_bwd_plain(q, k, v, out, lse, g, scale,
                                        causal, rb)
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
    del q, k, v, g, out, lse, ql, kl, vl, ol
    torch.cuda.empty_cache()
    flash_region_times(la, gen, flush, iters)
    del flush
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


FLASH_SHAPES = [  # (label, B, H, Hkv): the stock-flash region, S = 4096
    ("causal S=4096", 2, 32, 32),
    ("causal S=4096, GQA 32/8 (Llama-3-8B's head layout)", 2, 32, 8)]


def flash_region_times(la, gen, flush, iters, S=4096, D=128):
    """Kernel, plain and SDPA times (forward, backward) at the flash
    region's shapes, bf16 causal, beside the bound; logged, not rows of
    the kernels line (the rows time the training shape)."""
    F = torch.nn.functional
    bf16 = torch.bfloat16
    scale = 1.0 / np.sqrt(D)
    for label, B, H, Hkv in FLASH_SHAPES:
        q, g = (torch.randn(B, H, S, D, generator=gen, device=flush.device)
                .to(bf16) for _ in range(2))
        k, v = (torch.randn(B, Hkv, S, D, generator=gen, device=flush.device)
                .to(bf16) for _ in range(2))
        out, lse = la.attention_fwd(q, k, v, scale, True)
        gqa = Hkv != H
        ql, kl, vl = (a.detach().requires_grad_(True) for a in (q, k, v))
        ol = F.scaled_dot_product_attention(ql, kl, vl, is_causal=True,
                                            enable_gqa=gqa)
        fns = {
            "attention_fwd": (
                lambda: la.attention_fwd(q, k, v, scale, True),
                lambda: la.attention_fwd_plain(q, k, v, scale, True),
                lambda: F.scaled_dot_product_attention(
                    q, k, v, is_causal=True, enable_gqa=gqa)),
            "attention_bwd": (
                lambda: la.attention_bwd(q, k, v, out, lse, g, scale, True),
                lambda: la.attention_bwd_plain(q, k, v, out, lse, g, scale,
                                               True),
                lambda: torch.autograd.grad(ol, (ql, kl, vl), g,
                                            retain_graph=True))}
        bounds = attention_bounds(B, H, S, D, 2, True, Hkv)
        for (name, (kern, plain, lib)), (bound, by) in zip(fns.items(),
                                                           bounds):
            ms = time_ms(kern, flush, iters=iters)
            plain_ms = time_ms(plain, flush, iters=2, warmup=1)
            lib_ms = time_ms(lib, flush, iters=iters)
            torch.cuda.empty_cache()
            log(f"[kernels] {name} time at {label} [{B}, {H}/{Hkv}, {S}, "
                f"{D}] bf16: kernel {ms:.4f} ms | bound {bound:.4f} ms "
                f"({by}) | plain {plain_ms:.4f} ms | library_ms "
                f"{lib_ms:.4f} ms (SDPA{', enable_gqa' if gqa else ''}"
                f"{'' if name == 'attention_fwd' else ', autograd'}) | "
                f"{100 * bound / ms:.1f}% of bound | {ms / lib_ms:.2f}x "
                f"SDPA")
        del q, k, v, g, out, lse, ql, kl, vl, ol
        torch.cuda.empty_cache()


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
    qm.quant_matmul.routes = dict.fromkeys(qm.ROUTES, 0)

    def hold_qmm(label, M, xs, qw, sc, want_route):
        """One call, which must take ``want_route``, match the plain
        version and give the same bits when repeated."""
        before = dict(qm.quant_matmul.routes)
        got = qm.quant_matmul(xs, qw, sc)
        took = [r for r in qm.ROUTES
                if qm.quant_matmul.routes[r] != before[r]]
        if took != [want_route]:
            raise AssertionError(f"[kernels] quant_matmul {label}: took "
                                 f"{took}, expected {want_route}")
        torch.cuda.synchronize()
        want = qm.quant_matmul_reference(xs, qw, sc)
        if xs.dtype == f32:
            tol = (2e-4, 0.0, "fp32 sums of up to 11008 products "
                   "in other orders, |out| ~ 2")
        else:
            tol = (2e-4, 2 ** -7, BF16_WHY)
        err = _hold(f"quant_matmul {label} x {xs.dtype} ({want_route})",
                    got, want, *tol)
        qmm_err[(M, xs.dtype)] = max(qmm_err.get((M, xs.dtype), 0.0), err)
        if not torch.equal(qm.quant_matmul(xs, qw, sc), got):
            raise AssertionError(f"[kernels] quant_matmul {label}: a second "
                                 "call gave other bits")
        return err

    for label, (K, N) in QMM_SHAPES.items():
        w = torch.randn(K, N, generator=gen, device=device) * 0.02
        qw, sc = tq.quantize_per_channel(w)
        sc = sc.reshape(N)
        w_bf16 = tq.dequantize(qw, sc, bf16)      # the library's weight
        del w
        # every shape at decode and prefill M; gate/up also at the GEMV's
        # other row counts, past them, and a prompt's last chunk (188)
        extra = (1, 3, 9, 16, 32, 33, 64, 188) \
            if label == "gate/up_proj" else ()
        for M in (8, 512) + extra:
            x = torch.randn(M, K, generator=gen, device=device)
            for xd in ((bf16, f32) if M in (8, 512) else (bf16,)):
                xs = x.to(xd)
                hold_qmm(f"{label} M={M} K={K} N={N}", M, xs, qw, sc,
                         qm.route(M, K, N, xd))
            if M not in (8, 512):
                continue
            xb = x.to(bf16)
            timed[(label, M)] = (
                [time_ms(f, flush, iters=iters) for f in (
                    lambda: qm.quant_matmul(xb, qw, sc),
                    lambda: qm.quant_matmul_reference(xb, qw, sc),
                    lambda: torch.matmul(xb, w_bf16))],
                quant_matmul_bound(M, K, N, 2), qm.route(M, K, N, bf16))
            del x, xb
        if label == "gate/up_proj":
            # x rows past M, weight rows past K and scales past N hold NaN
            # or garbage in the same allocations: none may reach out
            for M in (9, 188):
                xbig = torch.randn(M + 64, K, generator=gen, device=device)
                xbig[M:] = float("nan")
                wbig = torch.full((K + 64, N), 127, dtype=torch.int8,
                                  device=device)
                wbig[:K] = qw
                sbig = torch.full((N + 64,), float("nan"), device=device)
                sbig[:N] = sc
                hold_qmm(f"{label} M={M} K={K} N={N}, NaN rows past M",
                         M, xbig.to(bf16)[:M], wbig[:K], sbig[:N],
                         qm.route(M, K, N, bf16))
                del xbig, wbig, sbig
        del qw, sc, w_bf16
        torch.cuda.empty_cache()
    # shapes TMA cannot describe take the SIMT kernels (any M, K and N)
    for M, K, N in ((3, 100, 37), (8, 4100, 4096), (77, 300, 130),
                    (188, 4096, 4100)):
        w = torch.randn(K, N, generator=gen, device=device) * 0.02
        qw, sc = tq.quantize_per_channel(w)
        x = torch.randn(M, K, generator=gen, device=device).to(bf16)
        hold_qmm(f"off the TMA rule M={M} K={K} N={N}", M, x, qw,
                 sc.reshape(N), "simt")
    log(f"[kernels] quant_matmul routes over the checks: "
        f"{dict(qm.quant_matmul.routes)}")
    for (label, M), ((ms, plain_ms, lib_ms), (bound, by), kind) in \
            timed.items():
        log(f"[kernels] quant_matmul time at {label} M={M} x bf16 ({kind} "
            f"route): kernel {ms:.4f} ms | bound {bound:.4f} ms ({by}) | "
            f"plain {plain_ms:.4f} ms | library_ms {lib_ms:.4f} ms "
            f"(torch.matmul over the weight dequantized to bf16 "
            f"beforehand) | {100 * bound / ms:.1f}% of bound | "
            f"{ms / lib_ms:.2f}x the library's time")

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
    ] + [(label, shape, f32, 2e-5, 0.0, "fp32 math on the same dequantized "
          "values, other summation order")
         for label, shape in PAGED_NEW_CASES] + [
        ("MQA G=32 q bf16", dict(PAGED_NEW_CASES[1][1]), bf16, 1e-4,
         2 ** -7, BF16_WHY),
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

    library_ms = _paged_library_ms(q, dense(kq, ks), dense(vq, vs), lens,
                                   flush, iters=iters)
    pdq_bound, pdq_by = paged_decode_quant_bound(q, kq, lens, table)
    log(f"[kernels] paged_decode_quant time at B=8 KV=32 D=128 ps=16 "
        f"pps=128, lengths {l7b}, q f32 / pool int8: kernel {ms:.4f} ms | "
        f"bound {pdq_bound:.4f} ms ({pdq_by}) | plain {plain_ms:.4f} ms | "
        f"library_ms {library_ms:.4f} ms (scaled_dot_product_attention, "
        f"bf16, over the gathered and dequantized cache, gather and "
        f"dequantization excluded) | {100 * pdq_bound / ms:.1f}% of bound | "
        f"{library_ms / ms:.2f}x faster than the library")
    sargs = make_quant_paged_case(gen, q_dtype=f32, device=device,
                                  **PAGED_SERVING)
    s_ms = time_ms(lambda: pdmod.paged_decode_quant(*sargs), flush,
                   iters=iters)
    s_bound, _ = paged_decode_quant_bound(sargs[0], sargs[1], sargs[3],
                                          sargs[4])
    log(f"[kernels] paged_decode_quant time at phase 4d's decode step (B=8, "
        f"every length 522, q f32 / pool int8): kernel {s_ms:.4f} ms | "
        f"bound {s_bound:.4f} ms | {100 * s_bound / s_ms:.1f}% of bound")
    del flush, args, q, kq, vq, sargs
    torch.cuda.empty_cache()
    qm.quant_matmul.launches, pdmod.paged_decode_quant.launches = before
    qm.quant_matmul.routes = dict.fromkeys(qm.ROUTES, 0)

    (qmm_ms, qmm_plain, qmm_lib), (qmm_bound, qmm_by), _ = \
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


def _streams(out):
    return {rid: list(h.tokens) for rid, h in out["handles"].items()}


def _first_diff(got, want):
    """(rid, token index) of the first difference of two stream dicts."""
    for rid in sorted(want):
        a, b = got.get(rid, []), want[rid]
        for i in range(max(len(a), len(b))):
            if i >= len(a) or i >= len(b) or a[i] != b[i]:
                return rid, i
    return None


def phase_serve(device, cfg=None, load=None, dtype=torch.bfloat16,
                engine_kw=None, quant="none", eager=False, tag=None):
    """Serve ``load`` through a ServingEngine built on seeded weights.
    ``eager`` runs decode's forward op by op (the executor's private A/B
    switch); else decode replays CUDA graphs, captured at each new batch
    or, with ``aot`` in ``engine_kw``, at build.  Returns ({kernel:
    launches in the run}, engine, {rid: tokens})."""
    from paddle_tpu_torch.inference.server import RequestState, ServingEngine
    from paddle_tpu_torch.models import LlamaConfig, init_llama_params
    from paddle_tpu_torch.testing.load import (
        LoadSpec, generate_load, run_load,
    )

    cfg = LlamaConfig.llama2_7b() if cfg is None else cfg
    load = SERVE_LOAD if load is None else load
    engine_kw = SERVE_KW if engine_kw is None else engine_kw
    if tag is None:
        tag = ("serve" if quant == "none" else f"serve-{quant}") \
            + (" eager" if eager else " graph")
    t0 = time.perf_counter()
    params = init_llama_params(cfg, seed=0, device=device, dtype=dtype)
    nparams = (sum(t.numel() for t in params["layers"].values())
               + params["embed"].numel()
               + (0 if params["lm_head"] is None
                  else params["lm_head"].numel()))
    engine = ServingEngine(cfg, params, dtype=dtype, device=device,
                           quant=quant, **engine_kw)
    del params          # an int8 engine keeps no dense projection
    ex = engine.executor
    ex._eager_decode = eager
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
        f"quant={quant}, aot={engine.aot_mode}, built in "
        f"{time.perf_counter() - t0:.1f} s; {resident:.2f} GiB resident "
        f"(weights, KV pool and any warmed graphs)")
    rep = engine._aot_report
    if rep is not None:
        log(f"[{tag}] warmup: {rep['entries']} entries, {rep['capture']} "
            f"captured, {rep['warm']} warm, {len(rep['failed'])} failed, "
            f"{rep['seconds']} s; programs {rep['programs']}; ladder "
            f"{rep['ladder']}; page buckets {rep['page_buckets']}")
        if rep["failed"]:
            raise AssertionError(f"[{tag}] warmup entries failed: "
                                 f"{rep['failed']}")
    progs = ex.programs
    before = {k: (p.traces, p.dispatches, p.seconds)
              for k, p in progs.items()}
    work = generate_load(LoadSpec(**dict(load, vocab=cfg.vocab_size)))
    counters = _serve_counters()
    for f in counters.values():
        f.launches = 0
    qmm = counters["quant_matmul"]
    qmm.routes = dict.fromkeys(qmm.routes, 0)
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
                f"[{tag}] {w['rid']}: {h.state.value}, {len(toks)} of "
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
    d = {k: (p.traces - before[k][0], p.dispatches - before[k][1],
             p.seconds - before[k][2]) for k, p in progs.items()}
    log(f"[{tag}] programs in the run: " + "; ".join(
        f"serve.{k} {n} captured in {sec:.3f} s, {r} "
        + ("eager calls" if device.type != "cuda" else "replays")
        for k, (n, r, sec) in d.items())
        + (" (decode eager: no program called)" if eager else ""))
    if eager and any(r for _, r, _ in d.values()):
        raise AssertionError(f"[{tag}] the eager A/B ran a program: {d}")
    if not eager and d["decode"][1] != steps:
        raise AssertionError(f"[{tag}] {d['decode'][1]} serve.decode "
                             f"calls for {steps} decode steps")
    if quant == "int8":
        log(f"[{tag}] quant_matmul calls by route: {dict(qmm.routes)}")
    return got, engine, _streams(out)


def _live_pools(engine):
    """The KV pool (and int8 scales) without the scratch page, on the
    host: what a load wrote, to hold two runs bit for bit."""
    c = engine.executor.cache
    ts = [c.k_pages, c.v_pages]
    if c.k_scales is not None:
        ts += [c.k_scales, c.v_scales]
    return [t.cpu() for t in ts]


def phase_serve_ab(device, quant="none", **kw):
    """Phases 4 / 4c with 4b / 4d: the load served with decode eager,
    then as replayed graphs, each followed by its decode profile.  The
    greedy streams and the KV pools the load wrote must be identical.
    Returns (launches of the graph run, its streams)."""
    _, engine, want = phase_serve(device, quant=quant, eager=True, **kw)
    pools = _live_pools(engine)
    if device.type == "cuda":
        phase_profile(engine, device)
    del engine
    _empty(device)
    got, engine, streams = phase_serve(device, quant=quant, **kw)
    tag = "serve" if quant == "none" else f"serve-{quant}"
    if streams != want:
        raise AssertionError(f"[{tag}] graph decode streams differ from "
                             f"eager at {_first_diff(streams, want)}")
    same = all(torch.equal(a, b) for a, b in zip(_live_pools(engine), pools))
    if not same:
        raise AssertionError(f"[{tag}] the KV pools of the graph and eager "
                             f"runs differ")
    log(f"[{tag}] graph decode = eager decode: identical greedy streams "
        f"({sum(map(len, streams.values()))} tokens) and KV pools bit for "
        f"bit")
    del pools
    if device.type == "cuda":
        phase_profile(engine, device)
    del engine
    _empty(device)
    return got, streams


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize()


def _empty(device):
    gc.collect()         # an executor and its graphs form a cycle
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


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
    engine.step()          # the first step at batch 8 may capture
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_steps):
        engine.step()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / n_steps * 1e3
    decode = ex.programs["decode"]
    replays = decode.dispatches
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            engine.step()
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t0) / n_steps * 1e3
    replays = decode.dispatches - replays
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
    mode = "eager" if ex._eager_decode else "graph"
    tag = ("profile" if ex.quant == "none" else f"profile-{ex.quant}") \
        + f" {mode}"
    if mode == "graph" and (replays != n_steps or not busy):
        raise AssertionError(
            f"[{tag}] {replays} replays in {n_steps} traced steps, "
            f"{busy:.3f} ms of device time attributed to them")
    log(f"[{tag}] decode step at batch {len(handles)}, lengths "
        f"{min(lens)}-{max(lens)}: {step_ms:.3f} ms untraced, "
        f"{traced_ms:.3f} ms traced | device busy {busy:.3f} ms/step ("
        + ", ".join(f"{k} {v:.3f}" for k, v in kinds.items() if v or
                    k in ("gemm", "other"))
        + f") | idle share {1 - busy / traced_ms:.3f} (of the untraced "
        f"step {max(0.0, 1 - busy / step_ms):.3f}) | {replays} graph "
        f"replays traced | weight-read bound "
        f"{weight_bytes / HBM_BYTES_PER_S * 1e3:.3f} ms/step "
        f"({weight_bytes / 1e9:.3f} GB of layer and head weights)")
    if ex.quant == "int8":
        log(f"[{tag}] int8 weight GEMMs: quant_matmul (qmm_ kernels) "
            f"{kinds['quant_matmul']:.3f} ms/step, cuBLAS (the bf16 LM "
            f"head) {kinds['gemm']:.3f} ms/step")
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1][0])[:8]
    for name, (ms, calls) in top:
        log(f"[{tag}]   {ms:8.3f} ms/step  {calls:6.1f} launches/step  "
            f"{name}")
    for h in handles:
        h.cancel()
    engine.step()


# -- phase 4e: the AOT plane -------------------------------------------------

def _fill_slots(engine, prompts, max_new):
    """Admit one request per prompt and step until every prefill is done;
    returns the handles (their slots decode next)."""
    handles = [engine.submit(p, max_new_tokens=max_new) for p in prompts]
    while engine.scheduler.queue or engine.scheduler.prefilling:
        engine.step()
    return handles


def _drain(engine, handles):
    for h in handles:
        h.cancel()
    engine.step()


def _agreement(got, want):
    """(requests whose streams are equal, tokens before each request's
    first difference, tokens in all)."""
    same = lead = 0
    for rid, b in want.items():
        a = got[rid]
        n = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                 min(len(a), len(b)))
        lead += n
        same += a == b
    return same, lead, sum(map(len, want.values()))


def phase_aot(device, phase4, cfg=None, load=None, dtype=torch.bfloat16,
              engine_kw=None, n=8, rounds=3, prompt=512):
    """Phase 4e: engines with aot="warm" and aot="strict" (decode at every
    batch and decode_n at n captured at build) serve phase 4's load with
    no failed warmup entry.  The ladder floors prefill chunks onto powers
    of two, so a prompt is prefilled in other chunks than in phase 4:
    the streams must equal those of an engine with the same ladder and
    decode eager (the graphs change nothing), and their agreement with
    phase 4's streams ``phase4`` is reported.  After seal(), a rung with
    no graph raises AotMissError.  Then every slot of both engines holds
    the same ``prompt``-token request, and ``rounds`` times the warm
    engine takes n decode steps while the strict one takes one
    decode_n(n): the same tokens, each timed."""
    from paddle_tpu_torch.core.aot import AotMissError

    engine_kw = SERVE_KW if engine_kw is None else engine_kw
    kw = dict(engine_kw, aot="warm", decode_n_steps=(n,))
    _, eng, want = phase_serve(device, cfg=cfg, load=load, dtype=dtype,
                               tag="aot-warm eager", engine_kw=kw,
                               eager=True)
    del eng
    _empty(device)
    same, lead, total = _agreement(want, phase4)
    log(f"[aot] ladder-chunked prefill vs phase 4's chunks, decode eager: "
        f"{same} of {len(phase4)} streams equal, {lead} of {total} tokens "
        f"before each stream's first difference (other chunk lengths, so "
        f"other GEMM shapes and bf16 rounding in the prefill)")
    # the control: no ladder, only another chunk length
    half = dict(engine_kw, prefill_chunk=engine_kw["prefill_chunk"] // 2)
    _, eng, other = phase_serve(device, cfg=cfg, load=load, dtype=dtype,
                                tag="aot control", engine_kw=half)
    del eng
    _empty(device)
    same, lead, total = _agreement(other, phase4)
    log(f"[aot] control, aot=off with prefill_chunk="
        f"{half['prefill_chunk']}: {same} of {len(phase4)} streams equal "
        f"to phase 4's, {lead} of {total} tokens before each stream's "
        f"first difference")
    engines = {}
    for mode in ("warm", "strict"):
        _, eng, streams = phase_serve(
            device, cfg=cfg, load=load, dtype=dtype, tag=f"aot-{mode}",
            engine_kw=dict(kw, aot=mode))
        if streams != want:
            raise AssertionError(
                f"[aot-{mode}] streams differ from the eager run with the "
                f"same ladder at {_first_diff(streams, want)}")
        log(f"[aot-{mode}] greedy streams identical to the eager run with "
            f"the same ladder ({sum(map(len, want.values()))} tokens)")
        engines[mode] = eng
    ex = engines["strict"].executor
    ms = ex.cache.max_seqs
    rng = np.random.RandomState(11)
    prompts = [rng.randint(1, ex.config.vocab_size, prompt)
               for _ in range(ms)]
    hs = {m: _fill_slots(e, prompts, rounds * n + 4)
          for m, e in engines.items()}
    sids = {m: sorted(h._req.sid for h in hs[m]) for m in engines}
    for rung, call in (((ms + 1,), lambda: ex.programs["decode"]((ms + 1,))),
                       ((ms, n + 1), lambda: ex.decode_n(sids["strict"],
                                                         n + 1))):
        try:
            call()
        except AotMissError as e:
            log(f"[aot-strict] sealed: rung {rung} raised AotMissError "
                f"({str(e)[:80]}...)")
        else:
            raise AssertionError(f"[aot-strict] rung {rung} ran after "
                                 f"seal()")
    warm = engines["warm"].executor
    states = {m: ({s: engines[m].executor.last_token[s] for s in sids[m]},
                  engines[m].executor.cache.lengths[sids[m]].tolist())
              for m in engines}
    if states["warm"][1] != states["strict"][1] or \
            list(states["warm"][0].values()) != \
            list(states["strict"][0].values()):
        raise AssertionError(f"[aot] the two engines' slots differ before "
                             f"decode_n: {states}")
    t_dec, t_n = [], []
    for _ in range(rounds):
        _sync(device)
        t0 = time.perf_counter()
        steps = [warm.decode(sids["warm"]) for _ in range(n)]
        _sync(device)
        t_dec.append((time.perf_counter() - t0) / n * 1e3)
        t0 = time.perf_counter()
        got = ex.decode_n(sids["strict"], n)
        _sync(device)
        t_n.append((time.perf_counter() - t0) / n * 1e3)
        dec = [[st[s] for st in steps] for s in sids["warm"]]
        if [got[s] for s in sids["strict"]] != dec:
            raise AssertionError(f"[aot] decode_n({n}) differs from {n} "
                                 f"decode steps: {got} vs {dec}")
    log(f"[aot] decode_n({n}) at batch {ms} = {n} decode steps over "
        f"{rounds} rounds ({rounds * n * ms} tokens, lengths "
        f"{prompt + 1}-{prompt + rounds * n}): ms per step "
        f"{', '.join(f'{t:.3f}' for t in t_n)} (decode_n) vs "
        f"{', '.join(f'{t:.3f}' for t in t_dec)} (decode), host wall, "
        f"synchronised")
    for m, e in engines.items():
        _drain(e, hs[m])
    del engines, ex, warm
    _empty(device)


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
    cpu = torch.device("cpu")
    for dev, p, aot in ((device, params, "off"), (cpu, cpu_params, "off"),
                        (device, params, "warm"), (cpu, cpu_params, "warm")):
        before = {k: f.launches for k, f in counters.items()}
        eng = ServingEngine(cfg, p, dtype=torch.float32, device=dev,
                            quant=quant, aot=aot, **PARITY_KW)
        out = run_load(eng, work)
        streams[dev.type, aot] = {rid: h.tokens
                                  for rid, h in out["handles"].items()}
        launched = {k: f.launches - before[k] for k, f in counters.items()}
        dec = eng.executor.programs["decode"]
        log(f"[{tag}] {dev.type} aot={aot}: "
            f"{out['stats']['decode_steps']} decode steps, kernel launches "
            f"{launched}, serve.decode {dec.dispatches} calls, "
            f"{dec.traces} captured")
        if dev.type == "cuda" and not all(launched.values()):
            raise AssertionError(f"[{tag}] the card run missed a kernel: "
                                 f"{launched}")
    if streams[device.type, "warm"] != streams[device.type, "off"]:
        raise AssertionError(f"[{tag}] aot=warm and aot=off streams "
                             f"differ on {device.type}: {streams}")
    for aot in ("off", "warm"):
        if streams[device.type, aot] != streams["cpu", aot]:
            raise AssertionError(f"[{tag}] aot={aot}: greedy streams "
                                 f"differ: {streams}")
        log(f"[{tag}] aot={aot}: greedy streams identical on "
            f"{device.type} and cpu for {len(work)} requests "
            f"({sum(map(len, streams['cpu', aot].values()))} tokens)")


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
    Attention takes the long_attention kernels at S >= 1024 (the long
    route up to 2048, the flash route above) and the short one below,
    2L forward and L backward launches per step either way."""
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
                "attention_fwd" if ("attn_fwd" in name
                                    or "attn_wg_fwd" in name) else
                "attention_bwd" if ("attn_bwd" in name or "attn_wg_dkdv"
                                    in name or "attn_wg_dq" in name
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

    f1, b1 = kernel_ms["bert-base p=0.1"]
    f0, b0 = kernel_ms["bert-base p=0"]
    log(f"[kernels] short_attention mask cost at [48, 12, 384, 64] bf16: "
        f"fwd {f1:.4f} ms at p=0.1 vs {f0:.4f} ms at p=0 "
        f"({100 * (f1 / f0 - 1):+.1f}%), bwd {b1:.4f} vs {b0:.4f} ms "
        f"({100 * (b1 / b0 - 1):+.1f}%)")

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


# -- phase 3f: the grouped expert FFN kernels ----------------------------------

#: bench.py's `moe` config (bench.py:1832-1939): d_model, experts, top-k,
#: FFN width, tokens, capacity factor
MOE = dict(H=2048, E=8, k=2, F=5504, T=8192, cf=1.25)


def moe_capacity(T, E=MOE["E"], k=MOE["k"], cf=MOE["cf"]):
    """Slots per expert, on the host as both packages compute it."""
    return min(T, max(1, int(np.ceil(T * cf * k / E))))


def grouped_ffn_bound(E, C, H, F, x_bytes, w_bytes, scales=False):
    """(bound_ms, bound_by): 4·E·C·H·F flops over the bf16 tensor-core
    rate (fp32 x: the fp32 rate) against x, weights, biases, scales and
    out moved once over HBM rate."""
    rate = FP32_FLOPS if x_bytes == 4 else BF16_FLOPS
    nbytes = (2 * E * C * H * x_bytes + 2 * E * H * F * w_bytes
              + E * (F + H) * (x_bytes + (4 if scales else 0)))
    to = 4 * E * C * H * F / rate * 1e3
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    return (to, "operations") if to >= tb else (tb, "bytes")


#: (label, E, C, H, F, dtype, activation, impl forced)
GROUPED_CASES = [
    ("bench bucket", 8, 2560, 2048, 5504, torch.bfloat16, "gelu", None),
    ("decode C=20 (T=64)", 8, 20, 2048, 5504, torch.bfloat16, "gelu", None),
    ("fp32", 4, 256, 256, 512, torch.float32, "gelu", None),
    ("relu", 4, 256, 512, 1024, torch.bfloat16, "relu", None),
    ("silu", 4, 256, 512, 1024, torch.bfloat16, "silu", None),
    ("C=130", 8, 130, 1024, 768, torch.bfloat16, "gelu", None),
    ("tiny", 2, 7, 8, 8, torch.bfloat16, "silu", None),
    ("tiny fp32", 2, 7, 8, 8, torch.float32, "silu", None),
    ("H, F not multiples of 128", 4, 64, 200, 300, torch.bfloat16, "gelu",
     "pallas"),
    ("H > 2048, F ragged, fp32", 2, 40, 2176, 200, torch.float32, "tanh",
     "pallas"),
]
GROUPED_Q_CASES = [("int8 bench bucket", 8, 2560), ("int8 decode C=20", 8, 20)]
#: (E, C, H, F) of the int8 case off the multiples of 128 (and of 16)
GROUPED_Q_RAGGED = (4, 64, 200, 300)


def _time_halves(gg, args, act, flush, iters):
    """Milliseconds of GEMM 1 alone and GEMM 2 alone of the tensor-core
    route on ``args`` (x, w1, s1, b1, w2, s2, b2)."""
    return tuple(time_ms(lambda p=p: gg._launch(*args, act, "halves",
                                                passes=p), flush, iters)
                 for p in (1, 2))


def _moe_weights(gen, E, H, F, dtype, device, scale=0.02):
    w1 = (torch.randn(E, H, F, generator=gen, device=device) * scale)
    w2 = (torch.randn(E, F, H, generator=gen, device=device) * scale)
    b1 = torch.randn(E, 1, F, generator=gen, device=device) * scale
    b2 = torch.randn(E, 1, H, generator=gen, device=device) * scale
    return [t.to(dtype) for t in (w1, b1, w2, b2)]


def _hold_grouped(label, got, want):
    if want.dtype == torch.float32:
        atol = 1e-5 * want.abs().max().item()
        return _hold(label, got, want, atol, 1e-5,
                     "fp32 sums of up to 2048 products in another order")
    atol = 1e-3 * want.float().abs().max().item()
    return _hold(label, got, want, atol, 2 ** -7, BF16_WHY)


def phase_grouped_kernels(device, iters=10):
    """Kernels 10 and 11 against their plain versions on the card at the
    MoE bench shape, a decode-sized C, fp32, other activations and ragged
    edges, each timed beside its bound, the plain version and the einsum
    route (the library call).  Returns their two rows."""
    from paddle_tpu_torch.ops import quant as tq
    from paddle_tpu_torch.ops.kernels import grouped_gemm as gg

    gen = torch.Generator(device=device)
    gen.manual_seed(97531)
    before = (gg.grouped_ffn.launches, gg.grouped_ffn_q.launches)
    flush = torch.empty(256 * 1024 * 1024, dtype=torch.uint8, device=device)
    errs, timed, halves = {"grouped_ffn": 0.0, "grouped_ffn_q": 0.0}, {}, {}
    bench_w = None
    for label, E, C, H, F, dt, act, impl in GROUPED_CASES:
        x = torch.randn(E, C, H, generator=gen, device=device).to(dt)
        w1, b1, w2, b2 = _moe_weights(gen, E, H, F, dt, device)
        if impl is None:
            got = gg.grouped_ffn_fwd(x, w1, b1, w2, b2, act)
        else:       # through the router, the kernel route forced
            got = gg.grouped_ffn(x, w1, b1, w2, b2, act, impl=impl)
        torch.cuda.synchronize()
        want = gg.grouped_ffn_reference(x, w1, b1, w2, b2, act)
        tag = f"{label} [{E}, {C}, {H}] x F={F} {dt} {act}"
        errs["grouped_ffn"] = max(errs["grouped_ffn"], _hold_grouped(
            f"grouped_ffn {tag}", got, want))
        if label in ("bench bucket", "decode C=20 (T=64)", "fp32"):
            timed[("grouped_ffn", label)] = (
                [time_ms(f, flush, iters) for f in (
                    lambda: gg.grouped_ffn_fwd(x, w1, b1, w2, b2, act),
                    lambda: gg.grouped_ffn_reference(x, w1, b1, w2, b2, act),
                    lambda: gg.einsum_ffn(x, w1, b1, w2, b2, act))],
                grouped_ffn_bound(E, C, H, F, x.element_size(),
                                  w1.element_size()), tag)
        if label == "bench bucket":
            bench_w = (w1, b1, w2, b2)
            halves[("grouped_ffn", label)] = _time_halves(
                gg, (x, w1, None, b1, w2, None, b2), act, flush, iters)
        del x, got, want
        if label != "bench bucket":
            del w1, b1, w2, b2
        torch.cuda.empty_cache()

    # kernel 11 over the bench weights quantized, bf16 x
    w1, b1, w2, b2 = bench_w
    q1, q2 = tq.quantize_linear(w1), tq.quantize_linear(w2)
    dq1 = tq.dequantize(q1["qweight"], q1["scale"], torch.bfloat16)
    dq2 = tq.dequantize(q2["qweight"], q2["scale"], torch.bfloat16)
    del bench_w, w1, w2
    for label, E, C in GROUPED_Q_CASES:
        H, F = MOE["H"], MOE["F"]
        x = torch.randn(E, C, H, generator=gen, device=device).bfloat16()
        args = (x, q1["qweight"], q1["scale"], b1, q2["qweight"],
                q2["scale"], b2)
        got = gg.grouped_ffn_q(*args)
        torch.cuda.synchronize()
        want = gg.grouped_ffn_q_reference(*args)
        tag = f"{label} [{E}, {C}, {H}] x F={F} bf16 gelu"
        errs["grouped_ffn_q"] = max(errs["grouped_ffn_q"], _hold_grouped(
            f"grouped_ffn_q {tag}", got, want))
        timed[("grouped_ffn_q", label)] = (
            [time_ms(f, flush, iters) for f in (
                lambda: gg.grouped_ffn_q(*args),
                lambda: gg.grouped_ffn_q_reference(*args),
                lambda: gg.einsum_ffn(x, dq1, b1, dq2, b2))],
            grouped_ffn_bound(E, C, H, F, 2, 1, scales=True), tag)
        if label == "int8 bench bucket":
            halves[("grouped_ffn_q", label)] = _time_halves(
                gg, args, "gelu", flush, iters)
        del x, args, got, want
        torch.cuda.empty_cache()
    del q1, q2, dq1, dq2, flush
    torch.cuda.empty_cache()

    # int8 weights whose H and F TMA cannot describe unpadded, through the
    # router with the kernel route forced (the wrapper zero-pads them)
    E, C, H, F = GROUPED_Q_RAGGED
    x = torch.randn(E, C, H, generator=gen, device=device).bfloat16()
    w1, b1, w2, b2 = _moe_weights(gen, E, H, F, torch.float32, device)
    q1, q2 = tq.quantize_linear(w1), tq.quantize_linear(w2)
    got = gg.grouped_ffn(x, q1, b1, q2, b2, "sigmoid", impl="pallas")
    torch.cuda.synchronize()
    want = gg.grouped_ffn_q_reference(x, q1["qweight"], q1["scale"], b1,
                                      q2["qweight"], q2["scale"], b2,
                                      "sigmoid")
    errs["grouped_ffn_q"] = max(errs["grouped_ffn_q"], _hold_grouped(
        f"grouped_ffn_q int8, H and F not multiples of 128 [{E}, {C}, {H}] "
        f"x F={F} bf16 sigmoid, impl=pallas", got, want))
    del x, w1, b1, w2, b2, q1, q2, got, want
    gg.grouped_ffn.launches, gg.grouped_ffn_q.launches = before

    lib = {"grouped_ffn": "einsum_ffn: torch.bmm + bias + activation + "
                          "torch.bmm in x's dtype",
           "grouped_ffn_q": "einsum_ffn over the weights dequantized to "
                            "bf16 beforehand"}
    for (name, label), ((ms, plain, library), (bound, by), tag) in \
            timed.items():
        log(f"[kernels] {name} time at {tag}: kernel {ms:.4f} ms | bound "
            f"{bound:.4f} ms ({by}) | plain {plain:.4f} ms | library_ms "
            f"{library:.4f} ms ({lib[name]}) | {100 * bound / ms:.1f}% of "
            f"bound")
    for (name, label), (t1, t2) in halves.items():
        log(f"[kernels] {name} GEMM halves at {label}: GEMM 1 (x @ w1, s1, "
            f"b1, activation, h as bf16 hi + lo) {t1:.4f} ms | GEMM 2 "
            f"(h_hi @ w2 + h_lo @ w2, s2, b2) {t2:.4f} ms")
    rows = []
    for name, label, line in (("grouped_ffn", "bench bucket", 110),
                              ("grouped_ffn_q", "int8 bench bucket", 184)):
        (ms, plain, library), (bound, by), _ = timed[(name, label)]
        rows.append({"name": name, "route": "cuda",
                     "source": "paddle_tpu_torch/csrc/grouped_gemm.cu",
                     "replaces": "paddle_tpu/ops/pallas_kernels/"
                                 f"grouped_gemm.py:{line}",
                     "max_abs_err": errs[name], "ms": ms, "plain_ms": plain,
                     "bound_ms": bound, "bound_by": by,
                     "library_ms": library})
    return rows


# -- phase 10: the MoE block trained at the bench shape -------------------------

MOE_RUN = dict(batch=4, seq=2048, steps=5, lr=1e-4)


class MoETrain(torch.nn.Module):
    """``sum(out.f32^2) / T + gate.loss`` over one MoELayer (bench.py's
    loss for its `moe` config)."""

    def __init__(self, device, H=MOE["H"], F=MOE["F"], E=MOE["E"],
                 k=MOE["k"], cf=MOE["cf"], seed=0, moe_impl=None):
        super().__init__()
        from paddle_tpu_torch.incubate.distributed.models.moe import MoELayer

        self.moe = MoELayer(d_model=H, d_hidden=F, num_experts=E,
                            gate="gshard", top_k=k, capacity_factor=cf,
                            moe_impl=moe_impl, device=device, seed=seed)

    def forward(self, x):
        out = self.moe(x.to(self.moe.gate.wg.dtype))
        T = x.shape[0] * x.shape[1]
        return out.float().square().sum() / T + self.moe.gate.loss.float()


def _moe_counters():
    from paddle_tpu_torch.ops.kernels import grouped_gemm as gg

    return {"grouped_ffn": gg.grouped_ffn, "grouped_ffn_q": gg.grouped_ffn_q}


def _moe_steps(label, run_step, n, per_step):
    """Run 1 + ``n`` steps; each must launch exactly ``per_step``.
    Returns (losses, timed step ms)."""
    counters = _moe_counters()
    losses, step_ms = [], []
    for i in range(n + 1):
        before = {k: f.launches for k, f in counters.items()}
        t1 = time.perf_counter()
        loss = run_step()
        ms = (time.perf_counter() - t1) * 1e3
        losses.append(loss)
        if i:
            step_ms.append(ms)
        got = {k: f.launches - before[k] for k, f in counters.items()}
        log(f"[{label}] step {i}{' (warm-up)' if i == 0 else ''}: loss "
            f"{loss:.6f}, {ms:.1f} ms, launches {got}")
        if got != per_step:
            raise AssertionError(f"[{label}] step {i} launched {got}, "
                                 f"expected {per_step}")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"[{label}] losses {losses}: not all finite")
    return losses, step_ms


def phase_moe_train(device, limit, run=None, H=MOE["H"], F=MOE["F"]):
    """bench.py's MoE body (ep_moe_local forward and backward) and then
    MoELayer trained with CompiledTrainStep, both at the bench shape.
    Returns ({kernel: launches over both}, step, batch)."""
    from paddle_tpu_torch.distributed.utils import moe_utils
    from paddle_tpu_torch.models import CompiledTrainStep

    run = dict(MOE_RUN, **(run or {}))
    B, S, n = run["batch"], run["seq"], run["steps"]
    E, k = MOE["E"], MOE["k"]
    T = B * S
    C = moe_capacity(T)
    on_card = device.type == "cuda"
    counters = _moe_counters()
    for f in counters.values():
        f.launches = 0
    per_step = {"grouped_ffn": 1 if on_card else 0, "grouped_ffn_q": 0}

    # (a) the bench body: bf16 tokens and experts, fp32 gate, GShard aux
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    tokens = torch.randn(T, H, generator=gen, device=device).bfloat16()
    wg = torch.randn(H, E, generator=gen, device=device) * 0.02
    w1 = (torch.randn(E, H, F, generator=gen, device=device) * 0.02
          ).bfloat16()
    w2 = (torch.randn(E, F, H, generator=gen, device=device) * 0.02
          ).bfloat16()
    b1 = torch.zeros(E, 1, F, dtype=torch.bfloat16, device=device)
    b2 = torch.zeros(E, 1, H, dtype=torch.bfloat16, device=device)
    leaves = [t.requires_grad_(True) for t in (tokens, w1, b1, w2, b2)]

    def body_step():
        for t in leaves:
            t.grad = None
        out, aux = moe_utils.ep_moe_local(
            tokens, wg, w1, b1, w2, b2, axis_name=None, n=1, num_experts=E,
            top_k=k, capacity=C, activation="gelu", gate_kind="gshard",
            impl="fused" if on_card else None)
        loss = out.float().square().sum() / T + aux
        loss.backward()
        return float(loss.detach())

    losses, step_ms = _moe_steps("moe-body", body_step, n, per_step)
    body_ms = float(np.mean(step_ms))
    log(f"[moe-body] ep_moe_local fwd+bwd, T={T} H={H} E={E} top-{k} F={F} "
        f"C={C}, bf16 tokens and experts, fp32 gate: step {body_ms:.1f} ms "
        f"(mean of {n}; {', '.join(f'{m:.1f}' for m in step_ms)}) | "
        f"{T / (body_ms / 1e3):.1f} MoE tokens/s | losses {losses} | "
        f"{limit}")
    del tokens, wg, w1, w2, b1, b2, leaves
    if on_card:
        torch.cuda.empty_cache()

    # (b) MoELayer through CompiledTrainStep
    t0 = time.perf_counter()
    model = MoETrain(device, H=H, F=F)
    step = CompiledTrainStep(model, lr=run["lr"], compute_dtype="bfloat16",
                             device=device)
    x = torch.as_tensor(np.random.RandomState(0).randn(B, S, H)
                        .astype(np.float32), device=device).bfloat16()
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    log(f"[moe-train] MoELayer(d_model={H}, d_hidden={F}, num_experts={E}, "
        f"gate='gshard', top_k={k}, capacity_factor={MOE['cf']}) on "
        f"[{B}, {S}, {H}] bf16, C={C}, bf16 compute, fp32 master and "
        f"moments, lr {run['lr']}, remat off, built in "
        f"{time.perf_counter() - t0:.1f} s")
    losses, step_ms = _moe_steps("moe-train", lambda: float(step.step(x)),
                                 n, per_step)
    mean_ms = float(np.mean(step_ms))
    flops = 3 * 4 * E * C * H * F
    peak = (torch.cuda.max_memory_allocated() / 2**30 if on_card
            else float("nan"))
    log(f"[moe-train] step {mean_ms:.1f} ms (mean of {n}; "
        f"{', '.join(f'{m:.1f}' for m in step_ms)}) | "
        f"{T / (mean_ms / 1e3):.1f} tokens/s | GEMM share of "
        f"{BF16_FLOPS / 1e12:g} TFLOP/s {flops / (mean_ms / 1e3) / BF16_FLOPS:.4f}"
        f" (3 x 4·E·C·H·F = {flops:.4e} flops per step) | peak memory "
        f"{peak:.2f} GiB | losses {losses} | {limit}")
    launches = {name: f.launches for name, f in counters.items()}
    return launches, step, (x,)


def phase_moe_profile(step, batch):
    """One traced MoELayer step: device ms of kernel 10, cuBLAS GEMMs,
    sort/gather/scatter, elementwise, AdamW (a record_function range), the
    rest, and the idle share."""
    import contextlib

    from torch.profiler import ProfilerActivity, profile, record_function

    counters = _moe_counters()
    saved = {k: f.launches for k, f in counters.items()}
    update = step._update

    def ranged(*a, **kw):
        with record_function("smoke::adamw"):
            return update(*a, **kw)

    torch.cuda.synchronize()
    with contextlib.ExitStack() as stack:
        step._update = ranged
        stack.callback(delattr, step, "_update")
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            step.step(*batch)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
    for k, f in counters.items():        # the traced step does not count
        f.launches = saved[k]
    kinds = {"grouped_ffn": 0.0, "gemm": 0.0, "sort/gather/scatter": 0.0,
             "elementwise": 0.0, "other": 0.0}
    adamw = 0.0
    per_kernel = {}
    for ev in prof.key_averages():
        if ev.key == "smoke::adamw":
            if ev.device_type == torch.autograd.DeviceType.CPU:
                adamw += ev.device_time_total / 1e3
            continue
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        ms = ev.self_device_time_total / 1e3
        name = ev.key.lower()
        kind = ("grouped_ffn" if "gffn" in name else
                "gemm" if any(s in name for s in ("gemm", "cutlass", "xmma",
                                                  "nvjet", "sm90_")) else
                "sort/gather/scatter" if any(s in name for s in (
                    "sort", "radix", "scan", "index", "scatter", "gather",
                    "cub::")) else
                "elementwise" if any(s in name for s in (
                    "elementwise", "vectorized", "unrolled")) else "other")
        kinds[kind] += ms
        per_kernel[ev.key[:60]] = (ms, ev.count)
    busy = sum(kinds.values())
    log(f"[profile-moe] one MoELayer step traced: {wall:.1f} ms wall | "
        f"device busy {busy:.1f} ms "
        f"({', '.join(f'{k} {v:.1f}' for k, v in kinds.items())}; AdamW "
        f"range {adamw:.1f}, inside the elementwise) | idle share "
        f"{1 - busy / wall:.3f}")
    for name, (ms, calls) in sorted(per_kernel.items(),
                                    key=lambda kv: -kv[1][0])[:12]:
        log(f"[profile-moe]   {ms:9.2f} ms  {calls:5d} launches  {name}")


# -- phase 10c: the int8 MoE forward -------------------------------------------

def phase_moe_int8(device, limit, iters=5, H=MOE["H"], F=MOE["F"]):
    """ep_moe_local with quantize_linear(w1) / quantize_linear(w2) on the
    fused route at T = 8192 and T = 64: exactly one kernel-11 launch per
    forward, and the output within a relative RMS of 0.05 of the bf16
    forward (the serving gate).  Returns kernel-11 launches."""
    from paddle_tpu_torch.distributed.utils import moe_utils
    from paddle_tpu_torch.ops import quant as tq

    E, k = MOE["E"], MOE["k"]
    gen = torch.Generator(device=device)
    gen.manual_seed(1)
    wg = torch.randn(H, E, generator=gen, device=device) * 0.02
    w1 = (torch.randn(E, H, F, generator=gen, device=device) * 0.02
          ).bfloat16()
    w2 = (torch.randn(E, F, H, generator=gen, device=device) * 0.02
          ).bfloat16()
    b1 = torch.zeros(E, 1, F, dtype=torch.bfloat16, device=device)
    b2 = torch.zeros(E, 1, H, dtype=torch.bfloat16, device=device)
    q1, q2 = tq.quantize_linear(w1), tq.quantize_linear(w2)
    counters = _moe_counters()
    launches = 0
    for T in (MOE["T"], 64):
        C = moe_capacity(T)
        tokens = torch.randn(T, H, generator=gen, device=device).bfloat16()
        kw = dict(axis_name=None, n=1, num_experts=E, top_k=k, capacity=C,
                  activation="gelu", gate_kind="gshard", impl="fused")
        with torch.no_grad():
            dense, _ = moe_utils.ep_moe_local(tokens, wg, w1, b1, w2, b2,
                                              **kw)
            before = counters["grouped_ffn_q"].launches
            times = []
            for i in range(iters + 1):
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                out, _ = moe_utils.ep_moe_local(tokens, wg, q1, b1, q2, b2,
                                                **kw)
                e1.record()
                e1.synchronize()
                if i:
                    times.append(e0.elapsed_time(e1))
            got = counters["grouped_ffn_q"].launches - before
        launches += got
        drift = ((out.float() - dense.float()).square().mean().sqrt()
                 / dense.float().square().mean().sqrt()).item()
        ms = float(np.mean(times))
        log(f"[moe-int8] T={T} C={C}: {ms:.4f} ms per int8 forward (mean of "
            f"{iters}; {', '.join(f'{t:.3f}' for t in times)}) | "
            f"{T / (ms / 1e3):.1f} tokens/s | kernel-11 launches {got} over "
            f"{iters + 1} forwards | int8 vs bf16 relative RMS {drift:.5f} "
            f"(limit 0.05) | {limit}")
        if got != iters + 1:
            raise AssertionError(f"[moe-int8] {got} kernel-11 launches for "
                                 f"{iters + 1} forwards")
        if not (np.isfinite(drift) and drift < 0.05):
            raise AssertionError(f"[moe-int8] drift {drift} over 0.05")
        del tokens, dense, out
    return launches


# -- phase 11: card vs CPU MoE training ----------------------------------------

def phase_moe_parity(device, steps=3):
    """The same MoELayer weights trained on the card (kernel 10) and on
    the CPU (its plain version), fp32, H=256, F=512, E=8, top-2, T=512."""
    import os

    from paddle_tpu_torch.models import CompiledTrainStep

    counters = _moe_counters()
    x = np.random.RandomState(2).randn(2, 256, 256).astype(np.float32)
    old = os.environ.get("PT_GROUPED_GEMM")
    os.environ["PT_GROUPED_GEMM"] = "pallas"
    losses = {}
    try:
        for dev in (device, torch.device("cpu")):
            model = MoETrain("cpu", H=256, F=512, seed=3, moe_impl="fused")
            step = CompiledTrainStep(model, lr=1e-3, device=dev)
            before = counters["grouped_ffn"].launches
            losses[dev.type] = [float(step.step(x)) for _ in range(steps)]
            launched = counters["grouped_ffn"].launches - before
            log(f"[moe-parity] {dev.type}: losses {losses[dev.type]}, "
                f"kernel-10 launches {launched}")
            if dev.type == "cuda" and launched != steps:
                raise AssertionError("[moe-parity] the card run did not take "
                                     f"kernel 10 once per step: {launched}")
    finally:
        if old is None:
            del os.environ["PT_GROUPED_GEMM"]
        else:
            os.environ["PT_GROUPED_GEMM"] = old
    got, want = np.array(losses[device.type]), np.array(losses["cpu"])
    rel = float(np.max(np.abs(got - want) / np.abs(want)))
    log(f"[moe-parity] {steps} fp32 steps, H=256, F=512, E=8, top-2, T=512: "
        f"max relative loss difference card vs CPU {rel:.3e} (limit 1e-4: "
        f"fp32 on both, TF32 off, scatter-add atomics and other summation "
        f"orders)")
    if not rel <= 1e-4:
        raise AssertionError(f"[moe-parity] losses differ: {losses}")


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
    grouped_rows = phase_grouped_kernels(device)
    launches, streams = phase_serve_ab(device)
    rows[0]["launches"] = launches["paged_decode"]
    phase_aot(device, streams)
    launches, _ = phase_serve_ab(device, quant="int8")
    for row in quant_rows:
        row["launches"] = launches[row["name"]]
    phase_parity(device)
    phase_parity(device, quant="int8")
    launches, step, batch = phase_train(device, limit)
    for row in train_rows:
        row["launches"] = launches[row["name"]]
    rows += train_rows + quant_rows
    phase_train_profile(step, batch, device)
    del step, batch
    torch.cuda.empty_cache()
    phase_train(device, limit, tag="train-s4096",
                cfg=LlamaConfig.llama2_7b(num_hidden_layers=4,
                                          recompute=True,
                                          recompute_policy="full",
                                          attention_impl="auto"),
                run=dict(batch=2, seq=4096, steps=3))
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
    launches, step, batch = phase_moe_train(device, limit)
    grouped_rows[0]["launches"] = launches["grouped_ffn"]
    phase_moe_profile(step, batch)
    del step, batch
    torch.cuda.empty_cache()
    grouped_rows[1]["launches"] = phase_moe_int8(device, limit)
    torch.cuda.empty_cache()
    phase_moe_parity(device)
    rows += grouped_rows
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
