"""Smoke run of the PyTorch port on one NVIDIA GPU (written for the H100).

    python3 chip_smoke.py

Phases, each fatal on failure (the script exits non-zero and prints no
result):

1. device  — name and power limit; TF32 off for matmuls and cuDNN, so
             fp32 means fp32 in every comparison below.
2. build   — every kernel under paddle_tpu_torch/csrc, one nvcc each,
             all started together.
3. kernels — each kernel against its plain PyTorch version on the same
             CUDA tensors, at the shapes the serving path gives it, then
             its time (CUDA events, L2 flushed before each launch) beside
             its bound, the plain version's time and one library call's.
4. serve   — Llama-2-7B at full width and depth in bf16, random weights
             from seed 0 made on the card, 16 seeded requests through
             ServingEngine (8 slots, 16-token pages, 2048-token window,
             512-token prefill chunks).  Every request must finish, and
             the kernel must have launched once per layer per decode step.
5. parity  — the same model cut to 2 layers, in fp32: 4 requests on the
             card (the kernel) and on the CPU (the plain versions) must
             give identical greedy streams and first-token logits within
             atol 1e-3.

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
        regs = [ln.strip() for ln in rec["log"].splitlines()
                if "registers" in ln]
        spills = [ln.strip() for ln in rec["log"].splitlines()
                  if "spill" in ln and " 0 bytes spill stores" not in ln]
        log(f"[build] {name}: {rec['seconds']:.1f} s; "
            f"{len(regs)} kernel instantiations; "
            f"max registers {_max_regs(regs)}; "
            f"spilling instantiations {len(spills)}")
    log(f"[build] all kernels in {wall:.1f} s")


def _max_regs(lines):
    vals = []
    for ln in lines:
        for part in ln.split(","):
            part = part.strip()
            if part.endswith("registers"):
                vals.append(int(part.split()[-2]))
    return max(vals) if vals else None


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
    bf16_why = ("bf16 output: the two fp32 results may round to "
                "neighbouring bf16 values, one ulp <= 2^-7 |want|")
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
         (bf16, bf16), 1e-4, 2 ** -7, bf16_why),
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
        if got.dtype != qd or got.shape != want.shape:
            raise AssertionError(f"[kernels] {label}: got {got.dtype} "
                                 f"{tuple(got.shape)}")
        if not torch.isfinite(got).all():
            raise AssertionError(f"[kernels] {label}: non-finite output "
                                 "(NaN pages leaked in)")
        diff = (got.float() - want.float()).abs()
        err = diff.max().item()
        over = (diff - (atol + rtol * want.float().abs())).max().item()
        log(f"[kernels] paged_decode {label}: max_abs_err {err:.3e} "
            f"(atol {atol:g} + rtol {rtol:g} * |want|: {why})")
        if not over <= 0:
            raise AssertionError(f"[kernels] {label}: max_abs_err {err}, "
                                 f"{over} over atol {atol} + rtol {rtol} "
                                 "* |want|")
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


# -- phase 4 -----------------------------------------------------------------

SERVE_KW = dict(max_seqs=8, page_size=16, max_len=2048, prefill_chunk=512)
SERVE_LOAD = dict(n_requests=16, mean_interarrival=2.0,
                  prompt_len=(128, 1024), max_new=(32, 64), vocab=32000,
                  seed=0)


def phase_serve(device, cfg=None, load=None, dtype=torch.bfloat16,
                engine_kw=None):
    from paddle_tpu_torch.inference.server import RequestState, ServingEngine
    from paddle_tpu_torch.models import LlamaConfig, init_llama_params
    from paddle_tpu_torch.ops.kernels import paged_decode as pdmod
    from paddle_tpu_torch.testing.load import (
        LoadSpec, generate_load, run_load,
    )

    cfg = LlamaConfig.llama2_7b() if cfg is None else cfg
    load = SERVE_LOAD if load is None else load
    engine_kw = SERVE_KW if engine_kw is None else engine_kw
    t0 = time.perf_counter()
    params = init_llama_params(cfg, seed=0, device=device, dtype=dtype)
    engine = ServingEngine(cfg, params, dtype=dtype, device=device,
                           **engine_kw)
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    nparams = (sum(t.numel() for t in params["layers"].values())
               + params["embed"].numel()
               + (0 if params["lm_head"] is None
                  else params["lm_head"].numel()))
    log(f"[serve] {cfg.num_hidden_layers} layers, hidden "
        f"{cfg.hidden_size}, {cfg.num_attention_heads} heads, D "
        f"{cfg.head_dim}, intermediate {cfg.intermediate_size}, vocab "
        f"{cfg.vocab_size}: {nparams / 1e9:.3f} B parameters in {dtype}, "
        f"built in {time.perf_counter() - t0:.1f} s")
    work = generate_load(LoadSpec(**dict(load, vocab=cfg.vocab_size)))
    pdmod.paged_decode.launches = 0
    t0 = time.perf_counter()
    out = run_load(engine, work)
    if device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = pdmod.paged_decode.launches
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
    want = cfg.num_hidden_layers * st["decode_steps"]
    if device.type == "cuda" and launches != want:
        raise AssertionError(
            f"[serve] paged_decode launched {launches} times, expected "
            f"{cfg.num_hidden_layers} layers x {st['decode_steps']} "
            f"decode steps = {want}")
    peak = (torch.cuda.max_memory_allocated() / 2**30
            if device.type == "cuda" else float("nan"))
    log(f"[serve] {len(work)} requests finished in {wall:.3f} s, "
        f"{st['steps']} steps, {st['decode_steps']} decode steps, "
        f"{st['decode_tokens']} decode tokens, {st['prefill_tokens']} "
        f"prefill tokens, {st['preemptions']} preemptions | "
        f"{st['decode_tokens'] / wall:.2f} decode tok/s | TTFT p50 "
        f"{st['ttft_ms_p50']} ms p99 {st['ttft_ms_p99']} ms | TPOT p50 "
        f"{st['tpot_ms_p50']} ms p99 {st['tpot_ms_p99']} ms | "
        f"paged_decode launches {launches} | peak memory {peak:.2f} GiB")
    return launches, engine


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
    kinds = {"paged_decode": 0.0, "gemm": 0.0, "other": 0.0}
    per_kernel = {}
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        ms = ev.self_device_time_total / 1e3 / n_steps
        name = ev.key.lower()
        kind = ("paged_decode" if "paged_decode" in name else
                "gemm" if any(k in name for k in ("gemm", "cutlass",
                                                  "xmma", "nvjet"))
                else "other")
        kinds[kind] += ms
        per_kernel[ev.key[:60]] = (ms, ev.count / n_steps)
    busy = sum(kinds.values())
    weight_bytes = sum(t.numel() * t.element_size()
                       for t in ex.layers.values()) + \
        ex.tops["head_w"].numel() * ex.tops["head_w"].element_size()
    lens = [int(ex.cache.lengths[h._req.sid]) for h in handles]
    log(f"[profile] decode step at batch {len(handles)}, lengths "
        f"{min(lens)}-{max(lens)}: {step_ms:.3f} ms untraced, "
        f"{traced_ms:.3f} ms traced | device busy {busy:.3f} ms/step "
        f"(paged_decode {kinds['paged_decode']:.3f}, gemm "
        f"{kinds['gemm']:.3f}, other {kinds['other']:.3f}) | idle share "
        f"{1 - busy / traced_ms:.3f} | weight-read bound "
        f"{weight_bytes / HBM_BYTES_PER_S * 1e3:.3f} ms/step")
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1][0])[:8]
    for name, (ms, calls) in top:
        log(f"[profile]   {ms:8.3f} ms/step  {calls:6.1f} launches/step  "
            f"{name}")
    for h in handles:
        h.cancel()
    engine.step()


# -- phase 5 -----------------------------------------------------------------

PARITY_KW = dict(max_seqs=4, page_size=16, max_len=256, prefill_chunk=32)
PARITY_LOAD = dict(n_requests=4, mean_interarrival=1.0,
                   prompt_len=(16, 64), max_new=(8, 8), vocab=32000,
                   seed=1)


def phase_parity(device, cfg=None):
    from paddle_tpu_torch.inference.server import PagedExecutor, ServingEngine
    from paddle_tpu_torch.models import (
        LlamaConfig, init_llama_params, params_to,
    )
    from paddle_tpu_torch.ops.kernels import paged_decode as pdmod
    from paddle_tpu_torch.testing.load import (
        LoadSpec, generate_load, run_load,
    )

    cfg = LlamaConfig.llama2_7b(num_hidden_layers=2) if cfg is None else cfg
    params = init_llama_params(cfg, seed=0, device=device,
                               dtype=torch.float32)
    cpu_params = params_to(params, device="cpu")
    work = generate_load(LoadSpec(**dict(PARITY_LOAD,
                                           vocab=cfg.vocab_size)))
    logits = []
    for dev, p in ((device, params), (torch.device("cpu"), cpu_params)):
        ex = PagedExecutor(cfg, p, dtype=torch.float32, device=dev,
                           max_seqs=1, page_size=16, max_len=256)
        with torch.no_grad():
            logits.append([ex._prefill_fwd(torch.as_tensor(
                w["prompt_ids"][None], dtype=torch.long, device=dev))[0]
                .cpu() for w in work])
    max_err = max((a - b).abs().max().item()
                  for a, b in zip(*logits))
    log(f"[parity] first-token logits card vs CPU: max_abs_err "
        f"{max_err:.3e} (atol 1e-3: fp32 on both, TF32 off, other "
        f"summation order through 2 layers of width 4096)")
    if not max_err <= 1e-3:
        raise AssertionError(f"[parity] logits differ by {max_err}")
    streams = {}
    for dev, p in ((device, params), (torch.device("cpu"), cpu_params)):
        before = pdmod.paged_decode.launches
        eng = ServingEngine(cfg, p, dtype=torch.float32, device=dev,
                            **PARITY_KW)
        out = run_load(eng, work)
        streams[dev.type] = {rid: h.tokens
                             for rid, h in out["handles"].items()}
        log(f"[parity] {dev.type}: {out['stats']['decode_steps']} decode "
            f"steps, kernel launches "
            f"{pdmod.paged_decode.launches - before}")
    if streams[device.type] != streams["cpu"]:
        raise AssertionError(f"[parity] greedy streams differ: "
                             f"{streams}")
    log(f"[parity] greedy streams identical on {device.type} and cpu "
        f"for {len(work)} requests ({sum(map(len, streams['cpu'].values()))}"
        f" tokens)")


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this "
              "script runs only on an NVIDIA GPU", file=sys.stderr)
        return 2
    import paddle_tpu_torch  # noqa: F401  (fails outside the repo)

    device = torch.device("cuda", 0)
    name, limit = phase_device()
    phase_build()
    row = phase_kernels(device)
    row["launches"], engine = phase_serve(device)
    phase_profile(engine, device)
    del engine
    phase_parity(device)
    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    print(json.dumps({"kernels": [{k: row[k] for k in keys}]}))
    print(limit)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
