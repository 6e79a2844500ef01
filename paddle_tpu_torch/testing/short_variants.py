"""What bounds the bf16 short-attention kernels?

Builds ``csrc/short_attention.cu`` as it is and in variants made by
replacing lines of it, and times the forward and the backward at
BERT-base's shape [48, 12, 384, 64] with dropout 0.1 and 0 and at Llama's
[4, 32, 512, 128] causal, each build in turn and then in the reverse
order (CUDA events, mean of 20 launches):

- ``kernel``: the source as it is.
- ``no out32``: the forward does not store its fp32 copy of ``out``.
- ``no lo products``: P (forward), pd and dS (backward) enter the tensor
  cores rounded to bf16 once (the ``lo`` products taken out).
- ``no P.V``: the forward without its P.V products.

Each row's ``excess`` is the largest ``|got - want| - tolerance`` over
out, out32, lse, dq, dk and dv against the plain version at phase 3e's
tolerances (above 0 fails; the last two variants compute something else
on purpose).  Prints one JSON object per build, case and order, with
ptxas's C75xx notes per build, then the card's name and power limit.

    python3 -m paddle_tpu_torch.testing.short_variants

Needs the card and ``nvcc``; builds into ``paddle_tpu_torch/_build``.
"""
from __future__ import annotations

import ctypes
import json
import math
import subprocess
import sys

import torch

from ..ops.kernels import _build
from ..ops.kernels import short_attention as sa

_OUT32 = ("      *reinterpret_cast<float2*>(out32 + at + 8 * j) = v0;\n"
          "      *reinterpret_cast<float2*>(out32 + at + 8 * kD + 8 * j) = "
          "v1;\n")
_FWD_LO = "        wgmma_rs_t(o, plo[kk], v_mn + tstep(kk));\n"
VARIANTS = {
    "kernel": [],
    "no out32": [(_OUT32, "")],
    "no lo products": [
        (_FWD_LO, ""),
        ("        wgmma_rs_t(acc, lo[kk], b_mn + tstep(kk));\n", ""),
        ("        wgmma_rs_t(gq, slo[kk], k_mn + tstep(kk));\n", "")],
    "no P.V": [("        wgmma_rs_t(o, phi[kk], v_mn + tstep(kk));\n"
                + _FWD_LO, "")],
}
#: (label, B, H, S, D, causal, dropout_p)
CASES = [("bert p=0.1", 48, 12, 384, 64, False, 0.1),
         ("bert p=0", 48, 12, 384, 64, False, 0.0),
         ("llama S=512", 4, 32, 512, 128, True, 0.0)]


def build_variants():
    """{name: (ctypes library, ptxas C75xx notes)}, all nvcc at once."""
    src = (_build.CSRC / "short_attention.cu").read_text()
    out = _build.BUILD / "short_variants"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, subs) in enumerate(VARIANTS.items()):
        text = src
        for old, new in subs:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: short_attention.cu does not "
                                   f"hold exactly one {old!r}")
            text = text.replace(old, new)
        cu, so = out / f"v{i}.cu", out / f"v{i}.so"
        cu.write_text(text)
        procs[name] = (so, subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, f"-I{_build.CSRC}",
             "-o", str(so), str(cu)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        notes = sorted({ln.split("(C75")[1][:2] for ln in log.splitlines()
                        if "(C75" in ln})
        libs[name] = (ctypes.CDLL(str(so)), [f"C75{n}" for n in notes])
    return libs


def time_ms(fn, n=20):
    for _ in range(3):
        fn()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    for _ in range(n):
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / n


def excess(got, want, atol, rtol):
    d = (got.float() - want.float()).abs()
    return (d - atol - rtol * want.float().abs()).max().item()


def make_case(B, H, S, D, causal, p, dev):
    """Inputs and the plain version's outputs; the backward is fed the
    plain forward's fp32 output and lse, so every build sees the same."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(2718)
    q, k, v, g = (torch.randn(B, H, S, D, generator=gen, device=dev)
                  .bfloat16() for _ in range(4))
    seed = torch.tensor([-1234567891], dtype=torch.int32, device=dev)
    scale = 1.0 / math.sqrt(D)
    args = (q, k, v, seed, scale, p, causal)
    wout, wlse, wout32 = sa.short_attention_fwd_reference(*args)
    bwd_args = (q, k, v, wout32, wlse, g, seed, scale, p, causal)
    wgrads = sa.short_attention_bwd_reference(*bwd_args)
    return args, bwd_args, (wout, wlse, wout32), wgrads


def run(args, bwd_args, want, wgrads):
    out, lse, out32 = sa.short_attention_fwd(*args)
    grads = sa.short_attention_bwd(*bwd_args)
    ex = [excess(out, want[0], 2e-3, 2 ** -7),
          excess(lse, want[1], 2e-5, 0.0),
          excess(out32, want[2], 2e-5, 0.0)]
    ex += [excess(a, w, 5e-3, 2 ** -6) for a, w in zip(grads, wgrads)]
    return (max(ex), time_ms(lambda: sa.short_attention_fwd(*args)),
            time_ms(lambda: sa.short_attention_bwd(*bwd_args)))


def main():
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    cases = {label: make_case(B, H, S, D, causal, p, dev)
             for label, B, H, S, D, causal, p in CASES}
    libs = build_variants()
    saved = _build._loaded.get("short_attention")
    launches = (sa.short_attention_fwd.launches,
                sa.short_attention_bwd.launches)
    try:
        for order in (list(libs), list(libs)[::-1]):
            for name in order:
                lib, notes = libs[name]
                _build._loaded["short_attention"] = lib
                for label, case in cases.items():
                    err, fwd_ms, bwd_ms = run(*case)
                    print(json.dumps({
                        "build": name, "case": label, "fwd_ms": fwd_ms,
                        "bwd_ms": bwd_ms, "excess": err, "ptxas": notes}),
                        flush=True)
    finally:
        if saved is None:
            _build._loaded.pop("short_attention", None)
        else:
            _build._loaded["short_attention"] = saved
        sa.short_attention_fwd.launches, \
            sa.short_attention_bwd.launches = launches
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip() or torch.cuda.get_device_name(0))
    return 0


if __name__ == "__main__":
    sys.exit(main())
