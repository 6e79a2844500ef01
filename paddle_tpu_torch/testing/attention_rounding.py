"""Does the bf16 attention kernel need P and dS as two bf16 terms?

Builds ``csrc/long_attention.cu`` a second time with the products of the
``lo`` terms taken out (P and dS then enter the tensor cores rounded to
bf16 once), and holds both builds against the plain version at
``chip_smoke.py`` phase 3b's bf16 tolerances: out 2e-3 + 2^-7 |want|,
lse 1e-3, dq/dk/dv 5e-3 + 2^-6 |want|.  Prints, per build and case, the
largest ``|got - want| - tolerance`` of each output (above 0 fails) and
the forward and backward ms (CUDA events, mean of 20) at the first case.

    python3 -m paddle_tpu_torch.testing.attention_rounding

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
from ..ops.kernels import long_attention as la

CASES = [  # (B, H, Hkv, S, causal)
    (4, 32, 32, 2048, True), (4, 32, 32, 1024, True),
    (2, 32, 8, 4096, True), (4, 32, 32, 2048, False)]
LO_PRODUCTS = ("wgmma_rs_n128t(o, plo[kk], v_mn + tstep(kk));",
               "wgmma_rs_n128t(acc, lo[kk], b_mn + tstep(kk));",
               "wgmma_rs_n128t(gq, slo[kk], k_mn + tstep(kk));")


def build_hi_only():
    src = (_build.CSRC / "long_attention.cu").read_text()
    for line in LO_PRODUCTS:
        if line not in src:
            raise RuntimeError(f"long_attention.cu has no {line!r}")
        src = src.replace(line, "")
    out = _build.BUILD / "rounding"
    out.mkdir(parents=True, exist_ok=True)
    (out / "long_attention_hi.cu").write_text(src)
    so = out / "long_attention_hi.so"
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS,
                    f"-I{_build.CSRC}", "-o", str(so),
                    str(out / "long_attention_hi.cu")], check=True,
                   capture_output=True)
    return ctypes.CDLL(str(so))


def excess(got, want, atol, rtol):
    d = (got.float() - want.float()).abs()
    return (d - atol - rtol * want.float().abs()).max().item()


def run_case(B, H, Hkv, S, causal, dev):
    gen = torch.Generator(device=dev)
    gen.manual_seed(4321)
    bf16 = torch.bfloat16
    q, g = (torch.randn(B, H, S, 128, generator=gen, device=dev).to(bf16)
            for _ in range(2))
    k, v = (torch.randn(B, Hkv, S, 128, generator=gen, device=dev).to(bf16)
            for _ in range(2))
    scale = 1.0 / math.sqrt(128)
    out, lse = la.attention_fwd(q, k, v, scale, causal)
    grads = la.attention_bwd(q, k, v, out, lse, g, scale, causal)
    wout, wlse = la.attention_fwd_plain(q, k, v, scale, causal)
    res = {"out": excess(out, wout, 2e-3, 2 ** -7),
           "lse": excess(lse, wlse, 1e-3, 0.0)}
    del wout, wlse
    wgrads = la.attention_bwd_plain(q, k, v, out, lse, g, scale, causal)
    for n, a, w in zip(("dq", "dk", "dv"), grads, wgrads):
        res[n] = excess(a, w, 5e-3, 2 ** -6)
    return res, (q, k, v, g, out, lse, scale, causal)


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


def main():
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    builds = {"hi+lo": _build.load("long_attention"),
              "hi only": build_hi_only()}
    for name, lib in builds.items():
        _build._loaded["long_attention"] = lib
        for i, case in enumerate(CASES):
            res, args = run_case(*case, dev)
            row = {"build": name, "case": case, "excess": res}
            if i == 0:
                q, k, v, g, out, lse, scale, causal = args
                row["fwd_ms"] = time_ms(
                    lambda: la.attention_fwd(q, k, v, scale, causal))
                row["bwd_ms"] = time_ms(lambda: la.attention_bwd(
                    q, k, v, out, lse, g, scale, causal))
            print(json.dumps(row), flush=True)
            del args
            torch.cuda.empty_cache()
    _build._loaded["long_attention"] = builds["hi+lo"]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip() or torch.cuda.get_device_name(0))
    return 0


if __name__ == "__main__":
    sys.exit(main())
