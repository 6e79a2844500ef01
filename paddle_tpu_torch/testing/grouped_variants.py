"""What bounds the tensor-core grouped expert FFN kernels?

Builds ``csrc/grouped_gemm.cu`` as it is and in variants made by
replacing lines of it, and times GEMM 1 and GEMM 2 of the bf16-x route
alone and together at the MoE bench bucket (E = 8, C = 2560, H = 2048,
F = 5504, gelu), dense and int8 weights, each build in turn and then in
the reverse order:

- ``kernel``: the source as it is.
- ``wgmma in a branch``: the products issued under ``if (row block has
  rows)``; ptxas then serializes every ``wgmma`` (its C7520 note).
- ``no products``: loads, barriers and epilogue without the ``wgmma``s.
- ``no loads``: products and epilogue without the TMA loads.

The last two compute garbage; their error column says so.  Prints one
JSON object per build, weight type and order, with ptxas's C75xx notes
per build, then the card's name and power limit.

    python3 -m paddle_tpu_torch.testing.grouped_variants

Needs the card and ``nvcc``; builds into ``paddle_tpu_torch/_build``.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys

import torch

from ..ops import quant
from ..ops.kernels import _build
from ..ops.kernels import grouped_gemm as gg

_PRODUCTS = ("        wgmma_n256(acc, da + 2 * kk, db + 128 * kk);\n"
             "        if (kPass == 2)\n"
             "          wgmma_n256(acc, da + (kATile >> 4) + 2 * kk, "
             "db + 128 * kk);\n")
VARIANTS = {
    "kernel": [],
    "wgmma in a branch": [
        ("      wg_fence();\n      const uint64_t da",
         "      wg_fence();\n      if (m0 + wgi * 64 < a.C) {\n"
         "      const uint64_t da"),
        (_PRODUCTS + "      }\n", _PRODUCTS + "      }\n      }\n")],
    "no products": [(_PRODUCTS, "")],
    "no loads": [
        ("      for (int i = 0; i < steps; ++i) {\n        const int s = "
         "i % P::kStages;\n        const uint32_t ph",
         "      for (int i = 0; i < 0; ++i) {\n        const int s = "
         "i % P::kStages;\n        const uint32_t ph"),
        ("      bar_wait(full + s, (i / P::kStages) & 1);\n", "")],
}


def build_variants():
    """{name: (ctypes library, ptxas C75xx notes)}, all nvcc at once."""
    src = (_build.CSRC / "grouped_gemm.cu").read_text()
    out = _build.BUILD / "grouped_variants"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, subs) in enumerate(VARIANTS.items()):
        text = src
        for old, new in subs:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: grouped_gemm.cu does not hold "
                                   f"exactly one {old!r}")
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


def time_ms(fn, n=10):
    for _ in range(2):
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
    E, C, H, F = 8, 2560, 2048, 5504
    gen = torch.Generator(device=dev)
    gen.manual_seed(11)
    x = torch.randn(E, C, H, generator=gen, device=dev).bfloat16()
    w1 = torch.randn(E, H, F, generator=gen, device=dev) * 0.02
    w2 = torch.randn(E, F, H, generator=gen, device=dev) * 0.02
    b1 = torch.randn(E, 1, F, generator=gen, device=dev) * 0.02
    b2 = torch.randn(E, 1, H, generator=gen, device=dev) * 0.02
    q1, q2 = quant.quantize_linear(w1), quant.quantize_linear(w2)
    cases = {
        "bf16": (x, w1.bfloat16(), None, b1, w2.bfloat16(), None, b2),
        "int8": (x, q1["qweight"], q1["scale"], b1, q2["qweight"],
                 q2["scale"], b2)}
    del w1, w2
    want = {"bf16": gg.grouped_ffn_reference(*[cases["bf16"][i] for i in
                                               (0, 1, 3, 4, 6)]),
            "int8": gg.grouped_ffn_q_reference(*cases["int8"])}
    libs = build_variants()
    saved = _build._loaded.get("grouped_gemm")
    try:
        for order in (list(libs), list(libs)[::-1]):
            for name in order:
                lib, notes = libs[name]
                _build._loaded["grouped_gemm"] = lib
                for kind, args in cases.items():
                    got = gg._launch(*args, "gelu", name)
                    err = (got.float() - want[kind].float()).abs().max()
                    ms = [time_ms(lambda p=p: gg._launch(
                        *args, "gelu", name, passes=p)) for p in (1, 2, 3)]
                    print(json.dumps({
                        "build": name, "weights": kind, "gemm1_ms": ms[0],
                        "gemm2_ms": ms[1], "both_ms": ms[2],
                        "max_abs_err": float(err), "ptxas": notes}),
                        flush=True)
    finally:
        if saved is None:
            _build._loaded.pop("grouped_gemm", None)
        else:
            _build._loaded["grouped_gemm"] = saved
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip() or torch.cuda.get_device_name(0))
    return 0


if __name__ == "__main__":
    sys.exit(main())
