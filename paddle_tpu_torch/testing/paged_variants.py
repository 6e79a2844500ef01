"""What bounds the paged-decode kernels?

Builds ``csrc/paged_decode.cu`` as it is and in variants made by
replacing lines of it, and times both routes — bf16 pool and int8 pool,
q f32 as serving gives it — at ``chip_smoke.py``'s phase 3 timing shape
(B = 8, KV = 32, G = 1, D = 128, ps = 16, pps = 128, lengths 1 to 2048)
and at phase 4b's decode step (B = 8, every length 522), each build in
turn and then in the reverse order (CUDA events, the L2 flushed before
each launch by writing 256 MB as ``chip_smoke.py`` does, mean of 50
launches; the kernel as it is also after a flush by reading, which
leaves no dirty line for its reads to write back):

- ``kernel``: the source as it is (a ring of 4 stages, one per consumer
  warp: tile u goes to warp u % 4).
- ``ring 2`` / ``ring 3``: ring depths 2 and 3, with as many consumer
  warps (a stage has one consumer warp).
- ``ring 8``: 8 stages, two per consumer warp.
- ``no combine``: the split kernel alone (the output is not written).
- ``copy only``: the pages' bulk copies and the ring's barriers, no math
  (the partials and the output are garbage).
- ``no PDL``: the combine launched plainly, not as a programmatic
  dependent of the split kernel.

and the kernel as it is with splits of 8, 16 (the default) and 32 pages
(``SPLIT_TOKENS`` 128, 256 and 512 at ps = 16).  Each row has the bound
(the K/V bytes under the lengths over 3.35 TB/s), the share of it the
build reaches, and its largest error against the plain version (``no
combine`` and ``copy only`` compute something else on purpose).  Prints one JSON object
per build, route, shape, split and order, with ptxas's registers for the
split kernel at D = 128, G = 1, then the card's name and power limit.

    python3 -m paddle_tpu_torch.testing.paged_variants

Needs the card and ``nvcc``; builds into ``paddle_tpu_torch/_build``.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

from ..ops.kernels import _build
from ..ops.kernels import paged_decode as pd



def _smoke():
    """``chip_smoke.py`` at the repo root: phases 3 / 3c's cases and
    bounds, and its reading of ptxas's report."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    import chip_smoke

    return chip_smoke

_RING = "constexpr int kStages = 4;                       // ring depth\n"
_WARPS = "constexpr int kConsumers = 4;                    // consumer warps\n"
_COMPUTE = "    for (int rb = 0; rb < rows; rb += R * S::TPW) {\n"


def _ring(n, warps):
    return [(_RING, _RING.replace("4;", f"{n};")),
            (_WARPS, _WARPS.replace("4;", f"{warps};"))]


VARIANTS = {
    "kernel": [],
    "ring 2": _ring(2, 2),
    "ring 3": _ring(3, 3),
    "ring 8": _ring(8, 4),
    "no combine": [
        ("    e = cudaLaunchKernelEx(&combine, paged_decode_quant_combine_"
         "kernel<TQ>, a);\n", "    e = cudaSuccess;\n"),
        ("    e = cudaLaunchKernelEx(&combine, paged_decode_combine_kernel<TQ>,"
         " a);\n", "    e = cudaSuccess;\n")],
    "copy only": [(_COMPUTE, _COMPUTE.replace("rb < rows", "rb < 0"))],
    "no PDL": [
        ("    e = cudaLaunchKernelEx(&combine, paged_decode_quant_combine_"
         "kernel<TQ>, a);\n",
         "    paged_decode_quant_combine_kernel<TQ><<<combine.gridDim, D, 0, "
         "stream>>>(a);\n    e = cudaGetLastError();\n"),
        ("    e = cudaLaunchKernelEx(&combine, paged_decode_combine_kernel<TQ>,"
         " a);\n",
         "    paged_decode_combine_kernel<TQ><<<combine.gridDim, D, 0, "
         "stream>>>(a);\n    e = cudaGetLastError();\n")],
}
#: (label, shape) — chip_smoke.py's phase 3 timing shape and phase 4b's
SHAPES = [
    ("timing", dict(B=8, KV=32, G=1, D=128, ps=16, pps=128,
                    lengths=[1, 8, 2048, 17, 500, 1024, 1999, 333])),
    ("serving", dict(B=8, KV=32, G=1, D=128, ps=16, pps=128,
                     lengths=[522] * 8)),
]
SPLIT_TOKENS = (128, 256, 512)


def build_variants():
    """{name: (ctypes library, registers of the D = 128, G = 1 split
    kernels)}, all nvcc at once."""
    src = (_build.CSRC / "paged_decode.cu").read_text()
    out = _build.BUILD / "paged_variants"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, subs) in enumerate(VARIANTS.items()):
        text = src
        for old, new in subs:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: paged_decode.cu does not hold "
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
        regs = {e["name"]: e["regs"] for e in _smoke()._ptxas_entries(log)
                if "split_kernel" in e["name"] and "Li128ELi1E" in e["name"]}
        libs[name] = (ctypes.CDLL(str(so)), regs)
    return libs


def time_ms(fn, flush, iters=50, clean=False):
    """Mean ms of ``fn`` after an L2 flush: by writing ``flush`` (as
    ``chip_smoke.py`` times, leaving up to 50 MB of dirty lines that the
    kernel's reads must write back) or, with ``clean``, by reading it."""
    for _ in range(5):
        fn()
    total = 0.0
    for _ in range(iters):
        if clean:
            flush.max()
        else:
            flush.zero_()
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        total += e0.elapsed_time(e1)
    return total / iters


def main():
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 2
    cs = _smoke()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(1234)
    flush = torch.empty(256 * 1024 * 1024, dtype=torch.uint8, device=dev)
    cases = []
    for label, shape in SHAPES:
        bf = cs.make_paged_case(gen, q_dtype=torch.float32,
                                kv_dtype=torch.bfloat16, device=dev, **shape)
        i8 = cs.make_quant_paged_case(gen, q_dtype=torch.float32,
                                      device=dev, **shape)
        cases.append((label, "bf16", pd.paged_decode, bf,
                      pd.paged_decode_reference(*bf),
                      cs.paged_decode_bound(bf[0], bf[1], bf[3], bf[4])[0]))
        cases.append((label, "int8", pd.paged_decode_quant, i8,
                      pd.paged_decode_quant_reference(*i8),
                      cs.paged_decode_quant_bound(i8[0], i8[1], i8[3],
                                                  i8[4])[0]))
    libs = build_variants()
    saved = _build._loaded.get("paged_decode")
    default = pd.SPLIT_TOKENS
    runs = [(n, default) for n in libs] + [
        ("kernel", t) for t in SPLIT_TOKENS if t != default]
    try:
        for order in (runs, runs[::-1]):
            for name, split in order:
                lib, regs = libs[name]
                _build._loaded["paged_decode"] = lib
                pd.SPLIT_TOKENS = split
                clean = (False, True) if (name, split) == runs[0] else \
                    (False,)
                for label, pool, fn, args, want, bound in cases:
                    got = fn(*args)
                    err = (got.float() - want.float()).abs().max().item()
                    for c in clean:
                        ms = time_ms(lambda: fn(*args), flush, clean=c)
                        print(json.dumps({
                            "build": name, "pool": pool, "shape": label,
                            "split_pages": pd.split_plan(
                                8, 32, 1, 128, 16, 128)["split_pages"],
                            "l2_flush": "read" if c else "write",
                            "ms": ms, "bound_ms": bound,
                            "pct_of_bound": 100 * bound / ms,
                            "max_abs_err": err, "registers": regs}),
                            flush=True)
    finally:
        pd.SPLIT_TOKENS = default
        if saved is None:
            _build._loaded.pop("paged_decode", None)
        else:
            _build._loaded["paged_decode"] = saved
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip() or torch.cuda.get_device_name(0))
    return 0


if __name__ == "__main__":
    sys.exit(main())
