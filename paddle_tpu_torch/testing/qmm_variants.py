"""What bounds the int8-weight matmul's tensor-core routes?

Builds ``csrc/quant_matmul.cu`` as it is and in variants made by
replacing lines of it, and times them on the card at ``chip_smoke.py``'s
phase 3c shapes (every Llama-2-7B projection, bf16 x, M = 8 through the
tensor-core GEMV and M = 512 through the ``wgmma`` GEMM), each build in
turn and then in the reverse order (CUDA events, the L2 flushed before
each launch by writing 256 MB as ``chip_smoke.py`` does, mean of 50
launches):

- ``kernel``: the source as it is.
- ``loads only``: the TMA ring and its barriers, no ldmatrix, widening
  or products (the output is garbage): what the weight stream alone
  costs.
- ``no widening``: the raw int8 bytes handed to the tensor cores as if
  they were bf16 (garbage, possibly non-finite): what the two LOP3s and
  the HSUB2 per pair of weights cost.
- ``no products``: the GEMM's loads and widening without its wgmmas (a
  cheap sink keeps the widened fragments alive; garbage out).
- ``1 tile`` / ``4 tiles``: the GEMV's block streams a strip of 128 or
  512 channels (2 weight tiles side by side, 256, as built; 4 with a
  128 KB ring), so each weight row is read 128, 256 or 512 bytes at a
  time.
- ``ring 48 KB`` / ``ring 128 KB``: the GEMV's ring per block (64 KB as
  built); ``4 stages`` / ``6 stages``: the GEMM's ring (8 as built).
- ``plain reduce``: the GEMV's split sum launched plainly, not as a
  programmatic dependent.
- ``wait 0``: the GEMM waits for each stage's products before widening
  the next, so widening and products no longer overlap in a warpgroup.
  (Two groups in flight, with three fragment arrays, measured the same
  as one.)

Then, with the kernel as it is: every shape after a read-only L2 flush
(which leaves no dirty line for the kernel's reads to write back), the
GEMV at half and twice the default K
split (:func:`~paddle_tpu_torch.ops.kernels.quant_matmul.decode_split`),
and both routes forced at M = 8, 16, 32 and 64 (gate/up), which places
the decode/prefill threshold.  Widening in shared memory (the grouped
FFN's route) was not built for this kernel.  Each row has the bound (x,
weight, scales and out moved once over 3.35 TB/s against 2MKN flops at
989 TFLOP/s), the share of it reached, and the largest error against the
plain version (the garbage variants excepted).  Prints one JSON object a
row, then the card's name and power limit.

    python3 -m paddle_tpu_torch.testing.qmm_variants [build ...]

(naming builds runs only those, ``kernel`` among them).

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
from ..ops.kernels import quant_matmul as qm


def _smoke():
    """``chip_smoke.py`` at the repo root: its shapes, bound and timer."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    import chip_smoke

    return chip_smoke


_DEC_LOOP = "    for (int j = 0; j < kTK / 16; j += 2) {\n"
_WG_WIDEN = "    for (int j = 0; j < kTK / 32; ++j)\n"
_WG_MMA = "    for (int kk = 0; kk < kTK / 16; ++kk)\n"
_WIDEN = "  const uint32_t mag = (t & 0x007f007fu) | 0x43004300u;\n"
_WG_PRODUCT = ("      hopper::wgmma_rs_n128(acc, a[kk / 2][kk % 2],\n"
               "                            db + hopper::kstep(kWgRows, kk));\n")
# in place of the products, a sink that keeps the widening alive
_SINK = ("      acc[kk] += __uint_as_float((a[kk / 2][kk % 2][0] ^ "
         "a[kk / 2][kk % 2][3]) & 0x3f800000u) + (float)(db & 1);\n")
_RING = "constexpr int kDecRing = 64 * 1024;             // ring bytes a block\n"
_STAGES = "constexpr int kWgStages = 8;\n"
_BOXES = ("constexpr int kDecBoxes = 2;  // weight tiles side by side: "
          "256 channels\n")
_PDL = "  e = cudaLaunchKernelEx(&cfg, qmm_reduce_kernel<__nv_bfloat16>,\n"
_WAIT = "    hopper::wg_wait1();  // products of stage i - 1 are done: free it\n"

VARIANTS = {
    "kernel": [],
    "loads only": [
        (_DEC_LOOP, _DEC_LOOP.replace("j < kTK / 16", "j < 0")),
        (_WG_WIDEN, _WG_WIDEN.replace("j < kTK / 32", "j < 0")),
        (_WG_MMA, _WG_MMA.replace("kk < kTK / 16", "kk < 0"))],
    "no widening": [(_WIDEN, _WIDEN + "  return t;\n")],
    "no products": [(_WG_PRODUCT, _SINK)],
    "1 tile": [(_BOXES, _BOXES.replace("2;", "1;"))],
    "4 tiles": [(_BOXES, _BOXES.replace("2;", "4;")),
                (_RING, _RING.replace("64 * 1024", "128 * 1024"))],
    "ring 48 KB": [(_RING, _RING.replace("64 * 1024", "48 * 1024"))],
    "ring 128 KB": [(_RING, _RING.replace("64 * 1024", "128 * 1024"))],
    "4 stages": [(_STAGES, _STAGES.replace("8;", "4;"))],
    "6 stages": [(_STAGES, _STAGES.replace("8;", "6;"))],
    "plain reduce": [
        (_PDL + "                         static_cast<const float*>"
         "(a.workspace), a.scale, out,\n"
         "                         a.M, a.N, a.ksplit);\n",
         "  qmm_reduce_kernel<__nv_bfloat16><<<cfg.gridDim, 256, 0, "
         "a.stream>>>(\n      static_cast<const float*>(a.workspace), "
         "a.scale, out, a.M, a.N, a.ksplit);\n  e = cudaGetLastError();\n")],
    "wait 0": [(_WAIT, _WAIT.replace("wg_wait1", "wg_wait0"))],
}
#: variants whose output is garbage on purpose
GARBAGE = ("loads only", "no widening", "no products")


def build_variants(names=None):
    """{name: (the launch function, ptxas registers of the qmm_ tensor-core
    kernels)}, one nvcc each, all started together."""
    names = list(VARIANTS) if names is None else list(names)
    src = (_build.CSRC / "quant_matmul.cu").read_text()
    out = _build.BUILD / "qmm_variants"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, name in enumerate(names):
        text = src
        for old, new in VARIANTS[name]:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: quant_matmul.cu does not hold "
                                   f"exactly one {old!r}")
            text = text.replace(old, new)
        cu, so = out / f"v{i}.cu", out / f"v{i}.so"
        cu.write_text(text)
        procs[name] = (so, subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, f"-I{_build.CSRC}",
             "-o", str(so), str(cu)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    built = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        regs = {e["name"]: e["regs"] for e in _smoke()._ptxas_entries(log)
                if e["name"].startswith(("qmm_dec", "qmm_wg"))}
        fn = ctypes.CDLL(str(so)).quant_matmul_launch
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        built[name] = (fn, regs)
    return built


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
    from ..ops import quant as tq

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(1357)
    flush = torch.empty(256 * 1024 * 1024, dtype=torch.uint8, device=dev)
    weights = {}
    for label, (K, N) in cs.QMM_SHAPES.items():
        w = torch.randn(K, N, generator=gen, device=dev) * 0.02
        qw, sc = tq.quantize_per_channel(w)
        weights[label] = (qw, sc.reshape(N))
    xs = {(label, M): torch.randn(M, K, generator=gen, device=dev)
          .to(torch.bfloat16)
          for label, (K, _) in cs.QMM_SHAPES.items()
          for M in (8, 16, 32, 64, 512)}

    def row(name, fn, label, M, kind, ksplit=None, clean=False, **extra):
        qw, sc = weights[label]
        x = xs[(label, M)]
        K, N = qw.shape
        got = qm.launch(fn, x, qw, sc, kind, ksplit)
        want = qm.quant_matmul_reference(x, qw, sc)
        err = (got.float() - want.float()).abs().max().item()
        ms = time_ms(lambda: qm.launch(fn, x, qw, sc, kind, ksplit), flush,
                     clean=clean)
        bound = cs.quant_matmul_bound(M, K, N, 2)[0]
        print(json.dumps(dict(
            build=name, shape=label, M=M, K=K, N=N, route=kind,
            ksplit=ksplit if kind == "decode" else None,
            l2_flush="read" if clean else "write", ms=ms,
            bound_ms=bound, pct_of_bound=100 * bound / ms,
            max_abs_err=None if name in GARBAGE else err, **extra)),
            flush=True)

    built = build_variants(sys.argv[1:] or None)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    names = list(built)
    for order in (names, names[::-1]):
        for name in order:
            fn, regs = built[name]
            for label in cs.QMM_SHAPES:
                for M in (8, 512):
                    row(name, fn, label, M,
                        "decode" if M <= qm.DECODE_MAX_M else "prefill",
                        registers=regs)
    fn = built["kernel"][0]
    for label in cs.QMM_SHAPES:
        for M in (8, 512):
            row("kernel", fn, label, M,
                "decode" if M <= qm.DECODE_MAX_M else "prefill", clean=True)
    for label, (K, N) in cs.QMM_SHAPES.items():
        base = qm.decode_split(K, N, sms)
        for ksplit in sorted({max(1, base // 2), base, 2 * base}):
            row("kernel", fn, label, 8, "decode", ksplit)
    for M in (8, 16, 32, 64):
        for kind in ("decode", "prefill"):
            row("kernel", fn, "gate/up_proj", M, kind)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip() or torch.cuda.get_device_name(0))
    return 0


if __name__ == "__main__":
    sys.exit(main())
