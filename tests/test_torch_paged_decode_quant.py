"""Paged-decode attention over int8 pages: the PyTorch port against
``paddle_tpu``.

The port's plain version (``paged_decode_quant_reference``) is held to
the JAX package's Pallas kernel ``_call_quant`` (through
``paged_decode_quant``), run in interpret mode on the CPU, and to its
dense reference ``_dense_paged_attention_q``.  Page sizes 16 and 32,
ragged lengths, GQA, and both (q, pool) dtype pairs the serving path
makes, (f32, int8) and (bf16, int8).  Inputs come from a numpy seed and
feed both packages.

Tolerances:
- f32 q (so f32 output): atol 2e-5 — fp32 accumulation on both sides
  (the JAX dense path partly in fp64 under the package's x64 mode), in
  another order, on values of order 1.
- bf16 q (bf16 output): the same fp32 value rounded to bf16 on both
  sides, so one bf16 ulp (|got - want| <= 2^-7 * |want|) on top of
  atol 2e-5.

The kernels' split rule over int8 pages (``testing/paged_split.py``:
split-K over whole pages, the page's k scale on the dot and its v scale
on the probability, partials merged in split order) is held to
``_call_quant`` at fp32 atol 2e-5 on lengths at, one past and inside a
split boundary, 0, the whole window, splits wholly past a length, and
G = 16 with D = 256; the gate takes those shapes from shapes alone.

The CUDA kernels themselves are compared with the plain version on the
card in ``test_kernel_matches_plain_on_card`` (marked ``cuda``, skipped
where there is none) and in ``chip_smoke.py``.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.inference.paged import _dense_paged_attention_q
from paddle_tpu.ops.pallas_kernels.paged_decode import (
    paged_decode_quant as jax_paged_decode_quant,
)
from paddle_tpu_torch.ops.kernels import paged_decode as pd
from paddle_tpu_torch.testing.paged_split import paged_decode_split_model

ATOL = 2e-5


def _mk(rng, B, H, KV, D, P, ps, pps):
    q = rng.randn(B, H, D).astype(np.float32)
    kp = rng.randint(-127, 128, (KV, P, ps, D)).astype(np.int8)
    vp = rng.randint(-127, 128, (KV, P, ps, D)).astype(np.int8)
    ks = (np.abs(rng.randn(KV, P)) / 127).astype(np.float32)
    vs = (np.abs(rng.randn(KV, P)) / 127).astype(np.float32)
    table = rng.choice(P, size=(B, pps), replace=False).astype(np.int32)
    return q, kp, vp, ks, vs, table


def _tol(qdtype):
    return dict(rtol=0 if qdtype == "float32" else 2 ** -7, atol=ATOL)


def _port(q, kp, vp, lens, table, ks, vs, qdtype="float32", fn=None):
    fn = fn or pd.paged_decode_quant_reference
    out = fn(torch.from_numpy(q).to(getattr(torch, qdtype)),
             torch.from_numpy(kp), torch.from_numpy(vp),
             torch.from_numpy(lens), torch.from_numpy(table),
             torch.from_numpy(ks), torch.from_numpy(vs))
    assert out.dtype == getattr(torch, qdtype)
    return out.float().numpy()


def _jax_args(q, kp, vp, lens, table, qdtype):
    return (jnp.asarray(q, getattr(jnp, qdtype)), jnp.asarray(kp),
            jnp.asarray(vp), jnp.asarray(lens), jnp.asarray(table))


CASES = {
    # name: (seed, shape kwargs, lengths, q dtype)
    "ps16_ragged_gqa": (0, dict(B=3, H=8, KV=2, D=64, P=24, ps=16, pps=4),
                        [64, 17, 1], "float32"),
    "ps32_ragged": (1, dict(B=2, H=4, KV=4, D=32, P=10, ps=32, pps=3),
                    [70, 33], "float32"),
    "ps16_bf16q": (2, dict(B=3, H=4, KV=2, D=64, P=12, ps=16, pps=3),
                   [40, 16, 5], "bfloat16"),
    "ps32_bf16q_d128": (3, dict(B=2, H=4, KV=4, D=128, P=8, ps=32, pps=2),
                        [64, 9], "bfloat16"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_reference_matches_pallas_and_dense(case):
    seed, shape, lens, qdtype = CASES[case]
    rng = np.random.RandomState(seed)
    q, kp, vp, ks, vs, table = _mk(rng, **shape)
    lens = np.asarray(lens, np.int32)
    got = _port(q, kp, vp, lens, table, ks, vs, qdtype)
    args = _jax_args(q, kp, vp, lens, table, qdtype)
    scales = (jnp.asarray(ks), jnp.asarray(vs))
    pallas = jax_paged_decode_quant(*args, *scales)
    dense = _dense_paged_attention_q(*args, *scales)
    for want in (pallas, dense):
        assert want.dtype == getattr(jnp, qdtype)
        np.testing.assert_allclose(got, np.asarray(want, np.float32),
                                   **_tol(qdtype))


def test_unread_page_scales_are_inert_in_the_port():
    """Pages past ceil(len / ps) carry NaN scales and the table points at
    them.  The port never reads them and gives the Pallas kernel's result
    on the same pool with those scales finite.  The Pallas kernel itself
    turns NaN there: it zero-fills its window tail but still multiplies
    the tail by the scales of the pages the table names (a cache only
    ever holds finite scales, so serving is unaffected)."""
    rng = np.random.RandomState(4)
    q, kp, vp, ks, vs, table = _mk(rng, B=2, H=4, KV=2, D=16, P=16, ps=16,
                                   pps=3)
    lens = np.array([5, 20], np.int32)          # covers 1 and 2 pages
    args = _jax_args(q, kp, vp, lens, table, "float32")
    want = np.asarray(jax_paged_decode_quant(*args, jnp.asarray(ks),
                                             jnp.asarray(vs)))
    for b, n in enumerate([1, 2]):
        ks[:, table[b, n:]] = np.nan
        vs[:, table[b, n:]] = np.nan
    got = _port(q, kp, vp, lens, table, ks, vs)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    poisoned = jax_paged_decode_quant(*args, jnp.asarray(ks),
                                      jnp.asarray(vs))
    assert not np.isfinite(np.asarray(poisoned)).all()


def test_wrapper_takes_plain_version_on_cpu_without_counting():
    rng = np.random.RandomState(5)
    q, kp, vp, ks, vs, table = _mk(rng, B=2, H=4, KV=2, D=16, P=16, ps=16,
                                   pps=2)
    lens = np.array([20, 3], np.int32)
    before = (pd.paged_decode_quant.launches, pd.paged_decode.launches)
    got = _port(q, kp, vp, lens, table, ks, vs, fn=pd.paged_decode_quant)
    assert (pd.paged_decode_quant.launches,
            pd.paged_decode.launches) == before
    np.testing.assert_array_equal(got, _port(q, kp, vp, lens, table, ks, vs))


def test_wrapper_rejects_bad_scales():
    rng = np.random.RandomState(6)
    q, kp, vp, ks, vs, table = _mk(rng, B=1, H=2, KV=2, D=8, P=8, ps=16,
                                   pps=2)
    with pytest.raises(ValueError, match="KV, P"):
        _port(q, kp, vp, np.array([3], np.int32), table, ks[:, :4], vs,
              fn=pd.paged_decode_quant)


SPLIT_CASES = {
    # name: (seed, shape kwargs, lengths, split_tokens, q dtype)
    "split_boundaries": (10, dict(B=5, H=8, KV=2, D=128, P=200, ps=16,
                                  pps=32), [256, 257, 100, 512, 0], None,
                         "float32"),
    "small_splits_bf16q": (11, dict(B=6, H=4, KV=4, D=64, P=100, ps=16,
                                    pps=16), [64, 65, 37, 0, 256, 200], 64,
                           "bfloat16"),
    "g16_d256_ps32": (12, dict(B=2, H=32, KV=2, D=256, P=8, ps=32, pps=3),
                      [96, 33], 32, "float32"),
}


@pytest.mark.parametrize("case", sorted(SPLIT_CASES))
def test_split_model_matches_pallas(case):
    """The split rule over int8 pages equals ``_call_quant``'s one dense
    softmax over the dequantized window."""
    seed, shape, lens, split_tokens, qdtype = SPLIT_CASES[case]
    rng = np.random.RandomState(seed)
    q, kp, vp, ks, vs, table = _mk(rng, **shape)
    lens = np.asarray(lens, np.int32)
    got = paged_decode_split_model(
        torch.from_numpy(q).to(getattr(torch, qdtype)), torch.from_numpy(kp),
        torch.from_numpy(vp), torch.from_numpy(lens),
        torch.from_numpy(table), torch.from_numpy(ks), torch.from_numpy(vs),
        split_tokens=split_tokens).float().numpy()
    want = jax_paged_decode_quant(*_jax_args(q, kp, vp, lens, table, qdtype),
                                  jnp.asarray(ks), jnp.asarray(vs))
    np.testing.assert_allclose(got, np.asarray(want, np.float32),
                               **_tol(qdtype))
    assert not got[lens == 0].any()


@pytest.mark.parametrize("shape,q_dtype", [
    (dict(H=32, KV=4, D=128, ps=16, pps=512), torch.float32),   # 8192
    (dict(H=32, KV=1, D=128, ps=16, pps=256), torch.bfloat16),  # G = 32
    (dict(H=8, KV=4, D=256, ps=16, pps=64), torch.float32),     # D = 256
])
def test_gate_takes_what_the_old_caps_refused(shape, q_dtype):
    B = 2
    P = B * shape["pps"] + 1
    q = torch.empty(B, shape["H"], shape["D"], dtype=q_dtype, device="meta")
    kp = torch.empty(shape["KV"], P, shape["ps"], shape["D"],
                     dtype=torch.int8, device="meta")
    lens = torch.empty(B, dtype=torch.int32, device="meta")
    table = torch.empty(B, shape["pps"], dtype=torch.int32, device="meta")
    sc = torch.empty(shape["KV"], P, device="meta")
    plan = pd._gate("paged_decode_quant", {
        "q": q, "k_pages": kp, "v_pages": kp, "lengths": lens,
        "page_indices": table, "k_scales": sc, "v_scales": sc},
        q, kp, kp, lens, table, pd._QUANT_DTYPE_PAIRS)
    assert plan == pd.split_plan(B, shape["KV"], shape["H"] // shape["KV"],
                                 shape["D"], shape["ps"], shape["pps"])


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "false); chip_smoke.py runs this check on the card")
    return torch.device("cuda")


#: (shape, lengths) of the card test beyond the first kernel's: the
#: shapes it refused and lengths at, one past and inside a split boundary
CARD_SHAPES = {
    "gqa": (dict(B=3, H=8, KV=2, D=128, P=32, pps=8), None),
    "g8_window8192": (dict(B=2, H=32, KV=4, D=128, pps=512), [8192, 6500]),
    "mqa_g32": (dict(B=2, H=32, KV=1, D=128, pps=256), [4096, 1000]),
    "d256_g2": (dict(B=3, H=8, KV=4, D=256, pps=32), [512, 300, 5]),
    "split_boundaries": (dict(B=5, H=8, KV=8, D=64, pps=32),
                         [256, 257, 511, 0, 512]),
}


@pytest.mark.cuda
@pytest.mark.parametrize("shape", sorted(CARD_SHAPES))
@pytest.mark.parametrize("qdtype,ps", [("float32", 16), ("float32", 32),
                                       ("bfloat16", 16)])
def test_kernel_matches_plain_on_card(cuda_device, qdtype, ps, shape):
    """fp32 output: the same fp32 arithmetic in another order (atol
    2e-5).  bf16 output: one bf16 ulp (rtol 2^-7) plus atol 1e-4."""
    rng = np.random.RandomState(7)
    dims, lens = CARD_SHAPES[shape]
    # the new shapes keep their window at either page size
    pps = dims["pps"] if lens is None else dims["pps"] * 16 // ps
    q, kp, vp, ks, vs, table = _mk(rng, **dict(
        dims, pps=pps, ps=ps, P=dims.get("P", dims["B"] * pps)))
    lens = np.array(lens or [8 * ps, 1, 40], np.int32)
    args = [torch.from_numpy(q).to(cuda_device, getattr(torch, qdtype))]
    args += [torch.from_numpy(a).to(cuda_device)
             for a in (kp, vp, lens, table, ks, vs)]
    got = pd.paged_decode_quant(*args)
    torch.cuda.synchronize()
    want = pd.paged_decode_quant_reference(*args)
    assert got.dtype == want.dtype
    bf16 = qdtype == "bfloat16"
    torch.testing.assert_close(got.float(), want.float(),
                               rtol=2 ** -7 if bf16 else 0.0,
                               atol=1e-4 if bf16 else 2e-5)
