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

The CUDA kernel itself is compared with the plain version on the card
in ``test_kernel_matches_plain_on_card`` (marked ``cuda``, skipped where
there is none) and in ``chip_smoke.py``.
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


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "false); chip_smoke.py runs this check on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("qdtype,ps", [("float32", 16), ("float32", 32),
                                       ("bfloat16", 16)])
def test_kernel_matches_plain_on_card(cuda_device, qdtype, ps):
    """fp32 output: the same fp32 arithmetic in another order (atol
    2e-5).  bf16 output: one bf16 ulp (rtol 2^-7) plus atol 1e-4."""
    rng = np.random.RandomState(7)
    q, kp, vp, ks, vs, table = _mk(rng, B=3, H=8, KV=2, D=128, P=32, ps=ps,
                                   pps=8)
    lens = np.array([8 * ps, 1, 40], np.int32)
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
