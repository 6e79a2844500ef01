"""Paged-decode attention of the PyTorch port against ``paddle_tpu``.

The port's plain version (``paged_decode_reference``) is held to the
JAX package's Pallas kernel, run in interpret mode on the CPU, and to
its dense reference ``_dense_paged_attention``, on the cases of
``test_paged_decode_kernel.py``.  Inputs come from a numpy seed and
feed both packages.

Tolerance: fp32, atol 2e-5 — both sides accumulate in fp32 (the JAX
dense path in fp64 under the package's x64 mode), and the summation
order differs, which moves results by a few ulps of values of order 1.

The kernels' split rule (split-K over whole pages, one partial per
split, merged in split order) is modelled in ``testing/paged_split.py``
and held to the Pallas kernel at the same fp32 atol 2e-5, on lengths at,
one past and inside a split boundary, 0, the whole window, splits wholly
past a length, and the shapes the first kernel refused (G = 16, G = 32,
D = 256).  The split plan and the kernels' gate are checked from shapes
alone, without a card.

The CUDA kernels themselves are compared with the plain version on the
card in ``test_kernel_matches_plain_on_card`` (marked ``cuda``, skipped
where there is none) and in ``chip_smoke.py``.
"""
import inspect

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.inference.paged import _dense_paged_attention
from paddle_tpu.ops.pallas_kernels.paged_decode import (
    paged_decode as jax_paged_decode,
)
from paddle_tpu_torch.ops.kernels import paged_decode as pd
from paddle_tpu_torch.testing.paged_split import (
    paged_decode_split_model, split_partials,
)

ATOL = 2e-5


def _mk(rng, B, H, KV, D, P, ps, pps):
    q = rng.randn(B, H, D).astype(np.float32)
    kp = rng.randn(KV, P, ps, D).astype(np.float32)
    vp = rng.randn(KV, P, ps, D).astype(np.float32)
    table = rng.choice(P, size=(B, pps), replace=False).astype(np.int32)
    return q, kp, vp, table


def _port(q, kp, vp, lens, table):
    out = pd.paged_decode_reference(
        torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
        torch.from_numpy(lens), torch.from_numpy(table))
    return out.numpy()


def _pallas(q, kp, vp, lens, table):
    return np.asarray(jax_paged_decode(jnp.asarray(q), jnp.asarray(kp),
                                       jnp.asarray(vp), lens, table))


def _dense(q, kp, vp, lens, table):
    return np.asarray(_dense_paged_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(lens), jnp.asarray(table)), np.float32)


CASES = {
    # name: (seed, shape kwargs, lengths)
    "full_lengths": (0, dict(B=2, H=4, KV=4, D=32, P=16, ps=4, pps=3),
                     [12, 12]),
    "ragged_gqa": (1, dict(B=3, H=8, KV=2, D=16, P=32, ps=4, pps=4),
                   [16, 7, 1]),
    "mid_page": (2, dict(B=1, H=2, KV=2, D=8, P=8, ps=4, pps=2), [5]),
    "decode_shape_d128": (3, dict(B=4, H=8, KV=4, D=128, P=40, ps=16,
                                  pps=8), [128, 1, 77, 16]),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_reference_matches_pallas_and_dense(case):
    seed, shape, lens = CASES[case]
    rng = np.random.RandomState(seed)
    q, kp, vp, table = _mk(rng, **shape)
    lens = np.asarray(lens, np.int32)
    got = _port(q, kp, vp, lens, table)
    np.testing.assert_allclose(got, _pallas(q, kp, vp, lens, table),
                               rtol=0, atol=ATOL)
    np.testing.assert_allclose(got, _dense(q, kp, vp, lens, table),
                               rtol=0, atol=ATOL)


def test_nan_poisoned_tail_is_inert():
    """Pages past ceil(len / ps) hold NaN and the table points at them:
    the Pallas kernel never DMAs them and the port masks them, so both
    stay finite and agree."""
    rng = np.random.RandomState(4)
    q, kp, vp, table = _mk(rng, B=2, H=4, KV=2, D=16, P=16, ps=4, pps=4)
    lens = np.array([5, 9], np.int32)          # covers 2 and 3 pages
    for b, n in enumerate([2, 3]):
        kp[:, table[b, n:]] = np.nan
        vp[:, table[b, n:]] = np.nan
    got = _port(q, kp, vp, lens, table)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, _pallas(q, kp, vp, lens, table),
                               rtol=0, atol=ATOL)


def test_wrapper_takes_plain_version_on_cpu_without_counting():
    rng = np.random.RandomState(5)
    q, kp, vp, table = _mk(rng, B=2, H=4, KV=2, D=16, P=16, ps=4, pps=2)
    lens = np.array([8, 3], np.int32)
    before = pd.paged_decode.launches
    got = pd.paged_decode(torch.from_numpy(q), torch.from_numpy(kp),
                          torch.from_numpy(vp), torch.from_numpy(lens),
                          torch.from_numpy(table))
    assert pd.paged_decode.launches == before
    np.testing.assert_array_equal(got.numpy(),
                                  _port(q, kp, vp, lens, table))


def test_wrapper_rejects_bad_group_ratio():
    rng = np.random.RandomState(6)
    q, kp, vp, table = _mk(rng, B=1, H=3, KV=2, D=8, P=8, ps=4, pps=2)
    with pytest.raises(ValueError, match="multiple"):
        pd.paged_decode(torch.from_numpy(q), torch.from_numpy(kp),
                        torch.from_numpy(vp),
                        torch.tensor([8], dtype=torch.int32),
                        torch.from_numpy(table))


def _bf16_pools(kp, vp):
    """bf16 pools for both packages: torch rounds, jnp takes the values."""
    kb, vb = (torch.from_numpy(x).bfloat16() for x in (kp, vp))
    return kb, vb, (jnp.asarray(t.float().numpy(), jnp.bfloat16)
                    for t in (kb, vb))


SPLIT_CASES = {
    # name: (seed, shape kwargs, lengths, split_tokens); the default split
    # is 256 tokens (16 pages at ps = 16)
    "split_boundaries": (10, dict(B=5, H=8, KV=2, D=128, P=200, ps=16,
                                  pps=32), [256, 257, 100, 512, 0], None),
    "small_splits": (11, dict(B=6, H=4, KV=4, D=64, P=100, ps=16, pps=16),
                     [64, 65, 37, 0, 256, 200], 64),
    "g16_d256": (12, dict(B=2, H=32, KV=2, D=256, P=12, ps=16, pps=4),
                 [64, 17], 32),
    "mqa_g32": (13, dict(B=2, H=32, KV=1, D=128, P=20, ps=16, pps=8),
                [128, 50], 32),
}


@pytest.mark.parametrize("case", sorted(SPLIT_CASES))
def test_split_model_matches_pallas(case):
    """The split rule over bf16 pools equals the Pallas kernel's one dense
    softmax over the window."""
    seed, shape, lens, split_tokens = SPLIT_CASES[case]
    rng = np.random.RandomState(seed)
    q, kp, vp, table = _mk(rng, **shape)
    lens = np.asarray(lens, np.int32)
    kb, vb, (kj, vj) = _bf16_pools(kp, vp)
    got = paged_decode_split_model(
        torch.from_numpy(q), kb, vb, torch.from_numpy(lens),
        torch.from_numpy(table), split_tokens=split_tokens).numpy()
    want = np.asarray(jax_paged_decode(jnp.asarray(q), kj, vj, lens, table))
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    if 0 in lens:
        assert not got[lens == 0].any()
    _, _, _, active = split_partials(
        torch.from_numpy(q), kb, vb, torch.from_numpy(lens),
        torch.from_numpy(table), split_tokens=split_tokens)
    st = pd.split_plan(shape["B"], shape["KV"], shape["H"] // shape["KV"],
                       shape["D"], shape["ps"], shape["pps"],
                       split_tokens)["split_tokens"]
    starts = torch.arange(active.shape[1]) * st
    assert torch.equal(active, starts[None] < torch.from_numpy(lens)[:, None])


def test_split_model_skips_rows_past_the_length():
    """NaN in the last page's unwritten tail and in every page past the
    cover: the split rule reads neither (it skips those rows) and matches
    the plain version, which masks them."""
    rng = np.random.RandomState(14)
    q, kp, vp, table = _mk(rng, B=3, H=4, KV=2, D=64, P=40, ps=16, pps=8)
    lens = np.array([37, 16, 100], np.int32)
    for b, n in enumerate(lens):
        cover = -(-n // 16)
        kp[:, table[b, cover:]] = np.nan
        vp[:, table[b, cover:]] = np.nan
        kp[:, table[b, cover - 1], n % 16 or 16:] = np.nan
        vp[:, table[b, cover - 1], n % 16 or 16:] = np.nan
    args = [torch.from_numpy(a) for a in (q, kp, vp, lens, table)]
    got = paged_decode_split_model(*args, split_tokens=32)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, pd.paged_decode_reference(*args),
                               rtol=0, atol=ATOL)


@pytest.mark.parametrize("shape", [
    (8, 32, 1, 128, 16, 128),     # Llama-2-7B serving, 2048-token window
    (2, 4, 8, 128, 16, 512),      # G = 8, 8192-token window
    (4, 1, 32, 128, 16, 256),     # MQA
    (3, 4, 2, 256, 16, 64),       # D = 256
    (2, 2, 3, 64, 5, 7),          # odd page size and window, G = 3
    (1, 1, 1, 64, 16, 0),         # an empty window
])
def test_split_plan_covers_the_window_with_whole_pages(shape):
    B, KV, G, D, ps, pps = shape
    assert "lengths" not in inspect.signature(pd.split_plan).parameters
    plan = pd.split_plan(*shape)
    sp, n = plan["split_pages"], plan["n_split"]
    assert 1 <= sp <= pd.MAX_SPLIT_PAGES and plan["split_tokens"] == sp * ps
    assert n >= 1 and (n - 1) * sp < max(pps, 1) <= n * sp
    assert sp == max(1, min(pd.SPLIT_TOKENS // ps, pd.MAX_SPLIT_PAGES, pps))
    qt = plan["q_tile"]
    assert qt in ((1, 2, 4, 8) if D <= 128 else (1, 2, 4))
    assert plan["n_qtile"] == -(-G // qt) and (qt >= G or qt == max(
        t for t in (1, 2, 4, 8) if D <= 128 or t <= 4))
    assert plan["scratch_floats"] == B * KV * n * G * (D + 2)


def _meta_case(B, H, KV, D, ps, pps, dtype=torch.bfloat16,
               q_dtype=torch.float32):
    P = B * pps + 1
    q = torch.empty(B, H, D, dtype=q_dtype, device="meta")
    kp = torch.empty(KV, P, ps, D, dtype=dtype, device="meta")
    vp = torch.empty(KV, P, ps, D, dtype=dtype, device="meta")
    lens = torch.empty(B, dtype=torch.int32, device="meta")
    table = torch.empty(B, pps, dtype=torch.int32, device="meta")
    return q, kp, vp, lens, table


def _gate(q, kp, vp, lens, table, pairs=None):
    return pd._gate("paged_decode", {"q": q, "k_pages": kp, "v_pages": vp,
                                     "lengths": lens, "page_indices": table},
                    q, kp, vp, lens, table, pairs or pd._DTYPE_PAIRS)


@pytest.mark.parametrize("shape,n_split,q_tile", [
    (dict(B=2, H=32, KV=4, D=128, ps=16, pps=512), 32, 8),   # G=8, 8192
    (dict(B=4, H=32, KV=1, D=128, ps=16, pps=256), 16, 8),   # G = 32
    (dict(B=3, H=8, KV=4, D=256, ps=16, pps=64), 4, 2),      # D = 256
    (dict(B=1, H=64, KV=4, D=256, ps=16, pps=8), 1, 4),      # G=16, D=256
])
def test_gate_takes_what_the_old_caps_refused(shape, n_split, q_tile):
    """Shapes the first kernel refused (a window whose scores overflowed
    shared memory, G > 8, D = 256) pass the gate; checked from shapes
    alone, nothing launched."""
    plan = _gate(*_meta_case(**shape))
    assert (plan["n_split"], plan["q_tile"]) == (n_split, q_tile)


def test_gate_refuses_a_misaligned_pool():
    q, kp, vp, lens, table = _meta_case(B=1, H=2, KV=2, D=64, ps=16, pps=2)
    n = kp.numel()
    kp = torch.empty(n + 1, dtype=torch.bfloat16)[1:].view(kp.shape)
    assert kp.is_contiguous() and kp.data_ptr() % 16
    with pytest.raises(ValueError, match="16-byte aligned"):
        _gate(q, kp, torch.empty(kp.shape, dtype=torch.bfloat16), lens,
              table)


def test_gate_refuses_pages_off_the_copy_unit_and_other_head_dims():
    with pytest.raises(ValueError, match="multiple of 16"):
        _gate(*_meta_case(B=1, H=2, KV=2, D=36, ps=3, pps=2))
    with pytest.raises(ValueError, match="head_dim 96"):
        _gate(*_meta_case(B=1, H=2, KV=2, D=96, ps=16, pps=2))
    with pytest.raises(TypeError, match="dtypes"):
        _gate(*_meta_case(B=1, H=2, KV=2, D=64, ps=16, pps=2,
                          q_dtype=torch.bfloat16, dtype=torch.float32))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "false); chip_smoke.py runs this check on the card")
    return torch.device("cuda")


#: shapes the card test runs: the first kernel's, then those it refused
#: and lengths at, one past and inside the 256-token split boundary
CARD_SHAPES = {
    "gqa": (dict(B=3, H=8, KV=2, D=128, P=32, ps=16, pps=8), [128, 1, 40]),
    "g8_window8192": (dict(B=2, H=32, KV=4, D=128, P=1024, ps=16, pps=512),
                      [8192, 6500]),
    "mqa_g32": (dict(B=2, H=32, KV=1, D=128, P=512, ps=16, pps=256),
                [4096, 1000]),
    "d256_g2": (dict(B=3, H=8, KV=4, D=256, P=96, ps=16, pps=32),
                [512, 300, 5]),
    "split_boundaries": (dict(B=5, H=8, KV=8, D=64, P=160, ps=16, pps=32),
                         [256, 257, 511, 0, 512]),
    # pages wider than a ring stage's 16 KB stream in tiles of rows
    "pages_of_128": (dict(B=2, H=4, KV=2, D=256, P=8, ps=128, pps=4),
                     [500, 129]),
}


@pytest.mark.cuda
@pytest.mark.parametrize("shape", sorted(CARD_SHAPES))
@pytest.mark.parametrize("dtypes,atol,rtol", [
    ((torch.float32, torch.float32), 2e-5, 0.0),
    ((torch.float32, torch.bfloat16), 2e-5, 0.0),
    ((torch.bfloat16, torch.bfloat16), 1e-4, 2 ** -7),
])
def test_kernel_matches_plain_on_card(cuda_device, dtypes, atol, rtol,
                                      shape):
    """fp32 output: same fp32 arithmetic in another order (atol 2e-5).
    bf16 output: the two fp32 results may round to neighbouring bf16
    values, so one bf16 ulp of the value (rtol 2^-7) plus atol 1e-4."""
    rng = np.random.RandomState(7)
    dims, lens = CARD_SHAPES[shape]
    q, kp, vp, table = _mk(rng, **dims)
    lens = np.array(lens, np.int32)
    qd, pdt = dtypes
    args = [torch.from_numpy(q).to(cuda_device, qd),
            torch.from_numpy(kp).to(cuda_device, pdt),
            torch.from_numpy(vp).to(cuda_device, pdt),
            torch.from_numpy(lens).to(cuda_device),
            torch.from_numpy(table).to(cuda_device)]
    got = pd.paged_decode(*args)
    torch.cuda.synchronize()
    want = pd.paged_decode_reference(*args)
    assert got.dtype == qd
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=atol)
