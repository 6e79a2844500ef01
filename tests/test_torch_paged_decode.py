"""Paged-decode attention of the PyTorch port against ``paddle_tpu``.

The port's plain version (``paged_decode_reference``) is held to the
JAX package's Pallas kernel, run in interpret mode on the CPU, and to
its dense reference ``_dense_paged_attention``, on the cases of
``test_paged_decode_kernel.py``.  Inputs come from a numpy seed and
feed both packages.

Tolerance: fp32, atol 2e-5 — both sides accumulate in fp32 (the JAX
dense path in fp64 under the package's x64 mode), and the summation
order differs, which moves results by a few ulps of values of order 1.

The CUDA kernel itself is compared with the plain version on the card
in ``test_kernel_matches_plain_on_card`` (marked ``cuda``, skipped
where there is none) and in ``chip_smoke.py``.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.inference.paged import _dense_paged_attention
from paddle_tpu.ops.pallas_kernels.paged_decode import (
    paged_decode as jax_paged_decode,
)
from paddle_tpu_torch.ops.kernels import paged_decode as pd

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


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "false); chip_smoke.py runs this check on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtypes,atol,rtol", [
    ((torch.float32, torch.float32), 2e-5, 0.0),
    ((torch.float32, torch.bfloat16), 2e-5, 0.0),
    ((torch.bfloat16, torch.bfloat16), 1e-4, 2 ** -7),
])
def test_kernel_matches_plain_on_card(cuda_device, dtypes, atol, rtol):
    """fp32 output: same fp32 arithmetic in another order (atol 2e-5).
    bf16 output: the two fp32 results may round to neighbouring bf16
    values, so one bf16 ulp of the value (rtol 2^-7) plus atol 1e-4."""
    rng = np.random.RandomState(7)
    q, kp, vp, table = _mk(rng, B=3, H=8, KV=2, D=128, P=32, ps=16, pps=8)
    lens = np.array([128, 1, 40], np.int32)
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
