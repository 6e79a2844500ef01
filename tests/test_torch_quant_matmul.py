"""Int8-weight matmul of the PyTorch port against ``paddle_tpu``.

The port's plain version (``quant_matmul_reference``) is held to the JAX
package's Pallas kernel ``_pallas_qmm``, run in interpret mode on the
CPU, and to the dequantize-then-dot fallback of ``ops/quant.qmatmul``,
on the same numpy inputs made from a seed.

Tolerances:
- f32 x: rtol 1e-5, atol 1e-5 — fp32 products and sums on both sides,
  summed in other orders (the Pallas kernel block by block over K).
- bf16 x: within one bf16 ulp of the JAX result (|got - want| <= 2^-7 *
  |want|, plus atol 1e-6 near zero) — both form the same f32 value up to
  summation order and round it to bf16, so the two roundings may land
  on neighbouring bf16 values.

The CUDA kernel itself is compared with the plain version on the card in
``test_kernel_matches_plain_on_card`` (marked ``cuda``, skipped where
there is none) and in ``chip_smoke.py``.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.ops import quant as jq
from paddle_tpu.ops.pallas_kernels.quant_matmul import _pallas_qmm
from paddle_tpu_torch.ops import quant as tq
from paddle_tpu_torch.ops.kernels import quant_matmul as qm

TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
       "bfloat16": dict(rtol=2 ** -7, atol=1e-6)}


def _case(seed, M, K, N):
    rng = np.random.RandomState(seed)
    x = rng.randn(M, K).astype(np.float32)
    w = (rng.randn(K, N) * 0.05).astype(np.float32)
    qw, s = jq.quantize_per_channel(jnp.asarray(w))
    return x, np.array(qw), np.array(s).reshape(N)


def _port(x, qw, s, dtype):
    return qm.quant_matmul_reference(
        torch.from_numpy(x).to(getattr(torch, dtype)),
        torch.from_numpy(qw), torch.from_numpy(s)).float().numpy()


def _close(got, want, dtype):
    np.testing.assert_allclose(got, np.asarray(want, np.float32),
                               **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M,K,N", [(1, 256, 128), (5, 256, 384),
                                   (8, 512, 256), (33, 256, 256)])
def test_reference_matches_pallas_interpret(M, K, N, dtype):
    x, qw, s = _case(M + K + N, M, K, N)
    want = _pallas_qmm(jnp.asarray(x, getattr(jnp, dtype)),
                       jnp.asarray(qw), jnp.asarray(s.reshape(1, N)))
    assert want.dtype == getattr(jnp, dtype)
    _close(_port(x, qw, s, dtype), want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M,K,N", [(1, 64, 32), (3, 100, 37),
                                   (8, 4, 5), (17, 48, 32)])
def test_qmatmul_matches_jax_fallback(M, K, N, dtype):
    """Shapes the TPU kernel's tiling gate refuses (N = 32 is the tiny
    config's k_proj): the port takes any shape, so it is held to the
    fallback there, through ``qmatmul`` with a leading batch dim."""
    x, qw, s = _case(M * 7 + K + N, M, K, N)
    x3 = x.reshape(1, M, K)
    want = jq.qmatmul(jnp.asarray(x3, getattr(jnp, dtype)),
                      {"qweight": jnp.asarray(qw),
                       "scale": jnp.asarray(s.reshape(1, N))},
                      impl="einsum")
    got = tq.qmatmul(torch.from_numpy(x3).to(getattr(torch, dtype)),
                     {"qweight": torch.from_numpy(qw),
                      "scale": torch.from_numpy(s.reshape(1, N))})
    assert got.shape == (1, M, N) and got.dtype == getattr(torch, dtype)
    _close(got.float().numpy(), want, dtype)


def test_wrapper_takes_plain_version_on_cpu_without_counting():
    x, qw, s = _case(9, 4, 64, 48)
    before = qm.quant_matmul.launches
    got = qm.quant_matmul(torch.from_numpy(x), torch.from_numpy(qw),
                          torch.from_numpy(s))
    assert qm.quant_matmul.launches == before
    np.testing.assert_array_equal(got.numpy(), _port(x, qw, s, "float32"))


def test_wrapper_rejects_mismatched_shapes():
    x, qw, s = _case(10, 2, 16, 8)
    with pytest.raises(ValueError, match="do not match"):
        qm.quant_matmul(torch.from_numpy(x[:, :8]), torch.from_numpy(qw),
                        torch.from_numpy(s))
    with pytest.raises(ValueError, match="do not match"):
        qm.quant_matmul(torch.from_numpy(x), torch.from_numpy(qw),
                        torch.from_numpy(s[:4]))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "false); chip_smoke.py runs this check on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M,K,N", [(1, 4096, 4096), (3, 100, 37),
                                   (8, 1030, 96), (9, 64, 32),
                                   (77, 300, 130), (512, 512, 256)])
def test_kernel_matches_plain_on_card(cuda_device, M, K, N, dtype):
    """Every kernel path (GEMV with one and several K slices, the mma and
    FMA tiles) and ragged edges.  f32: the same fp32 products summed in
    another order (atol 1e-4 at |out| ~ 1).  bf16 output: one bf16 ulp
    (rtol 2^-7) plus atol 1e-4 for the fp32 sums before rounding."""
    x, qw, s = _case(M + K + N, M, K, N)
    args = (torch.from_numpy(x).to(cuda_device, getattr(torch, dtype)),
            torch.from_numpy(qw).to(cuda_device),
            torch.from_numpy(s).to(cuda_device))
    got = qm.quant_matmul(*args)
    torch.cuda.synchronize()
    want = qm.quant_matmul_reference(*args)
    assert got.dtype == want.dtype and got.shape == (M, N)
    rtol = 0.0 if dtype == "float32" else 2 ** -7
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("M", [4, 40])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_on_unaligned_layer_slice(cuda_device, M, dtype):
    """A layer of a stacked [L, K, N] weight whose K * N is odd starts
    at an odd byte: the kernel falls back to narrow loads there (same
    tolerances as above)."""
    K, N = 101, 37
    x, qw, s = _case(M + 5, M, K, N)
    stacked = torch.zeros(2, K, N, dtype=torch.int8)
    stacked[1] = torch.from_numpy(qw)
    w = stacked.to(cuda_device)[1]
    assert w.data_ptr() % 4 != 0
    args = (torch.from_numpy(x).to(cuda_device, getattr(torch, dtype)), w,
            torch.from_numpy(s).to(cuda_device))
    got = qm.quant_matmul(*args)
    torch.cuda.synchronize()
    want = qm.quant_matmul_reference(*args)
    rtol = 0.0 if dtype == "float32" else 2 ** -7
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=1e-4)
