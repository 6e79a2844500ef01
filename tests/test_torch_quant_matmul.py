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

The tensor-core routes' arithmetic (K split into runs of whole 64-row
tiles, f32 partials summed in split order, one scale and one cast) is
modelled by ``testing/qmm_split.py`` and held to ``_pallas_qmm`` at the
same tolerances; its int8 -> bf16 byte trick is checked on every byte.

The CUDA kernels themselves are compared with the plain version on the
card in ``test_kernel_matches_plain_on_card`` (marked ``cuda``, skipped
where there is none) and in ``chip_smoke.py``.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.ops import quant as jq
from paddle_tpu.ops.pallas_kernels.quant_matmul import _pallas_qmm
from paddle_tpu_torch.ops import quant as tq
from paddle_tpu_torch.ops.kernels import quant_matmul as qm
from paddle_tpu_torch.testing import qmm_split

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
    """Every route (for bf16: the tensor-core GEMV with one and several
    splits, the wgmma GEMM, the SIMT kernels off the TMA shape rule; for
    f32 the fp32-core GEMV and tiles) and ragged edges.  f32: the same
    fp32 products summed in another order (atol 1e-4 at |out| ~ 1).  bf16
    output: one bf16 ulp (rtol 2^-7) plus atol 1e-4 for the fp32 sums
    before rounding.  A second call gives the same bits (the splits are
    summed in a fixed order)."""
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
    assert torch.equal(qm.quant_matmul(*args), got)


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N", [(8, 4096, 11008), (3, 11008, 4096),
                                   (16, 688, 144), (32, 4096, 4096),
                                   (33, 4096, 272), (64, 688, 144),
                                   (188, 4096, 11008), (512, 11008, 4096)])
def test_tensor_core_routes_match_plain_on_card(cuda_device, M, K, N):
    """bf16 x at the serving shapes and past them: the tensor-core GEMV
    at 1, 2 and 4 n8 tiles, with 8 and 3 splits and with K = 688's
    ragged last tile, and the wgmma GEMM with ragged row tiles, an odd
    count of channel tiles (a cluster's second block past N) and
    K = 11008; the route each call takes, one bf16 ulp (rtol
    2^-7) plus atol 1e-3 for fp32 sums of up to 11008 products at
    |out| ~ 5, and the same bits from a second call."""
    x, qw, s = _case(M * 3 + K + N, M, K, N)
    args = (torch.from_numpy(x).to(cuda_device, torch.bfloat16),
            torch.from_numpy(qw).to(cuda_device),
            torch.from_numpy(s).to(cuda_device))
    kind = qm.route(M, K, N, torch.bfloat16)
    assert kind == ("decode" if M <= qm.DECODE_MAX_M else "prefill")
    before = qm.quant_matmul.routes[kind]
    got = qm.quant_matmul(*args)
    torch.cuda.synchronize()
    assert qm.quant_matmul.routes[kind] == before + 1
    want = qm.quant_matmul_reference(*args)
    assert got.dtype == torch.bfloat16 and got.shape == (M, N)
    torch.testing.assert_close(got.float(), want.float(), rtol=2 ** -7,
                               atol=1e-3)
    assert torch.equal(qm.quant_matmul(*args), got)


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


# -- the tensor-core routes: their arithmetic, widening and routing ---------

@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("M,K,N", [(1, 256, 128), (3, 256, 144),
                                   (8, 688, 128), (9, 688, 144),
                                   (16, 512, 256), (64, 256, 272)])
def test_split_model_matches_pallas_interpret(M, K, N, dtype):
    """The kernels' order of summation (the K split the wrapper would
    give a CUDA call, one split, and a split per 64-row tile, f32
    partials added in split order, then the scale and one cast) against
    ``_pallas_qmm`` in interpret mode: M across the GEMV's n8 tiles and
    past them, K = 688 with a ragged last tile (11008's rule, 43 x 16),
    N off the 128-channel tiles."""
    x, qw, s = _case(3 * M + K + N, M, K, N)
    want = _pallas_qmm(jnp.asarray(x, getattr(jnp, dtype)),
                       jnp.asarray(qw), jnp.asarray(s.reshape(1, N)))
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    args = (xt, torch.from_numpy(qw), torch.from_numpy(s))
    planned = qmm_split.model_for(*args)
    assert planned.dtype == xt.dtype and planned.shape == (M, N)
    _close(planned.float().numpy(), want, dtype)
    for ksplit in (1, -(-K // qm.TILE_K)):
        got = qmm_split.split_model(*args, ksplit=ksplit)
        _close(got.float().numpy(), want, dtype)


def test_split_bounds_cover_k_in_whole_tiles():
    for K, ksplit in ((688, 3), (688, 11), (4096, 8), (11008, 8),
                      (4096, 3), (100, 2)):
        b = qmm_split.split_bounds(K, ksplit)
        assert len(b) == ksplit and b[0][0] == 0 and b[-1][1] == K
        assert all(k1 > k0 and k0 % qm.TILE_K == 0
                   for k0, k1 in b)
        assert all(b[i][1] == b[i + 1][0] for i in range(ksplit - 1))


def test_widen_pair_is_exact_for_every_byte():
    """The byte trick on all 256 x 256 (byte 0, byte 2) pairs equals
    int8 -> bf16, with bytes 1 and 3 holding garbage; and on the word an
    ``ldmatrix.trans`` hands a thread, [w(2t, 2g), w(2t, 2g + 1),
    w(2t + 1, 2g), w(2t + 1, 2g + 1)], it gives channel 2g's k pair and,
    shifted by 8, channel 2g + 1's."""
    b = torch.arange(256, dtype=torch.int64)
    lo, hi = torch.meshgrid(b, b, indexing="ij")
    junk = torch.randint(0, 256, lo.shape, generator=torch.Generator()
                         .manual_seed(5))
    words = lo | (junk << 8) | (hi << 16) | ((255 - junk) << 24)
    got = qmm_split.widen_pair(words)
    as_int8 = torch.where(b >= 128, b - 256, b).to(torch.int8)
    want = torch.stack([as_int8[lo.reshape(-1)], as_int8[hi.reshape(-1)]],
                       dim=-1).to(torch.bfloat16).reshape(got.shape)
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))

    rng = np.random.RandomState(6)
    w = rng.randint(-128, 128, size=(2, 2, 1000)).astype(np.int8)
    u = torch.from_numpy(w.view(np.uint8).astype(np.int64))
    # rows k = 2t, 2t + 1; columns channel 2g, 2g + 1
    word = u[0, 0] | (u[0, 1] << 8) | (u[1, 0] << 16) | (u[1, 1] << 24)
    wt = torch.from_numpy(w.astype(np.float32))
    for shift, ch in ((0, 0), (8, 1)):
        pair = qmm_split.widen_pair(word >> shift).float()
        assert torch.equal(pair[:, 0], wt[0, ch])
        assert torch.equal(pair[:, 1], wt[1, ch])


#: (K, N) of every Llama-2-7B projection: q/k/v/o, gate/up, down
LLAMA2_7B = {"qkvo": (4096, 4096), "gate_up": (4096, 11008),
             "down": (11008, 4096)}


@pytest.mark.parametrize("proj", sorted(LLAMA2_7B))
def test_route_takes_tensor_cores_at_every_llama_projection(proj):
    K, N = LLAMA2_7B[proj]
    bf16 = torch.bfloat16
    for M in (1, 8):
        assert qm.route(M, K, N, bf16) == "decode"
    for M in (188, 512):
        assert qm.route(M, K, N, bf16) == "prefill"
    assert qm.route(8, K, N, torch.float32) == "fp32"
    assert qm.route(8, K, N, bf16, aligned=False) == "simt"
    ksplit = qm.decode_split(K, N)
    assert 1 <= ksplit <= -(-K // qm.TILE_K)
    blocks = -(-N // qm.DECODE_N) * ksplit
    assert 200 <= blocks <= 3 * 132   # two blocks an SM, three fit


@pytest.mark.parametrize("M,K,N,dtype,want", [
    (8, 100, 37, torch.bfloat16, "simt"),
    (77, 300, 130, torch.bfloat16, "simt"),
    (4, 4096, 4100, torch.bfloat16, "simt"),   # N % 16 != 0
    (4, 4100, 4096, torch.bfloat16, "simt"),   # K % 8 != 0
    (32, 64, 32, torch.bfloat16, "decode"),    # the tiny config's k_proj
    (33, 64, 32, torch.bfloat16, "prefill"),
    (3, 100, 37, torch.float32, "fp32"),
    (512, 4096, 4096, torch.float32, "fp32"),
])
def test_route_rule_on_odd_shapes_and_f32(M, K, N, dtype, want):
    assert qm.route(M, K, N, dtype) == want


def test_gate_routes_and_refuses_without_a_launch():
    """``_gate`` reads shapes, dtypes, strides and pointers only, so it
    runs on CPU tensors: it names the route of aligned inputs, and
    raises on what every route refuses."""
    x, qw, s = _case(11, 8, 64, 32)
    X = torch.from_numpy(x).to(torch.bfloat16)
    W, S = torch.from_numpy(qw), torch.from_numpy(s)
    assert qm._gate(X, W, S) == ("decode" if X.data_ptr() % 16 == 0
                                 and W.data_ptr() % 16 == 0 else "simt")
    assert qm._gate(X.float(), W, S) == "fp32"
    with pytest.raises(ValueError, match="not contiguous"):
        qm._gate(torch.from_numpy(x.T.copy()).to(torch.bfloat16).t(), W, S)
    with pytest.raises(ValueError, match="not contiguous"):
        qm._gate(X, torch.from_numpy(qw.T.copy()).t(), S)
    for bad in ((X.half(), W, S), (X, W.to(torch.int16), S),
                (X, W.view(torch.uint8), S), (X, W, S.double())):
        with pytest.raises(TypeError, match="not supported"):
            qm._gate(*bad)
    with pytest.raises(ValueError, match="empty"):
        qm._gate(X[:0], W, S)
