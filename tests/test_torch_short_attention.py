"""Short-sequence attention of the PyTorch port against ``paddle_tpu``.

* ``keep_mask`` against the Pallas kernel's ``_keep_mask`` bit for bit,
  the hash run inside a one-output Pallas kernel in interpret mode, with
  seeds at both ends of int32 and enough heads (B=2, H=3) that
  ``(b·H + h)·747796405`` wraps.
* The port's plain forward (out, lse) and backward (dq, dk, dv) against
  the Pallas ``short_attention`` kernel itself, run on the CPU under
  ``pltpu.force_tpu_interpret_mode()`` with the same seed, over
  S in {128, 256}, D in {64, 128}, causal and not, p in {0, 0.1, 0.5},
  fp32 and bf16.
* ``v = I`` (S = D = 128, p = 0.5): the output is the dropped
  probability matrix, whose zero pattern must equal the Pallas kernel's
  exactly; with ``g = I``, ``dv`` is its transpose.
* ``sdpa``'s routing against ``_sdpa_plain``'s own choice with dropout on
  and off (its kernels replaced by spies, ``jax.devices()`` reporting a
  TPU), and the short route and the einsum route's dropout on the CPU.

Tolerances: out/lse fp32 atol 2e-5; bf16 out 2^-7 * |want| + 2e-3 (one
bf16 rounding of an fp32 result), lse atol 1e-3; dq/dk/dv fp32 atol
1e-4, bf16 2^-6 * |want| + 5e-3 (bf16 outputs of fp32 sums taken in
another order).
"""
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

import paddle_tpu.ops.nn_ops as jnn_ops
from paddle_tpu.ops.pallas_kernels.short_attention import (
    _fwd_call_impl, _keep_mask, short_attention as jax_short_attention,
)
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.ops import nn_ops
from paddle_tpu_torch.ops.kernels import short_attention as sa

DTYPES = {"fp32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
SEED = 987654321


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.array(jnp.asarray(a, jnp.float32))


def _check(got, want, atol, rtol=0.0):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    excess = np.abs(got - want) - (atol + rtol * np.abs(want))
    assert excess.max() <= 0, (np.abs(got - want).max(), excess.max())


def _jax_keep_mask(seed, B, H, S, keep):
    """``_keep_mask`` of every (b, h) program, as int32 [B, H, S, S]."""
    def kernel(seed_ref, o_ref):
        o_ref[0, 0] = _keep_mask(seed_ref, (S, S), keep).astype(jnp.int32)

    spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=1, grid=(B, H), in_specs=[],
        out_specs=[pl.BlockSpec((1, 1, S, S), lambda b, h, *_: (b, h, 0, 0))])
    with jax.enable_x64(False), pltpu.force_tpu_interpret_mode():
        out, = pl.pallas_call(
            kernel, grid_spec=spec,
            out_shape=[jax.ShapeDtypeStruct((B, H, S, S), jnp.int32)],
        )(jnp.asarray([seed], jnp.int32))
    return np.array(out).astype(bool)


@pytest.mark.parametrize("seed", [0, 12345, -7, 2 ** 31 - 1, -2 ** 31])
def test_keep_mask_bit_for_bit(seed):
    for keep in (0.9, 0.5):
        want = _jax_keep_mask(seed, 2, 3, 128, keep)
        got = sa.keep_mask(seed, 2, 3, 128, keep)
        assert got.dtype == torch.bool and got.shape == (2, 3, 128, 128)
        np.testing.assert_array_equal(got.numpy(), want)
        tensor_seed = torch.tensor([seed], dtype=torch.int32)
        assert torch.equal(sa.keep_mask(tensor_seed, 2, 3, 128, keep), got)
        assert abs(want.mean() - keep) < 0.01


def test_dropout_constants():
    assert sa.dropout_constants(0.1) == (int(0.9 * 2 ** 32),
                                         float(np.float32(1 / 0.9)))
    assert sa.dropout_constants(0.0)[0] == 2 ** 32 - 1
    assert sa.dropout_constants(0.5) == (2 ** 31, 2.0)


# (S, D, causal, dropout_p, dtype): every S, D, mode, rate and dtype,
# each rate with both dtypes and both masks
KERNEL_CASES = [
    (128, 64, False, 0.0, "fp32"), (128, 64, True, 0.1, "bf16"),
    (128, 128, True, 0.5, "fp32"), (128, 128, False, 0.1, "bf16"),
    (256, 64, False, 0.5, "bf16"), (256, 64, True, 0.0, "bf16"),
    (256, 128, True, 0.1, "fp32"), (256, 128, False, 0.5, "fp32"),
    (128, 64, True, 0.0, "fp32"), (256, 64, False, 0.1, "fp32"),
    (128, 128, False, 0.0, "bf16"), (256, 128, True, 0.5, "bf16"),
]


@pytest.mark.parametrize("S,D,causal,p,name", KERNEL_CASES)
def test_matches_pallas_kernel_in_interpret_mode(S, D, causal, p, name):
    jd, td = DTYPES[name]
    rng = np.random.RandomState(S + D + int(causal))
    q, k, v, g = (rng.randn(1, 2, S, D).astype(np.float32)
                  for _ in range(4))
    J = [jnp.asarray(a, jd) for a in (q, k, v, g)]
    scale = 1.0 / math.sqrt(D)
    with jax.enable_x64(False), pltpu.force_tpu_interpret_mode():
        jout, jlse = _fwd_call_impl(*J[:3], jnp.asarray([SEED], jnp.int32),
                                    scale, p, causal)
        _, vjp = jax.vjp(lambda a, b, c: jax_short_attention(
            a, b, c, jnp.int32(SEED), None, p, causal), *J[:3])
        jgrads = vjp(J[3])

    T = [torch.from_numpy(a).to(td) for a in (q, k, v)]
    seed = torch.tensor([SEED], dtype=torch.int32)
    out, lse, out32 = sa.short_attention_fwd(*T, seed, scale, p, causal)
    assert out.dtype == td and lse.dtype == torch.float32
    assert out32.dtype == torch.float32 and lse.shape == (1, 2, 1, S)
    assert torch.equal(out32.to(td), out)
    for t in T:
        t.requires_grad_(True)
    before = (sa.short_attention_fwd.launches,
              sa.short_attention_bwd.launches)
    aout = sa.short_attention(*T, SEED, None, p, causal)
    aout.backward(torch.from_numpy(g).to(td))
    assert (sa.short_attention_fwd.launches,
            sa.short_attention_bwd.launches) == before
    assert torch.equal(aout.detach(), out)
    # both drop exactly the same entries
    np.testing.assert_array_equal(_np(out) == 0, _np(jout) == 0)
    if name == "fp32":
        _check(out, jout, 2e-5)
        _check(lse, jlse, 2e-5)
        tol = (1e-4,)
    else:
        _check(out, jout, 2e-3, 2 ** -7)
        _check(lse, jlse, 1e-3)
        tol = (5e-3, 2 ** -6)
    for got, want in zip((t.grad for t in T), jgrads):
        assert got.dtype == td
        _check(got, want, *tol)


def test_identity_v_exposes_the_mask():
    """S = D = 128, p = 0.5, v = I: ``out`` is the dropped probability
    matrix, its zeros exactly the Pallas kernel's; with g = I, ``dv``
    is its transpose (``pd^T g``)."""
    S = D = 128
    rng = np.random.RandomState(3)
    q, k = (rng.randn(2, 2, S, D).astype(np.float32) for _ in range(2))
    eye = np.broadcast_to(np.eye(S, dtype=np.float32), (2, 2, S, S)).copy()
    with jax.enable_x64(False), pltpu.force_tpu_interpret_mode():
        jout, _ = _fwd_call_impl(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(eye),
                                 jnp.asarray([SEED], jnp.int32),
                                 1.0 / math.sqrt(D), 0.5, False)
    T = [torch.from_numpy(a) for a in (q, k, eye)]
    seed = torch.tensor([SEED], dtype=torch.int32)
    out, lse, out32 = sa.short_attention_fwd(*T, seed, 1.0 / math.sqrt(D),
                                             0.5, False)
    np.testing.assert_array_equal(_np(out) == 0, _np(jout) == 0)
    keep = sa.keep_mask(SEED, 2, 2, S, 0.5)
    assert torch.equal(out == 0, ~keep)
    _, _, dv = sa.short_attention_bwd(*T, out32, lse, T[2], seed,
                                      1.0 / math.sqrt(D), 0.5, False)
    assert torch.equal(dv == 0, out.transpose(-1, -2) == 0)
    # p recomputed as exp(s - lse) in the backward, e / l in the forward
    torch.testing.assert_close(dv, out.transpose(-1, -2), rtol=1e-5,
                               atol=1e-7)


def test_wrappers_check_their_inputs():
    q = torch.zeros(1, 2, 128, 64)
    seed = torch.tensor([1], dtype=torch.int32)
    with pytest.raises(ValueError, match="dropout_p"):
        sa.short_attention_fwd(q, q, q, seed, 0.125, 1.0)
    with pytest.raises(ValueError, match="seed"):
        sa.short_attention_fwd(q, q, q, None, 0.125, 0.1)
    with pytest.raises(ValueError, match="shapes differ"):
        sa.short_attention_fwd(q, q[:, :1], q, seed, 0.125)
    with pytest.raises(ValueError, match="seed"):
        sa.short_attention(q, q, q, None, 0.125, 0.1)


def test_no_dropout_passes_no_seed(monkeypatch):
    """Without dropout the autograd function gets no seed tensor (on the
    card, building one would copy from the host on every layer) and saves
    None for the backward; an int seed is ignored."""
    seen = []
    real = sa.short_attention_fwd
    monkeypatch.setattr(sa, "short_attention_fwd", lambda q, k, v, seed, *a:
                        seen.append(seed) or real(q, k, v, seed, *a))
    rng = np.random.RandomState(12)
    q, k, v = (torch.from_numpy(rng.randn(1, 2, 128, 64).astype(np.float32))
               .requires_grad_(True) for _ in range(3))
    sa.short_attention(q, k, v, 77, None, 0.0, True).sum().backward()
    assert seen == [None]
    want = sa.short_attention_fwd_reference(q, k, v, None, 0.125, 0.0, True)
    got = sa.short_attention(q, k, v, None, None, 0.0, True)
    assert torch.equal(got, want[0])
    assert all(t.grad is not None for t in (q, k, v))


class _Routed(Exception):
    pass


class _Tpu:
    platform = "tpu"


class _JnpSpy:
    """``jnp`` as ``nn_ops`` sees it, with the einsum path reporting
    itself instead of running."""

    def __getattr__(self, name):
        return getattr(jnp, name)

    @staticmethod
    def einsum(*a, **k):
        raise _Routed("einsum")


class _JaxOnTpu:
    """``jax`` as ``nn_ops`` sees it, but reporting a TPU device."""

    def __getattr__(self, name):
        return getattr(jax, name)

    @staticmethod
    def devices(*a, **k):
        return [_Tpu()]


def _jax_route(monkeypatch, Sq, Hq, Hkv, Dh, causal, mask, impl, on_tpu,
               dropout):
    """Which kernel ``_sdpa_plain`` picks (its kernels replaced by spies)."""
    def spy(route):
        def f(*a, **k):
            raise _Routed(route)
        return f

    with monkeypatch.context() as m:
        if on_tpu:
            m.setattr(jnn_ops, "jax", _JaxOnTpu())
        m.setattr("paddle_tpu.ops.pallas_kernels.long_attention."
                  "long_attention", spy("long"))
        m.setattr("paddle_tpu.ops.pallas_kernels.short_attention",
                  spy("short"))
        m.setattr(jnn_ops, "_flash_attention_tpu", spy("flash"))
        m.setattr(jnn_ops, "jnp", _JnpSpy())
        q = jnp.zeros((1, Sq, Hq, Dh), jnp.float32)
        kv = jnp.zeros((1, Sq, Hkv, Dh), jnp.float32)
        msk = jnp.zeros((1, 1, Sq, Sq), jnp.float32) if mask else None
        key = jax.random.PRNGKey(0) if dropout else None
        try:
            with jax.enable_x64(False):
                jnn_ops._sdpa_plain(q, kv, kv, msk, key, dropout, causal,
                                    None, impl)
        except _Routed as r:
            return str(r)
        raise AssertionError("_sdpa_plain returned without a route")


ROUTE_CASES = [
    # (Sq, H, Hkv, D, causal, mask, impl): BERT-base (S=384, D=64), Llama
    # below 1024, the long and flash regions, the edges
    (384, 12, 12, 64, False, False, "auto"),
    (384, 12, 12, 64, False, True, "auto"),
    (512, 4, 4, 128, True, False, "auto"),
    (128, 2, 2, 64, False, False, "auto"),
    (1024, 2, 2, 128, False, False, "auto"),
    (1024, 2, 2, 128, True, False, "auto"),
    (2048, 2, 2, 128, True, False, "auto"),
    (512, 4, 2, 128, True, False, "auto"),
    (384, 2, 2, 32, False, False, "auto"),
    (320, 2, 2, 64, False, False, "auto"),
    (384, 2, 2, 64, False, False, "short"),
    (2048, 2, 2, 128, True, False, "short"),
    (2048, 2, 2, 128, True, False, "flash"),
    (384, 2, 2, 64, False, False, "einsum"),
]


@pytest.mark.parametrize("dropout", [0.0, 0.1], ids=["nodrop", "dropout"])
@pytest.mark.parametrize("on_tpu", [True, False], ids=["tpu", "cpu"])
def test_route_matches_sdpa_plain(monkeypatch, on_tpu, dropout):
    """``attention_route`` picks what ``_sdpa_plain`` picks on every case,
    raising ValueError where it raises; with dropout, neither the long
    kernel nor stock flash is taken."""
    seen = set()
    for Sq, Hq, Hkv, Dh, causal, mask, impl in ROUTE_CASES:
        try:
            want = _jax_route(monkeypatch, Sq, Hq, Hkv, Dh, causal, mask,
                              impl, on_tpu, dropout)
        except ValueError:
            want = ValueError
        try:
            got = nn_ops.attention_route(Sq, Sq, Hq, Hkv, Dh, causal,
                                         has_mask=mask, impl=impl,
                                         accelerated=on_tpu,
                                         has_dropout=dropout > 0)
        except ValueError:
            got = ValueError
        assert got == want, (Sq, Hq, Hkv, Dh, causal, mask, impl, got, want)
        seen.add(want)
    if not on_tpu:
        assert seen == {"einsum", ValueError}
    elif dropout:
        assert seen == {"short", "einsum", ValueError}
    else:
        assert seen == {"long", "short", "flash", "einsum", ValueError}


def test_sdpa_short_route_draws_its_seed(monkeypatch):
    """With the CPU standing in for the card, BERT-shaped attention with
    dropout goes through ``short_attention`` with an int32 seed drawn from
    the generator: the output is the plain kernel's at that seed, and the
    same generator state gives the same output."""
    rng = np.random.RandomState(8)
    q, k, v = (torch.from_numpy(rng.randn(2, 128, 3, 64).astype(np.float32))
               for _ in range(3))
    monkeypatch.setattr(nn_ops, "_accelerated", lambda device: True)
    gen = torch.Generator().manual_seed(5)
    state = gen.get_state()
    out = nn_ops.sdpa(q, k, v, dropout_p=0.1, generator=gen)
    gen.set_state(state)
    seed = nn_ops._seed(gen, q.device)
    want, _, _ = sa.short_attention_fwd_reference(
        *(t.transpose(1, 2) for t in (q, k, v)), seed, 1 / 8, 0.1, False)
    assert torch.equal(out, want.transpose(1, 2))
    gen.set_state(state)
    assert torch.equal(nn_ops.sdpa(q, k, v, dropout_p=0.1, generator=gen),
                       out)
    with pytest.raises(ValueError, match="Generator"):
        nn_ops.sdpa(q, k, v, dropout_p=0.1)


@pytest.mark.parametrize("name", list(DTYPES))
def test_einsum_dropout(name):
    """The einsum route (here: a mask forces it) drops the probabilities,
    already in q's dtype, with a Bernoulli mask from the generator and
    divides by 1 - p, as ``_sdpa_plain`` does with its key."""
    _, td = DTYPES[name]
    rng = np.random.RandomState(9)
    q, k, v = (torch.from_numpy(rng.randn(2, 16, 2, 8).astype(
        np.float32)).to(td) for _ in range(3))
    mask = torch.zeros(2, 1, 16, 16)
    gen = torch.Generator().manual_seed(11)
    state = gen.get_state()
    got = nn_ops.sdpa(q, k, v, mask, dropout_p=0.25, generator=gen)
    gen.set_state(state)
    keep = torch.empty(2, 2, 16, 16).bernoulli_(0.75, generator=gen).bool()
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    logits = torch.einsum("bhqd,bhkd->bhqk", qt, kt).float() * (
        1.0 / math.sqrt(8))
    probs = torch.softmax(logits + mask, dim=-1).to(td)
    probs = torch.where(keep, probs / 0.75, torch.zeros((), dtype=td))
    want = torch.einsum("bhqk,bhkd->bhqd", probs, vt).transpose(1, 2)
    assert got.dtype == td
    assert torch.equal(got, want)


def test_llama_below_1024_takes_the_short_kernel(monkeypatch):
    """Llama training at S < 1024 with H == KV (the card's route,
    ``attention_route(512, ..., causal, accelerated=True) == "short"``, as
    ``_sdpa_plain`` picks on a TPU): the loss through the short kernel's
    plain version equals the einsum path's, and each layer's forward
    calls the kernel once."""
    assert nn_ops.attention_route(512, 512, 32, 32, 128, True,
                                  accelerated=True) == "short"
    cfg = LlamaConfig.tiny(num_key_value_heads=4, hidden_size=256,
                           num_attention_heads=4, max_position_embeddings=256)
    model = LlamaForCausalLM(cfg, device="cpu", seed=2)
    ids = torch.from_numpy(np.random.RandomState(4).randint(
        0, cfg.vocab_size, (2, 128)))
    with torch.no_grad():
        einsum = model(ids, ids)
    calls = []
    real = sa.short_attention_fwd
    monkeypatch.setattr(nn_ops, "_accelerated", lambda device: True)
    monkeypatch.setattr(sa, "short_attention_fwd", lambda *a, **kw:
                        calls.append(1) or real(*a, **kw))
    with torch.no_grad():
        short = model(ids, ids)
    assert len(calls) == cfg.num_hidden_layers
    np.testing.assert_allclose(float(short), float(einsum), rtol=1e-6)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "false)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("S,D,causal,p", [(384, 64, False, 0.1),
                                          (512, 128, True, 0.0),
                                          (128, 64, True, 0.5)])
@pytest.mark.parametrize("name", list(DTYPES))
def test_kernels_match_plain_on_card(cuda_device, name, S, D, causal, p):
    _, td = DTYPES[name]
    rng = np.random.RandomState(10)
    q, k, v, g = (torch.from_numpy(rng.randn(2, 3, S, D).astype(
        np.float32)).to(cuda_device, td) for _ in range(4))
    seed = torch.tensor([-123456789], dtype=torch.int32, device=cuda_device)
    scale = 1.0 / math.sqrt(D)
    before = (sa.short_attention_fwd.launches,
              sa.short_attention_bwd.launches)
    out, lse, out32 = sa.short_attention_fwd(q, k, v, seed, scale, p,
                                             causal)
    grads = sa.short_attention_bwd(q, k, v, out32, lse, g, seed, scale, p,
                                   causal)
    torch.cuda.synchronize()
    assert (sa.short_attention_fwd.launches,
            sa.short_attention_bwd.launches) == (before[0] + 1,
                                                 before[1] + 1)
    wout, wlse, wout32 = sa.short_attention_fwd_reference(
        q, k, v, seed, scale, p, causal)
    wgrads = sa.short_attention_bwd_reference(q, k, v, out32, lse, g, seed,
                                              scale, p, causal)
    assert torch.equal(out.cpu() == 0, wout.cpu() == 0)
    _check(out32.cpu(), wout32.cpu(), 2e-5)
    _check(lse.cpu(), wlse.cpu(), 2e-5)
    if name == "fp32":
        _check(out.cpu(), wout.cpu(), 2e-5)
        for a, b in zip(grads, wgrads):
            _check(a.cpu(), b.cpu(), 1e-4)
    else:
        _check(out.cpu(), wout.cpu(), 2e-3, 2 ** -7)
        for a, b in zip(grads, wgrads):
            _check(a.cpu(), b.cpu(), 5e-3, 2 ** -6)
