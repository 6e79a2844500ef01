"""Causal attention of the PyTorch port against ``paddle_tpu``.

* The port's plain forward and backward against the Pallas
  ``long_attention`` kernel itself, run on the CPU under
  ``pltpu.force_tpu_interpret_mode()`` (B=1, H=2, S=256, D=128,
  block_q 128), with and without fused RoPE, in fp32 and bf16.
* ``sdpa``'s routing against ``_sdpa_plain``'s own choice, read by
  running ``_sdpa_plain`` with its kernels replaced by spies and
  ``jax.devices()`` reporting a TPU (only inside ``nn_ops``).
* The einsum path against ``_sdpa_plain`` with GQA, causal and not.
* The stock-flash region (GQA, non-causal, S > 2048, ``impl="flash"``)
  through ``long_attention``'s plain version against ``_sdpa_plain``'s
  einsum route, forward and backward.

Tolerances: out/lse fp32 atol 2e-5; bf16 out
2^-7 * |want| + 2e-3 (one bf16 rounding of an fp32 result), lse atol
1e-3; dq/dk/dv fp32 atol 1e-4, bf16 2^-6 * |want| + 5e-3 (the port forms
delta = rowsum(g * out) from the bf16 output, the TPU kernel
rowsum(dp * p) in fp32).
"""
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

import paddle_tpu.ops.nn_ops as jnn_ops
from paddle_tpu.ops.pallas_kernels.long_attention import (
    _fwd_impl, long_attention as jax_long_attention,
)
from paddle_tpu_torch.ops import nn_ops
from paddle_tpu_torch.ops.kernels import long_attention as la

B, H, S, D = 1, 2, 256, 128
DTYPES = {"fp32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.array(jnp.asarray(a, jnp.float32))


def _check(got, want, atol, rtol=0.0):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    excess = np.abs(got - want) - (atol + rtol * np.abs(want))
    assert excess.max() <= 0, (np.abs(got - want).max(), excess.max())


@pytest.mark.parametrize("rope_base", [None, 10000.0], ids=["norope", "rope"])
@pytest.mark.parametrize("name", list(DTYPES))
def test_matches_pallas_kernel_in_interpret_mode(name, rope_base):
    jd, td = DTYPES[name]
    rng = np.random.RandomState(0 if rope_base is None else 1)
    q, k, v, g = (rng.randn(B, H, S, D).astype(np.float32)
                  for _ in range(4))
    J = [jnp.asarray(a, jd) for a in (q, k, v, g)]
    with pltpu.force_tpu_interpret_mode():
        jout, jlse = _fwd_impl(J[0], J[1], J[2], None, 128, True, rope_base)
        _, vjp = jax.vjp(lambda a, b, c: jax_long_attention(
            a, b, c, None, 128, True, rope_base), *J[:3])
        jdq, jdk, jdv = vjp(J[3])

    T = [torch.from_numpy(a).to(td) for a in (q, k, v)]
    out, lse = la.attention_fwd_reference(*T, 1.0 / math.sqrt(D), True,
                                          rope_base)
    assert out.dtype == td and lse.dtype == torch.float32
    assert lse.shape == (B, H, 1, S)
    for t in T:
        t.requires_grad_(True)
    before = (la.attention_fwd.launches, la.attention_bwd.launches)
    aout = la.long_attention(*T, rope_base=rope_base)
    aout.backward(torch.from_numpy(g).to(td))
    assert (la.attention_fwd.launches, la.attention_bwd.launches) == before
    assert torch.equal(aout.detach(), out)
    if name == "fp32":
        _check(out, jout, 2e-5)
        _check(lse, jlse, 2e-5)
        for got, want in zip((t.grad for t in T), (jdq, jdk, jdv)):
            assert got.dtype == td
            _check(got, want, 1e-4)
    else:
        _check(out, jout, 2e-3, 2 ** -7)
        _check(lse, jlse, 1e-3)
        for got, want in zip((t.grad for t in T), (jdq, jdk, jdv)):
            assert got.dtype == td
            _check(got, want, 5e-3, 2 ** -6)


class _Routed(Exception):
    pass


class _Tpu:
    platform = "tpu"


class _JaxOnTpu:
    """``jax`` as ``nn_ops`` sees it, but reporting a TPU device."""

    def __getattr__(self, name):
        return getattr(jax, name)

    @staticmethod
    def devices(*a, **k):
        return [_Tpu()]


def _jax_route(monkeypatch, Sq, Hq, Hkv, Dh, causal, mask, impl, on_tpu):
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
        q = jnp.zeros((1, Sq, Hq, Dh), jnp.float32)
        kv = jnp.zeros((1, Sq, Hkv, Dh), jnp.float32)
        msk = jnp.zeros((1, 1, Sq, Sq), jnp.float32) if mask else None
        try:
            with jax.enable_x64(False):
                jnn_ops._sdpa_plain(q, kv, kv, msk, None, 0.0, causal,
                                    None, impl)
        except _Routed as r:
            return str(r)
        return "einsum"


ROUTE_CASES = [
    # (Sq, H, Hkv, D, causal, mask, impl)
    (2048, 2, 2, 128, True, False, "auto"),
    (1024, 2, 2, 128, True, False, "auto"),
    (1280, 2, 2, 128, True, False, "auto"),
    (1024, 2, 2, 256, True, False, "auto"),
    (768, 2, 2, 128, True, False, "auto"),
    (512, 2, 2, 128, True, False, "auto"),
    (1024, 2, 2, 128, False, False, "auto"),
    (2048, 2, 2, 128, False, False, "auto"),
    (4096, 1, 1, 128, True, False, "auto"),
    (2048, 4, 2, 128, True, False, "auto"),
    (1024, 4, 2, 128, True, False, "auto"),
    (2048, 2, 2, 64, True, False, "auto"),
    (2048, 2, 2, 128, True, True, "auto"),
    (1152, 2, 2, 128, True, False, "auto"),
    (96, 2, 2, 32, True, False, "auto"),
    (2048, 2, 2, 128, True, False, "einsum"),
    (2048, 2, 2, 128, True, False, "flash"),
    (512, 2, 2, 128, True, False, "short"),
    (96, 2, 2, 32, True, False, "flash"),
    (2048, 2, 2, 128, True, False, "short"),
]


@pytest.mark.parametrize("on_tpu", [True, False], ids=["tpu", "cpu"])
def test_route_matches_sdpa_plain(monkeypatch, on_tpu):
    """``attention_route`` picks what ``_sdpa_plain`` picks on every case,
    raising ValueError where it raises (accelerated = on_tpu)."""
    seen = set()
    for Sq, Hq, Hkv, Dh, causal, mask, impl in ROUTE_CASES:
        try:
            want = _jax_route(monkeypatch, Sq, Hq, Hkv, Dh, causal, mask,
                              impl, on_tpu)
        except ValueError:
            want = ValueError
        try:
            got = nn_ops.attention_route(Sq, Sq, Hq, Hkv, Dh, causal,
                                         has_mask=mask, impl=impl,
                                         accelerated=on_tpu)
        except ValueError:
            got = ValueError
        assert got == want, (Sq, Hq, Hkv, Dh, causal, mask, impl, got, want)
        seen.add(want)
    assert seen == ({"long", "short", "flash", "einsum", ValueError}
                    if on_tpu else {"einsum", ValueError})


def test_sdpa_on_card_routes(monkeypatch):
    """With the CPU standing in for the card (``_accelerated`` patched):
    the long region goes through ``long_attention`` and the short region
    (causal S = 512) through ``short_attention`` (here their plain
    versions), each agreeing with the einsum path; the flash region
    (causal S = 1024 with GQA, 2 q heads over 1 kv head) goes through
    ``long_attention`` too and agrees with the grouped einsum path."""
    from paddle_tpu_torch.ops.kernels import short_attention as sa

    rng = np.random.RandomState(5)
    q, k, v = (torch.from_numpy(rng.randn(1, 1024, 2, 128).astype(
        np.float32)) for _ in range(3))
    einsum = nn_ops.sdpa(q, k, v, causal=True)
    einsum_short = nn_ops.sdpa(q[:, :512], k[:, :512], v[:, :512],
                               causal=True)
    einsum_gqa = nn_ops.sdpa(q, k[:, :, :1], v[:, :, :1], causal=True)
    monkeypatch.setattr(nn_ops, "_accelerated", lambda device: True)
    calls = []
    for mod, name in ((la, "long_attention"), (sa, "short_attention")):
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _n=name, _f=real, **kw:
                            calls.append(_n) or _f(*a, **kw))
    long = nn_ops.sdpa(q, k, v, causal=True)
    assert calls == ["long_attention"]
    np.testing.assert_allclose(_np(long), _np(einsum), rtol=0, atol=2e-5)
    short = nn_ops.sdpa(q[:, :512], k[:, :512], v[:, :512], causal=True)
    assert calls == ["long_attention", "short_attention"]
    np.testing.assert_allclose(_np(short), _np(einsum_short), rtol=0,
                               atol=2e-5)
    gqa = nn_ops.sdpa(q, k[:, :, :1], v[:, :, :1], causal=True)
    assert calls == ["long_attention", "short_attention", "long_attention"]
    np.testing.assert_allclose(_np(gqa), _np(einsum_gqa), rtol=0, atol=2e-5)


FLASH_CASES = {
    # id: (B, S, H, Hkv, causal, impl)
    "gqa-4over2": (1, 1024, 4, 2, True, "auto"),
    "noncausal": (1, 512, 2, 2, False, "flash"),
    "s2560": (1, 2560, 1, 1, True, "auto"),
    "impl-flash-gqa": (2, 512, 4, 1, True, "flash"),
}


@pytest.mark.parametrize("case", list(FLASH_CASES))
def test_flash_route_matches_sdpa_plain(monkeypatch, case):
    """The stock-flash region on the port, with the CPU standing in for
    the card (``_accelerated`` patched): ``attention_route`` says
    "flash", ``sdpa`` goes through ``long_attention`` (its plain version
    here, K/V repeated to the q heads) and matches ``_sdpa_plain``'s
    einsum route on the CPU (x64 off), out and dq/dk/dv, in fp32 at atol
    2e-5 (out) and 1e-4 (gradients, sums over up to 2560 terms in
    another order).  JAX's own flash kernel runs only on a TPU, so the
    einsum route is the reference (ROADMAP.md, Queue 3)."""
    B, S, H, Hkv, causal, impl = FLASH_CASES[case]
    D = 128
    assert nn_ops.attention_route(S, S, H, Hkv, D, causal,
                                  impl=impl) == "flash"
    rng = np.random.RandomState(11)
    q = rng.randn(B, S, H, D).astype(np.float32)
    k, v = (rng.randn(B, S, Hkv, D).astype(np.float32) for _ in range(2))
    g = rng.randn(B, S, H, D).astype(np.float32)
    with jax.enable_x64(False):
        want, vjp = jax.vjp(lambda a, b, c: jnn_ops._sdpa_plain(
            a, b, c, None, None, 0.0, causal), *(jnp.asarray(a)
                                                 for a in (q, k, v)))
        wgrads = vjp(jnp.asarray(g))
    monkeypatch.setattr(nn_ops, "_accelerated", lambda device: True)
    calls = []
    real = la.long_attention
    monkeypatch.setattr(la, "long_attention", lambda *a, **kw:
                        calls.append(1) or real(*a, **kw))
    T = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    got = nn_ops.sdpa(*T, causal=causal, impl=impl)
    got.backward(torch.from_numpy(g))
    assert calls == [1]
    _check(got, want, 2e-5)
    for a, w in zip((t.grad for t in T), wgrads):
        assert a.shape == w.shape
        _check(a, w, 1e-4)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("name", list(DTYPES))
def test_einsum_path_matches_sdpa_plain(name, causal):
    """GQA (4 q heads over 2 kv heads), S=40, D=16: the grouped einsum
    path against ``_sdpa_plain`` as the train step traces it (x64 off),
    with and without an additive mask."""
    jd, td = DTYPES[name]
    rng = np.random.RandomState(7)
    q = rng.randn(2, 40, 4, 16).astype(np.float32)
    k, v = (rng.randn(2, 40, 2, 16).astype(np.float32) for _ in range(2))
    mask = np.where(rng.rand(2, 1, 40, 40) < 0.1, -1e4, 0).astype(
        np.float32)
    for m in (None, mask):
        with jax.enable_x64(False):
            want = jnn_ops._sdpa_plain(
                *(jnp.asarray(a, jd) for a in (q, k, v)),
                None if m is None else jnp.asarray(m), None, 0.0, causal)
        got = nn_ops.sdpa(*(torch.from_numpy(a).to(td) for a in (q, k, v)),
                          None if m is None else torch.from_numpy(m),
                          causal=causal)
        assert got.dtype == td
        if name == "fp32":
            _check(got, want, 2e-5)
        else:
            _check(got, want, 2e-3, 2 ** -7)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "false)")
    return torch.device("cuda")


CARD_SHAPES = {
    # id: (B, H, Hkv, S, causal)
    "causal": (2, 4, 4, 1024, True),
    "gqa": (2, 8, 2, 1024, True),
    "noncausal": (1, 4, 4, 1536, False),
}


@pytest.mark.cuda
@pytest.mark.parametrize("shape", list(CARD_SHAPES))
@pytest.mark.parametrize("rope_base", [None, 10000.0], ids=["norope", "rope"])
@pytest.mark.parametrize("name", list(DTYPES))
def test_kernels_match_plain_on_card(cuda_device, name, rope_base, shape):
    """The kernels (bf16 without RoPE: the tensor-core ones) against the
    plain versions on the card, with GQA (dk/dv summed over each group in
    fp32, then rounded once) and without the causal mask; the bf16
    tolerances are chip_smoke.py phase 3b's."""
    _, td = DTYPES[name]
    B, H, Hkv, S, causal = CARD_SHAPES[shape]
    rng = np.random.RandomState(9)

    def make(h):
        return torch.from_numpy(rng.randn(B, h, S, 128).astype(
            np.float32)).to(cuda_device, td)

    q, k, v, g = make(H), make(Hkv), make(Hkv), make(H)
    scale = 1.0 / math.sqrt(128)
    out, lse = la.attention_fwd(q, k, v, scale, causal, rope_base)
    grads = la.attention_bwd(q, k, v, out, lse, g, scale, causal, rope_base)
    torch.cuda.synchronize()
    wout, wlse = la.attention_fwd_plain(q, k, v, scale, causal, rope_base)
    wq, wk, wv = la.attention_bwd_plain(q, k, v, out, lse, g, scale,
                                        causal, rope_base)
    if name == "fp32":
        _check(out.cpu(), wout.cpu(), 2e-5)
        _check(lse.cpu(), wlse.cpu(), 2e-5)
        for a, b in zip(grads, (wq, wk, wv)):
            _check(a.cpu(), b.cpu(), 1e-4)
    else:
        _check(out.cpu(), wout.cpu(), 2e-3, 2 ** -7)
        _check(lse.cpu(), wlse.cpu(), 1e-3)
        for a, b in zip(grads, (wq, wk, wv)):
            _check(a.cpu(), b.cpu(), 5e-3, 2 ** -6)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(DTYPES))
def test_kernels_refuse_d256_on_card(cuda_device, name):
    """D = 256 is not instantiated (a [64, 256] fp32 sum takes 128 of a
    consumer thread's 240 registers): both kernels raise, naming
    ROADMAP.md."""
    _, td = DTYPES[name]
    q = torch.zeros(1, 2, 512, 256, device=cuda_device, dtype=td)
    lse = torch.zeros(1, 2, 1, 512, device=cuda_device)
    with pytest.raises(ValueError, match="ROADMAP.md Queue 3"):
        la.attention_fwd(q, q, q, 0.0625, True)
    with pytest.raises(ValueError, match="ROADMAP.md Queue 3"):
        la.attention_bwd(q, q, q, q, lse, q, 0.0625, True)
