"""The decoder side of the port's ``nn/transformer.py`` against
``paddle_tpu``'s: ``MultiHeadAttention.Cache`` / ``StaticCache`` /
``gen_cache`` and the ``cache=`` forward, the encoder layer's cache,
``TransformerDecoderLayer`` (post-norm and pre-norm),
``TransformerDecoder``, ``Transformer`` and
``generate_square_subsequent_mask``.

On the CPU in fp32, the same numpy weights (the reference's state dict,
loaded into the port's modules) and inputs, dropout 0, eval mode.
Tolerance: rtol 1e-5 (atol 1e-6 for values near 0): the reference's
scores are float64 under its x64 mode (``1 / np.sqrt(D)`` is a numpy
float64), the port's fp32, through at most 2 + 2 layers of LayerNorm,
attention and a 64-wide feed-forward.

Incremental decoding (8 steps of one token through the port's decoder
with ``gen_cache``) equals the full causal forward within the same
tolerance.  ``paddle_tpu``'s decoder layer accepts ``cache`` and ignores
it, so the incremental path is held to the full forward (and the
attention-level cache to the reference's).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
from paddle_tpu_torch import nn
from paddle_tpu_torch.models import load_numpy_state

RTOL, ATOL = 1e-5, 1e-6
D_MODEL, NHEAD, FF = 32, 4, 64


def _np(t):
    return np.array(t._data) if hasattr(t, "_data") else t.detach().numpy()


def _load(port, ref):
    load_numpy_state(port, {k: _np(v) for k, v in ref.state_dict().items()})
    port.eval()
    ref.eval()
    return port


def _x(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _close(got, want):
    np.testing.assert_allclose(_np(got), _np(want), rtol=RTOL, atol=ATOL)


def _mha_pair(seed=0):
    paddle.seed(seed)
    ref = jnn.MultiHeadAttention(D_MODEL, NHEAD)
    return _load(nn.MultiHeadAttention(D_MODEL, NHEAD, device="cpu"),
                 ref), ref


def test_gen_cache_forms():
    port, ref = _mha_pair()
    x = _x(1, 2, 5, D_MODEL)
    pc, rc = port.gen_cache(torch.from_numpy(x)), \
        ref.gen_cache(paddle.to_tensor(x))
    assert isinstance(pc, nn.MultiHeadAttention.Cache)
    assert pc.k.shape == (2, 0, NHEAD, D_MODEL // NHEAD) == \
        tuple(rc.k.shape)
    assert pc.k.dtype == pc.v.dtype == torch.float32
    for how in (dict(type=nn.MultiHeadAttention.StaticCache), {}):
        if how:
            ps = port.gen_cache(torch.from_numpy(x), **how)
            rs = ref.gen_cache(paddle.to_tensor(x),
                               type=jnn.MultiHeadAttention.StaticCache)
        else:                          # a value given: static as well
            v = _x(2, 2, 5, D_MODEL)
            ps = port.gen_cache(torch.from_numpy(x), torch.from_numpy(v))
            rs = ref.gen_cache(paddle.to_tensor(x), paddle.to_tensor(v))
        assert isinstance(ps, nn.MultiHeadAttention.StaticCache)
        _close(ps.k, rs.k)
        _close(ps.v, rs.v)


def test_incremental_cache_matches_reference():
    """Three self-attention steps of 1, 2 and 1 tokens through a growing
    ``Cache``: outputs and cached K/V equal the reference's."""
    port, ref = _mha_pair(1)
    x = _x(3, 2, 4, D_MODEL)
    pc = port.gen_cache(torch.from_numpy(x))
    rc = ref.gen_cache(paddle.to_tensor(x))
    for a, b in ((0, 1), (1, 3), (3, 4)):
        step = x[:, a:b]
        with torch.no_grad():
            po, pc = port(torch.from_numpy(step), cache=pc)
        ro, rc = ref(paddle.to_tensor(step), cache=rc)
        _close(po, ro)
        _close(pc.k, rc.k)
        _close(pc.v, rc.v)
    assert pc.k.shape[1] == 4


def test_cross_attention_static_cache_matches_reference():
    port, ref = _mha_pair(2)
    q, mem = _x(4, 2, 3, D_MODEL), _x(5, 2, 6, D_MODEL)
    ps = port.gen_cache(torch.from_numpy(mem),
                        type=nn.MultiHeadAttention.StaticCache)
    rs = ref.gen_cache(paddle.to_tensor(mem),
                       type=jnn.MultiHeadAttention.StaticCache)
    with torch.no_grad():
        po, ps2 = port(torch.from_numpy(q), torch.from_numpy(mem),
                       torch.from_numpy(mem), cache=ps)
    ro, _ = ref(paddle.to_tensor(q), paddle.to_tensor(mem),
                paddle.to_tensor(mem), cache=rs)
    _close(po, ro)
    assert ps2 is ps                     # a static cache is returned as is


def test_bf16_step_promotes_the_fp32_cache():
    """``gen_cache`` starts fp32 (as the reference's); ``torch.cat``
    appends a bf16 step's K/V as fp32, as ``jnp.concatenate`` does, and
    the attention computes over the promoted cache."""
    port, _ = _mha_pair(3)
    port.to(torch.bfloat16)
    x = torch.from_numpy(_x(6, 2, 1, D_MODEL)).bfloat16()
    cache = port.gen_cache(x)
    assert cache.k.dtype == torch.float32
    with torch.no_grad():
        out, cache = port(x, cache=cache)
        out2, cache = port(x, cache=cache)
    want = jnp.concatenate([jnp.zeros((2, 0, 4, 8), jnp.float32),
                            jnp.zeros((2, 1, 4, 8), jnp.bfloat16)],
                           axis=1).dtype
    assert str(cache.k.dtype).replace("torch.", "") == str(want)
    assert cache.k.shape[1] == 2 and cache.v.dtype == torch.float32
    assert torch.isfinite(out2.float()).all()


def test_encoder_layer_cache_matches_reference():
    paddle.seed(4)
    ref = jnn.TransformerEncoderLayer(D_MODEL, NHEAD, FF, dropout=0.0)
    port = _load(nn.TransformerEncoderLayer(D_MODEL, NHEAD, FF, dropout=0.0,
                                            device="cpu"), ref)
    x = _x(7, 2, 3, D_MODEL)
    pc, rc = port.gen_cache(torch.from_numpy(x)), \
        ref.gen_cache(paddle.to_tensor(x))
    for t in range(3):
        with torch.no_grad():
            po, pc = port(torch.from_numpy(x[:, t:t + 1]), cache=pc)
        ro, rc = ref(paddle.to_tensor(x[:, t:t + 1]), cache=rc)
        _close(po, ro)


def test_square_subsequent_mask_equals_reference():
    for n in (1, 5, 8):
        got = nn.Transformer.generate_square_subsequent_mask(n, "cpu")
        want = jnn.Transformer.generate_square_subsequent_mask(n)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), _np(want))


@pytest.mark.parametrize("normalize_before", [False, True],
                         ids=["post-norm", "pre-norm"])
def test_decoder_layer_matches_reference(normalize_before):
    paddle.seed(5)
    ref = jnn.TransformerDecoderLayer(D_MODEL, NHEAD, FF, dropout=0.0,
                                      normalize_before=normalize_before)
    port = _load(nn.TransformerDecoderLayer(
        D_MODEL, NHEAD, FF, dropout=0.0, normalize_before=normalize_before,
        device="cpu"), ref)
    tgt, mem = _x(8, 2, 6, D_MODEL), _x(9, 2, 5, D_MODEL)
    mask = jnn.Transformer.generate_square_subsequent_mask(6)
    for m in (None, mask):
        with torch.no_grad():
            got = port(torch.from_numpy(tgt), torch.from_numpy(mem),
                       tgt_mask=None if m is None
                       else torch.from_numpy(_np(m)))
        want = ref(paddle.to_tensor(tgt), paddle.to_tensor(mem), tgt_mask=m)
        _close(got, want)


def _decoder_pair(normalize_before, seed=6, layers=2):
    paddle.seed(seed)
    rlayer = jnn.TransformerDecoderLayer(D_MODEL, NHEAD, FF, dropout=0.0,
                                         normalize_before=normalize_before)
    ref = jnn.TransformerDecoder(rlayer, layers,
                                 jnn.LayerNorm(D_MODEL)
                                 if normalize_before else None)
    player = nn.TransformerDecoderLayer(D_MODEL, NHEAD, FF, dropout=0.0,
                                        normalize_before=normalize_before,
                                        device="cpu")
    port = nn.TransformerDecoder(player, layers,
                                 nn.LayerNorm(D_MODEL, device="cpu")
                                 if normalize_before else None)
    return _load(port, ref), ref


@pytest.mark.parametrize("normalize_before", [False, True],
                         ids=["post-norm", "pre-norm"])
def test_decoder_matches_reference(normalize_before):
    port, ref = _decoder_pair(normalize_before)
    tgt, mem = _x(10, 2, 6, D_MODEL), _x(11, 2, 5, D_MODEL)
    mask = jnn.Transformer.generate_square_subsequent_mask(6)
    with torch.no_grad():
        got = port(torch.from_numpy(tgt), torch.from_numpy(mem),
                   tgt_mask=torch.from_numpy(_np(mask)))
    _close(got, ref(paddle.to_tensor(tgt), paddle.to_tensor(mem),
                    tgt_mask=mask))


@pytest.mark.parametrize("normalize_before", [False, True],
                         ids=["post-norm", "pre-norm"])
def test_incremental_decoding_equals_full_forward(normalize_before):
    """8 one-token steps through the decoder with ``gen_cache`` equal the
    full forward under ``generate_square_subsequent_mask`` row by row
    (and so the reference's full forward)."""
    port, ref = _decoder_pair(normalize_before, seed=7)
    S = 8
    tgt, mem = _x(12, 2, S, D_MODEL), _x(13, 2, 5, D_MODEL)
    mask = nn.Transformer.generate_square_subsequent_mask(S, "cpu")
    with torch.no_grad():
        full = port(torch.from_numpy(tgt), torch.from_numpy(mem),
                    tgt_mask=mask)
        cache = port.gen_cache(torch.from_numpy(mem))
        steps = []
        for t in range(S):
            out, cache = port(torch.from_numpy(tgt[:, t:t + 1]),
                              torch.from_numpy(mem), cache=cache)
            steps.append(out)
    _close(torch.cat(steps, dim=1), full)
    _close(full, ref(paddle.to_tensor(tgt), paddle.to_tensor(mem),
                     tgt_mask=paddle.to_tensor(mask.numpy())))
    assert all(c[0].k.shape[1] == S for c in cache)


@pytest.mark.parametrize("normalize_before", [False, True],
                         ids=["post-norm", "pre-norm"])
def test_transformer_matches_reference(normalize_before):
    paddle.seed(8)
    kw = dict(d_model=D_MODEL, nhead=NHEAD, num_encoder_layers=2,
              num_decoder_layers=2, dim_feedforward=FF, dropout=0.0,
              normalize_before=normalize_before)
    ref = jnn.Transformer(**kw)
    port = _load(nn.Transformer(**kw, device="cpu"), ref)
    src, tgt = _x(14, 2, 7, D_MODEL), _x(15, 2, 5, D_MODEL)
    m = jnn.Transformer.generate_square_subsequent_mask(5)
    with torch.no_grad():
        got = port(torch.from_numpy(src), torch.from_numpy(tgt),
                   tgt_mask=torch.from_numpy(_np(m)))
    _close(got, ref(paddle.to_tensor(src), paddle.to_tensor(tgt),
                    tgt_mask=m))


def test_transformer_defaults_match_reference():
    """The reference's defaults: d_model 512, 8 heads, 6 + 6 layers,
    feed-forward 2048, post-norm (no final norms); the same parameter
    names and shapes."""
    paddle.seed(9)
    ref = jnn.Transformer()
    port = nn.Transformer(device="cpu")
    assert (port.d_model, port.nhead) == (512, 8)
    assert len(port.encoder.layers) == len(port.decoder.layers) == 6
    assert port.encoder.norm is None and port.decoder.norm is None
    want = {k: tuple(v.shape) for k, v in ref.state_dict().items()}
    got = {k: tuple(v.shape) for k, v in port.state_dict().items()}
    assert got == want
