"""Int8 quantization of the PyTorch port (``paddle_tpu_torch.ops.quant``
and the int8 ``PagedKVCache``) against ``paddle_tpu``.

The same numpy inputs, made from a seed, go through both packages.
Every rounding point is the JAX package's (f32 divisions, round half to
even, the ``where(scale > 0, scale, 1)`` guard, clip to +-127), so the
quantized weights, the int8 pages and their f32 scales must be
BIT-IDENTICAL: any divergence would show up later as greedy streams that
differ.  Dequantized values are products of bit-identical operands, so
they are bit-identical too.  Decode attention through ``attend`` agrees
within atol 2e-5 (fp32 accumulation in another order, the JAX dense path
partly in fp64 under its x64 mode).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.inference.paged import PagedKVCache as JaxCache
from paddle_tpu.ops import quant as jq
from paddle_tpu_torch.inference.paged import PagedKVCache as TorchCache
from paddle_tpu_torch.inference.server import ServingEngine
from paddle_tpu_torch.models import LlamaConfig, init_llama_params
from paddle_tpu_torch.ops import quant as tq


def _np(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


# -- weights -------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(32, 48), (3, 32, 48)])
def test_quantize_per_channel_bit_exact(dtype, shape):
    rng = np.random.RandomState(0)
    w = (rng.randn(*shape) * 0.3).astype(np.float32)
    w[..., 5] = 0.0                               # a zero channel: scale 0
    jw = jnp.asarray(w, jnp.bfloat16 if dtype == "bfloat16" else
                     jnp.float32)
    tw = torch.from_numpy(w).to(getattr(torch, dtype))
    np.testing.assert_array_equal(np.asarray(jw, np.float32), _np(tw))
    jqw, js = jq.quantize_per_channel(jw)
    tqw, ts = tq.quantize_per_channel(tw)
    assert tqw.dtype == torch.int8 and ts.dtype == torch.float32
    assert tuple(ts.shape) == shape[:-2] + (1, shape[-1])
    np.testing.assert_array_equal(tqw.numpy(), np.asarray(jqw))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        tq.dequantize(tqw, ts).numpy(), np.asarray(jq.dequantize(jqw, js)))


def test_quantize_linear_and_state_dict_format():
    rng = np.random.RandomState(1)
    state = {"llama.layers.0.self_attn.q_proj.weight":
             torch.from_numpy(rng.randn(16, 24).astype(np.float32)),
             "llama.layers.0.mlp.down_proj.weight":
             torch.from_numpy(rng.randn(24, 16).astype(np.float32)),
             "llama.embed_tokens.weight":
             torch.from_numpy(rng.randn(32, 16).astype(np.float32)),
             "llama.norm.weight": torch.ones(16)}
    out = tq.quantize_state_dict(state)
    want = jq.quantize_state_dict({k: np.asarray(v) for k, v in
                                   state.items()})
    assert set(out) == set(want)
    for name, w in out.items():
        assert tq.is_quantized(w) == jq.is_quantized(want[name]), name
        if tq.is_quantized(w):
            assert set(w) == {"qweight", "scale"}
            np.testing.assert_array_equal(w["qweight"].numpy(),
                                          np.asarray(want[name]["qweight"]))
            np.testing.assert_array_equal(w["scale"].numpy(),
                                          np.asarray(want[name]["scale"]))
        else:
            assert w is state[name]
    assert not tq.is_quantized(state["llama.norm.weight"])


# -- KV pages --------------------------------------------------------------------


def _kv_case(rng, lead, P=6, ps=4, D=8):
    pages = np.zeros(lead + (P, ps, D), np.int8)
    scales = np.zeros(lead + (P,), np.float32)
    return pages, scales


def _check_kv_write(jp, js, tp, ts, pids, offs, vals):
    jp, js = jq.kv_write(jp, js, jnp.asarray(pids, jnp.int32),
                         jnp.asarray(offs, jnp.int32), jnp.asarray(vals))
    tq.kv_write(tp, ts, torch.from_numpy(np.asarray(pids)),
                torch.from_numpy(np.asarray(offs)), torch.from_numpy(vals))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    return jp, js


def test_kv_write_sequence_bit_exact():
    """A multi-page prefill span (duplicate page ids), then single-token
    appends that grow a page's scale (requantizing its residents), a
    two-sequence append, and a span over resident cells of a page whose
    scale grows: int8 pages and f32 scales bit-identical after every
    write, and the pool updated in place."""
    rng = np.random.RandomState(2)
    lead = (2, 2)                                   # [L, KV]
    pages, scales = _kv_case(rng, lead)
    jp, js = jnp.asarray(pages), jnp.asarray(scales)
    tp, ts = torch.from_numpy(pages.copy()), torch.from_numpy(scales.copy())
    tp_ptr, ts_ptr = tp.data_ptr(), ts.data_ptr()
    D = pages.shape[-1]
    # positions 2..8 of a sequence whose table row is [3, 1, 5]
    pids, offs = [3, 3, 1, 1, 1, 1, 5], [2, 3, 0, 1, 2, 3, 0]
    vals = rng.randn(*lead, 7, D).astype(np.float32)
    jp, js = _check_kv_write(jp, js, tp, ts, pids, offs, vals)
    for pos, mag in ((9, 5.0), (10, 0.1), (11, 20.0)):
        vals = (rng.randn(*lead, 1, D) * mag).astype(np.float32)
        jp, js = _check_kv_write(jp, js, tp, ts, [5], [pos % 4], vals)
    # one token each for two sequences (rows [5, ..] and [0, ..])
    vals = (rng.randn(*lead, 2, D) * 8).astype(np.float32)
    jp, js = _check_kv_write(jp, js, tp, ts, [2, 0], [0, 0], vals)
    # rewrite two resident cells of page 1 with larger values
    vals = (rng.randn(*lead, 2, D) * 30).astype(np.float32)
    jp, js = _check_kv_write(jp, js, tp, ts, [1, 1], [1, 2], vals)
    assert (tp.data_ptr(), ts.data_ptr()) == (tp_ptr, ts_ptr)
    assert int(np.count_nonzero(tp.numpy())) > 0


def test_kv_write_one_layer_decode_form():
    """The decode step's form: one layer's pages [KV, P, ps, D] and vals
    [KV, B, D], bf16 values as a bf16 serving stream writes them."""
    rng = np.random.RandomState(3)
    pages, scales = _kv_case(rng, (2,))
    jp, js = jnp.asarray(pages), jnp.asarray(scales)
    tp, ts = torch.from_numpy(pages.copy()), torch.from_numpy(scales.copy())
    for step in range(3):
        v = (rng.randn(2, 3, 8) * (1 + step)).astype(np.float32)
        vb = torch.from_numpy(v).bfloat16()
        jv = jnp.asarray(v, jnp.bfloat16)
        pids = jnp.asarray([4, 2, 4], jnp.int32)
        offs = jnp.asarray([step, step, step + 1], jnp.int32)
        jp, js = jq.kv_write(jp, js, pids, offs, jv)
        tq.kv_write(tp, ts, torch.tensor([4, 2, 4]),
                    torch.tensor([step, step, step + 1]), vb)
        np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_kv_dequant_bit_exact():
    rng = np.random.RandomState(4)
    pages = rng.randint(-127, 128, (2, 3, 4, 8)).astype(np.int8)
    scales = np.abs(rng.randn(2, 3)).astype(np.float32)
    for jd, td in ((None, None), (jnp.bfloat16, torch.bfloat16)):
        want = jq.kv_dequant(jnp.asarray(pages), jnp.asarray(scales), jd)
        got = tq.kv_dequant(torch.from_numpy(pages),
                            torch.from_numpy(scales), td)
        np.testing.assert_array_equal(_np(got), np.asarray(want, np.float32))


L, KV, D, PS = 2, 2, 8, 4
CACHE_KW = dict(n_layers=L, n_kv_heads=KV, head_dim=D, page_size=PS,
                max_seqs=3, max_pages_per_seq=4)


def test_int8_cache_matches_jax_cache():
    """write_at (spans crossing pages), append, gather_dense and attend on
    both int8 caches: pages and scales bit-identical, the dequantized
    gather bit-identical, attention within atol 2e-5."""
    rng = np.random.RandomState(5)
    jc = JaxCache(num_pages=12, dtype=jnp.float32, quant="int8", **CACHE_KW)
    tc = TorchCache(num_pages=12, dtype=torch.float32, device="cpu",
                    quant="int8", **CACHE_KW)
    assert tc.k_pages.dtype == torch.int8 and tc.compute_dtype == \
        torch.float32

    def kv(T, mag=1.0):
        return [(rng.randn(L, KV, T, D) * mag).astype(np.float32)
                for _ in range(2)]

    s0, s1 = jc.allocate(), jc.allocate()
    assert (tc.allocate(), tc.allocate()) == (s0, s1)
    for seq, T, start, mag in ((s0, 6, 0, 1.0), (s0, 3, 6, 4.0),
                               (s1, 5, 0, 0.5)):
        k, v = kv(T, mag)
        jc.write_at(seq, jnp.asarray(k), jnp.asarray(v), start)
        tc.write_at(seq, torch.from_numpy(k), torch.from_numpy(v), start)
    k, v = kv(2, 10.0)
    jc.append([s0, s1], jnp.asarray(k), jnp.asarray(v))
    tc.append([s0, s1], torch.from_numpy(k), torch.from_numpy(v))
    np.testing.assert_array_equal(tc.page_table, jc.page_table)
    np.testing.assert_array_equal(tc.lengths, jc.lengths)
    for name in ("k_pages", "v_pages", "k_scales", "v_scales"):
        np.testing.assert_array_equal(getattr(tc, name).numpy(),
                                      np.asarray(getattr(jc, name)), name)
    for s in (s0, s1):
        for a, b in zip(tc.gather_dense(s), jc.gather_dense(s)):
            assert a.dtype == torch.float32
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    q = rng.randn(2, 4, D).astype(np.float32)
    for layer in range(L):
        want = np.asarray(jc.attend(layer, jnp.asarray(q), [s0, s1]))
        got = tc.attend(layer, torch.from_numpy(q), [s0, s1]).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)


@pytest.mark.parametrize("quant,dtype", [("none", "float32"),
                                         ("none", "bfloat16"),
                                         ("int8", "float32"),
                                         ("int8", "bfloat16")])
def test_pool_bytes_per_page_equals_jax(quant, dtype):
    kw = dict(CACHE_KW, head_dim=128, page_size=16)
    jc = JaxCache(num_pages=10, dtype=getattr(jnp, dtype), quant=quant, **kw)
    tc = TorchCache(num_pages=10, dtype=getattr(torch, dtype),
                    device="cpu", quant=quant, **kw)
    assert tq.kv_pool_bytes_per_page(tc) == jq.kv_pool_bytes_per_page(jc)
    if quant == "none":
        assert tc.k_scales is None and tc.k_pages.dtype == tc.compute_dtype


# -- the mode knob ---------------------------------------------------------------


def test_env_gate(monkeypatch):
    """As ``tests/test_quant.py::test_env_gate``: ``PT_QUANT`` picks the
    mode when ``quant`` is not given, the argument wins over it, and a
    bad value fails the engine build."""
    cfg = LlamaConfig.tiny()
    params = init_llama_params(cfg, device="cpu")
    kw = dict(max_seqs=2, page_size=4, max_len=32, device="cpu")

    def mode(**extra):
        return ServingEngine(cfg, params, **kw, **extra).executor.quant

    monkeypatch.setenv("PT_QUANT", "int8")
    assert mode() == "int8"
    monkeypatch.setenv("PT_QUANT", "none")
    assert mode() == "none"
    monkeypatch.delenv("PT_QUANT")
    assert mode() == "none"
    monkeypatch.setenv("PT_QUANT", "int8")
    assert mode(quant="none") == "none"
    monkeypatch.setenv("PT_QUANT", "fp4")
    with pytest.raises(ValueError, match="PT_QUANT"):
        mode()
    with pytest.raises(ValueError, match="PT_QUANT"):
        tq.quant_mode("int4")
    assert tq.MODES == jq.MODES and tq.QMAX == jq.QMAX
    assert tq.DEFAULT_PATTERNS == jq.DEFAULT_PATTERNS


def test_int8_executor_holds_no_dense_projection():
    cfg = LlamaConfig.tiny()
    params = init_llama_params(cfg, device="cpu")
    ex = ServingEngine(cfg, params, quant="int8", max_seqs=2, page_size=4,
                       max_len=32, device="cpu").executor
    for name in ("self_attn.q_proj.weight", "mlp.down_proj.weight"):
        w = ex.layers[name]
        assert tq.is_quantized(w) and w["qweight"].dtype == torch.int8
        assert tuple(w["scale"].shape) == (cfg.num_hidden_layers, 1,
                                           params["layers"][name].shape[-1])
    assert not tq.is_quantized(ex.layers["input_layernorm.weight"])
    assert ex.cache.k_scales.shape == (cfg.num_hidden_layers,
                                       cfg.num_key_value_heads,
                                       ex.cache.num_pages)
    # the caller's dense weights are left alone
    assert params["layers"]["mlp.down_proj.weight"].dtype == torch.float32


def test_kv_write_with_distinct_pages_is_bit_identical():
    """Requantizing each touched page once (``pages_touched``) gives the
    bits of the per-token form, which is JAX's."""
    rng = np.random.RandomState(6)
    pages, scales = _kv_case(rng, (2, 2))
    pages[...] = rng.randint(-127, 128, pages.shape)
    scales[...] = np.abs(rng.randn(*scales.shape)) / 127
    pids, offs = [3, 3, 3, 1, 1, 5, 5], [1, 2, 3, 0, 1, 0, 1]
    vals = (rng.randn(2, 2, 7, 8) * 3).astype(np.float32)
    jp, js = jq.kv_write(jnp.asarray(pages), jnp.asarray(scales),
                         jnp.asarray(pids, jnp.int32),
                         jnp.asarray(offs, jnp.int32), jnp.asarray(vals))
    tp, ts = torch.from_numpy(pages.copy()), torch.from_numpy(scales.copy())
    tq.kv_write(tp, ts, torch.tensor(pids), torch.tensor(offs),
                torch.from_numpy(vals), torch.tensor(sorted(set(pids))))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
