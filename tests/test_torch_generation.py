"""Greedy KV-cache generation of the PyTorch port against ``paddle_tpu``.

``LlamaForCausalLM.generate`` and ``models.generation.LlamaDecoder`` of
both packages on the same numpy weights, on the CPU: tiny MHA, tiny GQA
with tied embeddings, and a narrow cut of Llama-2-13B's shape (its
head dim 128, MHA, the 13824 / 5120 MLP ratio).

Tolerance: fp32 token streams must be IDENTICAL.  bf16 logits of one
prefill forward within 0.02 of the largest |logit|, about 2.5 bf16 ulps
at the top of its binade (an ulp is 2^-7 relative there): every weight
and activation is rounded to bf16 at the reference's rounding points,
and two layers of matmuls summed in other orders (XLA's and torch's CPU
GEMMs) can round a value the other way.  Measured: 0.005-0.009.

Also: the length guard, fresh weights after in-place ``torch.optim.SGD``
steps (the counterpart of ``tests/test_decode_predictor.py::
test_generate_rebuilds_after_weight_change``), no static cache held
after ``generate`` returns, and ``LlamaConfig.llama2_13b`` on the meta
device.
"""
import gc
import weakref
from dataclasses import fields

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.models import LlamaConfig as JaxConfig
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models.generation import LlamaDecoder as JaxDecoder
from paddle_tpu_torch.models import (
    LlamaConfig, LlamaForCausalLM, load_numpy_state, numpy_state,
    serving_params,
)
from paddle_tpu_torch.models.generation import LlamaDecoder

BF16_REL = 0.02

CONFIGS = {
    "tiny-mha": dict(vocab_size=256, hidden_size=64, intermediate_size=128,
                     num_hidden_layers=2, num_attention_heads=4,
                     num_key_value_heads=4, max_position_embeddings=128),
    "tiny-gqa-tied": dict(vocab_size=256, hidden_size=64,
                          intermediate_size=128, num_hidden_layers=2,
                          num_attention_heads=4, num_key_value_heads=2,
                          max_position_embeddings=128,
                          tie_word_embeddings=True),
    # Llama-2-13B's head dim (128) and MLP ratio, narrow: 2 heads, 2 layers
    "13b-narrow": dict(vocab_size=512, hidden_size=256,
                       intermediate_size=688, num_hidden_layers=2,
                       num_attention_heads=2, num_key_value_heads=2,
                       max_position_embeddings=256),
}


def _pair(fields_kw, seed=11):
    """(paddle_tpu model, port model on the CPU) with the same weights."""
    paddle.seed(seed)
    jmodel = JaxLlama(JaxConfig(**fields_kw))
    state = {k: np.asarray(v._data) for k, v in jmodel.state_dict().items()}
    model = LlamaForCausalLM(LlamaConfig(**fields_kw), device="cpu")
    load_numpy_state(model, state)
    return jmodel, model


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def pair(request):
    return _pair(CONFIGS[request.param])


def test_13b_config_matches_reference():
    """``llama2_13b``'s fields equal the reference's dataclass, and the
    model built on the meta device counts 13,015,864,320 parameters."""
    want = JaxConfig.llama2_13b()
    got = LlamaConfig.llama2_13b()
    for f in fields(LlamaConfig):
        if hasattr(want, f.name):
            assert getattr(got, f.name) == getattr(want, f.name), f.name
    assert got.head_dim == 128
    model = LlamaForCausalLM(got, device="meta")
    assert model.num_params() == 13_015_864_320
    kv_bytes = (2 * got.num_hidden_layers * got.num_key_value_heads
                * got.head_dim * 2)
    assert kv_bytes == 819_200           # bf16 K/V a token


@pytest.mark.parametrize("new", [1, 7])
def test_generate_matches_reference(pair, new):
    """``generate`` on a numpy batch: token for token, the same kind and
    dtype out, and ``LlamaDecoder`` directly gives the same."""
    jmodel, model = pair
    V = model.config.vocab_size
    ids = np.random.RandomState(3).randint(0, V, (2, 9)).astype(np.int32)
    want = np.asarray(jmodel.generate(ids, max_new_tokens=new))
    got = model.generate(ids, max_new_tokens=new)
    assert isinstance(got, np.ndarray) and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        LlamaDecoder(model).generate(ids, max_new_tokens=new),
        np.asarray(JaxDecoder(jmodel).generate(ids, max_new_tokens=new)))


def test_generate_tensor_in_tensor_out(pair):
    jmodel, model = pair
    ids = np.random.RandomState(5).randint(
        0, model.config.vocab_size, (1, 5)).astype(np.int64)
    got = model.generate(torch.from_numpy(ids), max_new_tokens=4)
    want = jmodel.generate(paddle.to_tensor(ids), max_new_tokens=4)
    assert isinstance(got, torch.Tensor) and got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), np.asarray(want._data))


def _jax_bf16_logits(jmodel, ids, max_len):
    dec = JaxDecoder(jmodel)
    bf = jnp.bfloat16
    params = ({k: v.astype(bf) for k, v in dec.layers.items()},
              dec.embed.astype(bf), dec.norm_w.astype(bf),
              dec.head_w.astype(bf), dec.cos, dec.sin)
    cfg = jmodel.config
    shape = (cfg.num_hidden_layers, ids.shape[0], max_len,
             cfg.num_key_value_heads, cfg.head_dim)
    logits, _, _ = dec._forward(params, jnp.asarray(ids),
                                jnp.zeros(shape, bf), jnp.zeros(shape, bf),
                                0)
    return np.asarray(logits.astype(jnp.float32))


def test_bf16_logits_within_tolerance(pair):
    """A bf16 model's prefill logits against the reference's decoder on
    the same weights rounded to bf16: within 0.02 of the largest
    |logit| (see the module's docstring)."""
    jmodel, model = pair
    ids = np.random.RandomState(7).randint(
        0, model.config.vocab_size, (2, 12)).astype(np.int32)
    want = _jax_bf16_logits(jmodel, ids, 16)
    model16 = LlamaForCausalLM(model.config, device="cpu")
    load_numpy_state(model16, numpy_state(
        serving_params(model, "cpu"), model.config))
    model16.to(torch.bfloat16)
    dec = LlamaDecoder(model16)
    with torch.no_grad():
        kc, vc = dec._new_cache(2, 16, torch.bfloat16, torch.device("cpu"))
        got = dec._forward(torch.from_numpy(ids).long(), kc, vc, 0)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= BF16_REL * scale, (
        np.abs(got - want).max(), scale)


def test_length_guard():
    jmodel, model = _pair(CONFIGS["tiny-gqa-tied"])
    ids = np.zeros((1, 120), np.int32)
    for m in (jmodel, model):
        with pytest.raises(ValueError, match="max_position_embeddings"):
            m.generate(ids, max_new_tokens=9)
        with pytest.raises(ValueError, match="max_new_tokens"):
            m.generate(ids[:, :4], max_new_tokens=0)
    # exactly at the limit is allowed
    np.testing.assert_array_equal(
        model.generate(ids, max_new_tokens=8),
        np.asarray(jmodel.generate(ids, max_new_tokens=8)))


def test_generate_uses_weights_after_inplace_sgd():
    """In-place ``torch.optim.SGD`` steps change the parameters under the
    same objects; the next ``generate`` decodes with the new weights:
    the reference's model loaded with the updated state gives the same
    tokens, and they differ from the tokens before the steps."""
    jmodel, model = _pair(CONFIGS["tiny-mha"], seed=4)
    ids = np.random.RandomState(4).randint(0, 256, (1, 6)).astype(np.int64)
    first = model.generate(ids, max_new_tokens=4)
    np.testing.assert_array_equal(
        first, np.asarray(jmodel.generate(ids, max_new_tokens=4)))
    before = {n: p for n, p in model.named_parameters()}
    opt = torch.optim.SGD(model.parameters(), lr=0.5)
    t = torch.from_numpy(ids)
    for _ in range(3):
        loss = model(t, labels=t)
        loss.backward()
        opt.step()
        opt.zero_grad()
    assert all(p is before[n] for n, p in model.named_parameters())
    after = model.generate(ids, max_new_tokens=4)
    assert not np.array_equal(after, first)
    paddle.seed(0)
    fresh = JaxLlama(JaxConfig(**CONFIGS["tiny-mha"]))
    fresh.set_state_dict({k: paddle.to_tensor(v) for k, v in numpy_state(
        serving_params(model, "cpu"), model.config).items()})
    np.testing.assert_array_equal(
        after, np.asarray(fresh.generate(ids, max_new_tokens=4)))


def test_no_static_cache_held_after_generate(monkeypatch):
    """The static caches a call allocates are gone when it returns: the
    decoder keeps no per-shape state (the reference's LRU of compiled
    programs would pin one cache per key)."""
    _, model = _pair(CONFIGS["tiny-gqa-tied"])
    made = []
    alloc = LlamaDecoder._new_cache

    def tracked(self, *a):
        kc, vc = alloc(self, *a)
        made.extend([weakref.ref(kc), weakref.ref(vc)])
        return kc, vc

    monkeypatch.setattr(LlamaDecoder, "_new_cache", tracked)
    dec = LlamaDecoder(model)
    for S in (5, 9):
        dec.generate(np.ones((2, S), np.int32), max_new_tokens=3)
    model.generate(np.ones((1, 4), np.int32), max_new_tokens=2)
    gc.collect()
    assert len(made) == 6 and all(r() is None for r in made)
    assert not any(isinstance(v, torch.Tensor) and v.dim() == 5
                   for v in vars(dec).values())
