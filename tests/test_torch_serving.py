"""Greedy serving of the PyTorch port against ``paddle_tpu``.

``LlamaConfig.tiny()`` (and a tied-embedding variant) in fp32: the JAX
model's ``state_dict()`` goes through numpy into
``paddle_tpu_torch.models.from_numpy_state``, and both executors run on
the CPU (the JAX package's decode attention takes its dense path there,
the port's the kernel's plain version).

Tolerance: logits atol 1e-4 — fp32 on both sides, summed in other
orders (the JAX side partly in fp64 under its x64 mode) through two
layers and a 256-way head.  Token streams must be IDENTICAL.

The int8 executors (``quant="int8"``: per-channel int8 projections and
an int8 KV pool with per-page scales) are held to the same tolerance
and the same stream identity: the quantized weights are bit-identical
(``tests/test_torch_quant.py``), and the rest is the same fp32
arithmetic in another order.  The port's own int8-vs-none drift of the
prefill logits stays under a relative RMS of 0.05, the bound of
``tests/test_quant.py::test_int8_logit_drift_bound``.
"""
import subprocess
import sys
from dataclasses import fields

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.inference.server import PagedExecutor as JaxExecutor
from paddle_tpu.inference.server import ServingEngine as JaxEngine
from paddle_tpu.models import LlamaConfig as JaxConfig
from paddle_tpu.models import LlamaForCausalLM
from paddle_tpu.testing.load import LoadSpec as JaxLoadSpec
from paddle_tpu.testing.load import generate_load as jax_generate_load
from paddle_tpu.testing.load import run_load as jax_run_load
from paddle_tpu_torch.inference.server import PagedExecutor, ServingEngine
from paddle_tpu_torch.models import LlamaConfig, from_numpy_state
from paddle_tpu_torch.testing.load import LoadSpec, generate_load, run_load

ATOL = 1e-4
ENGINE_KW = dict(max_seqs=2, page_size=4, max_len=64)


def _build(tied):
    paddle.seed(11)
    jcfg = JaxConfig.tiny(tie_word_embeddings=tied)
    model = LlamaForCausalLM(jcfg)
    cfg = LlamaConfig(**{f.name: getattr(jcfg, f.name)
                         for f in fields(LlamaConfig)})
    state = {k: np.asarray(v._data) for k, v in model.state_dict().items()}
    return model, cfg, from_numpy_state(state, cfg, "cpu", torch.float32)


@pytest.fixture(scope="module", params=[False, True],
                ids=["untied", "tied"])
def pair(request):
    return _build(request.param)


@pytest.fixture(scope="module")
def untied():
    return _build(False)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=0, atol=ATOL)


def test_executor_logits_match(pair):
    """prefill, prefill_chunk and decode logits (and the KV they write)
    agree with the JAX programs on the same weights and tokens."""
    _check_executor_logits(*pair, quant="none")


def test_int8_executor_logits_match(pair):
    """The same on the int8 executors: quantized projections
    bit-identical, then prefill, prefill_chunk and decode logits within
    atol 1e-4 and the same greedy tokens."""
    _check_executor_logits(*pair, quant="int8")


def _check_executor_logits(model, cfg, params, quant):
    jex = JaxExecutor(model, dtype=jnp.float32, quant=quant, **ENGINE_KW)
    pex = PagedExecutor(cfg, params, dtype=torch.float32, device="cpu",
                        quant=quant, **ENGINE_KW)
    for name, w in pex.layers.items():
        if isinstance(w, dict):
            for part in ("qweight", "scale"):
                np.testing.assert_array_equal(
                    w[part].numpy(), np.asarray(jex.layers[name][part]))
    assert isinstance(pex.layers["mlp.up_proj.weight"], dict) == \
        (quant == "int8")
    ids = np.random.RandomState(0).randint(1, 256, (13,)).astype(np.int32)

    # whole-prompt prefill
    jl, jk, jv = jex._jit_prefill(jex.layers, jex.tops,
                                  jnp.asarray(ids[None]))
    pl, pk, pv = pex._prefill_fwd(torch.from_numpy(ids[None]).long())
    _close(pl, jl)
    _close(pk, jk)
    _close(pv, jv)

    # chunked prefill of the same prompt: 5 tokens, then 8 over the past
    sj, sp = jex.alloc_slot(), pex.alloc_slot()
    jex.prefill_chunk(sj, ids[:5], 0, final=False)
    pex.prefill_chunk(sp, ids[:5], 0, final=False)
    past_j = jex.cache.gather_dense(sj, 5)
    past_p = pex.cache.gather_dense(sp, 5)
    _close(past_p[0], past_j[0])
    _close(past_p[1], past_j[1])
    jl, _, _ = jex._jit_chunk(jex.layers, jex.tops, jnp.asarray(ids[None, 5:]),
                              jnp.int32(5), *past_j, jnp.int32(5))
    with torch.no_grad():
        pl, _, _ = pex._chunk_fwd(torch.from_numpy(ids[None, 5:]).long(), 5,
                                  *past_p, 5)
    _close(pl, jl)
    assert jex.prefill_chunk(sj, ids[5:], 5, final=True) == \
        pex.prefill_chunk(sp, ids[5:], 5, final=True)

    # decode steps: logits from the pure forwards, then the public step
    for _ in range(3):
        jex.cache.reserve([sj], 1)
        pex.cache.reserve([sp], 1)
        n = int(jex.cache.lengths[sj])
        jl, _, _ = jex._decode_fwd(
            jex.layers, jex.tops, jnp.asarray([jex.last_token[sj]]),
            jnp.asarray([n]), *jex._pools(),
            jnp.asarray(jex.cache.lengths[[sj]]),
            jnp.asarray(np.maximum(jex.cache.page_table[[sj]], 0)))
        tables, lengths = pex.cache.tables([sp])
        with torch.no_grad():
            pl = pex._decode_fwd(torch.tensor([pex.last_token[sp]]),
                                 lengths.long(), lengths, tables)
        _close(pl, jl)
        assert jex.decode([sj]) == pex.decode([sp])
    assert pex.prefill_events == [(sp, 5), (sp, 8)]


def _streams(handles):
    return {rid: (h.state.value, h.tokens, h.num_preemptions)
            for rid, h in handles.items()}


def _serve_both(model, cfg, params, spec_kw, **engine_kw):
    jwork = jax_generate_load(JaxLoadSpec(**spec_kw))
    pwork = generate_load(LoadSpec(**spec_kw))
    for a, b in zip(jwork, pwork):       # same draws, same requests
        assert a["rid"] == b["rid"] and a["arrival_tick"] == b["arrival_tick"]
        np.testing.assert_array_equal(a["prompt_ids"], b["prompt_ids"])
        assert a["max_new_tokens"] == b["max_new_tokens"]
    jout = jax_run_load(JaxEngine(model, dtype=jnp.float32, **engine_kw),
                        jwork)
    pout = run_load(ServingEngine(cfg, params, dtype=torch.float32,
                                  device="cpu", **engine_kw), pwork)
    return jout, pout


SPEC = dict(n_requests=6, mean_interarrival=1.5, prompt_len=(4, 24),
            max_new=(4, 12), vocab=256, seed=3)


def test_greedy_streams_match_with_chunked_prefill(untied):
    _check_chunked_prefill_streams(*untied, quant="none")


def test_int8_greedy_streams_match_with_chunked_prefill(pair):
    _check_chunked_prefill_streams(*pair, quant="int8")


def _check_chunked_prefill_streams(model, cfg, params, quant):
    jout, pout = _serve_both(model, cfg, params, SPEC, prefill_chunk=5,
                             quant=quant, **ENGINE_KW)
    assert _streams(pout["handles"]) == _streams(jout["handles"])
    assert all(h.state.value == "finished"
               for h in pout["handles"].values())
    assert pout["stats"]["steps"] == jout["stats"]["steps"]


def test_greedy_streams_match_under_preemption(untied):
    """A pool of 8 four-token pages for two slots: decode runs the pool
    dry, victims are preempted and recomputed, and both packages make
    the same choices and emit the same tokens."""
    _check_preemption_streams(*untied, quant="none")


def test_int8_greedy_streams_match_under_preemption(untied):
    """The same on the int8 engines: a preempted request's pages are
    freed with their scales and re-quantized on recompute."""
    _check_preemption_streams(*untied, quant="int8")


def _check_preemption_streams(model, cfg, params, quant):
    spec = dict(SPEC, prompt_len=(10, 20), max_new=(8, 14), seed=5)
    jout, pout = _serve_both(model, cfg, params, spec, num_pages=8,
                             prefill_chunk=8, quant=quant, **ENGINE_KW)
    assert pout["stats"]["preemptions"] > 0
    assert pout["stats"]["preemptions"] == jout["stats"]["preemptions"]
    assert _streams(pout["handles"]) == _streams(jout["handles"])


def test_int8_logit_drift_bound(pair):
    """The port's int8 prefill logits stay within a relative RMS of 0.05
    of its own unquantized forward, finite, on three seeded prompts."""
    _, cfg, params = pair
    exs = {q: PagedExecutor(cfg, params, dtype=torch.float32, device="cpu",
                            quant=q, **ENGINE_KW) for q in ("none", "int8")}
    rng = np.random.RandomState(5)
    worst = 0.0
    for _ in range(3):
        ids = torch.as_tensor(rng.randint(1, 256, (1, 16)))
        with torch.no_grad():
            ln, lq = (exs[q]._prefill_fwd(ids)[0].double()
                      for q in ("none", "int8"))
        assert torch.isfinite(lq).all()
        rel = float(torch.sqrt(torch.mean((ln - lq) ** 2))
                    / (torch.sqrt(torch.mean(ln ** 2)) + 1e-12))
        worst = max(worst, rel)
    assert 0 < worst < 0.05, worst


def test_port_imports_neither_jax_nor_paddle_tpu():
    code = (
        "import sys, paddle_tpu_torch\n"
        "import paddle_tpu_torch.inference.server\n"
        "import paddle_tpu_torch.models\n"
        "import paddle_tpu_torch.testing.load\n"
        "import paddle_tpu_torch.ops.kernels.paged_decode\n"
        "import paddle_tpu_torch.ops.kernels.rms_norm\n"
        "import paddle_tpu_torch.ops.kernels.long_attention\n"
        "import paddle_tpu_torch.ops.kernels.quant_matmul\n"
        "import paddle_tpu_torch.ops.quant\n"
        "import paddle_tpu_torch.nn, paddle_tpu_torch.models.training\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'paddle_tpu', 'triton'))\n"
        "print(','.join(bad))\n")
    out = subprocess.run([sys.executable, "-c", code], check=True,
                         capture_output=True, text=True, timeout=120)
    assert out.stdout.strip() == ""


def test_engine_defaults_to_cuda_and_refuses_without_it(untied):
    _, cfg, params = untied
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ServingEngine(cfg, params, **ENGINE_KW)


def _entry_points(cfg, params):
    from paddle_tpu_torch.inference.paged import PagedKVCache
    from paddle_tpu_torch.models import (
        CompiledTrainStep, LlamaForCausalLM, init_llama_params, params_to,
        rope_tables,
    )

    state = {"llama.embed_tokens.weight": params["embed"].numpy(),
             "llama.norm.weight": params["norm"].numpy(),
             "lm_head.weight": params["lm_head"].numpy()}
    for name, w in params["layers"].items():
        for i in range(cfg.num_hidden_layers):
            state[f"llama.layers.{i}.{name}"] = w[i].numpy()
    return {
        "PagedKVCache": lambda: PagedKVCache(
            n_layers=1, n_kv_heads=1, head_dim=4, num_pages=4).k_pages,
        "init_llama_params": lambda: init_llama_params(cfg)["embed"],
        "rope_tables": lambda: rope_tables(cfg)[0],
        "from_numpy_state": lambda: from_numpy_state(state, cfg)["embed"],
        "PagedExecutor": lambda: PagedExecutor(
            cfg, params_to(params), **ENGINE_KW).cache.k_pages,
        "LlamaForCausalLM": lambda: LlamaForCausalLM(cfg).lm_head.weight,
        "CompiledTrainStep": lambda: CompiledTrainStep(
            LlamaForCausalLM(cfg, device="cpu"))._master["lm_head.weight"],
    }


@pytest.mark.parametrize("entry", ["PagedKVCache", "init_llama_params",
                                   "rope_tables", "from_numpy_state",
                                   "PagedExecutor", "LlamaForCausalLM",
                                   "CompiledTrainStep"])
def test_entry_points_default_to_cuda(untied, entry):
    """With no device named, each entry point puts its tensors on CUDA,
    or raises where there is none; it never drops to the CPU."""
    _, cfg, params = untied
    make = _entry_points(cfg, params)[entry]
    if torch.cuda.is_available():
        assert make().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()


@pytest.mark.parametrize("layer", ["Linear", "Embedding", "RMSNorm"])
def test_nn_layers_default_to_cuda(layer):
    """The building blocks resolve ``device=None`` as every entry point
    does: CUDA, raising where there is none; ``device="cpu"`` builds."""
    from paddle_tpu_torch import nn as pnn

    make = {"Linear": lambda **kw: pnn.Linear(4, 3, **kw),
            "Embedding": lambda **kw: pnn.Embedding(5, 3, **kw),
            "RMSNorm": lambda **kw: pnn.RMSNorm(3, 1e-6, **kw)}[layer]
    assert make(device="cpu").weight.device.type == "cpu"
    if torch.cuda.is_available():
        assert make().weight.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()
