"""Llama training of the PyTorch port against ``paddle_tpu``.

``LlamaConfig.tiny()`` (GQA: 4 heads over 2 kv heads; tied and untied
embeddings): the JAX model's state dict goes through numpy into the
port's ``LlamaForCausalLM`` (``load_numpy_state``), and both run on the
CPU on the same seeded token ids.  The JAX side is taken as its train
step traces it (``jax.value_and_grad`` of ``CompiledTrainStep.loss_of``
under ``jax.jit``, x64 off), with ``FLAGS_use_fused_rms_norm`` on in both packages where a
test says so.

Tolerances: fp32 loss rtol 1e-5, gradients atol 1e-4 (fp32 on both
sides, other summation orders); bf16 loss rtol 2e-2 and gradients
||got - want|| <= 2e-2 ||want|| per tensor (bf16 rounds at the same
points in both packages, but sums in other orders round differently);
train-step losses over 5 steps rtol 1e-5 (fp32) and 2e-2 (bf16 with bf16
moments).
"""
from dataclasses import fields

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.inference.server import ServingEngine as JaxEngine
from paddle_tpu.models import CompiledTrainStep as JaxTrainStep
from paddle_tpu.models import LlamaConfig as JaxConfig
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.ops.activation import _swiglu_plain
from paddle_tpu.ops.nn_ops import _rope_plain
from paddle_tpu.ops.nn_ops import (
    fused_linear_cross_entropy as jax_flce,
)
from paddle_tpu.testing.load import LoadSpec as JaxLoadSpec
from paddle_tpu.testing.load import generate_load as jax_generate_load
from paddle_tpu.testing.load import run_load as jax_run_load
from paddle_tpu_torch.core.flags import set_flags
from paddle_tpu_torch.inference.server import ServingEngine
from paddle_tpu_torch.models import (
    CompiledTrainStep, LlamaConfig, LlamaForCausalLM, load_numpy_state,
    rope_tables, serving_params,
)
from paddle_tpu_torch.ops.nn_ops import (
    cross_entropy, fused_linear_cross_entropy, fused_rope, swiglu,
)
from paddle_tpu_torch.testing.load import LoadSpec, generate_load, run_load


@pytest.fixture
def fused_flag():
    """FLAGS_use_fused_rms_norm on in both packages for one test."""
    paddle.set_flags({"FLAGS_use_fused_rms_norm": True})
    set_flags({"FLAGS_use_fused_rms_norm": True})
    yield
    paddle.set_flags({"FLAGS_use_fused_rms_norm": False})
    set_flags({"FLAGS_use_fused_rms_norm": False})


def _state(model):
    return {k: np.array(v._data, dtype=np.float32)
            for k, v in model.state_dict().items()}


def _pair(seed=11, **cfg_kw):
    """(JAX model, port model) on the same weights."""
    paddle.seed(seed)
    jmodel = JaxLlama(JaxConfig.tiny(**cfg_kw))
    cfg = LlamaConfig(**{f.name: getattr(jmodel.config, f.name)
                         for f in fields(LlamaConfig)})
    pmodel = LlamaForCausalLM(cfg, device="cpu")
    load_numpy_state(pmodel, _state(jmodel))
    return jmodel, pmodel


def _batch(cfg, bs=2, seq=16, seed=0):
    ids = np.random.RandomState(seed).randint(
        0, cfg.vocab_size, (bs, seq)).astype(np.int64)
    return ids, np.roll(ids, -1, axis=1)     # next-token labels


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.array(jnp.asarray(a, jnp.float32))


def test_load_numpy_state_round_trips_names():
    jmodel, pmodel = _pair(tie_word_embeddings=False)
    state = _state(jmodel)
    got = {k: p.detach().numpy() for k, p in pmodel.named_parameters()}
    assert sorted(got) == sorted(state)
    for k in state:
        np.testing.assert_array_equal(got[k], state[k])
    assert "lm_head.weight" in state
    assert state["llama.layers.0.self_attn.k_proj.weight"].shape == (64, 32)
    with pytest.raises(KeyError, match="missing"):
        load_numpy_state(pmodel, {k: v for k, v in state.items()
                                  if k != "llama.norm.weight"})
    with pytest.raises(KeyError, match="unknown"):
        load_numpy_state(pmodel, dict(state, extra=state["llama.norm.weight"]))


def _jax_loss_and_grads(jmodel, ids, labels, compute_dtype=None):
    step = JaxTrainStep(jmodel, donate=False, compute_dtype=compute_dtype)
    with jax.enable_x64(False):
        loss, grads = jax.jit(jax.value_and_grad(step.loss_of))(
            step.params, jnp.asarray(ids), jnp.asarray(labels))
    return float(loss), {k: _np(g) for k, g in grads.items()}


def _port_loss_and_grads(pmodel, ids, labels):
    loss = pmodel(torch.from_numpy(ids), torch.from_numpy(labels))
    loss.backward()
    return float(loss.detach()), {k: _np(p.grad)
                                  for k, p in pmodel.named_parameters()}


@pytest.mark.parametrize("tied", [False, True], ids=["untied", "tied"])
@pytest.mark.parametrize("recompute", [False, True],
                         ids=["plain", "recompute"])
def test_loss_and_grads_match_fp32(tied, recompute, fused_flag):
    jmodel, pmodel = _pair(tie_word_embeddings=tied, recompute=recompute)
    ids, labels = _batch(pmodel.config)
    labels[0, :3] = -100                      # ignored positions
    jl, jg = _jax_loss_and_grads(jmodel, ids, labels)
    pl, pg = _port_loss_and_grads(pmodel, ids, labels)
    np.testing.assert_allclose(pl, jl, rtol=1e-5)
    assert sorted(pg) == sorted(jg)
    for k in jg:
        np.testing.assert_allclose(pg[k], jg[k], rtol=0, atol=1e-4,
                                   err_msg=k)


def test_loss_and_grads_match_bf16(fused_flag):
    jmodel, pmodel = _pair(recompute=True)
    CompiledTrainStep(pmodel, compute_dtype="bfloat16", device="cpu")
    assert pmodel.llama.layers[0].mlp.up_proj.weight.dtype == torch.bfloat16
    assert pmodel.llama.norm.weight.dtype == torch.float32
    ids, labels = _batch(pmodel.config, seed=1)
    jl, jg = _jax_loss_and_grads(jmodel, ids, labels, "bfloat16")
    pl, pg = _port_loss_and_grads(pmodel, ids, labels)
    np.testing.assert_allclose(pl, jl, rtol=2e-2)
    for k in jg:
        err = np.linalg.norm(pg[k] - jg[k])
        assert err <= 2e-2 * np.linalg.norm(jg[k]), (k, err)


@pytest.mark.parametrize("neox", [True, False], ids=["neox", "interleaved"])
@pytest.mark.parametrize("positions", [False, True],
                         ids=["rows", "position_ids"])
@pytest.mark.parametrize("name", ["fp32", "bf16"])
def test_fused_rope_matches(name, neox, positions):
    """Training RoPE: the fp32 tables cast to q's dtype, then
    ``q * c + rot(q) * s``, as ``F.fused_rotary_position_embedding`` feeds
    ``_rope_plain``; bf16 results must be bit-identical (same rounding
    points), fp32 within 1e-6."""
    cfg = LlamaConfig.tiny()
    cos, sin = rope_tables(cfg, "cpu")
    rng = np.random.RandomState(12)
    q = rng.randn(2, 10, 4, 16).astype(np.float32)
    k = rng.randn(2, 10, 2, 16).astype(np.float32)
    pos = (rng.randint(0, 64, (2, 10)) if positions else None)
    jd, td = ((jnp.float32, torch.float32) if name == "fp32"
              else (jnp.bfloat16, torch.bfloat16))
    jq, jk = _rope_plain(jnp.asarray(q, jd), jnp.asarray(k, jd),
                         jnp.asarray(cos.numpy(), jd),
                         jnp.asarray(sin.numpy(), jd),
                         None if pos is None else jnp.asarray(pos), neox)
    tq, tk = fused_rope(torch.from_numpy(q).to(td),
                        torch.from_numpy(k).to(td), cos, sin,
                        None if pos is None else torch.from_numpy(pos),
                        neox)
    assert tq.dtype == td and tk.dtype == td
    atol = 1e-6 if name == "fp32" else 0.0
    np.testing.assert_allclose(_np(tq), _np(jq), rtol=0, atol=atol)
    np.testing.assert_allclose(_np(tk), _np(jk), rtol=0, atol=atol)


@pytest.mark.parametrize("split", [False, True], ids=["two", "split"])
def test_swiglu_matches(split):
    rng = np.random.RandomState(13)
    x = rng.randn(6, 32).astype(np.float32)
    y = rng.randn(6, 32).astype(np.float32)
    if split:
        want = _swiglu_plain(jnp.asarray(np.concatenate([x, y], -1)))
        got = swiglu(torch.from_numpy(np.concatenate([x, y], -1)))
    else:
        want = _swiglu_plain(jnp.asarray(x), jnp.asarray(y))
        got = swiglu(torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-6, atol=1e-6)


def test_recompute_equals_plain():
    """recompute=True (checkpointed layers, fused loss head) gives the same
    loss and gradients as recompute=False on the same weights."""
    _, plain = _pair(recompute=False)
    _, remat = _pair(recompute=True)
    ids, labels = _batch(plain.config, seed=2)
    l1, g1 = _port_loss_and_grads(plain, ids, labels)
    l2, g2 = _port_loss_and_grads(remat, ids, labels)
    np.testing.assert_allclose(l2, l1, rtol=1e-6)
    for k in g1:
        np.testing.assert_allclose(g2[k], g1[k], rtol=0, atol=1e-6,
                                   err_msg=k)


@pytest.mark.parametrize("tied", [False, True], ids=["untied", "tied"])
def test_fused_linear_cross_entropy_matches(tied):
    rng = np.random.RandomState(4)
    n, h, V = 24, 16, 50
    hidden = rng.randn(n, h).astype(np.float32)
    weight = (0.3 * rng.randn(*((V, h) if tied else (h, V)))).astype(
        np.float32)
    labels = rng.randint(0, V, n).astype(np.int64)
    labels[::5] = -100
    with jax.enable_x64(False):
        jl, (jdh, jdw) = jax.value_and_grad(
            lambda a, b: jax_flce(a, b, jnp.asarray(labels), tied, -100),
            argnums=(0, 1))(jnp.asarray(hidden), jnp.asarray(weight))
    th = torch.from_numpy(hidden).requires_grad_(True)
    tw = torch.from_numpy(weight).requires_grad_(True)
    loss = fused_linear_cross_entropy(th, tw, torch.from_numpy(labels), tied)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-6)
    np.testing.assert_allclose(_np(th.grad), _np(jdh), rtol=0, atol=1e-6)
    np.testing.assert_allclose(_np(tw.grad), _np(jdw), rtol=0, atol=1e-6)
    # the plain loss of the same logits, as recompute=False takes it
    logits = th.detach() @ (tw.detach().t() if tied else tw.detach())
    np.testing.assert_allclose(
        float(cross_entropy(logits, torch.from_numpy(labels))), float(jl),
        rtol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_step_matches_jax(dtype, fused_flag):
    """5 AdamW steps of CompiledTrainStep at the bench path's settings
    (recompute, fused RMSNorm, fp32 master; bf16: bf16 compute and
    moments): the losses match step for step, the parameters after."""
    jmodel, pmodel = _pair(recompute=True)
    kw = {} if dtype == "float32" else dict(compute_dtype="bfloat16",
                                            moments_dtype="bfloat16")
    jstep = JaxTrainStep(jmodel, lr=1e-3, donate=False, **kw)
    pstep = CompiledTrainStep(pmodel, lr=1e-3, device="cpu", **kw)
    ids, labels = _batch(pmodel.config, bs=4, seq=16, seed=3)
    jl = [float(jstep.step(ids, labels)) for _ in range(5)]
    pl = [float(pstep.step(ids, labels)) for _ in range(5)]
    rtol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(pl, jl, rtol=rtol)
    assert pl[-1] < pl[0]
    pstate = pstep.state_dict()
    assert pstate["t"] == 5
    for k, want in jstep._master.items():
        got = _np(pstate["master"][k])
        err = np.linalg.norm(got - _np(want))
        assert err <= rtol * np.linalg.norm(_np(want)), (k, err)
        assert pstate["params"][k].dtype == (
            torch.float32 if dtype == "float32" or "norm" in k
            else torch.bfloat16)
        assert pstate["m"][k].dtype == getattr(torch, kw.get(
            "moments_dtype", "float32"))


@pytest.mark.parametrize("option", [dict(mesh=object())])
def test_out_of_scope_options_raise(option):
    _, pmodel = _pair()
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        CompiledTrainStep(pmodel, device="cpu", **option)


def test_out_of_scope_methods_and_policies_raise():
    _, pmodel = _pair()
    with pytest.raises(ValueError, match="unknown recompute_policy"):
        LlamaForCausalLM(LlamaConfig.tiny(recompute=True,
                                          recompute_policy="nope"),
                         device="cpu")
    with pytest.raises(ValueError, match="master_dtype"):
        CompiledTrainStep(pmodel, device="cpu", master_dtype="float16")


def test_scan_layers_has_no_effect():
    _, plain = _pair()
    _, scan = _pair(scan_layers=True)
    ids, _ = _batch(plain.config)
    with torch.no_grad():
        assert torch.equal(plain(torch.from_numpy(ids)),
                           scan(torch.from_numpy(ids)))


def test_num_params_and_flops_match_jax():
    jmodel, pmodel = _pair()
    assert pmodel.num_params() == jmodel.num_params()
    assert pmodel.flops_per_token(16) == jmodel.flops_per_token(16)


def test_train_then_serve_streams_match(fused_flag):
    """Train the port model 2 steps, serve greedily from
    ``serving_params`` through the port's engine, and from the same
    weights through ``paddle_tpu``'s engine: identical streams."""
    _, pmodel = _pair(seed=21, recompute=True)
    step = CompiledTrainStep(pmodel, lr=1e-2, device="cpu")
    ids, labels = _batch(pmodel.config, bs=4, seq=16, seed=6)
    losses = [float(step.step(ids, labels)) for _ in range(2)]
    assert losses[1] < losses[0]

    paddle.seed(0)
    jmodel = JaxLlama(JaxConfig.tiny())
    jmodel.set_state_dict({k: paddle.to_tensor(p.detach().numpy())
                           for k, p in pmodel.named_parameters()})
    spec = dict(n_requests=4, mean_interarrival=1.0, prompt_len=(4, 16),
                max_new=(4, 10), vocab=256, seed=8)
    engine_kw = dict(max_seqs=2, page_size=4, max_len=64)
    jout = jax_run_load(JaxEngine(jmodel, dtype=jnp.float32, **engine_kw),
                        jax_generate_load(JaxLoadSpec(**spec)))
    pout = run_load(ServingEngine(pmodel.config,
                                  serving_params(pmodel, device="cpu"),
                                  dtype=torch.float32, device="cpu",
                                  **engine_kw),
                    generate_load(LoadSpec(**spec)))
    streams = {rid: h.tokens for rid, h in pout["handles"].items()}
    assert streams == {rid: h.tokens for rid, h in jout["handles"].items()}
    assert all(len(t) > 0 for t in streams.values())
