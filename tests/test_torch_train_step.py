"""The train step's options in the PyTorch port (``CompiledTrainStep``:
the gated per-tensor AdamW, ``multi_step``, ``bfloat16_sr``,
``guarded_step``, ``update_fn``, ``loss_fn``, ``moments``, ``remat``,
``set_state_dict``, ``state_device`` and schedulers; Llama's recompute
policies) against ``paddle_tpu`` on the CPU, on the same numpy weights
and inputs, at tiny sizes.

Tolerances: the port against itself (the gated update against the
plain ungated one, ``multi_step(k)`` against k ``step`` calls, a
clean ``guarded_step`` against ``step``, each policy against "full")
bit for bit; against ``paddle_tpu`` fp32 losses and parameters rtol
1e-5 (other summation orders), gradients atol 1e-4 as in
``test_torch_llama_training.py``.  ``bfloat16_sr`` cannot share JAX's
random bits, so it is held to the rounding formula on shared bits (bit
for bit), to its bias (the mean of 20000 roundings of 1 + 1e-3 within
2e-4) and to convergence (``test_llama_training.py``'s 30-step check).
"""
from dataclasses import fields

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
import paddle_tpu.optimizer.lr as jlr
from paddle_tpu.models import CompiledTrainStep as JaxTrainStep
from paddle_tpu.models import LlamaConfig as JaxConfig
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models.training import _stochastic_round_bf16
from paddle_tpu.nn import functional as JF
from paddle_tpu_torch.models import (
    BertConfig, BertForQuestionAnswering, CompiledTrainStep, LlamaConfig,
    LlamaForCausalLM, load_numpy_state,
)
from paddle_tpu_torch.models import llama as port_llama
from paddle_tpu_torch.models import training as training_mod
from paddle_tpu_torch.models.training import sr_bits, stochastic_round_bf16
from paddle_tpu_torch.nn import Linear
from paddle_tpu_torch.nn.common import embedding_grad
from paddle_tpu_torch.optimizer import lr as plr

POLICIES = ("full", "save_mlp", "save_attn", "dots")


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


def _port(seed=11, **cfg_kw):
    return _pair(seed, **cfg_kw)[1]


def _batch(vocab=256, bs=2, seq=16, seed=0, k=None):
    shape = (bs, seq) if k is None else (k, bs, seq)
    ids = np.random.RandomState(seed).randint(0, vocab, shape)
    return ids.astype(np.int64), np.roll(ids, -1, axis=-1).astype(np.int64)


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.array(jnp.asarray(a, jnp.float32))


def _assert_state_equal(a, b):
    for name in ("params", "_master", "_m", "_v"):
        ta, tb = getattr(a, name), getattr(b, name)
        assert sorted(ta) == sorted(tb)
        for k in ta:
            assert torch.equal(ta[k], tb[k]), (name, k)
    assert a._t == b._t


def _assert_close_to_jax(pstep, jstep, rtol=1e-5):
    for k, want in jstep._master.items():
        got = _np(pstep._master[k])
        err = np.linalg.norm(got - _np(want))
        assert err <= rtol * np.linalg.norm(_np(want)), (k, err)


class Poisoned(torch.nn.Module):
    """A model whose loss adds the buffer ``poison`` (0 when clean)."""

    def __init__(self, model):
        super().__init__()
        self.model = model
        self.register_buffer("poison", torch.zeros(()))

    def forward(self, *batch):
        return self.model(*batch) + self.poison


# -- the update ------------------------------------------------------------------

def _plain_update(step, grads, scale, t, lr, ok):
    """AdamW tensor by tensor, op by op, ungated and in place (fp32
    master): the plain version the step's gated update is held to."""
    beta1, beta2, eps, _ = step._hyper
    c = step._coefficients(t, lr)
    for k, p in step.params.items():
        g = grads[k]
        if scale is not None:
            g = g * scale.to(g.dtype)
        g = g.float()
        mk = beta1 * step._m[k].float() + (1 - beta1) * g
        vk = beta2 * step._v[k].float() + (1 - beta2) * g * g
        mhat = mk / c["c1"]
        vhat = vk / c["c2"]
        master = step._master[k]
        if not step._no_decay(k):
            master.mul_(c["decay"])
        master.sub_(lr * mhat / (torch.sqrt(vhat) + eps))
        p.copy_(master)
        step._m[k].copy_(mk)
        step._v[k].copy_(vk)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_update_equals_plain(dtype):
    """3 steps through the gated per-tensor update equal the plain
    ungated update bit for bit (parameters, master, moments): the gate
    held True changes no bit."""
    kw = ({} if dtype == "float32" else
          dict(compute_dtype="bfloat16", moments_dtype="bfloat16"))
    step = CompiledTrainStep(_port(recompute=True), device="cpu", **kw)
    plain = CompiledTrainStep(_port(recompute=True), device="cpu", **kw)
    plain._update = lambda *a: _plain_update(plain, *a)
    ids, labels = _batch()
    for _ in range(3):
        assert torch.equal(step.step(ids, labels), plain.step(ids, labels))
    _assert_state_equal(step, plain)


def test_update_matches_jax():
    jmodel, pmodel = _pair(recompute=True)
    jstep = JaxTrainStep(jmodel, lr=1e-3, donate=False)
    pstep = CompiledTrainStep(pmodel, lr=1e-3, device="cpu")
    ids, labels = _batch(seed=5)
    jl = [float(jstep.step(ids, labels)) for _ in range(4)]
    pl = [float(pstep.step(ids, labels)) for _ in range(4)]
    np.testing.assert_allclose(pl, jl, rtol=1e-5)
    _assert_close_to_jax(pstep, jstep)


@pytest.mark.parametrize("master", ["float32", "bfloat16_sr"])
def test_gate_held_off_writes_nothing(master):
    """A step run as a graph's warm-up runs (the gate held False): every
    state tensor and the generators come out as they went in, and the
    next step equals a step of a twin that never warmed up."""
    kw = dict(lr=5e-3, master_dtype=master, device="cpu")
    if master == "bfloat16_sr":
        kw.update(compute_dtype="bfloat16", moments_dtype="bfloat16")
    step = CompiledTrainStep(_port(recompute=True), **kw)
    twin = CompiledTrainStep(_port(recompute=True), **kw)
    ids, labels = _batch(seed=3)
    step.step(ids, labels)
    twin.step(ids, labels)
    snap, gen = step.state_dict(), step._sr_gen.get_state()
    with step._scratch():
        assert not bool(step._live)
        step._run([torch.from_numpy(ids), torch.from_numpy(labels)],
                  step._scalar(2), step._scalar(5e-3))
    assert bool(step._live)
    for tree, name in (("params", "params"), ("master", "_master"),
                       ("m", "_m"), ("v", "_v")):
        for k, v in getattr(step, name).items():
            assert torch.equal(v, snap[tree][k]), (tree, k)
    assert torch.equal(step._sr_gen.get_state(), gen)
    assert torch.equal(step.step(ids, labels), twin.step(ids, labels))
    _assert_state_equal(step, twin)


# -- multi_step -----------------------------------------------------------------

STACKED = {"shared": False, "stacked": True, "per-element": (True, False)}


@pytest.mark.parametrize("how", sorted(STACKED))
def test_multi_step_equals_steps_and_jax(how):
    """multi_step(3) = 3 step() calls bit for bit (losses of every step,
    state, step count, the scheduler), and paddle_tpu's multi_step
    within rtol 1e-5."""
    stacked, k = STACKED[how], 3
    per = stacked if isinstance(stacked, tuple) else (stacked,) * 2
    ids, labels = _batch(seed=7, k=k)
    batch = [ids if per[0] else ids[0], labels if per[1] else labels[0]]

    def sched(m):
        return m.StepDecay(1e-3, step_size=2, gamma=0.5)

    jmodel, pmodel = _pair(recompute=True)
    multi = CompiledTrainStep(pmodel, lr=sched(plr), device="cpu")
    single = CompiledTrainStep(_port(recompute=True), lr=sched(plr),
                               device="cpu")
    jstep = JaxTrainStep(jmodel, lr=sched(jlr), donate=False)
    last = multi.multi_step(k, *batch, stacked=stacked)
    losses = [single.step(*[b[i] if s else b for b, s in zip(batch, per)])
              for i in range(k)]
    assert torch.equal(multi.last_losses, torch.stack(losses))
    assert torch.equal(last, losses[-1])
    _assert_state_equal(multi, single)
    assert multi.lr.last_epoch == single.lr.last_epoch == k
    assert multi.lr() == single.lr()
    jl = float(jstep.multi_step(k, *batch, stacked=stacked))
    np.testing.assert_allclose(float(last), jl, rtol=1e-5)
    _assert_close_to_jax(multi, jstep)
    assert jstep.lr() == multi.lr()


def test_multi_step_rejections_leave_the_scheduler():
    step = CompiledTrainStep(_port(), lr=plr.StepDecay(0.1, step_size=2),
                             device="cpu")
    ids, labels = _batch()
    before = (step.lr.last_epoch, float(step.lr()), step._t)
    with pytest.raises(ValueError, match="stacked"):
        step.multi_step(4, ids, labels, stacked=(True,))
    with pytest.raises(ValueError, match="leading dim 4"):
        step.multi_step(4, ids, labels, stacked=True)
    assert (step.lr.last_epoch, float(step.lr()), step._t) == before
    plateau = CompiledTrainStep(_port(), lr=plr.ReduceOnPlateau(0.1),
                                device="cpu")
    with pytest.raises(ValueError, match="ReduceOnPlateau"):
        plateau.multi_step(2, ids, labels)


def test_multi_step_graph_plumbing_on_the_cpu_is_the_loop():
    """The CPU path keeps no graph buffers and captures nothing."""
    step = CompiledTrainStep(_port(), device="cpu")
    ids, labels = _batch()
    step.multi_step(2, ids, labels)
    assert step._multi_bufs == {} and step._graph.traces == 0
    assert step._t == 2 and step.last_losses.shape == (2,)


# -- bfloat16_sr -------------------------------------------------------------------

def test_bf16_sr_keeps_one_bf16_copy_and_converges():
    """As test_llama_training.py's single-copy test: no master, bf16
    parameters outside the norms, and 30 steps of memorisation lower
    the loss by more than 1.5."""
    pmodel = _port(recompute=True)
    step = CompiledTrainStep(pmodel, lr=5e-3, compute_dtype="bfloat16",
                             moments_dtype="bfloat16",
                             master_dtype="bfloat16_sr", device="cpu")
    assert step._master == {}
    assert all(p.dtype == (torch.float32 if "norm" in k else torch.bfloat16)
               for k, p in step.params.items())
    assert all(m.dtype == torch.bfloat16 for m in step._m.values())
    ids = np.random.RandomState(0).randint(0, 256, (2, 64))
    losses = [float(step.step(ids, ids)) for _ in range(30)]
    assert losses[-1] < losses[0] - 1.5, losses


def test_bf16_sr_is_unbiased():
    x = torch.full((20000,), 1.0 + 1e-3)
    gen = torch.Generator().manual_seed(3)
    r = stochastic_round_bf16(x, gen)
    assert r.dtype == torch.bfloat16
    assert set(r.float().unique().tolist()) == {1.0, 1.0078125}
    assert abs(float(r.float().mean()) - (1.0 + 1e-3)) < 2e-4


def test_sr_bits_match_jax_formula():
    """The port's rounding equals ``_stochastic_round_bf16`` bit for bit
    on the random bits JAX draws for it, at ordinary values, on the
    bf16 grid, at +-inf, NaN, +-0, the largest finite float and
    denormals."""
    rng = np.random.RandomState(9)
    special = np.array([np.inf, -np.inf, np.nan, 0.0, -0.0, 1.0, -2.5,
                        3.4028235e38, -3.4028235e38, 1e-40, -1e-45,
                        65504.0, 1.0078125], np.float32)
    x = np.concatenate([rng.randn(4000).astype(np.float32) * 10.0 ** rng
                        .randint(-30, 30, 4000), special]).astype(np.float32)
    key = jax.random.PRNGKey(21)
    want = np.asarray(jax.lax.bitcast_convert_type(
        _stochastic_round_bf16(jnp.asarray(x), key), jnp.uint16))
    r = np.asarray(jax.random.randint(key, x.shape, 0, 1 << 16,
                                      dtype=jnp.uint32)).astype(np.int32)
    got = sr_bits(torch.from_numpy(x), torch.from_numpy(r)).view(torch.int16)
    np.testing.assert_array_equal(got.numpy().view(np.uint16), want)


def test_bf16_sr_multi_step_equals_steps():
    """The SR generator is the step's own: multi_step draws the bits k
    step() calls draw."""
    kw = dict(lr=5e-3, compute_dtype="bfloat16", moments_dtype="bfloat16",
              master_dtype="bfloat16_sr", device="cpu")
    a = CompiledTrainStep(_port(recompute=True), **kw)
    b = CompiledTrainStep(_port(recompute=True), **kw)
    ids, labels = _batch(seed=2)
    a.multi_step(3, ids, labels)
    for _ in range(3):
        b.step(ids, labels)
    _assert_state_equal(a, b)


# -- guarded_step ------------------------------------------------------------------

def test_guarded_clean_run_equals_plain_step_and_jax():
    jmodel, pmodel = _pair(recompute=True)
    plain = CompiledTrainStep(_port(recompute=True), device="cpu")
    guarded = CompiledTrainStep(pmodel, device="cpu")
    jstep = JaxTrainStep(jmodel, donate=False)
    ids, labels = _batch(seed=4)
    for _ in range(3):
        loss, gnorm, ok = guarded.guarded_step(float("inf"), ids, labels)
        jloss, jgnorm, jok = jstep.guarded_step(float("inf"), ids, labels)
        assert ok and jok
        assert loss == float(plain.step(ids, labels))
        np.testing.assert_allclose([loss, gnorm], [jloss, jgnorm],
                                   rtol=1e-5)
    _assert_state_equal(guarded, plain)
    _assert_close_to_jax(guarded, jstep)


@pytest.mark.parametrize("poison,threshold", [(float("nan"), float("inf")),
                                              (1e6, 1e3)],
                         ids=["nan_loss", "loss_spike"])
@pytest.mark.parametrize("master", ["float32", "bfloat16_sr"])
def test_guarded_skip_keeps_state(poison, threshold, master):
    """A poisoned loss and a spike above the threshold skip: every state
    tensor and the step count stay as they were (found_inf semantics),
    and the next clean step goes on from there."""
    kw = ({} if master == "float32" else
          dict(compute_dtype="bfloat16", moments_dtype="bfloat16"))
    step = CompiledTrainStep(Poisoned(_port(recompute=True)), device="cpu",
                             master_dtype=master, **kw)
    ids, labels = _batch(seed=8)
    step.guarded_step(float("inf"), ids, labels)
    snap = step.state_dict()
    step.model.poison.fill_(poison)
    loss, gnorm, ok = step.guarded_step(threshold, ids, labels)
    assert not ok and np.isfinite(gnorm)
    assert np.isnan(loss) if np.isnan(poison) else loss > threshold
    for tree, name in (("params", "params"), ("master", "_master"),
                       ("m", "_m"), ("v", "_v")):
        for k, v in getattr(step, name).items():
            assert torch.equal(v, snap[tree][k]), (tree, k)
    assert step._t == snap["t"] == 1
    step.model.poison.zero_()
    assert step.guarded_step(float("inf"), ids, labels)[2]
    assert step._t == 2


# -- recompute policies -------------------------------------------------------------

def _loss_and_grads(model, ids, labels):
    loss = model(torch.from_numpy(ids), torch.from_numpy(labels))
    names = [k for k, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, list(model.parameters()))
    return loss.detach(), dict(zip(names, grads))


@pytest.mark.parametrize("policy", POLICIES)
def test_policy_equals_full_and_jax(policy):
    jmodel, pmodel = _pair(recompute=True, recompute_policy=policy)
    ids, labels = _batch(seed=6)
    loss, grads = _loss_and_grads(pmodel, ids, labels)
    full_loss, full = _loss_and_grads(_port(recompute=True), ids, labels)
    assert torch.equal(loss, full_loss)
    assert all(torch.equal(grads[k], full[k]) for k in full)
    jstep = JaxTrainStep(jmodel, donate=False)
    with jax.enable_x64(False):
        jl, jg = jax.jit(jax.value_and_grad(jstep.loss_of))(
            jstep.params, jnp.asarray(ids), jnp.asarray(labels))
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    for k in jg:
        np.testing.assert_allclose(_np(grads[k]), _np(jg[k]), rtol=1e-5,
                                   atol=1e-4, err_msg=k)


@pytest.mark.parametrize("policy", POLICIES)
def test_policy_saves_the_reference_set(policy, monkeypatch):
    """A hook on the policy's save decisions records what each layer
    keeps besides its input: nothing (full); the gate and up products
    (save_mlp); the [B, S, h] attention output (save_attn); every
    matmul output, the seven projections and the two attention
    products (dots)."""
    saved = []
    real = port_llama._remat_policy

    def recording(name):
        policy_fn = real(name)
        if policy_fn is None:
            return None

        def hook(ctx, op, *args, **kwargs):
            d = policy_fn(ctx, op, *args, **kwargs)
            if d == torch.utils.checkpoint.CheckpointPolicy.MUST_SAVE \
                    and not ctx.is_recompute:
                saved.append((getattr(port_llama._site_state, "name", None),
                              op.__name__, tuple(ctx.op_output.shape)))
            return d
        return hook

    monkeypatch.setattr(port_llama, "_remat_policy", recording)
    model = _port(recompute=True, recompute_policy=policy)
    cfg = model.config
    ids, labels = _batch(seed=6)
    loss, grads = _loss_and_grads(model, ids, labels)
    L, N = cfg.num_hidden_layers, ids.size
    h, i = cfg.hidden_size, cfg.intermediate_size
    if policy == "full":
        assert saved == []
    elif policy == "save_mlp":
        assert saved == [("mlp_gate", "mm.default", (N, i)),
                         ("mlp_up", "mm.default", (N, i))] * L
    elif policy == "save_attn":
        assert {s for s, _, _ in saved} == {"attn_out"}
        assert len(saved) % L == 0
        assert all(int(np.prod(shape)) == N * h for _, _, shape in saved)
    else:
        mms = [shape for _, op, shape in saved if op == "mm.default"]
        kv = cfg.num_key_value_heads * cfg.head_dim
        assert mms == [(N, h), (N, kv), (N, kv), (N, h), (N, i), (N, i),
                       (N, h)] * L
        assert sum(op == "bmm.default" for _, op, _ in saved) == 2 * L
    full_loss, full = _loss_and_grads(_port(recompute=True), ids, labels)
    assert torch.equal(loss, full_loss)


def test_unknown_policy_raises():
    with pytest.raises(ValueError, match="unknown recompute_policy"):
        LlamaForCausalLM(LlamaConfig.tiny(recompute=True,
                                          recompute_policy="nope"),
                         device="cpu")


# -- update_fn, loss_fn, moments ---------------------------------------------------

def _linear_pair(seed=3):
    paddle.seed(seed)
    jlin = paddle.nn.Linear(4, 3)
    plin = Linear(4, 3, device="cpu", bias=True)
    state = _state(jlin)
    with torch.no_grad():
        plin.weight.copy_(torch.from_numpy(state["weight"]))
        plin.bias.copy_(torch.from_numpy(state["bias"]))
    return jlin, plin


def _xy(seed=0, n=8):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, 4).astype(np.float32),
            rng.randint(0, 3, (n,)).astype(np.int64))


@pytest.mark.parametrize("n_labels", [1, 2])
def test_loss_fn_with_labels_matches_jax(n_labels):
    """loss = loss_fn(model(*inputs), *labels) over the last n_labels
    batch elements."""
    jlin, plin = _linear_pair()
    x, y = _xy()
    w = np.linspace(0.5, 1.5, 8).astype(np.float32)
    if n_labels == 1:
        def jloss(out, lab):
            return JF.cross_entropy(out, lab)

        def ploss(out, lab):
            return torch.nn.functional.cross_entropy(out, lab)
        batch = (x, y)
    else:
        def jloss(out, lab, wt):
            return (JF.cross_entropy(out, lab, reduction="none")
                    .reshape([-1]) * wt).mean()

        def ploss(out, lab, wt):
            return (torch.nn.functional.cross_entropy(
                out, lab, reduction="none") * wt).mean()
        batch = (x, y, w)
    jstep = JaxTrainStep(jlin, lr=0.1, loss_fn=jloss, n_labels=n_labels,
                         donate=False)
    pstep = CompiledTrainStep(plin, lr=0.1, loss_fn=ploss,
                              n_labels=n_labels, device="cpu")
    jl = [float(jstep.step(*batch)) for _ in range(3)]
    pl = [float(pstep.step(*batch)) for _ in range(3)]
    np.testing.assert_allclose(pl, jl, rtol=1e-5)
    _assert_close_to_jax(pstep, jstep)


@pytest.mark.parametrize("moments", ["m", "none"])
def test_update_fn_and_moments_match_jax(moments):
    """A momentum-SGD (moments="m") and a plain SGD (moments="none")
    update_fn: only the moment trees the rule reads are allocated, the
    grads arrive clipped, and the result matches paddle_tpu."""
    def make(lib):
        def upd(master, grads, m, v, t, lr):
            if moments == "m":
                new_m = {k: 0.9 * m[k] + grads[k] for k in master}
                return ({k: master[k] - lr * new_m[k] for k in master},
                        new_m, v)
            return {k: master[k] - lr * grads[k] for k in master}, m, v
        return upd

    jlin, plin = _linear_pair(seed=4)
    x, y = _xy(seed=1)
    kw = dict(lr=0.5, moments=moments, grad_clip_norm=0.05)
    jstep = JaxTrainStep(jlin, update_fn=make(jnp), donate=False,
                         loss_fn=JF.cross_entropy, **kw)
    pstep = CompiledTrainStep(
        plin, update_fn=make(torch), device="cpu",
        loss_fn=lambda o, t: torch.nn.functional.cross_entropy(o, t), **kw)
    assert (len(pstep._m) > 0) == (moments == "m") and pstep._v == {}
    jl = [float(jstep.step(x, y)) for _ in range(4)]
    pl = [float(pstep.step(x, y)) for _ in range(4)]
    np.testing.assert_allclose(pl, jl, rtol=1e-5)
    _assert_close_to_jax(pstep, jstep)
    for k in jstep._m:
        np.testing.assert_allclose(_np(pstep._m[k]), _np(jstep._m[k]),
                                   rtol=1e-5, atol=1e-7)


def test_adamw_needs_both_moments():
    with pytest.raises(ValueError, match="moments='mv'"):
        CompiledTrainStep(_port(), moments="m", device="cpu")


# -- remat=True, set_state_dict, state_device --------------------------------------

def test_remat_whole_forward_matches():
    """remat=True: the same steps as without, bit for bit, and
    paddle_tpu's remat=True within rtol 1e-5."""
    jmodel, pmodel = _pair()
    remat = CompiledTrainStep(pmodel, remat=True, device="cpu")
    plain = CompiledTrainStep(_port(), device="cpu")
    jstep = JaxTrainStep(jmodel, remat=True, donate=False)
    ids, labels = _batch(seed=12)
    rl = [remat.step(ids, labels) for _ in range(3)]
    assert all(torch.equal(a, plain.step(ids, labels)) for a in rl)
    _assert_state_equal(remat, plain)
    jl = [float(jstep.step(ids, labels)) for _ in range(3)]
    np.testing.assert_allclose([float(x) for x in rl], jl, rtol=1e-5)


class _QA(torch.nn.Module):
    def __init__(self, cfg, seed):
        super().__init__()
        self.qa = BertForQuestionAnswering(cfg, device="cpu", seed=seed)

    def forward(self, ids, starts, ends):
        return self.qa(ids, start_positions=starts, end_positions=ends)


def test_remat_replays_the_dropout_masks():
    """BERT with dropout: under remat=True the recompute draws the
    forward's masks again (the generators run from the forward's
    states), so the steps equal the plain ones bit for bit."""
    cfg = BertConfig.tiny(hidden_dropout_prob=0.2,
                          attention_probs_dropout_prob=0.2)
    steps = []
    for remat in (True, False):
        model = _QA(cfg, seed=1)
        model.train()
        steps.append(CompiledTrainStep(model, remat=remat, device="cpu"))
    rng = np.random.RandomState(0)
    batch = (rng.randint(0, cfg.vocab_size, (2, 32)),
             rng.randint(0, 32, (2,)), rng.randint(0, 32, (2,)))
    for _ in range(2):
        assert torch.equal(steps[0].step(*batch), steps[1].step(*batch))
    _assert_state_equal(*steps)


@pytest.mark.parametrize("synced", [True, False])
def test_remat_capture_path_recomputes_the_forward_masks(monkeypatch,
                                                         synced):
    """Under a CUDA-graph capture a generator's state cannot be read, so
    ``remat=True`` recomputes each dropout mask from the generator's
    twin, swapped into the module for the recompute and set to the
    generator's state before each replay (``_Replay.sync``).  The
    capture path runs here on the CPU with the capture test forced
    true: after one sync the twins stay in lockstep over two steps, the
    recompute's masks are the forward's, and the steps equal the plain
    ones bit for bit; a twin left behind its generator draws other
    masks, and the steps differ."""
    monkeypatch.setattr(training_mod, "_capturing", lambda: True)
    cfg = BertConfig.tiny(hidden_dropout_prob=0.2,
                          attention_probs_dropout_prob=0.2)
    steps = []
    for remat in (True, False):
        model = _QA(cfg, seed=1)
        model.train()
        steps.append(CompiledTrainStep(model, remat=remat, device="cpu"))
    replay = steps[0]._remat
    assert len(replay.twins) == len(replay.generators) >= 1
    assert all(t in steps[0]._generators for t in replay.twins.values())
    for step in steps:          # move every model generator on
        for g in training_mod._model_generators(step.model):
            torch.rand(3, generator=g)
    if synced:
        replay.sync()
    rng = np.random.RandomState(0)
    batch = (rng.randint(0, cfg.vocab_size, (2, 32)),
             rng.randint(0, 32, (2,)), rng.randint(0, 32, (2,)))
    same = [torch.equal(steps[0].step(*batch), steps[1].step(*batch))
            for _ in range(2)]
    # the first forward draws the same masks either way
    assert same[0] and all(same) is synced
    eq = all(torch.equal(steps[0]._master[k], steps[1]._master[k])
             for k in steps[0]._master)
    assert eq is synced
    if synced:
        _assert_state_equal(*steps)
        # both advanced by the same draws: still in lockstep
        for g in replay.generators:
            assert torch.equal(g.get_state(),
                               replay.twins[id(g)].get_state())


def test_set_state_dict_from_jax_resumes():
    """paddle_tpu trains 2 steps with a warm-up schedule; its state dict
    (numpy arrays and the scheduler's state) loads into a fresh port
    step, and 2 more steps on each side agree."""
    def sched(m):
        return m.LinearWarmup(m.ExponentialDecay(1e-3, gamma=0.9),
                              warmup_steps=3, start_lr=1e-4, end_lr=1e-3)

    jmodel, _ = _pair(recompute=True)
    jstep = JaxTrainStep(jmodel, lr=sched(jlr), donate=False)
    ids, labels = _batch(seed=13)
    for _ in range(2):
        jstep.step(ids, labels)
    jstate = jstep.state_dict()
    pstep = CompiledTrainStep(_port(seed=99, recompute=True), lr=sched(plr),
                              device="cpu")
    pstep.set_state_dict({
        **{tree: {k: np.asarray(v) for k, v in jstate[tree].items()}
           for tree in ("params", "master", "m", "v")},
        "t": jstate["t"], "lr_scheduler": jstate["lr_scheduler"]})
    assert pstep._t == 2 and pstep.lr.last_epoch == jstep.lr.last_epoch
    jl = [float(jstep.step(ids, labels)) for _ in range(2)]
    pl = [float(pstep.step(ids, labels)) for _ in range(2)]
    np.testing.assert_allclose(pl, jl, rtol=1e-5)
    _assert_close_to_jax(pstep, jstep)
    assert pstep.state_dict()["lr_scheduler"] == jstep.state_dict()[
        "lr_scheduler"]


def test_set_state_dict_round_trip_is_exact():
    sched = plr.StepDecay(1e-3, step_size=1, gamma=0.7)
    a = CompiledTrainStep(_port(recompute=True), lr=sched, device="cpu")
    ids, labels = _batch(seed=14)
    a.step(ids, labels)
    state = a.state_dict()
    b = CompiledTrainStep(_port(seed=5, recompute=True),
                          lr=plr.StepDecay(1e-3, step_size=1, gamma=0.7),
                          device="cpu")
    addresses = {k: p.data_ptr() for k, p in b.params.items()}
    b.set_state_dict(state)
    assert {k: p.data_ptr() for k, p in b.params.items()} == addresses
    for _ in range(2):
        assert torch.equal(a.step(ids, labels), b.step(ids, labels))
    _assert_state_equal(a, b)
    assert a.lr() == b.lr()


def test_state_device_matches_jax():
    """The model built on the CPU, the state placed by state_device: the
    same steps as device=, and paddle_tpu's state_device run."""
    jmodel, pmodel = _pair(recompute=True)
    jstep = JaxTrainStep(jmodel, donate=False,
                         state_device=jax.devices("cpu")[0])
    pstep = CompiledTrainStep(pmodel, state_device="cpu")
    other = CompiledTrainStep(_port(recompute=True), device="cpu")
    assert pstep.device == torch.device("cpu")
    ids, labels = _batch(seed=15)
    jl = [float(jstep.step(ids, labels)) for _ in range(3)]
    pl = [pstep.step(ids, labels) for _ in range(3)]
    assert all(torch.equal(a, other.step(ids, labels)) for a in pl)
    np.testing.assert_allclose([float(x) for x in pl], jl, rtol=1e-5)
    with pytest.raises(ValueError, match="disagree"):
        CompiledTrainStep(_port(), device="cpu", state_device="meta")


def test_mesh_still_raises():
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        CompiledTrainStep(_port(), device="cpu", mesh=object())


# -- the embedding backward ---------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_embedding_grad_is_the_exact_sum(dtype):
    """The port's embedding backward (fixed order, fp64 running sums):
    each row is the fp64 sum of its id's gradient rows rounded once,
    unread rows are 0, and it agrees with the library's backward."""
    rng = np.random.RandomState(1)
    ids = torch.from_numpy(rng.randint(0, 40, (6, 50)))
    ids[0] = 7                              # one id 50 times and more
    grad = torch.from_numpy(rng.randn(6, 50, 24).astype(np.float32)).to(dtype)
    got = embedding_grad(ids, grad, 64, dtype)
    exact = torch.zeros(64, 24, dtype=torch.float64).index_add_(
        0, ids.reshape(-1), grad.reshape(-1, 24).double())
    assert got.dtype == dtype and got.shape == (64, 24)
    assert torch.equal(got, exact.to(dtype))
    assert torch.equal(got[40:], torch.zeros(24, 24, dtype=dtype))
    w = torch.zeros(64, 24, dtype=dtype, requires_grad=True)
    (lib,) = torch.autograd.grad(torch.nn.functional.embedding(ids, w), w,
                                 grad)
    if dtype == torch.float32:
        np.testing.assert_allclose(_np(got), _np(lib), rtol=0, atol=1e-5)
    else:                   # the library sums a repeated id in bf16
        err = np.linalg.norm(_np(got) - _np(lib))
        assert err <= 2e-2 * np.linalg.norm(_np(lib)), err
    assert torch.equal(embedding_grad(ids, grad, 64, dtype), got)


# -- on the card ------------------------------------------------------------------

def _ids_on(device, seed=0, B=2, S=256, vocab=256):
    ids = np.random.RandomState(seed).randint(0, vocab, (B, S))
    return (torch.as_tensor(ids, device=device),) * 2


@pytest.mark.cuda
@pytest.mark.parametrize("master", ["float32", "bfloat16_sr"])
def test_cuda_multi_step_replays_equal_eager(master):
    """multi_step(3) as a replayed CUDA graph equals 3 eager steps bit for
    bit, twice over (the second call only replays)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    cfg = LlamaConfig.tiny(recompute=True, max_position_embeddings=256)
    kw = dict(compute_dtype="bfloat16", moments_dtype="bfloat16",
              master_dtype=master, device="cuda")
    a = CompiledTrainStep(LlamaForCausalLM(cfg, device="cuda", seed=1), **kw)
    b = CompiledTrainStep(LlamaForCausalLM(cfg, device="cuda", seed=1), **kw)
    batch = _ids_on("cuda")
    for _ in range(2):
        b.multi_step(3, *batch)
        eager = torch.stack([a.step(*batch) for _ in range(3)])
        assert torch.equal(b.last_losses, eager)
        _assert_state_equal(a, b)
    assert b._graph.traces == 1 and b._graph.dispatches == 2


@pytest.mark.cuda
def test_cuda_remat_with_dropout_replays_equal_eager():
    """remat=True over BERT with dropout under multi_step capture: each
    replay equals the eager remat step from the same generator states
    bit for bit (the recompute draws from the registered twins), and at
    lr 0 three replays give three different losses (new masks)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    cfg = BertConfig.tiny(hidden_dropout_prob=0.1,
                          attention_probs_dropout_prob=0.1)
    steps = []
    for _ in range(2):
        model = torch.nn.Module()
        model.qa = BertForQuestionAnswering(cfg, device="cuda", seed=1)
        model.forward = lambda ids, s, e, m=model.qa: m(
            ids, start_positions=s, end_positions=e)
        model.train()
        steps.append(CompiledTrainStep(model, lr=0.0, remat=True,
                                       compute_dtype="bfloat16",
                                       device="cuda"))
    rng = np.random.RandomState(0)
    batch = tuple(torch.as_tensor(a, device="cuda") for a in (
        rng.randint(0, cfg.vocab_size, (2, 128)), rng.randint(0, 128, (2,)),
        rng.randint(0, 128, (2,))))
    eager, graph = steps
    el = [eager.step(*batch) for _ in range(3)]
    gl = [graph.multi_step(1, *batch) for _ in range(3)]
    assert all(torch.equal(a, b) for a, b in zip(el, gl))
    assert len({float(x) for x in gl}) == 3
    _assert_state_equal(eager, graph)
    assert graph._graph.traces == 1 and graph._graph.dispatches == 3
