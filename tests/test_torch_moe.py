"""The MoE block of the PyTorch port against ``paddle_tpu``.

Held to the JAX package on the CPU, on the same numpy inputs and weights:
``sort_dispatch`` element for element (with capacity overflow),
``dispatch_masks``, ``topk`` with exact ties, ``ep_moe_local`` on both
routes (out, aux loss and gradients against ``jax.value_and_grad``),
``MoELayer`` with the GShard, Switch and naive gates on both routes
(forward, gate loss and tape gradients), ``CompiledTrainStep`` over a
small MoE training module, the weight bridge and the Xavier fans.

Tolerances: fp32 rtol 1e-5 (atol 1e-6 near zero) -- f32 on both sides,
sums in other orders; bf16 compute in the train step rtol 2e-2, as the
other train-step tests of the port.  Routing decisions (indices, keep
masks, slots) are held exactly.

On the CPU, ``impl="fused"`` takes the grouped FFN's einsum route unless
``PT_GROUPED_GEMM=pallas``, in both packages; with it, the port's plain
version of the kernel meets the Pallas kernel in interpret mode.  The
card runs the kernel route in the ``cuda``-marked tests (skipped where
there is none) and in ``chip_smoke.py``.
"""
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu.distributed.utils import moe_utils as jmu
from paddle_tpu.incubate.distributed.models.moe import MoELayer as JaxMoE
from paddle_tpu.incubate.distributed.models.moe.gate import (
    GShardGate as JaxGShard,
)
from paddle_tpu.models.training import CompiledTrainStep as JaxTrainStep
from paddle_tpu.nn.initializer import _fans
from paddle_tpu_torch.distributed.utils import moe_utils as mu
from paddle_tpu_torch.incubate.distributed.models.moe import (
    GShardGate, MoELayer,
)
from paddle_tpu_torch.models import CompiledTrainStep, load_numpy_state
from paddle_tpu_torch.nn import initializer
from paddle_tpu_torch.ops.kernels import grouped_gemm as gg
from paddle_tpu_torch.ops.manipulation import topk


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    if hasattr(a, "_data"):
        a = a._data
    return np.array(jnp.asarray(a, jnp.float32))


def _jax(fn, *a, **kw):
    with jax.enable_x64(False):
        return fn(*a, **kw)


def _close(got, want, rtol=1e-5, atol=1e-6, msg=""):
    np.testing.assert_allclose(_np(got), _np(want), rtol=rtol, atol=atol,
                               err_msg=msg)


# -- routing --------------------------------------------------------------------

def _idx(T, k, E, seed):
    """Top-k expert ids of random softmax probabilities (distinct per
    row), skewed so some experts overflow a small capacity."""
    r = np.random.RandomState(seed)
    logits = r.randn(T, E) + np.linspace(0, 2, E)
    return np.argsort(-logits, axis=-1, kind="stable")[:, :k]


@pytest.mark.parametrize("T,k,E,C", [(64, 2, 8, 2), (64, 2, 8, 40),
                                     (37, 1, 4, 5), (16, 2, 8, 16)])
def test_sort_dispatch_matches_jax(T, k, E, C):
    idx = _idx(T, k, E, seed=T + C)
    want = _jax(jmu.sort_dispatch, jnp.asarray(idx, jnp.int32), E, C)
    got = mu.sort_dispatch(torch.from_numpy(idx), E, C)
    for name in ("src_tok", "filled", "slot", "keep"):
        assert got[name].dtype == {"src_tok": torch.int32,
                                   "filled": torch.bool,
                                   "slot": torch.int32,
                                   "keep": torch.bool}[name], name
        np.testing.assert_array_equal(got[name].numpy(),
                                      np.asarray(want[name]), err_msg=name)
    if C == 2:
        assert not bool(got["keep"].all())       # overflow happened


@pytest.mark.parametrize("C", [2, 9])
def test_dispatch_masks_match_jax_and_drop_the_sorted_slots(C):
    T, k, E = 48, 2, 8
    r = np.random.RandomState(C)
    probs = np.asarray(jax.nn.softmax(jnp.asarray(r.randn(T, E),
                                                  jnp.float32)))
    idx = _idx(T, k, E, seed=C)
    want = _jax(jmu.dispatch_masks, jnp.asarray(probs), jnp.asarray(idx),
                E, C)
    got = mu.dispatch_masks(torch.from_numpy(probs), torch.from_numpy(idx),
                            E, C)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_np(g), _np(w))
    plan = mu.sort_dispatch(torch.from_numpy(idx), E, C)
    assert torch.equal(plan["keep"], got[2])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_topk_ties_match_paddle_tpu(dtype):
    """Exact ties break lowest index first, as ``paddle_tpu.ops.topk``
    and ``jax.lax.top_k`` break them."""
    r = np.random.RandomState(0)
    x = r.randint(0, 4, size=(64, 8)).astype(np.float32) / 8
    jx = jnp.asarray(x, getattr(jnp, dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    for k in (1, 2, 3):
        jv, ji = _jax(paddle.topk, paddle.to_tensor(jx), k)
        tv, ti = topk(tx, k)
        np.testing.assert_array_equal(ti.numpy(), _np(ji).astype(np.int64))
        np.testing.assert_array_equal(_np(tv), _np(jv))
        _, li = _jax(jax.lax.top_k, jx, k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(li))
    tv, ti = topk(tx.t(), 2, axis=0, largest=False)
    jv, ji = _jax(paddle.topk, paddle.to_tensor(jx.T), 2, axis=0,
                  largest=False)
    np.testing.assert_array_equal(ti.numpy(), _np(ji).astype(np.int64))


def test_resolve_moe_impl_matches_jax(monkeypatch):
    monkeypatch.delenv("PT_MOE_IMPL", raising=False)
    for impl in (None, "auto", "fused", "einsum"):
        assert mu.resolve_moe_impl(256, impl) == \
            jmu.resolve_moe_impl(256, impl)
    monkeypatch.setenv("PT_MOE_IMPL", "fused")
    assert mu.resolve_moe_impl(256) == jmu.resolve_moe_impl(256) == "fused"
    monkeypatch.setenv("PT_MOE_IMPL", "nope")
    for fn in (mu.resolve_moe_impl, jmu.resolve_moe_impl):
        with pytest.raises(ValueError, match="auto|fused|einsum"):
            fn(256)
    monkeypatch.delenv("PT_MOE_IMPL")
    assert mu.resolve_moe_impl(2048, accelerated=True) == "fused"
    assert mu.resolve_moe_impl(2000, accelerated=True) == "einsum"


# -- the single-device body -----------------------------------------------------

def _body_operands(T=64, H=32, E=8, F=48, seed=0):
    r = np.random.RandomState(seed)
    return [a.astype(np.float32) for a in (
        r.randn(T, H), r.randn(H, E) * 0.3, r.randn(E, H, F) * 0.1,
        r.randn(E, 1, F) * 0.1, r.randn(E, F, H) * 0.1,
        r.randn(E, 1, H) * 0.1)]


@pytest.mark.parametrize("gemm", ["einsum", "pallas"])
@pytest.mark.parametrize("impl,gate_kind,k", [
    ("fused", "gshard", 2), ("einsum", "gshard", 2), ("fused", "switch", 1),
    ("einsum", "naive", 2)])
def test_ep_moe_local_matches_jax(monkeypatch, impl, gate_kind, k, gemm):
    """Out, aux and the gradients of tokens, wg, w1, b1, w2 and b2 (loss
    sum(out^2)/T + aux, the bench body's) against jax.value_and_grad;
    capacity 12 of 16 average slots, so choices are dropped."""
    monkeypatch.setenv("PT_GROUPED_GEMM", gemm)
    arrs = _body_operands(seed=len(gate_kind) + k)
    T, E, C = 64, 8, 12
    kw = dict(axis_name=None, n=1, num_experts=E, top_k=k, capacity=C,
              activation="gelu", gate_kind=gate_kind, impl=impl)

    def jloss(*args):
        out, aux = jmu.ep_moe_local(*args, **kw)
        return jnp.sum(out.astype(jnp.float32) ** 2) / T + aux, (out, aux)

    (jl, (jout, jaux)), jgrads = _jax(jax.jit(
        jax.value_and_grad(jloss, argnums=tuple(range(6)), has_aux=True)),
        *[jnp.asarray(a) for a in arrs])
    targs = [torch.from_numpy(a).requires_grad_(True) for a in arrs]
    out, aux = mu.ep_moe_local(*targs, **kw)
    loss = out.float().square().sum() / T + aux
    loss.backward()
    _close(out, jout, msg="out")
    _close(aux, jaux, msg="aux")
    _close(loss, jl, msg="loss")
    for name, t, w in zip(("tokens", "wg", "w1", "b1", "w2", "b2"), targs,
                          jgrads):
        _close(t.grad, w, atol=1e-5, msg=name)


def test_ep_moe_local_int8_matches_jax(monkeypatch):
    """Quantized w1/w2 on the fused route: kernel 11's plain version
    against ``_pallas_ffn_q`` in interpret mode, bf16 tokens."""
    from paddle_tpu.ops import quant as jq
    from paddle_tpu_torch.ops import quant as tq

    monkeypatch.setenv("PT_GROUPED_GEMM", "pallas")
    tokens, wg, w1, b1, w2, b2 = _body_operands(seed=9)
    kw = dict(axis_name=None, n=1, num_experts=8, top_k=2, capacity=16,
              activation="gelu", gate_kind="gshard", impl="fused")
    jout, jaux = _jax(jax.jit(lambda *a: jmu.ep_moe_local(*a, **kw)),
                      jnp.asarray(tokens, jnp.bfloat16), jnp.asarray(wg),
                      jq.quantize_linear(jnp.asarray(w1)), jnp.asarray(b1),
                      jq.quantize_linear(jnp.asarray(w2)), jnp.asarray(b2))
    before = gg.grouped_ffn_q.launches
    out, aux = mu.ep_moe_local(
        torch.from_numpy(tokens).bfloat16(), torch.from_numpy(wg),
        tq.quantize_linear(torch.from_numpy(w1)), torch.from_numpy(b1),
        tq.quantize_linear(torch.from_numpy(w2)), torch.from_numpy(b2), **kw)
    assert gg.grouped_ffn_q.launches == before      # CPU: the plain version
    assert out.dtype == torch.bfloat16
    want = _np(jout)
    assert np.all(np.abs(_np(out) - want) <= 2 ** -7 * np.abs(want) + 2e-3)
    _close(aux, jaux)


def test_unported_paths_raise():
    arrs = [torch.from_numpy(a) for a in _body_operands()]
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        mu.ep_moe_local(*arrs, axis_name="ep", n=2, num_experts=8, top_k=2,
                        capacity=4, activation="gelu", gate_kind="gshard")
    for fn in (mu.global_scatter, mu.global_gather):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            fn(arrs[2], "ep", 2)
    for kw in (dict(dispatch_mode="alltoall"), dict(mesh=object()),
               dict(experts=[torch.nn.Identity()] * 8)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            MoELayer(16, 32, 8, device="cpu", **kw)
    with pytest.raises(ValueError, match="topk=2"):
        JaxGShard(16, 8, topk=1)
    with pytest.raises(ValueError, match="topk=2"):
        GShardGate(16, 8, topk=1, device="cpu")


# -- MoELayer -------------------------------------------------------------------

def _state(layer):
    return {k: np.array(v._data, dtype=np.float32)
            for k, v in layer.state_dict().items()}


def _pair(gate="gshard", top_k=2, cf=1.25, impl="fused", seed=7, H=16,
          F=32):
    paddle.seed(seed)
    jl = JaxMoE(d_model=H, d_hidden=F, num_experts=8, gate=gate,
                top_k=top_k, capacity_factor=cf, moe_impl=impl)
    tl = MoELayer(H, F, 8, gate=gate, top_k=top_k, capacity_factor=cf,
                  moe_impl=impl, device="cpu", seed=None)
    load_numpy_state(tl, _state(jl))
    return jl, tl


def test_parameter_names_and_load_numpy_state():
    jl, tl = _pair()
    state = _state(jl)
    assert {k: tuple(p.shape) for k, p in tl.named_parameters()} == \
        {k: v.shape for k, v in state.items()} == {
            "gate.wg": (16, 8), "experts.w1": (8, 16, 32),
            "experts.b1": (8, 1, 32), "experts.w2": (8, 32, 16),
            "experts.b2": (8, 1, 16)}
    for k, p in tl.named_parameters():
        np.testing.assert_array_equal(_np(p), state[k])


@pytest.mark.parametrize("impl", ["fused", "einsum"])
@pytest.mark.parametrize("gate,top_k", [("gshard", 2), ("switch", 1),
                                        ("naive", 2)])
def test_moe_layer_matches_jax(gate, top_k, impl):
    """Forward, gate loss and tape gradients of out.sum() (x, the expert
    weights and biases, the gate weight through the combine weights);
    cf 0.5 drops choices."""
    jl, tl = _pair(gate, top_k, cf=0.5, impl=impl, seed=11)
    xv = np.random.RandomState(3).randn(2, 8, 16).astype(np.float32)
    x = paddle.to_tensor(xv)
    x.stop_gradient = False
    with jax.enable_x64(False):
        jout = jl(x)
        jout.sum().backward()
    tx = torch.from_numpy(xv).requires_grad_(True)
    out = tl(tx)
    out.sum().backward()
    _close(out, jout, msg="out")
    _close(tl.gate.loss, jl.gate.loss, msg="gate loss")
    _close(tx.grad, x.grad, atol=1e-5, msg="x")
    jparams = dict(jl.named_parameters())
    for name, p in tl.named_parameters():
        _close(p.grad, jparams[name].grad, atol=1e-5, msg=name)


def test_fused_equals_einsum_in_fp32():
    """The contract of ``tests/test_moe_ep.py``: in fp32 the fused route
    gives the einsum route's output and loss."""
    xv = np.random.RandomState(22).randn(4, 8, 16).astype(np.float32)
    outs = []
    for impl in ("einsum", "fused"):
        _, tl = _pair("gshard", 2, cf=0.3, impl=impl, seed=5)
        outs.append((tl(torch.from_numpy(xv)), tl.gate.loss))
    torch.testing.assert_close(outs[0][0], outs[1][0], rtol=1e-6, atol=1e-7)
    assert torch.equal(outs[0][1], outs[1][1])


class _JaxMoETrain(jnn.Layer):
    """``sum(out.f32^2) / T + gate.loss`` over a MoELayer."""

    def __init__(self, **kw):
        super().__init__()
        self.moe = JaxMoE(**kw)

    def forward(self, x):
        out = self.moe(paddle.cast(x, self.moe.gate.wg.dtype))
        o = paddle.cast(out, "float32")
        T = x.shape[0] * x.shape[1]
        return paddle.sum(o * o) / T + paddle.cast(self.moe.gate.loss,
                                                   "float32")


class _MoETrain(torch.nn.Module):
    def __init__(self, **kw):
        super().__init__()
        self.moe = MoELayer(device="cpu", seed=None, **kw)

    def forward(self, x):
        out = self.moe(x.to(self.moe.gate.wg.dtype))
        T = x.shape[0] * x.shape[1]
        return out.float().square().sum() / T + self.moe.gate.loss.float()


@pytest.mark.parametrize("dtype,gemm", [("float32", "pallas"),
                                        ("bfloat16", "pallas"),
                                        ("bfloat16", "einsum")])
def test_train_step_matches_jax(monkeypatch, dtype, gemm):
    """3 AdamW steps of CompiledTrainStep on the MoE training module
    (gshard, top-2, fused route): the losses match step for step.  In
    bf16 the kernel route keeps h in f32 and the einsum route rounds it,
    so each port route is held to the same JAX route; the two routes
    differ from each other."""
    monkeypatch.setenv("PT_GROUPED_GEMM", gemm)
    kw = dict(d_model=32, d_hidden=64, num_experts=8, gate="gshard",
              top_k=2, capacity_factor=1.25, moe_impl="fused")
    paddle.seed(13)
    jw = _JaxMoETrain(**kw)
    tw = _MoETrain(**kw)
    load_numpy_state(tw, _state(jw))
    ckw = {} if dtype == "float32" else dict(compute_dtype="bfloat16")
    jstep = JaxTrainStep(jw, lr=1e-3, donate=False, **ckw)
    tstep = CompiledTrainStep(tw, lr=1e-3, device="cpu", **ckw)
    x = np.random.RandomState(4).randn(2, 16, 32).astype(np.float32)
    jl = [float(_jax(jstep.step, x)) for _ in range(3)]
    tl = [float(tstep.step(x)) for _ in range(3)]
    rtol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(tl, jl, rtol=rtol)
    assert tl[-1] < tl[0]


def test_bf16_routes_differ(monkeypatch):
    """With bf16 compute the kernel route (h in f32) and the einsum route
    (h rounded to bf16) are different functions: the same module gives
    other outputs, which is why each is held to its own JAX route."""
    _, tl = _pair("gshard", 2, impl="fused", seed=2, H=32, F=64)
    tl.to(torch.bfloat16)
    x = torch.from_numpy(np.random.RandomState(1).randn(2, 16, 32)
                         .astype(np.float32)).bfloat16()
    outs = {}
    for gemm in ("pallas", "einsum"):
        monkeypatch.setenv("PT_GROUPED_GEMM", gemm)
        outs[gemm] = tl(x)
    assert not torch.equal(outs["pallas"], outs["einsum"])
    torch.testing.assert_close(outs["pallas"], outs["einsum"], rtol=5e-2,
                               atol=5e-2)


# -- initializer ----------------------------------------------------------------

@pytest.mark.parametrize("shape", [(8, 16, 32), (16, 8), (7,), (4, 3, 5, 2),
                                   ()])
def test_xavier_fans_match_paddle_tpu(shape):
    assert initializer.fans(shape) == _fans(shape)


def test_xavier_uniform_limit_for_stacked_experts():
    """A [E, H, F] weight draws from +-sqrt(6 / (H*F + E*F))."""
    E, H, F = 8, 64, 96
    gen = torch.Generator().manual_seed(0)
    w = initializer.xavier_uniform_(torch.empty(E, H, F), gen)
    limit = math.sqrt(6.0 / (H * F + E * F))
    assert float(w.abs().max()) <= limit
    assert float(w.abs().max()) > 0.99 * limit
    assert abs(float(w.std()) - limit / math.sqrt(3)) < 0.02 * limit
    layer = MoELayer(H, F, E, device="cpu", seed=1)
    assert float(layer.experts.w1.abs().max()) <= limit
    assert not layer.experts.b1.any() and not layer.experts.b2.any()


# -- on the card ----------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "false); chip_smoke.py runs this check on the card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_moe_layer_on_card_launches_the_kernel_once(cuda_device,
                                                    monkeypatch):
    """Auto routing on CUDA at H % 128 == 0 takes the fused route and the
    kernel, one launch per forward; the output matches the CPU's plain
    version of the same route (fp32, other summation orders)."""
    x = np.random.RandomState(0).randn(2, 64, 128).astype(np.float32)
    cpu = MoELayer(128, 256, 8, device="cpu", seed=3, moe_impl="fused")
    card = MoELayer(128, 256, 8, device=cuda_device, seed=None)
    card.load_state_dict(cpu.state_dict())
    monkeypatch.delenv("PT_GROUPED_GEMM", raising=False)
    monkeypatch.delenv("PT_MOE_IMPL", raising=False)
    before = gg.grouped_ffn.launches
    got = card(torch.from_numpy(x).to(cuda_device))
    torch.cuda.synchronize()
    assert gg.grouped_ffn.launches == before + 1
    monkeypatch.setenv("PT_GROUPED_GEMM", "pallas")
    want = cpu(torch.from_numpy(x))
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-5)
