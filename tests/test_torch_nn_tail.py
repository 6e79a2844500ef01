"""The rest of the port's ``nn`` against ``paddle_tpu``'s on the CPU:
the functional ops (``linear``, ``embedding``, ``one_hot``, ``pad``,
``normalize``, ``unfold`` / ``fold``, the pixel and channel shuffles,
``grid_sample`` / ``affine_grid``, ``bilinear``, ``maxout``,
``local_response_norm``, ``instance_norm``, ``temporal_shift``,
``gather_tree``, the in-place activations), the attention entry points
(values against the reference, and the route each takes on a CUDA
tensor, rehearsed on the CPU by taking the CPU for an accelerator: the
kernel wrappers then run their plain versions), the activation, misc,
vision and N-d tail layers, ``nn.utils``, beam search, and the random
ops by their distributions and ``paddle.seed`` (JAX's threefry stream is
not Philox: never bit for bit).  Mirrors ``tests/test_nn_extended.py``
and ``tests/test_nn_nd_tail.py``.

Tolerance: within 1e-5 of the largest magnitude (at least 1), fp32 on
both sides; the attention routes 2e-5 (the kernels' plain versions sum
in blocks).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as ref
import paddle_tpu_torch as paddle
from paddle_tpu import nn as jnn
from paddle_tpu.nn import functional as JF
from paddle_tpu_torch import nn as pnn
from paddle_tpu_torch.nn import functional as PF
from paddle_tpu_torch.ops import nn_ops

from torch_nn_harness import check, close, jt, run_ref

R = np.random.RandomState(21)


@pytest.fixture(autouse=True)
def _cpu_place():
    prev = paddle.get_device()
    paddle.set_device("cpu")
    yield
    paddle.set_device(prev)


def _r(*s, scale=1.0):
    return (R.randn(*s) * scale).astype(np.float32)


def _fn(name, arrays, diff, *args, **kw):
    """``F.<name>(*arrays, *args, **kw)`` on both sides."""
    return dict(ref=lambda *a: getattr(JF, name)(*map(jt, a), *args, **kw),
                port=lambda *a: getattr(PF, name)(*a, *args, **kw),
                arrays=arrays, diff=diff)


def _layer(name, ctor, arrays, diff, forward=None):
    """``nn.<name>(*ctor)(*arrays)`` on both sides (eval mode)."""
    def run(nn, wrap):
        def f(*a):
            layer = getattr(nn, name)(*ctor)
            layer.eval()
            return layer(*map(wrap, a))
        return f
    return dict(ref=run(jnn, jt), port=run(pnn, lambda t: t), arrays=arrays,
                diff=diff)


S_ATT, H_ATT, D_ATT = 16, 2, 8
QKV = _r(2, S_ATT, 3, H_ATT, D_ATT)
VARLEN = _r(10, 3, H_ATT, D_ATT)
CU = np.array([0, 4, 10])
STARTS = R.randint(0, S_ATT, (2, S_ATT))
CSR_COLS = []
CSR_OFFS = np.zeros((1, 2, 9), np.int64)
for h in range(2):
    cols = []
    for r in range(8):
        c = sorted(R.choice(8, R.randint(1, 4), replace=False))
        cols.append(c)
        CSR_OFFS[0, h, r + 1] = CSR_OFFS[0, h, r] + len(c)
    CSR_COLS.append(sum(cols, []))
NNZ = max(len(c) for c in CSR_COLS)
CSR_COLS = np.array([[c + [0] * (NNZ - len(c)) for c in CSR_COLS]])
ROPE_COS, ROPE_SIN = np.cos(_r(32, D_ATT)), np.sin(_r(32, D_ATT))

CASES = {
    "linear": _fn("linear", [_r(3, 4), _r(4, 5), _r(5)], [0, 1, 2]),
    "embedding padding_idx": dict(
        ref=lambda w: JF.embedding(ref.to_tensor(np.array([[1, 0], [2, 1]])),
                                   jt(w), padding_idx=1),
        port=lambda w: PF.embedding(torch.tensor([[1, 0], [2, 1]]), w,
                                    padding_idx=1),
        arrays=[_r(4, 3)], diff=[0]),
    "one_hot": _fn("one_hot", [np.array([0, 3, 2])], [], 4),
    "normalize": _fn("normalize", [_r(3, 4)], [0], p=3, axis=0),
    "pad reflect": _fn("pad", [_r(1, 2, 4, 5)], [0], [1, 2, 2, 1],
                       mode="reflect"),
    "zeropad2d": _fn("zeropad2d", [_r(1, 2, 3, 3)], [0], [1, 0, 2, 1]),
    "label_smooth": _fn("label_smooth", [_r(3, 5)], [0], epsilon=0.2),
    "unfold": _fn("unfold", [_r(2, 3, 6, 5)], [0], [3, 2], 2, 1, 1),
    "fold": _fn("fold", [_r(2, 12, 9)], [0], [4, 5], [2, 2], 2, 1),
    "pixel_shuffle": _fn("pixel_shuffle", [_r(1, 8, 2, 3)], [0], 2),
    "pixel_shuffle NHWC": _fn("pixel_shuffle", [_r(1, 2, 3, 8)], [0], 2,
                              data_format="NHWC"),
    "pixel_unshuffle": _fn("pixel_unshuffle", [_r(1, 2, 4, 6)], [0], 2),
    "channel_shuffle": _fn("channel_shuffle", [_r(1, 6, 2, 2)], [0], 3),
    "affine_grid": _fn("affine_grid", [_r(2, 2, 3)], [0], [2, 3, 4, 5]),
    "affine_grid unaligned": _fn("affine_grid", [_r(2, 2, 3)], [0],
                                 [2, 3, 4, 5], align_corners=False),
    "cosine_similarity": _fn("cosine_similarity", [_r(3, 5), _r(3, 5)],
                             [0, 1], axis=1),
    "pairwise_distance": _fn("pairwise_distance", [_r(3, 5), _r(3, 5)],
                             [0, 1], p=3.0, keepdim=True),
    "bilinear": _fn("bilinear", [_r(3, 4), _r(3, 5), _r(2, 4, 5), _r(2)],
                    [0, 1, 2, 3]),
    "maxout": _fn("maxout", [_r(2, 6, 3)], [0], 3),
    "local_response_norm": _fn("local_response_norm", [_r(2, 5, 3, 3)],
                               [0], 3, alpha=0.1),
    "instance_norm": _fn("instance_norm", [_r(2, 3, 4, 4), None, None,
                                           _r(3), _r(3)][0:1], [0]),
    "temporal_shift": _fn("temporal_shift", [_r(4, 8, 2, 2)], [0], 2),
    "gather_tree": _fn("gather_tree", [R.randint(0, 9, (4, 2, 3)),
                                       R.randint(0, 3, (4, 2, 3))], []),
    "sequence_mask": _fn("sequence_mask", [np.array([1, 3, 0])], [], 4),
    "softmax_2d": _layer("Softmax2D", (), [_r(2, 3, 2, 2)], [0]),
    "flash_attention": dict(
        ref=lambda q, k, v: JF.flash_attention(jt(q), jt(k), jt(v),
                                               causal=True)[0],
        port=lambda q, k, v: PF.flash_attention(q, k, v, causal=True)[0],
        arrays=[QKV[:, :, 0], QKV[:, :, 1], QKV[:, :, 2]], diff=[0, 1, 2]),
    "flash_attn_qkvpacked": dict(
        ref=lambda qkv: JF.flash_attn_qkvpacked(jt(qkv)),
        port=lambda qkv: PF.flash_attn_qkvpacked(qkv),
        arrays=[QKV], diff=[0]),
    "flash_attn_varlen_qkvpacked": dict(
        ref=lambda qkv: JF.flash_attn_varlen_qkvpacked(
            jt(qkv), CU, CU, 6, 6, 0.2, causal=True),
        port=lambda qkv: PF.flash_attn_varlen_qkvpacked(
            qkv, torch.from_numpy(CU), torch.from_numpy(CU), 6, 6, 0.2,
            causal=True),
        arrays=[VARLEN], diff=[0]),
    "flash_attention_with_sparse_mask": dict(
        ref=lambda q, k, v, s: JF.flash_attention_with_sparse_mask(
            jt(q), jt(k), jt(v), attn_mask_start_row_indices=jt(s),
            is_causal=False),
        port=lambda q, k, v, s: PF.flash_attention_with_sparse_mask(
            q, k, v, attn_mask_start_row_indices=s, is_causal=False),
        arrays=[QKV[:, :, 0], QKV[:, :, 1], QKV[:, :, 2], STARTS],
        diff=[0, 1, 2]),
    "sparse_attention": dict(
        ref=lambda q, k, v: JF.sparse_attention(jt(q), jt(k), jt(v),
                                                CSR_OFFS, CSR_COLS),
        port=lambda q, k, v: PF.sparse_attention(
            q, k, v, torch.from_numpy(CSR_OFFS), torch.from_numpy(CSR_COLS)),
        arrays=[_r(1, 2, 8, 4), _r(1, 2, 8, 4), _r(1, 2, 8, 4)],
        diff=[0, 1, 2]),
    "fused_rotary_position_embedding": dict(
        ref=lambda q, k, v: JF.fused_rotary_position_embedding(
            jt(q), jt(k), jt(v), sin=jt(jnp.asarray(ROPE_SIN)),
            cos=jt(jnp.asarray(ROPE_COS)))[:2],
        port=lambda q, k, v: PF.fused_rotary_position_embedding(
            q, k, v, sin=torch.from_numpy(ROPE_SIN),
            cos=torch.from_numpy(ROPE_COS))[:2],
        arrays=[QKV[:, :, 0], QKV[:, :, 1], QKV[:, :, 2]], diff=[0, 1]),
}
for name in ("grid_sample", ):
    for mode in ("bilinear", "nearest"):
        for padding in ("zeros", "border", "reflection"):
            for align in (True, False):
                CASES[f"grid_sample {mode} {padding} {align}"] = _fn(
                    "grid_sample", [_r(2, 3, 5, 6),
                                    _r(2, 4, 3, 2, scale=0.8)],
                    [0] if mode == "nearest" else [0, 1], mode=mode,
                    padding_mode=padding, align_corners=align)
ACTS = {"CELU": (0.7,), "ELU": (0.5,), "GELU": (True,), "Hardshrink": (0.3,),
        "Hardsigmoid": (), "Hardswish": (), "Hardtanh": (-0.5, 0.7),
        "LeakyReLU": (0.2,), "LogSigmoid": (), "LogSoftmax": (0,),
        "Mish": (), "ReLU": (), "ReLU6": (), "SELU": (), "Sigmoid": (),
        "Silu": (), "Softmax": (1,), "Softplus": (2.0, 5.0),
        "Softshrink": (0.4,), "Softsign": (), "Swish": (), "Tanh": (),
        "Tanhshrink": (), "ThresholdedReLU": (0.3,)}
for name, args in ACTS.items():
    CASES[name] = _layer(name, args, [_r(3, 4, scale=3.0)], [0])
CASES.update({
    "PReLU": dict(ref=lambda x: jnn.PReLU(3, 0.1)(jt(x)),
                  port=lambda x: pnn.PReLU(3, 0.1)(x),
                  arrays=[_r(2, 3, 4)], diff=[0]),
    "Flatten": _layer("Flatten", (1, 2), [_r(2, 3, 4, 5)], [0]),
    "GLU": _layer("GLU", (1,), [_r(2, 6, 3)], [0]),
    "Pad1D reflect": _layer("Pad1D", ([2, 1], "reflect"), [_r(2, 3, 5)],
                            [0]),
    "Pad2D replicate": _layer("Pad2D", ([1, 2, 0, 1], "replicate"),
                              [_r(1, 2, 3, 4)], [0]),
    "Pad2D circular NHWC": _layer(
        "Pad2D", ([1, 1, 2, 0], "circular", 0.0, "NHWC"), [_r(1, 3, 4, 2)],
        [0]),
    "Pad3D constant": _layer("Pad3D", (1, "constant", 0.5),
                             [_r(1, 1, 2, 2, 2)], [0]),
    "ZeroPad2D": _layer("ZeroPad2D", ([0, 1, 2, 0],), [_r(1, 2, 2, 2)], [0]),
    "ZeroPad1D": _layer("ZeroPad1D", (2,), [_r(1, 2, 3)], [0]),
    "ZeroPad3D": _layer("ZeroPad3D", ([1, 0, 0, 1, 1, 1],),
                        [_r(1, 1, 2, 2, 2)], [0]),
    "Unflatten": _layer("Unflatten", (1, [2, 3]), [_r(2, 6, 2)], [0]),
    "Maxout": _layer("Maxout", (2,), [_r(2, 4, 3)], [0]),
    "AlphaDropout eval": _layer("AlphaDropout", (0.3,), [_r(3, 4)], [0]),
    "RReLU eval": _layer("RReLU", (), [_r(3, 4)], [0]),
    "Dropout3D eval": _layer("Dropout3D", (0.4,), [_r(1, 2, 2, 2, 2)], [0]),
    "FeatureAlphaDropout eval": _layer("FeatureAlphaDropout", (0.4,),
                                       [_r(2, 3, 4)], [0]),
    "LocalResponseNorm": _layer("LocalResponseNorm", (3, 0.1),
                                [_r(2, 5, 2, 2)], [0]),
    "InstanceNorm3D": _layer("InstanceNorm3D", (2,), [_r(2, 2, 2, 3, 3)],
                             [0]),
    "PixelShuffle": _layer("PixelShuffle", (2,), [_r(1, 8, 2, 2)], [0]),
    "PixelUnshuffle": _layer("PixelUnshuffle", (2,), [_r(1, 2, 4, 4)], [0]),
    "ChannelShuffle": _layer("ChannelShuffle", (2,), [_r(1, 4, 2, 2)], [0]),
    "GridSampler": _layer("GridSampler", ("bilinear", "border", False),
                          [_r(1, 2, 3, 4), _r(1, 2, 2, 2, scale=0.7)],
                          [0, 1]),
    "Fold": _layer("Fold", ([3, 3], 2), [_r(1, 8, 4)], [0]),
    "Unfold": _layer("Unfold", (2, 1, 1), [_r(1, 2, 3, 3)], [0]),
    "UpsamplingNearest2D": _layer("UpsamplingNearest2D", (None, 2),
                                  [_r(1, 2, 3, 3)], [0]),
    "UpsamplingBilinear2D": _layer("UpsamplingBilinear2D", ([5, 4],),
                                   [_r(1, 2, 3, 3)], [0]),
    "CosineSimilarity": _layer("CosineSimilarity", (0,),
                               [_r(4, 3), _r(4, 3)], [0, 1]),
    "PairwiseDistance": _layer("PairwiseDistance", (1.5,),
                               [_r(4, 3), _r(4, 3)], [0, 1]),
})


@pytest.fixture(scope="module")
def ref_out():
    return run_ref(CASES)


@pytest.mark.parametrize("name", list(CASES))
def test_matches_reference(name, ref_out):
    check(name, CASES, ref_out, 1e-5)


@pytest.mark.parametrize("fn", ["relu_", "tanh_", "elu_", "hardtanh_",
                                "leaky_relu_", "softmax_",
                                "thresholded_relu_"])
def test_inplace_activations(fn):
    x = _r(3, 4)
    t = torch.from_numpy(x.copy())
    out = getattr(PF, fn)(t)
    assert out is t
    want = getattr(JF, fn[:-1])(ref.to_tensor(x)).numpy()
    close(t.numpy(), want, 1e-6)


# -- the attention routes -----------------------------------------------------------

@pytest.mark.parametrize("case", [
    ("flash_attention causal S=1024 D=128", "long", 1024, 128, 0.0, True),
    ("flash_attention dropout S=256 D=64", "short", 256, 64, 0.1, True),
    ("flash_attn_qkvpacked S=512 D=128", "short", 512, 128, 0.0, False),
    ("masked", "einsum", 256, 64, 0.0, True),
])
def test_entry_points_reach_the_kernels(case, monkeypatch):
    """With the CPU taken for an accelerator, ``F.flash_attention`` and
    ``F.flash_attn_qkvpacked`` reach the ``long_attention`` /
    ``short_attention`` wrappers as the card's route would (their plain
    versions run here); without dropout each equals the einsum route."""
    from paddle_tpu_torch.ops.kernels import long_attention as la
    from paddle_tpu_torch.ops.kernels import short_attention as sa

    tag, route, S, D, p, causal = case
    calls = []
    for mod, name in ((la, "long_attention"), (sa, "short_attention")):
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _r=real, _n=name, **k:
                            calls.append(_n) or _r(*a, **k))
    rng = np.random.RandomState(1)
    qkv = torch.from_numpy(rng.randn(1, S, 3, 2, D).astype(np.float32))
    want = nn_ops.sdpa(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2],
                       causal=causal, impl="einsum")
    monkeypatch.setattr(nn_ops, "_accelerated", lambda device: True)
    paddle.seed(0)
    if tag == "masked":
        got = PF.flash_attention_with_sparse_mask(
            qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2],
            attn_mask_start_row_indices=torch.zeros(1, S, dtype=torch.long))
    elif "qkvpacked" in tag:
        got = PF.flash_attn_qkvpacked(qkv, dropout=p, causal=causal)
    else:
        got, _ = PF.flash_attention(qkv[:, :, 0], qkv[:, :, 1],
                                    qkv[:, :, 2], dropout=p, causal=causal)
    assert calls == ([] if route == "einsum" else [f"{route}_attention"])
    if p == 0.0:
        close(got.numpy(), want.numpy(), 2e-5)
    else:
        paddle.seed(0)
        again, _ = PF.flash_attention(qkv[:, :, 0], qkv[:, :, 1],
                                      qkv[:, :, 2], dropout=p, causal=causal)
        assert torch.equal(got, again)


# -- random ops ---------------------------------------------------------------------

def test_channel_dropouts_and_alpha_dropout():
    paddle.seed(3)
    x = torch.ones(64, 32, 3, 3)
    y = PF.dropout2d(x, 0.25)
    per_channel = y.reshape(64, 32, -1)
    assert ((per_channel == 0).all(-1) | (per_channel == 1 / 0.75).all(-1)
            ).all()
    keep = float((per_channel[..., 0] != 0).float().mean())
    assert abs(keep - 0.75) < 6 * (0.75 * 0.25 / 2048) ** 0.5
    y3 = PF.dropout3d(torch.ones(16, 8, 2, 2, 2), 0.5)
    assert ((y3 == 0) | (y3 == 2)).all()
    assert torch.equal(PF.dropout2d(x, 0.25, training=False), x)
    z = torch.randn(200000)
    a = PF.alpha_dropout(torch.nn.functional.selu(z), 0.2)
    assert abs(float(a.mean())) < 0.02 and abs(float(a.std()) - 1) < 0.02
    f = PF.feature_alpha_dropout(torch.ones(8, 16, 5), 0.5)
    assert (f == f[..., :1]).all()
    paddle.seed(3)
    again = PF.dropout2d(x, 0.25)
    assert torch.equal(y, again)
    g = torch.Generator().manual_seed(0)
    assert PF.dropout(x, 0.5, generator=g).shape == x.shape
    d = pnn.Dropout(0.5)
    d.eval()
    assert torch.equal(d(x), x)


def test_rrelu_gumbel_softmax_and_class_center_sample():
    paddle.seed(4)
    x = -torch.ones(10000)
    y = PF.rrelu(x, 0.1, 0.3)
    assert float(y.max()) <= -0.1 and float(y.min()) >= -0.3
    assert torch.equal(PF.rrelu(x, 0.1, 0.3, training=False),
                       torch.full_like(x, -0.2))
    logits = torch.randn(6, 5)
    soft = PF.gumbel_softmax(logits, 0.5)
    close(soft.sum(-1).numpy(), np.ones(6), 1e-6)
    hard = PF.gumbel_softmax(logits, hard=True)
    assert ((hard == 0) | (hard == 1)).all() and (hard.sum(-1) == 1).all()
    label = torch.tensor([7, 2, 7, 9])
    remapped, centers = PF.class_center_sample(label, 20, 6)
    assert len(centers) == 6 and {2, 7, 9} <= set(centers.tolist())
    assert torch.equal(centers[remapped], label)
    r_remapped, r_centers = JF.class_center_sample(
        ref.to_tensor(label.numpy()), 20, 6)
    assert len(r_centers.numpy()) == 6


# -- nn.utils and the stateful layers -------------------------------------------------

def _lin(nn, seed=0):
    rng = np.random.RandomState(seed)
    layer = nn.Linear(4, 3)
    layer.set_state_dict({"weight": rng.randn(4, 3).astype(np.float32),
                          "bias": rng.randn(3).astype(np.float32)})
    return layer


def test_weight_norm_spectral_norm_and_back():
    x = _r(2, 4)
    for dim in (0, 1, None):
        r = jnn.utils.weight_norm(_lin(jnn), dim=dim)
        p = pnn.utils.weight_norm(_lin(pnn), dim=dim)
        assert sorted(p.state_dict()) == sorted(r.state_dict())
        close(p(torch.from_numpy(x)).detach().numpy(),
              r(ref.to_tensor(x)).numpy(), 1e-5)
        out = p(torch.from_numpy(x)).sum()
        out.backward()
        assert p.weight_g.grad is not None and p.weight_v.grad is not None
    pnn.utils.remove_weight_norm(p)
    close(p(torch.from_numpy(x)).detach().numpy(),
          _lin(pnn)(torch.from_numpy(x)).detach().numpy(), 1e-5)
    r = jnn.utils.spectral_norm(_lin(jnn), n_power_iterations=2)
    p = pnn.utils.spectral_norm(_lin(pnn), n_power_iterations=2)
    assert sorted(p.state_dict()) == sorted(r.state_dict())
    close(p(torch.from_numpy(x)).detach().numpy(),
          r(ref.to_tensor(x)).numpy(), 1e-5)
    w = _r(6, 2, 3)
    rs, ps = jnn.SpectralNorm(w.shape, dim=1), pnn.SpectralNorm(w.shape,
                                                                 dim=1)
    close(ps(torch.from_numpy(w)).detach().numpy(),
          rs(ref.to_tensor(w)).numpy(), 1e-5)
    close(ps.weight_u.numpy(), rs.weight_u.numpy(), 1e-5)


def test_clip_and_vector_helpers():
    rl, pl = _lin(jnn), _lin(pnn)
    x = _r(5, 4)
    for layer, wrap in ((rl, ref.to_tensor), (pl, torch.from_numpy)):
        (layer(wrap(x)) ** 2).sum().backward()
    for norm_type in (2.0, float("inf")):
        rt = jnn.utils.clip_grad_norm_(rl.parameters(), 1.0, norm_type)
        pt = pnn.utils.clip_grad_norm_(pl.parameters(), 1.0, norm_type)
        close(pt.numpy(), np.asarray(rt.numpy()), 1e-5)
    for rp, pp in zip(rl.parameters(), pl.parameters()):
        close(pp.grad.numpy(), rp.grad.numpy(), 1e-5)
    jnn.utils.clip_grad_value_(rl.parameters(), 0.01)
    pnn.utils.clip_grad_value_(pl.parameters(), 0.01)
    for rp, pp in zip(rl.parameters(), pl.parameters()):
        close(pp.grad.numpy(), rp.grad.numpy(), 1e-7)
    vec = pnn.utils.parameters_to_vector(pl.parameters())
    close(vec.detach().numpy(),
          jnn.utils.parameters_to_vector(rl.parameters()).numpy(), 0)
    pnn.utils.vector_to_parameters(vec * 2, pl.parameters())
    close(pl.weight.detach().numpy(), 2 * rl.weight.numpy(), 1e-7)


def test_bilinear_and_beam_search_carry_across():
    rb, pb = jnn.Bilinear(3, 4, 2), pnn.Bilinear(3, 4, 2)
    assert pb.set_state_dict(rb.state_dict()) == ([], [])
    a, b = _r(5, 3), _r(5, 4)
    close(pb(torch.from_numpy(a), torch.from_numpy(b)).detach().numpy(),
          rb(ref.to_tensor(a), ref.to_tensor(b)).numpy(), 1e-5)
    V, Hd = 7, 6

    def parts(nn):
        return nn.Embedding(V, Hd), nn.GRUCell(Hd, Hd), nn.Linear(Hd, V)

    rp, pp = parts(jnn), parts(pnn)
    for r, p in zip(rp, pp):
        assert p.set_state_dict(r.state_dict()) == ([], [])
    init = _r(2, Hd)
    ids_r, sc_r = jnn.dynamic_decode(
        jnn.BeamSearchDecoder(rp[1], 0, 6, 3, embedding_fn=rp[0],
                              output_fn=rp[2]),
        inits=ref.to_tensor(init), max_step_num=5, batch_size=2)
    ids_p, sc_p = pnn.dynamic_decode(
        pnn.BeamSearchDecoder(pp[1], 0, 6, 3, embedding_fn=pp[0],
                              output_fn=pp[2]),
        inits=torch.from_numpy(init), max_step_num=5, batch_size=2)
    assert np.array_equal(ids_p.numpy(), ids_r.numpy())
    close(sc_p.numpy(), sc_r.numpy(), 1e-5)
