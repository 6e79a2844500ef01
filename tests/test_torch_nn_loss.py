"""The losses of the port (``nn.functional``'s, ``.extended``'s and the
loss layers of ``nn/loss.py`` and ``nn/layers_nd.py``) against
``paddle_tpu``'s on the CPU, the same seeded numpy inputs on both
sides: values and the gradients of a fixed weighted sum of the outputs
(``tests/torch_nn_harness.py``), the reference's side of every case in
one ``jax.jit``.  Mirrors what ``tests/test_nn_extended.py`` and
``tests/test_nn_nd_tail.py`` check of the reference.

Tolerance: within 1e-5 of the largest magnitude (at least 1), fp32 on
both sides (sums in other orders; the CTC and RNN-T recursions 1e-4).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as ref
import paddle_tpu_torch as paddle
from paddle_tpu import nn as jnn
from paddle_tpu.nn import functional as JF
from paddle_tpu_torch import nn as pnn
from paddle_tpu_torch.nn import functional as PF

from torch_nn_harness import check, jt, run_ref

R = np.random.RandomState(11)


@pytest.fixture(autouse=True)
def _cpu_place():
    prev = paddle.get_device()
    paddle.set_device("cpu")
    yield
    paddle.set_device(prev)


def _r(*s, scale=1.0):
    return (R.randn(*s) * scale).astype(np.float32)


def _u(*s, lo=0.05, hi=0.95):
    return R.uniform(lo, hi, s).astype(np.float32)


def _i(hi, *s):
    return R.randint(0, hi, s).astype(np.int64)


def _pm1(*s):
    return np.where(R.rand(*s) > 0.5, 1.0, -1.0).astype(np.float32)


def _fn(name, arrays, diff, **kw):
    """A case of ``F.<name>(*arrays, **kw)`` on both sides."""
    return dict(ref=lambda *a: getattr(JF, name)(*map(jt, a), **kw),
                port=lambda *a: getattr(PF, name)(*a, **kw),
                arrays=arrays, diff=diff)


def _layer(name, ctor_args, arrays, diff, **kw):
    """A case of ``nn.<name>(*ctor_args, **kw)(*arrays)``."""
    return dict(ref=lambda *a: getattr(jnn, name)(*ctor_args, **kw)(
        *map(jt, a)),
        port=lambda *a: getattr(pnn, name)(*ctor_args, **kw)(*a),
        arrays=arrays, diff=diff)


CASES = {}
for red in ("mean", "sum", "none"):
    CASES[f"mse_loss {red}"] = _fn("mse_loss", [_r(4, 5), _r(4, 5)], [0, 1],
                                   reduction=red)
    CASES[f"l1_loss {red}"] = _fn("l1_loss", [_r(4, 5), _r(4, 5)], [0],
                                  reduction=red)
    CASES[f"smooth_l1_loss {red}"] = _fn(
        "smooth_l1_loss", [_r(4, 5), _r(4, 5)], [0], reduction=red,
        delta=0.7)
    CASES[f"binary_cross_entropy {red}"] = _fn(
        "binary_cross_entropy", [_u(6), _u(6, lo=0, hi=1)], [0],
        reduction=red)
    CASES[f"kl_div {red}"] = _fn("kl_div", [_r(3, 4), _u(3, 4)], [0, 1],
                                 reduction=red)
CASES.update({
    "cross_entropy weighted": _fn(
        "cross_entropy", [_r(6, 5), _i(5, 6), _u(5)], [0]),
    "cross_entropy smoothed": _fn(
        "cross_entropy", [_r(6, 5), _i(5, 6)], [0], label_smoothing=0.1),
    "cross_entropy ignore": _fn(
        "cross_entropy", [_r(6, 5), np.array([1, 2, 0, 3, 1, 2])], [0],
        ignore_index=1),
    "softmax_with_cross_entropy": _fn(
        "softmax_with_cross_entropy", [_r(6, 5), _i(5, 6, 1)], [0],
        return_softmax=True),
    "softmax_with_cross_entropy soft": _fn(
        "softmax_with_cross_entropy", [_r(6, 5), _u(6, 5)], [0],
        soft_label=True),
    "nll_loss": _fn("nll_loss", [_r(6, 5), _i(5, 6), _u(5)], [0]),
    "kl_div batchmean log_target": _fn(
        "kl_div", [_r(3, 4), _r(3, 4)], [0, 1], reduction="batchmean",
        log_target=True),
    "log_loss": _fn("log_loss", [_u(5, 1), _u(5, 1, lo=0, hi=1)], [0]),
    "bce_with_logits pos_weight": dict(
        ref=lambda x, y, w, pw: JF.binary_cross_entropy_with_logits(
            jt(x), jt(y), jt(w), pos_weight=jt(pw)),
        port=lambda x, y, w, pw: PF.binary_cross_entropy_with_logits(
            x, y, w, pos_weight=pw),
        arrays=[_r(4, 3), _u(4, 3), _u(4, 3), _u(3)], diff=[0]),
    "dice_loss": _fn("dice_loss", [_u(3, 4, 5), _i(5, 3, 4, 1)], [0]),
    "sigmoid_focal_loss": _fn("sigmoid_focal_loss",
                              [_r(4, 3), _u(4, 3, lo=0, hi=1), _u(1) + 1],
                              [0], reduction="mean"),
    "multi_margin_loss": dict(
        ref=lambda x, y, w: JF.multi_margin_loss(jt(x), jt(y), 2, 0.5,
                                                 jt(w)),
        port=lambda x, y, w: PF.multi_margin_loss(x, y, 2, 0.5, w),
        arrays=[_r(5, 4), _i(4, 5), _u(4)], diff=[0]),
    "hsigmoid_loss": dict(
        ref=lambda x, y, w, b: JF.hsigmoid_loss(jt(x), jt(y), 7, jt(w),
                                                jt(b)),
        port=lambda x, y, w, b: PF.hsigmoid_loss(x, y, 7, w, b),
        arrays=[_r(4, 6), _i(7, 4), _r(6, 6), _r(6)], diff=[0, 2, 3]),
    "margin_cross_entropy": _fn(
        "margin_cross_entropy", [_u(4, 6, lo=-0.9, hi=0.9), _i(6, 4)], [0],
        return_softmax=True, scale=8.0),
    "adaptive_log_softmax_with_loss": dict(
        ref=lambda x, y, hw, p0, e0, p1, e1, hb: JF.
        adaptive_log_softmax_with_loss(
            jt(x), jt(y), jt(hw), [[jt(p0), jt(e0)], [jt(p1), jt(e1)]],
            [4, 8, 12], jt(hb)),
        port=lambda x, y, hw, p0, e0, p1, e1, hb: PF.
        adaptive_log_softmax_with_loss(x, y, hw, [[p0, e0], [p1, e1]],
                                       [4, 8, 12], hb),
        arrays=[_r(6, 8), np.array([0, 3, 5, 9, 11, 7]), _r(6, 8), _r(4, 8),
                _r(4, 4), _r(2, 8), _r(4, 2), _r(6)],
        diff=[0, 2, 3, 4, 5, 6, 7]),
    "triplet_margin_with_distance_loss": _fn(
        "triplet_margin_with_distance_loss", [_r(4, 5), _r(4, 5), _r(4, 5)],
        [0, 1, 2], swap=True),
    "rnnt_loss": _fn("rnnt_loss", [_r(2, 5, 4, 6), _i(5, 2, 3) + 1,
                                   np.array([5, 4]), np.array([3, 2])],
                     [0]),
    "rnnt_loss no fastemit": _fn(
        "rnnt_loss", [_r(2, 4, 3, 5), _i(4, 2, 2) + 1, np.array([4, 3]),
                      np.array([2, 1])], [0], fastemit_lambda=0.0,
        reduction="none"),
    # extended
    "ctc_loss": _fn("ctc_loss", [_r(8, 2, 5), _i(4, 2, 3) + 1,
                                 np.array([8, 6]), np.array([3, 2])], [0]),
    "ctc_loss sum norm_by_times": _fn(
        "ctc_loss", [_r(7, 3, 4), _i(3, 3, 2) + 1, np.array([7, 5, 6]),
                     np.array([2, 1, 2])], [0], reduction="sum",
        norm_by_times=True),
    "margin_ranking_loss": _fn("margin_ranking_loss",
                               [_r(6), _r(6), _pm1(6)], [0, 1], margin=0.3),
    "triplet_margin_loss": _fn("triplet_margin_loss",
                               [_r(4, 5), _r(4, 5), _r(4, 5)], [0, 1, 2],
                               p=1.5, swap=True),
    "cosine_embedding_loss": _fn("cosine_embedding_loss",
                                 [_r(4, 5), _r(4, 5), _pm1(4)], [0, 1],
                                 margin=0.2),
    "hinge_embedding_loss": _fn("hinge_embedding_loss", [_r(6), _pm1(6)],
                                [0]),
    "soft_margin_loss": _fn("soft_margin_loss", [_r(6), _pm1(6)], [0]),
    "multi_label_soft_margin_loss": _fn(
        "multi_label_soft_margin_loss",
        [_r(3, 4), (R.rand(3, 4) > 0.5).astype(np.float32), _u(4)], [0]),
    "poisson_nll_loss": _fn("poisson_nll_loss", [_r(6), _u(6) * 4], [0],
                            full=True),
    "poisson_nll_loss linear": _fn("poisson_nll_loss", [_u(6), _u(6)], [0],
                                   log_input=False),
    "gaussian_nll_loss": _fn("gaussian_nll_loss", [_r(5), _r(5), _u(5)],
                             [0, 2], full=True),
    "square_error_cost": _fn("square_error_cost", [_r(3, 2), _r(3, 2)],
                             [0]),
    "npair_loss": _fn("npair_loss", [_r(4, 3), _r(4, 3), _i(2, 4)], [0, 1]),
    # layers
    "CrossEntropyLoss": _layer("CrossEntropyLoss", (), [_r(4, 3), _i(3, 4)],
                               [0]),
    "MSELoss": _layer("MSELoss", ("sum",), [_r(3), _r(3)], [0]),
    "L1Loss": _layer("L1Loss", (), [_r(3), _r(3)], [0]),
    "SmoothL1Loss": _layer("SmoothL1Loss", ("mean", 0.5), [_r(4), _r(4)],
                           [0]),
    "NLLLoss": _layer("NLLLoss", (), [_r(4, 3), _i(3, 4)], [0]),
    "BCELoss": _layer("BCELoss", (), [_u(4), _u(4, lo=0, hi=1)], [0]),
    "BCEWithLogitsLoss": _layer("BCEWithLogitsLoss", (),
                                [_r(4), _u(4, lo=0, hi=1)], [0]),
    "KLDivLoss": _layer("KLDivLoss", ("sum",), [_r(4), _u(4)], [0]),
    "CTCLoss": _layer("CTCLoss", (0, "sum"), [_r(6, 2, 4), _i(3, 2, 2) + 1,
                                             np.array([6, 5]),
                                             np.array([2, 2])], [0]),
    "MarginRankingLoss": _layer("MarginRankingLoss", (0.1,),
                                [_r(4), _r(4), _pm1(4)], [0]),
    "TripletMarginLoss": _layer("TripletMarginLoss", (),
                                [_r(3, 4), _r(3, 4), _r(3, 4)], [0]),
    "CosineEmbeddingLoss": _layer("CosineEmbeddingLoss", (),
                                  [_r(3, 4), _r(3, 4), _pm1(3)], [0]),
    "HingeEmbeddingLoss": _layer("HingeEmbeddingLoss", (2.0,),
                                 [_r(5), _pm1(5)], [0]),
    "SoftMarginLoss": _layer("SoftMarginLoss", (), [_r(5), _pm1(5)], [0]),
    "MultiLabelSoftMarginLoss": _layer(
        "MultiLabelSoftMarginLoss", (),
        [_r(3, 4), (R.rand(3, 4) > 0.5).astype(np.float32)], [0]),
    "PoissonNLLLoss": _layer("PoissonNLLLoss", (), [_r(5), _u(5)], [0]),
    "GaussianNLLLoss": _layer("GaussianNLLLoss", (),
                              [_r(5), _r(5), _u(5)], [0]),
    "MultiMarginLoss": _layer("MultiMarginLoss", (), [_r(4, 3), _i(3, 4)],
                              [0]),
    "TripletMarginWithDistanceLoss": _layer(
        "TripletMarginWithDistanceLoss", (),
        [_r(3, 4), _r(3, 4), _r(3, 4)], [0]),
    "RNNTLoss": _layer("RNNTLoss", (), [_r(1, 3, 3, 4), _i(3, 1, 2) + 1,
                                       np.array([3]), np.array([2])], [0]),
})

LOOSE = {"ctc_loss", "ctc_loss sum norm_by_times", "CTCLoss", "rnnt_loss",
         "rnnt_loss no fastemit", "RNNTLoss"}


@pytest.fixture(scope="module")
def ref_out():
    return run_ref(CASES)


@pytest.mark.parametrize("name", list(CASES))
def test_loss_matches_reference(name, ref_out):
    check(name, CASES, ref_out, 1e-4 if name in LOOSE else 1e-5)


def _state(layer):
    return {k: v.numpy() for k, v in layer.state_dict().items()}


def test_parametrised_loss_layers_carry_weights_across():
    """``HSigmoidLoss`` and ``AdaptiveLogSoftmaxWithLoss``: the
    reference's parameters (its ``state_dict()``) load into the port by
    the same names and give the same loss."""
    rng = np.random.RandomState(2)
    x = rng.randn(6, 8).astype(np.float32)
    y = np.array([0, 3, 5, 9, 11, 7])
    for make in (lambda nn: nn.HSigmoidLoss(8, 12),
                 lambda nn: nn.AdaptiveLogSoftmaxWithLoss(
                     8, 12, [4, 8], div_value=2.0, head_bias=True)):
        r, p = make(jnn), make(pnn)
        assert list(p.state_dict()) == list(r.state_dict())
        assert p.set_state_dict(r.state_dict()) == ([], [])
        want = r(ref.to_tensor(x), ref.to_tensor(y))
        got = p(torch.from_numpy(x), torch.from_numpy(y))
        if isinstance(want, tuple):
            for g, w in zip(got, want):
                np.testing.assert_allclose(g.detach().numpy(), w.numpy(),
                                           rtol=0, atol=1e-5)
        else:
            np.testing.assert_allclose(got.detach().numpy(), want.numpy(),
                                       rtol=0, atol=1e-5)
