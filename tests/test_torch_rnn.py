"""The recurrent layers of the port (``paddle_tpu_torch/nn/rnn.py``)
against ``paddle_tpu``'s on the CPU: the cells, ``RNN`` / ``BiRNN`` over
cells and the stacked ``SimpleRNN`` / ``LSTM`` / ``GRU`` (layers,
directions, ``time_major``, initial states, bias-free attrs).  Both
sides get the same parameters by name (the reference's state-dict names,
which the port keeps) and the same input; outputs, final states and the
gradients of the input and of every parameter are compared
(``tests/torch_nn_harness.py``), the reference's side of every case in
one ``jax.jit``.  Mirrors ``tests/test_rnn.py``'s cases.

Tolerance: within 1e-5 of the largest magnitude (at least 1), fp32 on
both sides (the port projects all steps' inputs in one matmul).
"""
import numpy as np
import pytest
import torch

import jax

import paddle_tpu_torch as paddle
from paddle_tpu import nn as jnn
from paddle_tpu.core.tensor import Tensor
from paddle_tpu_torch import nn as pnn

from torch_nn_harness import check, concrete_key, run_ref


@pytest.fixture(autouse=True)
def _cpu_place():
    prev = paddle.get_device()
    paddle.set_device("cpu")
    yield
    paddle.set_device(prev)


I, H, B, T = 5, 6, 3, 4

LAYERS = {
    "SimpleRNNCell": (lambda nn: nn.SimpleRNNCell(I, H), "cell", 0),
    "SimpleRNNCell relu state": (
        lambda nn: nn.SimpleRNNCell(I, H, activation="relu"), "cell", 1),
    "LSTMCell": (lambda nn: nn.LSTMCell(I, H), "cell", 0),
    "LSTMCell state": (lambda nn: nn.LSTMCell(I, H), "cell", 2),
    "GRUCell": (lambda nn: nn.GRUCell(I, H), "cell", 0),
    "GRUCell no bias_hh": (lambda nn: nn.GRUCell(I, H, bias_hh_attr=False),
                           "cell", 1),
    "RNN(LSTMCell)": (lambda nn: nn.RNN(nn.LSTMCell(I, H)), "seq", 0),
    "RNN(GRUCell) reverse time_major": (
        lambda nn: nn.RNN(nn.GRUCell(I, H), is_reverse=True,
                          time_major=True), "seq_tm", 0),
    "BiRNN": (lambda nn: nn.BiRNN(nn.SimpleRNNCell(I, H),
                                  nn.SimpleRNNCell(I, H)), "seq", 0),
    "SimpleRNN 2 layers relu": (
        lambda nn: nn.SimpleRNN(I, H, 2, activation="relu"), "seq", 0),
    "LSTM": (lambda nn: nn.LSTM(I, H), "seq", 0),
    "LSTM 2 layers bidirect": (
        lambda nn: nn.LSTM(I, H, 2, direction="bidirect"), "seq", 0),
    "LSTM 2 layers states": (lambda nn: nn.LSTM(I, H, 2), "seq", 2),
    "GRU time_major": (lambda nn: nn.GRU(I, H, 2, time_major=True),
                       "seq_tm", 0),
    "GRU bidirectional states": (
        lambda nn: nn.GRU(I, H, 1, direction="bidirectional"), "seq", 1),
    "SimpleRNN no input bias": (
        lambda nn: nn.SimpleRNN(I, H, bias_ih_attr=False), "seq", 0),
}


def _state_shapes():
    concrete_key()
    shapes = jax.eval_shape(lambda: {
        n: {k: v._data for k, v in make(jnn).state_dict().items()}
        for n, (make, _, _) in LAYERS.items()})
    return jax.tree_util.tree_map(lambda v: tuple(v.shape), shapes)


def _states_arg(kind, n_states, layer_dirs):
    """The initial states' shapes: a cell's ``[B, H]`` (two for an
    LSTM cell), a stacked layer's ``[layers * dirs, B, H]``."""
    shape = (B, H) if kind == "cell" else (layer_dirs, B, H)
    return [shape] * n_states


def _ref_forward(make, keys, kind, n_states):
    def run(x, *rest):
        states, params = rest[:n_states], rest[n_states:]
        layer = make(jnn)
        own = dict(layer.named_parameters())
        for k, p in zip(keys, params):
            own[k]._data = p
        st = [Tensor(s) for s in states]
        st = (None if not st else st[0] if len(st) == 1 else tuple(st))
        return layer(Tensor(x), st)
    return run


def _port_forward(make, keys, n_states):
    def run(x, *rest):
        states, params = rest[:n_states], rest[n_states:]
        layer = make(pnn)
        st = (None if not states else states[0] if len(states) == 1
              else tuple(states))
        return torch.func.functional_call(layer, dict(zip(keys, params)),
                                          (x, st))
    return run


def _cases():
    shapes = _state_shapes()
    rng = np.random.RandomState(3)
    cases = {}
    for name, (make, kind, n_states) in LAYERS.items():
        keys = list(shapes[name])
        params = [(rng.randn(*shapes[name][k]) * 0.4).astype(np.float32)
                  for k in keys]
        xs = (B, I) if kind == "cell" else (
            (T, B, I) if kind == "seq_tm" else (B, T, I))
        layer_dirs = sum(1 for k in keys if k.startswith("weight_ih"))
        states = [rng.randn(*s).astype(np.float32)
                  for s in _states_arg(kind, n_states, layer_dirs)]
        arrays = [rng.randn(*xs).astype(np.float32)] + states + params
        cases[name] = dict(
            ref=_ref_forward(make, keys, kind, n_states),
            port=_port_forward(make, keys, n_states), arrays=arrays,
            diff=list(range(len(arrays))), keys=keys)
    return cases


CASES = _cases()


@pytest.fixture(scope="module")
def ref_out():
    return run_ref(CASES)


@pytest.mark.parametrize("name", list(CASES))
def test_rnn_matches_reference(name, ref_out):
    make = LAYERS[name][0]
    port = make(pnn)
    assert isinstance(port, pnn.Layer)
    assert sorted(port.state_dict()) == sorted(CASES[name]["keys"])
    check(name, CASES, ref_out, 1e-5)


def test_weights_carry_across_and_dropout_between_layers():
    """The reference's state-dict names load into the port's LSTM by
    ``set_state_dict`` (the outputs on them are held above); in eval
    mode ``dropout`` is off, in training it changes the output, drawing
    from the port's generator (``paddle.seed`` repeats it)."""
    concrete_key()
    shapes = jax.eval_shape(lambda: {
        k: v._data for k, v in jnn.LSTM(I, H, 2, dropout=0.5)
        .state_dict().items()})
    rng = np.random.RandomState(0)
    state = {k: rng.randn(*v.shape).astype(np.float32) * 0.4
             for k, v in shapes.items()}
    p = pnn.LSTM(I, H, 2, dropout=0.5)
    assert p.set_state_dict(state) == ([], [])
    x = torch.from_numpy(rng.randn(B, T, I).astype(np.float32))
    p.eval()
    y_eval = p(x)[0]
    torch.testing.assert_close(y_eval, p(x)[0], rtol=0, atol=0)
    p.train()
    paddle.seed(5)
    y1 = p(x)[0]
    paddle.seed(5)
    y2 = p(x)[0]
    assert torch.equal(y1, y2) and not torch.allclose(y1, y_eval)
