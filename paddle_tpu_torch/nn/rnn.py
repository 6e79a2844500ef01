"""Recurrent layers.  Counterpart of ``paddle_tpu/nn/rnn.py``
(``SimpleRNNCell``, ``LSTMCell``, ``GRUCell``, ``RNN``, ``BiRNN`` and the
multi-layer ``SimpleRNN`` / ``LSTM`` / ``GRU``) with its parameter names
(``weight_ih`` / ``weight_hh`` / ``bias_ih`` / ``bias_hh`` per cell;
``weight_ih_l0``, ``..._l0_reverse`` in the stacked layers), its
U(-1/sqrt(hidden), 1/sqrt(hidden)) initialisation, its gate order and
its zero initial states, so state dicts carry across unchanged.  Gates:
LSTM chunks (i, f, g, o); GRU chunks (r, z, c) with ``h = (h_prev - c)
* z + c`` and the reset applied after the recurrent matmul.

The reference scans each (layer, direction) with ``lax.scan``; here the
input projection of all steps is one matmul and the recurrence a loop
over time in eager PyTorch (autograd gives the backward).
"""
from __future__ import annotations

import math

import torch

from . import functional as F
from . import initializer as I
from .layers import Layer

_GATES = {"simple": 1, "lstm": 4, "gru": 3}


def _step(mode, act, xg, h, c, w_hh, b_hh):
    """One time step from the projected input ``xg = x @ w_ih.T + b_ih``:
    ``(h, c)`` (``c`` unchanged but for the LSTM)."""
    hg = h @ w_hh.t()
    if mode == "lstm":
        i, f, g, o = torch.chunk(xg + hg + b_hh, 4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        return torch.sigmoid(o) * torch.tanh(c), c
    if mode == "gru":
        hg = hg + b_hh
        x_r, x_z, x_c = torch.chunk(xg, 3, dim=-1)
        h_r, h_z, h_c = torch.chunk(hg, 3, dim=-1)
        r = torch.sigmoid(x_r + h_r)
        z = torch.sigmoid(x_z + h_z)
        cand = torch.tanh(x_c + r * h_c)
        return (h - cand) * z + cand, c
    out = xg + hg + b_hh
    return (torch.tanh(out) if act == "tanh" else torch.relu(out)), c


def _bias(b, n, like):
    return b if b is not None else like.new_zeros(n)


class RNNCellBase(Layer):
    MODE = "simple"

    def _make_weights(self, input_size, hidden_size, weight_ih_attr=None,
                      weight_hh_attr=None, bias_ih_attr=None,
                      bias_hh_attr=None, device=None, dtype=None,
                      generator=None):
        n = _GATES[self.MODE] * hidden_size
        std = 1.0 / math.sqrt(hidden_size)
        kw = dict(default_initializer=I.Uniform(-std, std), device=device,
                  dtype=dtype, generator=generator)
        self.weight_ih = self.create_parameter([n, input_size],
                                               attr=weight_ih_attr, **kw)
        self.weight_hh = self.create_parameter([n, hidden_size],
                                               attr=weight_hh_attr, **kw)
        self.bias_ih = self.create_parameter([n], attr=bias_ih_attr,
                                             is_bias=True, **kw)
        self.bias_hh = self.create_parameter([n], attr=bias_hh_attr,
                                             is_bias=True, **kw)

    def _zeros(self, inputs):
        return inputs.new_zeros(inputs.shape[0], self.hidden_size)

    def _cell(self, inputs, h, c):
        n = _GATES[self.MODE] * self.hidden_size
        xg = inputs @ self.weight_ih.t() + _bias(self.bias_ih, n, inputs)
        return _step(self.MODE, getattr(self, "activation", "tanh"), xg, h,
                     c, self.weight_hh, _bias(self.bias_hh, n, inputs))


class SimpleRNNCell(RNNCellBase):
    def __init__(self, input_size, hidden_size, activation="tanh",
                 weight_ih_attr=None, weight_hh_attr=None, bias_ih_attr=None,
                 bias_hh_attr=None, name=None, *, device=None, dtype=None,
                 generator=None):
        super().__init__()
        if activation not in ("tanh", "relu"):
            raise ValueError("activation must be tanh or relu")
        self.input_size, self.hidden_size = input_size, hidden_size
        self.activation = activation
        self._make_weights(input_size, hidden_size, weight_ih_attr,
                           weight_hh_attr, bias_ih_attr, bias_hh_attr,
                           device, dtype, generator)

    def forward(self, inputs, states=None):
        h = self._zeros(inputs) if states is None else states
        out, _ = self._cell(inputs, h, None)
        return out, out


class LSTMCell(RNNCellBase):
    MODE = "lstm"

    def __init__(self, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None,
                 proj_size=0, name=None, *, device=None, dtype=None,
                 generator=None):
        super().__init__()
        if proj_size:
            raise NotImplementedError(
                "LSTMCell proj_size != 0 is not implemented")
        self.input_size, self.hidden_size = input_size, hidden_size
        self._make_weights(input_size, hidden_size, weight_ih_attr,
                           weight_hh_attr, bias_ih_attr, bias_hh_attr,
                           device, dtype, generator)

    def forward(self, inputs, states=None):
        if states is None:
            states = (self._zeros(inputs), self._zeros(inputs))
        h, c = self._cell(inputs, *states)
        return h, (h, c)


class GRUCell(RNNCellBase):
    MODE = "gru"

    def __init__(self, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None,
                 name=None, *, device=None, dtype=None, generator=None):
        super().__init__()
        self.input_size, self.hidden_size = input_size, hidden_size
        self._make_weights(input_size, hidden_size, weight_ih_attr,
                           weight_hh_attr, bias_ih_attr, bias_hh_attr,
                           device, dtype, generator)

    def forward(self, inputs, states=None):
        h = self._zeros(inputs) if states is None else states
        out, _ = self._cell(inputs, h, None)
        return out, out


class RNN(Layer):
    """Runs any cell over a sequence, step by step (custom cells keep
    their Python semantics); ``is_reverse`` walks time backwards."""

    def __init__(self, cell, is_reverse=False, time_major=False):
        super().__init__()
        self.cell = cell
        self.is_reverse = is_reverse
        self.time_major = time_major

    def forward(self, inputs, initial_states=None):
        x = inputs.transpose(0, 1) if self.time_major else inputs
        T = x.shape[1]
        states = initial_states
        outs = [None] * T
        for t in (range(T - 1, -1, -1) if self.is_reverse else range(T)):
            outs[t], states = self.cell(x[:, t], states)
        out = torch.stack(outs, 1)
        return (out.transpose(0, 1) if self.time_major else out), states


class BiRNN(Layer):
    def __init__(self, cell_fw, cell_bw, time_major=False):
        super().__init__()
        self.rnn_fw = RNN(cell_fw, is_reverse=False, time_major=time_major)
        self.rnn_bw = RNN(cell_bw, is_reverse=True, time_major=time_major)

    def forward(self, inputs, initial_states=None):
        fw, bw = (initial_states if initial_states is not None
                  else (None, None))
        out_fw, st_fw = self.rnn_fw(inputs, fw)
        out_bw, st_bw = self.rnn_bw(inputs, bw)
        return torch.cat([out_fw, out_bw], -1), (st_fw, st_bw)


class _StackedRNN(Layer):
    """Multi-layer, optionally bidirectional runner of ``SimpleRNN``,
    ``LSTM`` and ``GRU``: per (layer, direction) the input projection of
    all steps as one matmul, then the recurrence; ``dropout`` between
    layers in training (from ``generator``, default the port's generator
    of the input's device)."""

    MODE = "simple"

    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 activation="tanh", weight_ih_attr=None, weight_hh_attr=None,
                 bias_ih_attr=None, bias_hh_attr=None, name=None, *,
                 device=None, dtype=None, generator=None):
        super().__init__()
        if direction not in ("forward", "bidirect", "bidirectional"):
            raise ValueError(f"unknown direction {direction!r}")
        if activation not in ("tanh", "relu"):
            raise ValueError("activation must be tanh or relu")
        self.input_size = input_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.bidirectional = direction != "forward"
        self.time_major = time_major
        self.dropout = dropout
        self.activation = activation
        self.generator = generator
        n = _GATES[self.MODE] * hidden_size
        std = 1.0 / math.sqrt(hidden_size)
        kw = dict(default_initializer=I.Uniform(-std, std), device=device,
                  dtype=dtype)
        dirs = 2 if self.bidirectional else 1
        for layer in range(num_layers):
            in_sz = input_size if layer == 0 else hidden_size * dirs
            for d in range(dirs):
                sfx = f"_l{layer}" + ("_reverse" if d else "")
                for pname, shape, attr in (
                        (f"weight_ih{sfx}", [n, in_sz], weight_ih_attr),
                        (f"weight_hh{sfx}", [n, hidden_size], weight_hh_attr),
                        (f"bias_ih{sfx}", [n], bias_ih_attr),
                        (f"bias_hh{sfx}", [n], bias_hh_attr)):
                    setattr(self, pname, self.create_parameter(
                        shape, attr=attr, is_bias="bias" in pname, **kw))

    def _run(self, x, h, c, layer, reverse):
        sfx = f"_l{layer}" + ("_reverse" if reverse else "")
        n = _GATES[self.MODE] * self.hidden_size
        w_ih = getattr(self, f"weight_ih{sfx}")
        w_hh = getattr(self, f"weight_hh{sfx}")
        b_ih = _bias(getattr(self, f"bias_ih{sfx}"), n, x)
        b_hh = _bias(getattr(self, f"bias_hh{sfx}"), n, x)
        xg = x @ w_ih.t() + b_ih
        T = x.shape[1]
        ys = [None] * T
        for t in (range(T - 1, -1, -1) if reverse else range(T)):
            h, c = _step(self.MODE, self.activation, xg[:, t], h, c, w_hh,
                         b_hh)
            ys[t] = h
        return torch.stack(ys, 1), h, c

    def forward(self, inputs, initial_states=None):
        x = inputs.transpose(0, 1) if self.time_major else inputs
        dirs = 2 if self.bidirectional else 1
        L = self.num_layers
        if initial_states is None:
            zeros = x.new_zeros(L * dirs, x.shape[0], self.hidden_size)
            initial_states = ((zeros, zeros) if self.MODE == "lstm"
                              else zeros)
        if self.MODE == "lstm":
            h0, c0 = initial_states
        else:
            h0, c0 = initial_states, torch.zeros_like(initial_states)
        hs, cs = [], []
        out = x
        for layer in range(L):
            outs = []
            for d in range(dirs):
                i = layer * dirs + d
                ys, h, c = self._run(out, h0[i], c0[i], layer, d == 1)
                outs.append(ys)
                hs.append(h)
                cs.append(c)
            out = outs[0] if dirs == 1 else torch.cat(outs, -1)
            if self.dropout and layer < L - 1 and self.training:
                out = F.dropout(out, self.dropout, training=True,
                                generator=self.generator)
        h_final = torch.stack(hs, 0)
        if self.time_major:
            out = out.transpose(0, 1)
        if self.MODE == "lstm":
            return out, (h_final, torch.stack(cs, 0))
        return out, h_final


class SimpleRNN(_StackedRNN):
    MODE = "simple"


class LSTM(_StackedRNN):
    MODE = "lstm"


class GRU(_StackedRNN):
    MODE = "gru"
