"""Recurrent layers (the port of ``paddle_tpu/nn/rnn.py``): the
SimpleRNN / LSTM / GRU cells, ``RNN`` over a cell, ``BiRNN`` and the
multi-layer ``SimpleRNN`` / ``LSTM`` / ``GRU``.

The reference runs each layer as one ``lax.scan`` (``_scan_layer``, :206);
the port runs the same step as a loop over time on the tensors' device,
with the input projection of every step hoisted into one matmul (``x @
W_ih^T + b_ih`` for all steps at once) and one ``[B, H] @ [H, G*H]`` a step.
cuDNN's RNN is not used.  Semantics are the reference's:

- gate order i, f, g, o (LSTM) and r, z, c with ``h = z * h + (1 - z) *
  c`` (GRU); weights ``weight_ih [G*H, I]``, ``weight_hh [G*H, H]``;
- with ``sequence_length`` a row's state freezes past its length and its
  output there is 0; the reverse direction walks right to left but masks
  as if the sequence were left-aligned;
- ``time_major`` swaps the first two dims in and out; inter-layer dropout
  between stacked layers; final states stacked ``[layers * directions, B,
  H]`` in the order layer 0 forward, layer 0 backward, layer 1 ...
"""

from __future__ import annotations

import math

import torch

from ..core.amp_state import cast as _amp
from . import functional as F
from . import initializer as I
from .layer import Layer, LayerList


def _uniform_std(hidden_size):
    std = 1.0 / math.sqrt(hidden_size)
    return I.Uniform(-std, std)


class RNNCellBase(Layer):
    """Base of the single-step cells (reference :39)."""

    def get_initial_states(self, batch_ref, shape=None, dtype=None,
                           init_value=0.0, batch_dim_idx=0):
        """States of ``init_value`` for ``batch_ref``'s batch, in its dtype
        and on its device (``dtype`` is accepted and ignored, as in the
        reference)."""
        batch = batch_ref.shape[batch_dim_idx]
        shapes = shape or self.state_shape

        def full(s):
            return torch.full((batch,) + tuple(s), init_value,
                              dtype=batch_ref.dtype, device=batch_ref.device)
        if isinstance(shapes[0], (tuple, list)):
            return tuple(full(s) for s in shapes)
        return full(shapes)

    def _make_params(self, gates, input_size, hidden_size,
                     weight_ih_attr=None, weight_hh_attr=None,
                     bias_ih_attr=None, bias_hh_attr=None):
        init = _uniform_std(hidden_size)
        self.weight_ih = self.create_parameter(
            [gates * hidden_size, input_size], attr=weight_ih_attr,
            default_initializer=init)
        self.weight_hh = self.create_parameter(
            [gates * hidden_size, hidden_size], attr=weight_hh_attr,
            default_initializer=init)
        self.bias_ih = None if bias_ih_attr is False else \
            self.create_parameter([gates * hidden_size], attr=None,
                                  is_bias=True, default_initializer=init)
        self.bias_hh = None if bias_hh_attr is False else \
            self.create_parameter([gates * hidden_size], attr=None,
                                  is_bias=True, default_initializer=init)


def _project(x, w, b):
    """``x @ w^T (+ b)`` over the last dim."""
    out = torch.matmul(x, w.t())
    return out if b is None else out + b


def _recur(xp, h, whh, bhh):
    """``xp + h W_hh^T + b_hh``, summed in the reference's order."""
    out = xp + torch.matmul(h, whh.t())
    return out if bhh is None else out + bhh


def _lstm_cell(xp, h, c, whh, bhh):
    """One LSTM step from the projected input ``xp = x W_ih^T + b_ih``."""
    i, f, g, o = torch.chunk(_recur(xp, h, whh, bhh), 4, dim=-1)
    c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c_new), c_new


def _gru_cell(xp, h, whh, bhh):
    x_r, x_z, x_c = torch.chunk(xp, 3, dim=-1)
    h_r, h_z, h_c = torch.chunk(_project(h, whh, bhh), 3, dim=-1)
    r = torch.sigmoid(x_r + h_r)
    z = torch.sigmoid(x_z + h_z)
    return z * h + (1.0 - z) * torch.tanh(x_c + r * h_c)


def _simple_cell(xp, h, whh, bhh, act):
    return act(_recur(xp, h, whh, bhh))


def _act(name):
    return torch.tanh if name == "tanh" else torch.relu


def _mode(cell):
    return "LSTM" if isinstance(cell, LSTMCell) else \
        "GRU" if isinstance(cell, GRUCell) else "RNN"


class SimpleRNNCell(RNNCellBase):
    """``h = act(x W_ih^T + b_ih + h W_hh^T + b_hh)`` (reference :741)."""

    def __init__(self, input_size, hidden_size, activation="tanh",
                 weight_ih_attr=None, weight_hh_attr=None,
                 bias_ih_attr=None, bias_hh_attr=None, name=None):
        super().__init__()
        if activation not in ("tanh", "relu"):
            raise ValueError("activation must be tanh or relu")
        self.input_size, self.hidden_size = input_size, hidden_size
        self.activation = activation
        self._make_params(1, input_size, hidden_size, weight_ih_attr,
                          weight_hh_attr, bias_ih_attr, bias_hh_attr)

    @property
    def state_shape(self):
        return (self.hidden_size,)

    def forward(self, inputs, states=None):
        h = states if states is not None else self.get_initial_states(inputs)
        x, h, wih, whh, bih, bhh = _amp(
            "simple_rnn_cell", inputs, h, self.weight_ih, self.weight_hh,
            self.bias_ih, self.bias_hh)
        out = _simple_cell(_project(x, wih, bih), h, whh, bhh,
                           _act(self.activation))
        return out, out


class LSTMCell(RNNCellBase):
    """Gate order i, f, g, o (reference :918)."""

    def __init__(self, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None,
                 name=None):
        super().__init__()
        self.input_size, self.hidden_size = input_size, hidden_size
        self._make_params(4, input_size, hidden_size, weight_ih_attr,
                          weight_hh_attr, bias_ih_attr, bias_hh_attr)

    @property
    def state_shape(self):
        return ((self.hidden_size,), (self.hidden_size,))

    def forward(self, inputs, states=None):
        if states is None:
            states = self.get_initial_states(inputs)
        x, h, c, wih, whh, bih, bhh = _amp(
            "lstm_cell", inputs, states[0], states[1], self.weight_ih,
            self.weight_hh, self.bias_ih, self.bias_hh)
        h_new, c_new = _lstm_cell(_project(x, wih, bih), h, c, whh, bhh)
        return h_new, (h_new, c_new)


class GRUCell(RNNCellBase):
    """Gate order r, z, c; ``h = z * h + (1 - z) * c`` (reference :1144)."""

    def __init__(self, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None,
                 name=None):
        super().__init__()
        self.input_size, self.hidden_size = input_size, hidden_size
        self._make_params(3, input_size, hidden_size, weight_ih_attr,
                          weight_hh_attr, bias_ih_attr, bias_hh_attr)

    @property
    def state_shape(self):
        return (self.hidden_size,)

    def forward(self, inputs, states=None):
        h = states if states is not None else self.get_initial_states(inputs)
        x, h, wih, whh, bih, bhh = _amp(
            "gru_cell", inputs, h, self.weight_ih, self.weight_hh,
            self.bias_ih, self.bias_hh)
        out = _gru_cell(_project(x, wih, bih), h, whh, bhh)
        return out, out


def _run_layer(mode, x, h, c, cell, seq_len, reverse):
    """One direction of one layer over ``x`` ``[B, T, I]``: (y ``[B, T,
    H]``, h, c).  ``seq_len`` (int ``[B]``) freezes each row's state past
    its length and zeroes its output there; ``reverse`` walks right to
    left with the same left-aligned mask (the reference's ``_scan_layer``,
    :206)."""
    x, h, c, wih, whh, bih, bhh = _amp(
        f"rnn_{mode.lower()}", x, h, c, cell.weight_ih, cell.weight_hh,
        cell.bias_ih, cell.bias_hh)
    xp = _project(x, wih, bih)                     # [B, T, G*H], all steps
    T = x.shape[1]
    act = _act(getattr(cell, "activation", "tanh"))
    ys = [None] * T
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        if mode == "LSTM":
            h_new, c_new = _lstm_cell(xp[:, t], h, c, whh, bhh)
        elif mode == "GRU":
            h_new, c_new = _gru_cell(xp[:, t], h, whh, bhh), c
        else:
            h_new, c_new = _simple_cell(xp[:, t], h, whh, bhh, act), c
        if seq_len is not None:
            valid = (t < seq_len)[:, None]
            h_new = torch.where(valid, h_new, h)
            c_new = torch.where(valid, c_new, c)
            ys[t] = torch.where(valid, h_new, 0.0)
        else:
            ys[t] = h_new
        h, c = h_new, c_new
    return torch.stack(ys, dim=1), h, c


def _seq(sequence_length):
    return None if sequence_length is None else sequence_length.long()


def _tree_select(valid, new, old):
    if isinstance(new, (tuple, list)):
        return type(new)(_tree_select(valid, n, o) for n, o in zip(new, old))
    return torch.where(valid, new, old)


class RNN(Layer):
    """A cell run over a sequence (reference :288).  The built-in cells
    take the layer loop; any other cell steps its own ``forward``."""

    def __init__(self, cell, is_reverse=False, time_major=False):
        super().__init__()
        self.cell = cell
        self.is_reverse = is_reverse
        self.time_major = time_major

    def forward(self, inputs, initial_states=None, sequence_length=None):
        if not isinstance(self.cell, (LSTMCell, GRUCell, SimpleRNNCell)):
            return self._forward_custom_cell(inputs, initial_states,
                                             sequence_length)
        mode = _mode(self.cell)
        x = inputs.transpose(0, 1) if self.time_major else inputs
        B, H = x.shape[0], self.cell.hidden_size
        zeros = torch.zeros((B, H), dtype=x.dtype, device=x.device)
        if initial_states is None:
            h0, c0 = zeros, zeros
        elif mode == "LSTM":
            h0, c0 = initial_states
        else:
            h0, c0 = initial_states, zeros
        y, h, c = _run_layer(mode, x, h0, c0, self.cell,
                             _seq(sequence_length), self.is_reverse)
        if self.time_major:
            y = y.transpose(0, 1)
        return y, ((h, c) if mode == "LSTM" else h)

    def _forward_custom_cell(self, inputs, initial_states, sequence_length):
        x = inputs.transpose(0, 1) if self.time_major else inputs
        T = x.shape[1]
        states = initial_states if initial_states is not None else \
            self.cell.get_initial_states(x[:, 0])
        seq = _seq(sequence_length)
        outs = [None] * T
        for t in (range(T - 1, -1, -1) if self.is_reverse else range(T)):
            out, new_states = self.cell(x[:, t], states)
            if seq is not None:
                valid = (t < seq)[:, None]
                out = torch.where(valid, out, 0.0)
                new_states = _tree_select(valid, new_states, states)
            outs[t] = out
            states = new_states
        y = torch.stack(outs, dim=1)
        if self.time_major:
            y = y.transpose(0, 1)
        return y, states


class BiRNN(Layer):
    """A forward and a backward cell over the same input, outputs
    concatenated on the last dim (reference rnn.py BiRNN)."""

    def __init__(self, cell_fw, cell_bw, time_major=False):
        super().__init__()
        self.cell_fw, self.cell_bw = cell_fw, cell_bw
        self.rnn_fw = RNN(cell_fw, is_reverse=False, time_major=time_major)
        self.rnn_bw = RNN(cell_bw, is_reverse=True, time_major=time_major)
        self.time_major = time_major

    def forward(self, inputs, initial_states=None, sequence_length=None):
        s_fw = s_bw = None
        if initial_states is not None:
            s_fw, s_bw = initial_states
        y_fw, st_fw = self.rnn_fw(inputs, s_fw, sequence_length)
        y_bw, st_bw = self.rnn_bw(inputs, s_bw, sequence_length)
        return torch.cat([y_fw, y_bw], dim=-1), (st_fw, st_bw)


class _RNNBase(Layer):
    """The multi-layer, optionally bidirectional stack (reference :342)."""

    MODE = "RNN"

    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 activation="tanh", weight_ih_attr=None, weight_hh_attr=None,
                 bias_ih_attr=None, bias_hh_attr=None, name=None):
        super().__init__()
        if direction in ("bidirect", "bidirectional"):
            self.num_directions = 2
        elif direction == "forward":
            self.num_directions = 1
        else:
            raise ValueError(f"unknown direction {direction!r}")
        self.input_size, self.hidden_size = input_size, hidden_size
        self.num_layers = num_layers
        self.time_major = time_major
        self.dropout = dropout
        self.activation = activation
        cells = []
        for layer in range(num_layers):
            in_sz = input_size if layer == 0 else \
                hidden_size * self.num_directions
            for _ in range(self.num_directions):
                cells.append(self._make_cell(in_sz, hidden_size,
                                             weight_ih_attr, weight_hh_attr,
                                             bias_ih_attr, bias_hh_attr))
        self.cells = LayerList(cells)

    def _make_cell(self, in_sz, hidden, wih, whh, bih, bhh):
        if self.MODE == "LSTM":
            return LSTMCell(in_sz, hidden, wih, whh, bih, bhh)
        if self.MODE == "GRU":
            return GRUCell(in_sz, hidden, wih, whh, bih, bhh)
        return SimpleRNNCell(in_sz, hidden, self.activation, wih, whh, bih,
                             bhh)

    def forward(self, inputs, initial_states=None, sequence_length=None):
        x = inputs.transpose(0, 1) if self.time_major else inputs
        B = x.shape[0]
        D, L, H = self.num_directions, self.num_layers, self.hidden_size
        lstm = self.MODE == "LSTM"
        zeros = torch.zeros((L * D, B, H), dtype=x.dtype, device=x.device)
        if initial_states is None:
            h0, c0 = zeros, zeros
        elif lstm:
            h0, c0 = initial_states
        else:
            h0, c0 = initial_states, zeros
        seq = _seq(sequence_length)
        h_outs, c_outs = [], []
        for layer in range(L):
            ys = []
            for d in range(D):
                idx = layer * D + d
                y, h, c = _run_layer(self.MODE, x, h0[idx], c0[idx],
                                     self.cells[idx], seq, bool(d))
                ys.append(y)
                h_outs.append(h)
                c_outs.append(c)
            x = ys[0] if D == 1 else torch.cat(ys, dim=-1)
            if self.dropout > 0 and layer < L - 1:
                x = F.dropout(x, p=self.dropout, training=self.training)
        if self.time_major:
            x = x.transpose(0, 1)
        h_fin = torch.stack(h_outs)
        if lstm:
            return x, (h_fin, torch.stack(c_outs))
        return x, h_fin


class SimpleRNN(_RNNBase):
    MODE = "RNN"


class LSTM(_RNNBase):
    MODE = "LSTM"

    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 weight_ih_attr=None, weight_hh_attr=None, bias_ih_attr=None,
                 bias_hh_attr=None, name=None):
        super().__init__(input_size, hidden_size, num_layers, direction,
                         time_major, dropout, "tanh", weight_ih_attr,
                         weight_hh_attr, bias_ih_attr, bias_hh_attr, name)


class GRU(_RNNBase):
    MODE = "GRU"

    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 weight_ih_attr=None, weight_hh_attr=None, bias_ih_attr=None,
                 bias_hh_attr=None, name=None):
        super().__init__(input_size, hidden_size, num_layers, direction,
                         time_major, dropout, "tanh", weight_ih_attr,
                         weight_hh_attr, bias_ih_attr, bias_hh_attr, name)


__all__ = ["BiRNN", "GRU", "GRUCell", "LSTM", "LSTMCell", "RNN",
           "RNNCellBase", "SimpleRNN", "SimpleRNNCell"]
