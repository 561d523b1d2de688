"""LSTM primitives: one cell step and a masked sequence LSTM
(visitron_tpu/models/lstm.py).

The full padded sequence runs through a per-step loop with a validity mask
that freezes the state at padded positions, which reproduces pack_padded
semantics exactly: outputs at padded steps are zero and the final (h, c)
equal the state at each sequence's true last step.  The loop is plain
PyTorch on the device (a few small launches per token); the JAX package has
no kernel for it either.

Cells keep the torch LSTM gate layout (rows [i; f; g; o]) and raw parameters
(wi, wh, bi, bh), the same arrays as the flax module.
"""

from __future__ import annotations

import math

import torch
from torch import nn


def lstm_cell_step(params, x, h, c):
    """One LSTMCell step. params: {wi: (4H, I), wh: (4H, H), bi, bh: (4H,)}."""
    gates = x @ params["wi"].T + params["bi"] + h @ params["wh"].T + params["bh"]
    i, f, g, o = gates.chunk(4, dim=-1)
    c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    h_new = torch.sigmoid(o) * torch.tanh(c_new)
    return h_new, c_new


class LSTMCellParams(nn.Module):
    """Torch-layout LSTMCell parameters; calling it returns the params dict."""

    def __init__(self, input_size: int, hidden_size: int):
        super().__init__()
        self.wi = nn.Parameter(torch.zeros(4 * hidden_size, input_size))
        self.wh = nn.Parameter(torch.zeros(4 * hidden_size, hidden_size))
        self.bi = nn.Parameter(torch.zeros(4 * hidden_size))
        self.bh = nn.Parameter(torch.zeros(4 * hidden_size))

    def forward(self) -> dict:
        return {"wi": self.wi, "wh": self.wh, "bi": self.bi, "bh": self.bh}

    def initial_params(self, g: torch.Generator) -> dict:
        # torch LSTM default (and the flax module's): U(-1/sqrt(H), 1/sqrt(H)).
        bound = 1.0 / math.sqrt(self.wh.shape[1])
        return {name: torch.empty(p.shape).uniform_(-bound, bound, generator=g)
                for name, p in (("wi", self.wi), ("wh", self.wh),
                                ("bi", self.bi), ("bh", self.bh))}


def masked_lstm_scan(params, inputs, lengths, dtype=None):
    """Run an LSTM over (B, T, I) with per-sequence lengths.

    The input-side gate projection runs as ONE (B, T, I)x(I, 4H) matmul
    before the loop; each step only does the recurrent h @ Wh matmul and the
    elementwise gates.  Returns (outputs (B, T, H) zeroed at pads,
    (h_last, c_last))."""
    b, t, _ = inputs.shape
    hidden_size = params["wh"].shape[1]
    if dtype is None:
        dtype = inputs.dtype
    mask = (torch.arange(t, device=inputs.device)[None, :]
            < lengths[:, None]).to(dtype)
    h = torch.zeros((b, hidden_size), dtype=dtype, device=inputs.device)
    c = torch.zeros((b, hidden_size), dtype=dtype, device=inputs.device)
    gates_x = inputs @ params["wi"].T + params["bi"] + params["bh"]
    wh_t = params["wh"].T
    # Per-step views through unbind: under autograd its backward stacks the
    # T step gradients once, where indexing gates_x[:, step] would allocate,
    # zero-fill and accumulate a full (B, T, 4H) gradient at every step.
    steps_x = gates_x.unbind(1)
    steps_m = mask.unbind(1)
    ys = []
    for step in range(t):
        gates = steps_x[step] + h @ wh_t
        i, f, g, o = gates.chunk(4, dim=-1)
        c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h_new = torch.sigmoid(o) * torch.tanh(c_new)
        v = steps_m[step][:, None]
        h = v * h_new + (1 - v) * h
        c = v * c_new + (1 - v) * c
        ys.append(h * v)
    return torch.stack(ys, dim=1), (h, c)


class LSTM(nn.Module):
    """Masked unidirectional sequence LSTM with pack_padded parity."""

    def __init__(self, input_size: int, hidden_size: int,
                 bidirectional: bool = False, dtype=torch.float32):
        super().__init__()
        if bidirectional:
            raise NotImplementedError("the bidirectional LSTM is not ported yet")
        self.dtype = dtype
        self.fwd = LSTMCellParams(input_size, hidden_size)

    def forward(self, inputs, lengths):
        return masked_lstm_scan(self.fwd(), inputs.to(self.dtype), lengths, self.dtype)
