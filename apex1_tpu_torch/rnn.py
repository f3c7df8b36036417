"""RNN modules (the port of ``apex1_tpu/rnn.py``; reference
``apex/RNN``): `LSTM`, `GRU`, `RNNReLU` and `RNNTanh`.

Seq-first (T, B, F), as the reference. Each layer's input projection
for every step is one product hoisted out of the loop; the loop over
the steps runs the hidden product and the gates. The cells are the JAX
package's, not ``torch.nn``'s: one bias, on the input projection
(``l{i}_ih_b``), none on the hidden one, so the GRU's candidate is
``n = tanh(xn + r * (h @ Wh_n))``. Parameters keep the flax names and
(in, out) layouts: ``l{i}_ih_w`` (fan_in, G·H), ``l{i}_ih_b`` (G·H,),
``l{i}_hh_w`` (H, G·H), gates in the order i, f, g, o (LSTM) and r, z,
n (GRU); fp32 on ``device`` (CUDA unless the caller names another),
cast to the input's dtype at the call.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from apex1_tpu_torch.ops._common import resolve_device
from apex1_tpu_torch.ops.fused_dense import lecun_normal_


def _apply(x: torch.Tensor, w: torch.Tensor,
           b: Optional[torch.Tensor]) -> torch.Tensor:
    y = x @ w.to(x.dtype)
    return y if b is None else y + b.to(x.dtype)


class _Recurrent(nn.Module):
    """The layers' parameters; ``gates`` hidden-size blocks a layer."""

    gates = 1

    def __init__(self, input_size: int, hidden_size: int,
                 num_layers: int = 1, bias: bool = True, device=None):
        super().__init__()
        self.input_size, self.hidden_size = input_size, hidden_size
        self.num_layers = num_layers
        dev = resolve_device(device)
        G, H = self.gates, hidden_size
        for layer in range(num_layers):
            fan_in = input_size if layer == 0 else H
            self.register_parameter(f"l{layer}_ih_w", nn.Parameter(
                lecun_normal_(torch.empty(fan_in, G * H, device=dev),
                              fan_in)))
            self.register_parameter(f"l{layer}_ih_b", nn.Parameter(
                torch.zeros(G * H, device=dev)) if bias else None)
            self.register_parameter(f"l{layer}_hh_w", nn.Parameter(
                lecun_normal_(torch.empty(H, G * H, device=dev), H)))

    def _layer(self, layer: int):
        return (getattr(self, f"l{layer}_ih_w"),
                getattr(self, f"l{layer}_ih_b"),
                getattr(self, f"l{layer}_hh_w"))

    def _zeros(self, xs: torch.Tensor) -> torch.Tensor:
        return torch.zeros(xs.shape[1], self.hidden_size, dtype=xs.dtype,
                           device=xs.device)


class LSTM(_Recurrent):
    """``apex.RNN.LSTM``: ``forward(xs (T, B, input_size), state=None)``
    -> (outputs (T, B, H), (h_n, c_n) each (layers, B, H)); ``state``
    an (h0, c0) pair of (layers, B, H)."""

    gates = 4

    def forward(self, xs: torch.Tensor, state=None):
        outs, finals = xs, []
        for layer in range(self.num_layers):
            wi, bi, wh = self._layer(layer)
            x_gates = _apply(outs, wi, bi)          # (T, B, 4H), one product
            if state is None:
                h, c = self._zeros(xs), self._zeros(xs)
            else:
                h, c = state[0][layer], state[1][layer]
            steps = []
            for xg in x_gates:
                i, f, g, o = (xg + _apply(h, wh, None)).chunk(4, dim=-1)
                c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
                h = torch.sigmoid(o) * torch.tanh(c)
                steps.append(h)
            outs = torch.stack(steps)
            finals.append((h, c))
        return outs, (torch.stack([f[0] for f in finals]),
                      torch.stack([f[1] for f in finals]))


class GRU(_Recurrent):
    """``apex.RNN.GRU``: ``forward(xs, state=None)`` -> (outputs, h_n
    (layers, B, H))."""

    gates = 3

    def forward(self, xs: torch.Tensor, state=None):
        outs, finals = xs, []
        for layer in range(self.num_layers):
            wi, bi, wh = self._layer(layer)
            x_gates = _apply(outs, wi, bi)
            h = self._zeros(xs) if state is None else state[layer]
            steps = []
            for xg in x_gates:
                xr, xz, xn = xg.chunk(3, dim=-1)
                hr, hz, hn = _apply(h, wh, None).chunk(3, dim=-1)
                r = torch.sigmoid(xr + hr)
                z = torch.sigmoid(xz + hz)
                n = torch.tanh(xn + r * hn)
                h = (1.0 - z) * n + z * h
                steps.append(h)
            outs = torch.stack(steps)
            finals.append(h)
        return outs, torch.stack(finals)


class RNNReLU(_Recurrent):
    """``apex.RNN.RNNReLU``: the vanilla RNN, ``h = act(x Wi + b + h
    Wh)`` with ``activation`` "relu" (or "tanh")."""

    def __init__(self, input_size: int, hidden_size: int,
                 num_layers: int = 1, bias: bool = True,
                 activation: str = "relu", device=None):
        super().__init__(input_size, hidden_size, num_layers, bias, device)
        self.activation = activation

    def forward(self, xs: torch.Tensor, state=None):
        act = F.relu if self.activation == "relu" else torch.tanh
        outs, finals = xs, []
        for layer in range(self.num_layers):
            wi, bi, wh = self._layer(layer)
            x_gates = _apply(outs, wi, bi)
            h = self._zeros(xs) if state is None else state[layer]
            steps = []
            for xg in x_gates:
                h = act(xg + _apply(h, wh, None))
                steps.append(h)
            outs = torch.stack(steps)
            finals.append(h)
        return outs, torch.stack(finals)


class RNNTanh(RNNReLU):
    """``apex.RNN.RNNTanh``: `RNNReLU` with tanh."""

    def __init__(self, input_size: int, hidden_size: int,
                 num_layers: int = 1, bias: bool = True,
                 activation: str = "tanh", device=None):
        super().__init__(input_size, hidden_size, num_layers, bias,
                         activation, device)
