"""ANYdrive v3 SEA actuator network: 2-layer LSTM(2 -> 8 -> 8) + linear
head, with fixed input scale (2.0, 0.25) and output scale 20 N*m
(anydrive_v3_lstm.pt; consumer contract at anymal.py:62-81: input per
joint (pos_err, vel), hidden/cell (2, envs*12, 8), output = torque;
hidden state zeroed per env on reset, anymal.py:56-60).

Batch-last: one LSTM cell step per sim dt over the flattened
(joint x env) batch, as plain matrix products between two launches of the
physics kernel. The weights are read straight from the TorchScript file.
"""
from __future__ import annotations

import torch
from torch import nn


class SEANet(nn.Module):
    hidden = 8

    def __init__(self, path):
        super().__init__()
        m = torch.jit.load(path, map_location="cpu")
        p = {k: v.detach().clone() for k, v in m.named_parameters()}
        p.update({k: v.detach().clone() for k, v in m.named_buffers()})
        # torch LSTM gate order: i, f, g, o (rows of the 4H x in matrices)
        for l in (0, 1):
            self.register_buffer(f"w_ih{l}", p[f"lstm.weight_ih_l{l}"])
            self.register_buffer(f"w_hh{l}", p[f"lstm.weight_hh_l{l}"])
            self.register_buffer(
                f"b{l}", (p[f"lstm.bias_ih_l{l}"]
                          + p[f"lstm.bias_hh_l{l}"])[:, None])   # (32, 1)
        self.register_buffer("w_out", p["linear.weight"])        # (1, 8)
        self.register_buffer("b_out", p["linear.bias"][:, None])  # (1, 1)
        self.register_buffer("in_scale", p["in_scale"].reshape(2, 1))
        self.out_scale = float(p["out_scale"].reshape(()))

    def init_state(self, batch, dtype=torch.float32, device=None):
        """(h, c): each (2 layers, 8, batch), batch = nq * N flattened."""
        z = torch.zeros((2, self.hidden, batch), dtype=dtype, device=device)
        return z, z.clone()

    def forward(self, pos_err, vel, state):
        """pos_err, vel: (B,) flattened joint-major batch. Returns
        (torque (B,), new_state)."""
        h, c = state
        x = torch.stack([pos_err, vel]) * self.in_scale          # (2, B)
        new_h, new_c = [], []
        for l in (0, 1):
            gates = (getattr(self, f"w_ih{l}") @ x
                     + getattr(self, f"w_hh{l}") @ h[l]
                     + getattr(self, f"b{l}"))                   # (32, B)
            gi, gf, gg, go = torch.chunk(gates, 4, dim=0)
            cl = torch.sigmoid(gf) * c[l] \
                + torch.sigmoid(gi) * torch.tanh(gg)
            hl = torch.sigmoid(go) * torch.tanh(cl)
            new_h.append(hl)
            new_c.append(cl)
            x = hl
        tau = self.out_scale * (self.w_out @ x + self.b_out)[0]
        return tau, (torch.stack(new_h), torch.stack(new_c))
