"""Go1 / Aliengo per-leg actuator MLP ("UniNet", go1_net.pt): a shared MLP
[30 -> 128 -> 128 -> 128 -> 3] with tanh, applied to each of the 4 legs
(go1.py:22-35). The input per leg is a 5-step history of normalised
(pos_err, vel) for its 3 joints, interleaved per joint as
[q_err(5), dq(5)] x 3 (go1.py:79-107), with the normalisation statistics
of go1.py:50-53; the output dVel is rescaled by vel_std.

The reference computes the output and discards it (go1.py:68-76); the
env evaluates the net only when ``actuator_net_discard_output`` is off
(the applied-UniNet extension, run on the general engine). Batch-last:
the history buffers are (12, 5, N) tensors rolled on the device, and the
four legs go through the MLP as one (30, 4 N) batch. The weights are read
straight from the TorchScript file.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

LEN_HIST = 5
LEG_DOF = 3
LEG_NUM = 4

# go1.py:50-53 (per-joint stats tiled across legs)
POS_ERR_MEAN = np.array([0.00036437, 0.01540757, -0.00972657])
POS_ERR_STD = np.array([0.11722939, 0.19275887, 0.28700321])
VEL_MEAN = np.array([-0.00017714, -0.00024455, 0.0005956])
VEL_STD = np.array([2.31517027, 3.84613839, 5.52599008])


class UniNet(nn.Module):
    def __init__(self, path):
        super().__init__()
        m = torch.jit.load(path, map_location="cpu")
        p = {k: v.detach().clone() for k, v in m.named_parameters()}
        self.n_layers = 4
        for l, i in enumerate((0, 2, 4, 6)):
            self.register_buffer(f"w{l}", p[f"architecture.{i}.weight"])
            self.register_buffer(f"b{l}",
                                 p[f"architecture.{i}.bias"][:, None])

        def col(a):
            return torch.as_tensor(np.tile(a, LEG_NUM),
                                   dtype=torch.float32)[:, None]

        self.register_buffer("pos_err_mean", col(POS_ERR_MEAN))
        self.register_buffer("pos_err_std", col(POS_ERR_STD))
        self.register_buffer("vel_mean", col(VEL_MEAN))
        self.register_buffer("vel_std", col(VEL_STD))

    def init_state(self, n, dtype=torch.float32, device=None):
        """History buffers: (12, LEN_HIST, N) for pos_err and vel."""
        shape = (LEG_DOF * LEG_NUM, LEN_HIST, n)
        return {"pos_err": torch.zeros(shape, dtype=dtype, device=device),
                "vel": torch.zeros(shape, dtype=dtype, device=device)}

    def core(self, x):
        """x: (30, B) per-leg inputs (batch-last). Returns (3, B)."""
        for l in range(self.n_layers):
            x = getattr(self, f"w{l}") @ x + getattr(self, f"b{l}")
            if l < self.n_layers - 1:
                x = torch.tanh(x)
        return x

    def forward(self, target_q, q, qd, state):
        """Advance the history and evaluate (go1.py:79-107).
        target_q / q / qd: (12, N). Returns (dVel (12, N), state')."""
        pos_err_s = ((target_q - q) - self.pos_err_mean) / self.pos_err_std
        vel_s = (qd - self.vel_mean) / self.vel_std
        pe = torch.cat([state["pos_err"][:, 1:], pos_err_s[:, None, :]],
                       dim=1)
        ve = torch.cat([state["vel"][:, 1:], vel_s[:, None, :]], dim=1)
        n = q.shape[-1]
        # per-joint interleave [q_err(5), dq(5)] x 3 joints -> (30, N) per
        # leg; the legs side by side as one (30, 4 N) batch
        per_joint = torch.cat([pe, ve], dim=1)             # (12, 10, N)
        x = per_joint.reshape(LEG_NUM, LEG_DOF * 2 * LEN_HIST, n)
        x = x.permute(1, 0, 2).reshape(LEG_DOF * 2 * LEN_HIST, LEG_NUM * n)
        out = self.core(x).reshape(LEG_DOF, LEG_NUM, n)    # (3, 4, N)
        dvel = out.permute(1, 0, 2).reshape(LEG_DOF * LEG_NUM, n) \
            * self.vel_std
        return dvel, {"pos_err": pe, "vel": ve}
