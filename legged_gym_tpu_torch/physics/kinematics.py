"""Forward kinematics over the link tree — stacked, level-parallel,
batch-last: ``R_w (3, 3, nl, N)``, ``p_w (3, nl, N)``.

Levels are precomputed on the host from the parent table
(``tree_levels``); within a level all joints are independent. Used by the
apparent-mass probe (engine.calibrate_contact_mass) and the spawn
depenetration of the env; the hot path runs the chain layout instead
(chain_step.py). Revolute joints only: the port's robots have no
prismatic joint.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from legged_gym_tpu_torch.ops import lin, quat as quat_ops


@dataclasses.dataclass(frozen=True)
class FK:
    R_w: torch.Tensor     # (3, 3, nl, N) link world rotations
    p_w: torch.Tensor     # (3, nl, N) link world positions
    v_ang: torch.Tensor   # (3, nl, N) angular velocity, LINK frame
    v_lin: torch.Tensor   # (3, nl, N) origin velocity, LINK frame
    R_loc: torch.Tensor   # (3, 3, nq, N) child-in-parent joint rotations
    p_loc: torch.Tensor   # (3, nq, N) child-in-parent joint offsets


def tree_levels(model):
    """Joint indices grouped by tree depth: list of int np.ndarrays.
    Joint j moves link j+1; depth(link) = depth(parent) + 1."""
    depth = np.zeros(model.nl, np.int32)
    for li in range(1, model.nl):
        depth[li] = depth[model.link_parent[li]] + 1
    levels = []
    for d in range(1, depth.max() + 1 if model.nl > 1 else 1):
        levels.append(np.nonzero(depth[1:] == d)[0].astype(np.int32))
    return levels


def _check_revolute(model):
    if np.any(model.joint_is_prismatic):
        raise NotImplementedError("prismatic joints are not ported")


def _axis_rotations(axes, angles):
    """Rodrigues for a stack of constant unit axes.
    axes: (L, 3) host constants; angles: (L, N) -> (3, 3, L, N)."""
    c = torch.cos(angles)
    s = torch.sin(angles)
    oc = 1.0 - c
    ax = torch.as_tensor(axes, dtype=angles.dtype, device=angles.device)
    x, y, z = ax[:, 0:1], ax[:, 1:2], ax[:, 2:3]
    return torch.stack([
        torch.stack([c + x * x * oc, x * y * oc - z * s, x * z * oc + y * s]),
        torch.stack([y * x * oc + z * s, c + y * y * oc, y * z * oc - x * s]),
        torch.stack([z * x * oc - y * s, z * y * oc + x * s, c + z * z * oc]),
    ])


def forward_kinematics(model, state) -> FK:
    """model: RobotModel (host constants), state: PhysicsState."""
    _check_revolute(model)
    n = state.pos.shape[-1]
    dtype, dev = state.pos.dtype, state.pos.device
    nl, nq = model.nl, model.nq

    R_w = [None] * nl
    p_w = [None] * nl
    v_ang = [None] * nl
    v_lin = [None] * nl
    R_loc = [None] * nq
    p_loc = [None] * nq
    R_w[0] = quat_ops.to_matrix(state.quat)
    p_w[0] = state.pos
    v_ang[0] = state.vel[0:3]
    v_lin[0] = state.vel[3:6]

    for idx in tree_levels(model):
        li = idx + 1
        pi = model.link_parent[li]
        Rj = torch.as_tensor(model.joint_rot[idx], dtype=dtype, device=dev)
        Rj = Rj.permute(1, 2, 0)[..., None]                 # (3, 3, L, 1)
        pj = torch.as_tensor(model.joint_pos[idx].T, dtype=dtype,
                             device=dev)[:, :, None]        # (3, L, 1)
        axis_c = torch.as_tensor(model.joint_axis[idx].T, dtype=dtype,
                                 device=dev)[:, :, None]    # (3, L, 1)
        q_l = state.q[idx]                                  # (L, N)
        qd_l = state.qd[idx]
        R = lin.mm(Rj, _axis_rotations(model.joint_axis[idx], q_l))
        p = pj.expand(3, len(idx), n)
        Rp = torch.stack([R_w[j] for j in pi], dim=2)       # (3, 3, L, N)
        pp = torch.stack([p_w[j] for j in pi], dim=1)       # (3, L, N)
        wp = torch.stack([v_ang[j] for j in pi], dim=1)
        vp = torch.stack([v_lin[j] for j in pi], dim=1)
        Rw_l = lin.mm(Rp, R)
        pw_l = pp + lin.mv(Rp, p)
        w_l = lin.mtv(R, wp) + axis_c * qd_l[None]
        v_l = lin.mtv(R, vp + quat_ops.cross(wp, p))
        for j, (lk, jk) in enumerate(zip(li, idx)):
            R_w[lk], p_w[lk] = Rw_l[:, :, j], pw_l[:, j]
            v_ang[lk], v_lin[lk] = w_l[:, j], v_l[:, j]
            R_loc[jk], p_loc[jk] = R[:, :, j], p[:, j]

    return FK(R_w=torch.stack(R_w, dim=2), p_w=torch.stack(p_w, dim=1),
              v_ang=torch.stack(v_ang, dim=1), v_lin=torch.stack(v_lin, dim=1),
              R_loc=torch.stack(R_loc, dim=2), p_loc=torch.stack(p_loc, dim=1))


def contact_point_kinematics(model, fk):
    """World position and velocity of every collision point:
    (pos (3, P, N), vel (3, P, N))."""
    li = torch.as_tensor(model.cp_link, dtype=torch.long,
                         device=fk.p_w.device)
    off = torch.as_tensor(model.cp_pos.T, dtype=fk.p_w.dtype,
                          device=fk.p_w.device)[:, :, None]  # (3, P, 1)
    R = fk.R_w[:, :, li]                                     # (3, 3, P, N)
    pos = fk.p_w[:, li] + lin.mv(R, off)
    v_local = fk.v_lin[:, li] + quat_ops.cross(fk.v_ang[:, li], off)
    return pos, lin.mv(R, v_local)
