"""Forward kinematics over the link tree — stacked, level-parallel,
batch-last: ``R_w (3, 3, nl, N)``, ``p_w (3, nl, N)``.

Levels are precomputed on the host from the parent table
(``tree_levels``); within a level all joints are independent. Used by the
general stacked engine (engine.Engine), the apparent-mass probe and the
spawn depenetration of the env; the chain paths run the chain layout
instead (chain_step.py). Revolute and prismatic joints: a prismatic joint
keeps its fixed rotation and translates its child along the axis by q
(no shipped robot has one; levels without one skip the blend).

The model's constants are built once per (device, dtype) by
``model_consts``: on the card each rebuild from numpy would be a
host-to-device copy inside the step.
"""
from __future__ import annotations

import dataclasses
import weakref

import numpy as np
import torch

from benchmark.reference.ops import lin, quat as quat_ops


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


@dataclasses.dataclass(frozen=True)
class LevelConsts:
    """One tree level's joints: indices and constants (L joints)."""
    idx: np.ndarray       # (L,) joint indices
    idx_t: torch.Tensor   # (L,) the same, long, on the device
    li: np.ndarray        # (L,) child links (idx + 1)
    pi: np.ndarray        # (L,) parent links
    Rj: torch.Tensor      # (3, 3, L, 1) fixed joint-frame rotations
    pj: torch.Tensor      # (3, L, 1) joint offsets in the parent frame
    axis: torch.Tensor    # (3, L, 1) joint axes, child frame
    ax: tuple             # x, y, z components of the axes, (L, 1) each
    pm: object            # (L, 1) 1.0 for prismatic joints; None: none


@dataclasses.dataclass(frozen=True)
class ModelConsts:
    """A RobotModel's constants as tensors on one device and dtype."""
    levels: tuple                 # LevelConsts, root first
    axes_all: torch.Tensor        # (3, nq, 1) joint axes
    prism_all: object             # (1, nq, 1) prismatic mask; None: none
    armature: torch.Tensor        # (nq, 1)
    cp_link: torch.Tensor         # (P,) long: owning link per point
    cp_off: torch.Tensor          # (3, P, 1) point offsets, link frame
    cp_radius: torch.Tensor       # (P, 1)
    link_table: torch.Tensor      # (nl, W) long: points per link
    body_table: torch.Tensor      # (nb, W') long: points per report body


_CONSTS = {}


def source_table(targets, n_targets):
    """The host side of ``out.at[:, targets].add(x)``: for each of the
    ``n_targets`` targets, the indices of its sources in source order,
    padded to one width with ``len(targets)``, which ``segment_sum`` points
    at an appended zero row (contact.segment_sum). (n_targets, W) int64."""
    targets = np.asarray(targets, np.int64).reshape(-1)
    lists = [np.nonzero(targets == t)[0] for t in range(n_targets)]
    table = np.full((n_targets, max([len(l) for l in lists] + [1])),
                    len(targets), np.int64)
    for t, l in enumerate(lists):
        table[t, :len(l)] = l
    return table


def model_consts(model, dtype, device) -> ModelConsts:
    """The model's constants on ``device`` in ``dtype``, built on the first
    call for each (model, device, dtype) and kept while the model lives."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    key = (id(model), str(device), dtype)
    hit = _CONSTS.get(key)
    if hit is not None:
        return hit

    def t(a, dt=dtype):
        return torch.as_tensor(np.asarray(a), dtype=dt, device=device)

    prism = np.asarray(model.joint_is_prismatic, bool)
    levels = []
    for idx in tree_levels(model):
        ax = t(model.joint_axis[idx])                        # (L, 3)
        levels.append(LevelConsts(
            idx=idx, idx_t=t(idx, torch.long), li=idx + 1, pi=model.link_parent[idx + 1],
            Rj=t(model.joint_rot[idx]).permute(1, 2, 0)[..., None],
            pj=t(model.joint_pos[idx].T)[:, :, None],
            axis=t(model.joint_axis[idx].T)[:, :, None],
            ax=(ax[:, 0:1], ax[:, 1:2], ax[:, 2:3]),
            pm=t(prism[idx])[:, None] if prism[idx].any() else None))
    c = ModelConsts(
        levels=tuple(levels),
        axes_all=t(model.joint_axis.T)[:, :, None],
        prism_all=t(prism)[None, :, None] if prism.any() else None,
        armature=t(model.armature)[:, None],
        cp_link=t(model.cp_link, torch.long),
        cp_off=t(model.cp_pos.T)[:, :, None],
        cp_radius=t(model.cp_radius)[:, None],
        link_table=t(source_table(model.cp_link, model.nl), torch.long),
        body_table=t(source_table(model.cp_body, model.num_bodies),
                     torch.long))
    _CONSTS[key] = c
    if not any(k[0] == id(model) for k in _CONSTS if k != key):
        weakref.finalize(model, _forget, id(model))
    return c


def _forget(model_id):
    for k in [k for k in _CONSTS if k[0] == model_id]:
        del _CONSTS[k]


def _axis_rotations(ax, angles):
    """Rodrigues for a stack of constant unit axes.
    ax: (x, y, z) axis components, (L, 1) each; angles: (L, N) ->
    (3, 3, L, N)."""
    c = torch.cos(angles)
    s = torch.sin(angles)
    oc = 1.0 - c
    x, y, z = ax
    return torch.stack([
        torch.stack([c + x * x * oc, x * y * oc - z * s, x * z * oc + y * s]),
        torch.stack([y * x * oc + z * s, c + y * y * oc, y * z * oc - x * s]),
        torch.stack([z * x * oc - y * s, z * y * oc + x * s, c + z * z * oc]),
    ])


def forward_kinematics(model, state) -> FK:
    """model: RobotModel (host constants), state: PhysicsState."""
    n = state.pos.shape[-1]
    mc = model_consts(model, state.pos.dtype, state.pos.device)
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

    for lc in mc.levels:
        idx, li, pi = lc.idx, lc.li, lc.pi
        q_l = state.q[lc.idx_t]                             # (L, N)
        qd_l = state.qd[lc.idx_t]
        R_rot = _axis_rotations(lc.ax, q_l)
        if lc.pm is None:
            p = lc.pj.expand(3, len(idx), n)
            s_ang, s_lin = lc.axis, None
        else:
            # mixed level: prismatic joints keep the identity rotation and
            # translate along the axis
            pm = lc.pm
            R_rot = R_rot * (1 - pm) + lin.eye(R_rot.shape[2:], R_rot.dtype,
                                               R_rot.device) * pm
            p = lc.pj + lc.axis * (q_l * pm)[None]
            s_ang, s_lin = lc.axis * (1 - pm)[None], lc.axis * pm[None]
        R = lin.mm(lc.Rj, R_rot)
        Rp = torch.stack([R_w[j] for j in pi], dim=2)       # (3, 3, L, N)
        pp = torch.stack([p_w[j] for j in pi], dim=1)       # (3, L, N)
        wp = torch.stack([v_ang[j] for j in pi], dim=1)
        vp = torch.stack([v_lin[j] for j in pi], dim=1)
        Rw_l = lin.mm(Rp, R)
        pw_l = pp + lin.mv(Rp, p)
        w_l = lin.mtv(R, wp) + s_ang * qd_l[None]
        v_l = lin.mtv(R, vp + quat_ops.cross(wp, p))
        if s_lin is not None:
            v_l = v_l + s_lin * qd_l[None]
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
    mc = model_consts(model, fk.p_w.dtype, fk.p_w.device)
    li, off = mc.cp_link, mc.cp_off                          # (P,), (3, P, 1)
    R = fk.R_w[:, :, li]                                     # (3, 3, P, N)
    pos = fk.p_w[:, li] + lin.mv(R, off)
    v_local = fk.v_lin[:, li] + quat_ops.cross(fk.v_ang[:, li], off)
    return pos, lin.mv(R, v_local)
