"""Contact configuration and per-link wrench accumulation.

The implicit impulse contact law itself runs inside the fused chain step
(chain_step.contact_force_from_plane and its CUDA kernel); this module
keeps the configuration and the stacked wrench accumulation the
apparent-mass probe (engine.calibrate_contact_mass) needs.
Friction combine follows PhysX 'average' mode: mu = (mu_env + mu_terrain) / 2.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class ContactConfig:
    """The implicit (inelastic Baumgarte) impulse law
    f_n = (m_eff / dt) * max(0, baumgarte * depth / dt - v_n)."""
    slip_velocity: float = 0.05    # m/s, Coulomb regularization knee
    terrain_friction: float = 1.0  # static friction of the ground
    baumgarte: float = 1.0
    max_pushout_vel: float = 0.5   # [m/s] cap on the Baumgarte pushout
    # anchored static friction (kernel variant K4, not ported yet)
    warm_start: bool = False


def accumulate_link_wrenches(model, fk, cp_pos, f_pts):
    """World wrenches (force (3, nl, N), torque about link origin
    (3, nl, N)) accumulated per link by index_add."""
    li = torch.as_tensor(model.cp_link, dtype=torch.long,
                         device=cp_pos.device)
    arm = cp_pos - fk.p_w[:, li]                         # (3, P, N)
    n = torch.stack([
        arm[1] * f_pts[2] - arm[2] * f_pts[1],
        arm[2] * f_pts[0] - arm[0] * f_pts[2],
        arm[0] * f_pts[1] - arm[1] * f_pts[0],
    ])
    shape = (3, model.nl) + tuple(f_pts.shape[2:])
    link_f = torch.zeros(shape, dtype=f_pts.dtype, device=f_pts.device)
    link_n = torch.zeros_like(link_f)
    return link_f.index_add(1, li, f_pts), link_n.index_add(1, li, n)
