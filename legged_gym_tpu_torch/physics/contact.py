"""Contact configuration, the anchored static-friction law and per-link
wrench accumulation.

The implicit impulse contact law itself runs inside the fused chain step
(chain_step.contact_force_from_plane and its CUDA kernel); this module
keeps the configuration, the anchored tangential law that the plain chain
step calls when ``warm_start`` is on (kernel variant K4), and the stacked
wrench accumulation the apparent-mass probe
(engine.calibrate_contact_mass) needs.
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
    # Anchored static friction (kernel variant K4): carry per-point
    # tangential anchors so a loaded stance sticks instead of creeping at
    # ~F*dt/m_t. The anchor restoring force uses the same implicit impulse
    # form as the normal direction (f = m_t/dt * (v_target - v),
    # v_target = -beta*offset/dt), so its effective stiffness
    # m_t*beta/dt^2 scales with the calibrated tangential mass and the law
    # is unconditionally stable. Off by default; aliengo's wide
    # near-straight stance needs it.
    warm_start: bool = False
    anchor_beta: float = 0.5           # offset-correction gain per substep
    anchor_vmax: float = 1.0           # [m/s] cap on the anchor pull
    anchor_stale2: float = 0.01        # [m^2] snap anchors further than this
    # geometric anchor release: the anchor survives while the point stays
    # within this clearance of the surface, so landing micro-hops do not
    # re-snap it at a displaced position
    anchor_release_depth: float = 0.005   # [m]


# Fresh / reset anchor value: farther than sqrt(anchor_stale2) from any
# reachable contact point, so the stale rule re-snaps on first touch no
# matter where the robot spawns (a zero anchor is valid for a foot within
# 10 cm of the world origin and would drag it toward (0, 0, 0)).
ANCHOR_SENTINEL = 1e6


def anchored_tangential(cfg, cp_pos, fn_mag, mu, vt_vec, n_vec, m_t, dt,
                        anchor, depth=None):
    """Implicit anchored static friction.

    Args (leading point axes arbitrary, env axis last):
      cfg: anything with the anchor_* fields (ContactConfig, ChainConsts);
      cp_pos (3, ...): world point positions; fn_mag (...): normal force;
      mu (...): friction coefficient; vt_vec (3, ...): tangential
      velocity; n_vec (3, ...): unit terrain normal; m_t: tangential
      apparent mass (broadcastable); anchor (3, ...): anchor positions;
      depth (...): signed penetration — anchors release geometrically
      (the point is more than anchor_release_depth clear of the surface),
      not on momentary normal-force dropouts: fn_mag flickers to zero
      during stance micro-bounces, and re-snapping the anchor each flicker
      ratchets a loaded stance outward.

    Returns (f_t (3, ...) tangential force, new_anchor (3, ...)).
    """
    dxa = cp_pos[0] - anchor[0]
    dya = cp_pos[1] - anchor[1]
    dza = cp_pos[2] - anchor[2]
    near = ((fn_mag > 0.0) if depth is None
            else (depth > -cfg.anchor_release_depth))
    stale = (dxa * dxa + dya * dya + dza * dza) > cfg.anchor_stale2
    fresh = (~near) | stale
    dxa = torch.where(fresh, 0.0, dxa)
    dya = torch.where(fresh, 0.0, dya)
    dza = torch.where(fresh, 0.0, dza)
    nx, ny, nz = n_vec[0], n_vec[1], n_vec[2]
    # tangential projection of the anchor offset
    dn = dxa * nx + dya * ny + dza * nz
    dxa, dya, dza = dxa - dn * nx, dya - dn * ny, dza - dn * nz
    # implicit anchor impulse: f = (m_t/dt) (v_target - v_t),
    # v_target = -beta * offset / dt, |v_target| <= anchor_vmax
    d_mag = torch.sqrt(dxa * dxa + dya * dya + dza * dza) + 1e-12
    v_pull = torch.clamp_max(cfg.anchor_beta * d_mag / dt, cfg.anchor_vmax)
    g = m_t / dt
    ftx = g * (-v_pull * dxa / d_mag - vt_vec[0])
    fty = g * (-v_pull * dya / d_mag - vt_vec[1])
    ftz = g * (-v_pull * dza / d_mag - vt_vec[2])
    ft_mag = torch.sqrt(ftx * ftx + fty * fty + ftz * ftz) + 1e-9
    scale = torch.clamp_max(mu * fn_mag / ft_mag, 1.0)
    f_t = torch.stack([ftx * scale, fty * scale, ftz * scale])
    # new anchor: sliding (scale < 1) drags it so the remembered offset
    # stays consistent with the clipped force; sticking keeps it. While the
    # point is unloaded but still geometrically near, the remembered anchor
    # stays untouched (the cone scale is ~0 then, and dragging the anchor
    # to cp_pos each flicker would erase the offset).
    off = torch.stack([dxa, dya, dza]) * scale[None]
    loaded = fn_mag > 1e-3
    new_anchor = torch.where(
        fresh[None], cp_pos,
        torch.where(loaded[None], cp_pos - off, anchor))
    return f_t, new_anchor


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
