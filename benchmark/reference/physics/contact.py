"""Contact laws in the stacked layout (points x envs, batch-last), the
anchored static-friction law and the per-link / per-body accumulations.

The chain paths run the same implicit impulse law inside the fused chain
step (chain_step.contact_force_from_plane and its CUDA kernel); the
general stacked engine (engine.Engine) calls ``contact_forces`` and
``SelfCollision`` here. The anchored tangential law is shared by
both. Friction combine follows PhysX 'average' mode:
mu = (mu_env + mu_terrain) / 2. The explicit spring law
(``ContactConfig.implicit=False``) runs on the general engine only, as in
the JAX package; no task configures it.

Every scatter of the JAX package (``.at[...].add``) is a gather here: the
host builds, once per index list, a padded per-target list of sources in
source order (``kinematics.source_table``), and the device sums the
gathered rows (``segment_sum``). No atomics: the result is the same from
run to run on the card. (The apparent-mass probe's wrenches, one unit
force per env, sum exactly either way.)
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from benchmark.reference.physics.kinematics import (model_consts,
                                                     source_table)
from benchmark.reference.terrain.heightfield import (patch_sample_bilinear,
                                                      sample_bilinear)


@dataclasses.dataclass(frozen=True)
class ContactConfig:
    """The implicit (inelastic Baumgarte) impulse law
    f_n = (m_eff / dt) * max(0, baumgarte * depth / dt - v_n), or with
    ``implicit`` off the explicit spring-damper
    f_n = max(stiffness * depth - damping * v_n, 0)."""
    stiffness: float = 5000.0      # N/m (explicit law only)
    damping: float = 150.0         # N s/m (explicit law only)
    slip_velocity: float = 0.05    # m/s, Coulomb regularization knee
    terrain_friction: float = 1.0  # static friction of the ground
    implicit: bool = True
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


def contact_forces(model, grid, cfg, cp_pos, cp_vel, friction, dt, m_eff,
                   m_eff_t=None, v_max=None, f_prev=None, patch=None,
                   k_static=None):
    """Per-point world contact forces against the terrain (stacked layout),
    the JAX package's ``contact_forces``: its implicit impulse law, or
    with ``cfg.implicit`` off its explicit spring-damper (no apparent-mass
    blend, no impulse cap on friction; m_eff, v_max and k_static unused).

    Args:
      model: RobotModel; grid: TerrainGrid or None (plane z = 0);
      cfg: ContactConfig; cp_pos / cp_vel: (3, P, N) world position /
      velocity of the collision points; friction: (N,) per-env friction;
      dt: substep length; m_eff: (P, 1) apparent mass per point; m_eff_t:
      (P, 1) tangential apparent mass; v_max: (P, 1) per-point pushout
      cap (else cfg.max_pushout_vel); f_prev: (3, P, N) anchors when
      cfg.warm_start; patch: per-env TerrainPatch (windowed sampling);
      k_static: (P, 1) one-way support spring stiffness. The (P, 1)
      constants are tensors on cp_pos's device.

    Returns f_pts (3, P, N); with cfg.warm_start and f_prev given,
    (f_pts, new_anchors (3, P, N)).
    """
    x, y, z = cp_pos[0], cp_pos[1], cp_pos[2]            # (P, N)
    if patch is not None and grid is not None:
        h, dhdx, dhdy = patch_sample_bilinear(grid, patch, x, y)
    else:
        h, dhdx, dhdy = sample_bilinear(grid, x, y)

    # unit terrain normal
    inv_norm = 1.0 / torch.sqrt(1.0 + dhdx * dhdx + dhdy * dhdy)
    nx, ny, nz = -dhdx * inv_norm, -dhdy * inv_norm, inv_norm

    mc = model_consts(model, cp_pos.dtype, cp_pos.device)
    depth = mc.cp_radius + (h - z) * nz                  # signed penetration
    active = depth > 0.0

    vx, vy, vz = cp_vel[0], cp_vel[1], cp_vel[2]
    v_n = vx * nx + vy * ny + vz * nz
    if cfg.implicit:
        me = m_eff
        # direction-aware apparent mass: harmonic blend of the normal and
        # the tangential mass by the normal's tilt
        if m_eff_t is not None:
            me = 1.0 / (nz * nz / me + (1.0 - nz * nz) / m_eff_t)
        v_push = cfg.baumgarte * depth / dt
        if v_max is None:
            v_push = torch.clamp_max(v_push, cfg.max_pushout_vel)
        else:
            v_push = torch.minimum(v_push, v_max)
        fn_raw = (me / dt) * torch.clamp_min(v_push - v_n, 0.0)
        if k_static is not None:
            # one-way static-support spring, depth saturated at 15 mm, off
            # while the point separates faster than 5 cm/s
            fn_raw = fn_raw + (k_static * torch.clamp_max(depth, 0.015)
                               * (v_n < 0.05))
    else:
        fn_raw = torch.clamp_min(cfg.stiffness * depth - cfg.damping * v_n,
                                 0.0)
    fn_mag = torch.where(active, fn_raw, 0.0)

    # tangential velocity and regularized Coulomb friction
    vtx = vx - v_n * nx
    vty = vy - v_n * ny
    vtz = vz - v_n * nz
    vt = torch.sqrt(vtx * vtx + vty * vty + vtz * vtz)
    mu = 0.5 * (friction[None, :] + cfg.terrain_friction)
    ft_over_vt = mu * fn_mag / (vt + cfg.slip_velocity)
    met = m_eff if m_eff_t is None else m_eff_t
    if cfg.implicit:
        # impulse cap: one substep can at most stop the slip (tangential
        # mass)
        ft_over_vt = torch.minimum(ft_over_vt, met / dt)

    if cfg.warm_start and f_prev is not None:
        f, ax = anchored_tangential(
            cfg, cp_pos, fn_mag, mu, torch.stack([vtx, vty, vtz]),
            torch.stack([nx, ny, nz]), met, dt, f_prev, depth=depth)
        return f + fn_mag[None] * torch.stack([nx, ny, nz]), ax

    fx = fn_mag * nx - ft_over_vt * vtx
    fy = fn_mag * ny - ft_over_vt * vty
    fz = fn_mag * nz - ft_over_vt * vtz
    return torch.stack([fx, fy, fz])                     # (3, P, N)


def segment_sum(x, table):
    """x: (C, S, ...) sources; table: (T, W) long
    ``kinematics.source_table`` on x's device -> (C, T, ...) per-target
    sums, in the same order every run."""
    zero = torch.zeros_like(x[:, :1])
    return torch.cat([x, zero], dim=1)[:, table].sum(dim=2)


def accumulate_body_forces(model, f_pts):
    """Per-report-body net contact force (3, nb, N): the analogue of
    Isaac's net_contact_force tensor."""
    mc = model_consts(model, f_pts.dtype, f_pts.device)
    return segment_sum(f_pts, mc.body_table)


def accumulate_link_wrenches(model, fk, cp_pos, f_pts):
    """World wrenches (force (3, nl, N), torque about link origin
    (3, nl, N)) accumulated per link."""
    mc = model_consts(model, cp_pos.dtype, cp_pos.device)
    arm = cp_pos - fk.p_w[:, mc.cp_link]                 # (3, P, N)
    n = torch.stack([
        arm[1] * f_pts[2] - arm[2] * f_pts[1],
        arm[2] * f_pts[0] - arm[0] * f_pts[2],
        arm[0] * f_pts[1] - arm[1] * f_pts[0],
    ])
    fn = segment_sum(torch.cat([f_pts, n], dim=0), mc.link_table)
    return fn[:3], fn[3:]


# ------------------------------------------------------------ self-collision

def self_collision_candidate_pairs(model):
    """Host-side candidate pair list for sphere-set self-collision
    (Isaac asset.self_collisions == 0, legged_robot.py:711-720): all
    collision-point pairs on distinct links that are not parent and child,
    the base excluded (its contact force is the termination signal, and
    the coarse base / thigh spheres would fire where PhysX's hulls never
    touch). Returns (Q, 2) int32 point-index pairs, i < j."""
    P = len(model.cp_link)
    pairs = []
    for i in range(P):
        for j in range(i + 1, P):
            li, lj = int(model.cp_link[i]), int(model.cp_link[j])
            if li == lj:
                continue
            if (model.link_parent[li] == lj
                    or model.link_parent[lj] == li):
                continue
            if li == 0 or lj == 0:
                continue
            pairs.append((i, j))
    return np.array(pairs, np.int32).reshape(-1, 2)


class SelfCollision:
    """Frictionless sphere-sphere self-contact of one pair list with the
    terrain's implicit impulse law: stop the approach velocity plus a
    capped pushout bias, scaled by the pair's reduced apparent mass (the
    JAX package's ``self_collision_forces``). Its constants are built once
    on ``device`` in ``dtype``; the engine keeps one per (device, dtype).

    pairs: (Q, 2) point pairs (self_collision_candidate_pairs, possibly
    rest-filtered); m_eff: (P,) calibrated apparent masses."""

    def __init__(self, model, pairs, m_eff, dtype=torch.float32,
                 device="cpu"):
        pairs = np.asarray(pairs, np.int64).reshape(-1, 2)
        i, j = pairs[:, 0], pairs[:, 1]
        # the reduced mass and the radius sums in float32 from float32
        # inputs, as the JAX package computes them on the device
        me = np.maximum(np.asarray(m_eff, np.float32), np.float32(1e-6))
        m_ij = np.float32(1.0) / (np.float32(1.0) / me[i]
                                  + np.float32(1.0) / me[j])
        r = np.asarray(model.cp_radius, np.float32)

        def t(a, dt=dtype):
            return torch.as_tensor(a, dtype=dt, device=device)

        self.i, self.j = t(i, torch.long), t(j, torch.long)
        self.rsum = t(r[i] + r[j])[:, None]
        self.m_ij = t(m_ij)[:, None]
        # sources 0..Q-1 carry +f to point i, Q..2Q-1 carry -f to point j:
        # per point its +f terms in pair order, then its -f terms
        self.table = t(source_table(np.concatenate([i, j]),
                                    len(model.cp_link)), torch.long)

    def __call__(self, cp_pos, cp_vel, dt, v_max=0.2):
        """cp_pos / cp_vel: (3, P, N). Returns f_pts (3, P, N) to add to
        the terrain contact forces."""
        i, j = self.i, self.j
        d = cp_pos[:, i] - cp_pos[:, j]                 # (3, Q, N)
        dist = torch.sqrt(torch.sum(d * d, dim=0) + 1e-12)
        nrm = d / dist[None]
        overlap = self.rsum - dist
        v_rel = cp_vel[:, i] - cp_vel[:, j]
        v_n = torch.sum(nrm * v_rel, dim=0)             # + = separating
        bias = torch.clamp_max(overlap / dt, v_max)
        jmag = torch.where(overlap > 0.0,
                           self.m_ij * torch.clamp_min(bias - v_n, 0.0) / dt,
                           0.0)                         # (Q, N)
        f = nrm * jmag[None]                            # (3, Q, N)
        return segment_sum(torch.cat([f, -f], dim=1), self.table)
