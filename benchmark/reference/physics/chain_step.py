"""Chain-structured physics step — the plain PyTorch version of the fused
CUDA kernel (chain_kernel.py).

Tensors are batch-last: the env axis is LAST and the chain (leg) axis is
second-to-last, the layout of the JAX package's ``physics/chain_step.py``,
so the two compare without transposes. Every array constant (joint
frames, gains, point offsets) travels in a dict ``cv`` built once by
:func:`const_values` (numpy) and :func:`const_tensors` (on a device).

The CPU path of ``ChainEngine`` runs this module; on the card it is the
reference the kernel is held against (tests/test_torch_kernel.py,
chip_smoke.py). Semantics: PD position drive with implicit damping,
joint-limit springs, velocity caps, implicit impulse contact against a
heightfield patch with the contact plane sampled once per policy step;
with ``warm_start`` and anchors given, the tangential contact force is
the anchored static-friction law (contact.anchored_tangential) and the
anchors ride along.

The four configurations of the kernel, all here: K1 (the above without
anchors), K4 (K1 with warm-start friction anchors), K2 (the plane
re-sampled at the first substep of every sim dt when ``plane_per_step``
is off, and / or the trimesh wall rule when ``wall_thresh > 0``) and K3
(``torque_mode``: ``targets`` is a held torque clipped to the effort
limits, no PD). They combine freely; :func:`variant` names the one a
``ChainConsts`` selects.

Anchors travel as ONE packed tensor (3, n_points, N) in the kernel's point
order: the base group's slots, then each level group slot-major,
chain-minor. Group gi's (3, S, K, N) array — the JAX package's layout —
is a reshaped view of a slice (:func:`split_anchors`).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from benchmark.reference.ops import lin
from benchmark.reference.ops import quat as quat_ops
from benchmark.reference.ops.quat import cross
from benchmark.reference.physics.contact import (ANCHOR_SENTINEL,
                                                  anchored_tangential)


@dataclasses.dataclass(frozen=True)
class ChainConsts:
    """Host-side constant bundle: structure and scalars, plus the (L, K)
    per-joint arrays that const_values() lays out."""
    cm: object                 # ChainModel
    dt_inner: float
    substeps: int
    decimation: int
    gravity: tuple
    kp: np.ndarray             # (L, K)
    kd_eff: np.ndarray
    effort: np.ndarray
    implicit_d: np.ndarray
    limit_stiffness: float
    limit_damping: float
    lower: np.ndarray
    upper: np.ndarray
    qd_cap: np.ndarray
    base_ang_cap: float
    base_lin_cap: float
    mu_terrain: float
    slip_velocity: float
    baumgarte: float
    border_size: float
    horizontal_scale: float
    # trimesh vertical-face rule (TerrainGrid.wall_thresh): > 0 makes a
    # cell whose corner spread exceeds it collide as a flat floor at its
    # min corner (kernel variant K2)
    wall_thresh: float
    patch_S: int
    # sample the contact plane once per POLICY step (True: K1, the main
    # path) or at the first substep of every sim dt (False: K2)
    plane_per_step: bool = True
    # anchored static friction (K4): with anchors given, the tangential
    # force is contact.anchored_tangential; the field names match
    # ContactConfig so the shared law can read either object
    warm_start: bool = False
    anchor_beta: float = 0.5
    anchor_vmax: float = 1.0
    anchor_stale2: float = 0.01
    anchor_release_depth: float = 0.005
    # torque drive (K3): ``targets`` is a held torque (L, K, N) clipped to
    # the effort limits instead of PD position targets. ChainEngine builds
    # a decimation=1 torque-mode ChainConsts whose implicit_d is the
    # passive impedance; the actuator net re-evaluates between launches
    torque_mode: bool = False


def variant(cc: ChainConsts, anchored=False) -> str:
    """The kernel variant a configuration selects: "K3" with the torque
    drive, else "K2" with per-sim-dt planes or the wall rule, else "K4"
    when anchors ride along, else "K1". K2 and K3 may carry anchors too."""
    if cc.torque_mode:
        return "K3"
    if not cc.plane_per_step or cc.wall_thresh > 0.0:
        return "K2"
    return "K4" if anchored else "K1"


def check_variant(cc: ChainConsts):
    """Every configuration of the step is ported (K1-K4 and their
    combinations); raises only on one that makes no sense."""
    if cc.wall_thresh < 0.0:
        raise ValueError(f"wall_thresh {cc.wall_thresh} < 0")
    if cc.substeps < 1 or cc.decimation < 1:
        raise ValueError(f"substeps {cc.substeps}, decimation "
                         f"{cc.decimation}: both must be >= 1")


def n_points(cm) -> int:
    """Contact points of the chain model, all groups."""
    return sum(g.offs.shape[0] * g.offs.shape[1] for g in cm.groups)


def init_anchors(cm, n, device, dtype=torch.float32):
    """Packed far-sentinel anchors (3, n_points, N)."""
    return torch.full((3, n_points(cm), n), ANCHOR_SENTINEL, dtype=dtype,
                      device=device)


def split_anchors(cm, packed):
    """Packed (3, n_points, N) -> per-group views (3, S, K, N), no copy."""
    out, base = [], 0
    for g in cm.groups:
        S, K = g.offs.shape[:2]
        out.append(packed[:, base:base + S * K].reshape(
            3, S, K, packed.shape[-1]))
        base += S * K
    return out


def pack_anchors(groups):
    """Per-group (3, S, K, N) arrays -> packed (3, n_points, N)."""
    return torch.cat([a.reshape(3, -1, a.shape[-1]) for a in groups], dim=1)


def const_values(cc: ChainConsts, dtype=np.float32) -> dict:
    """All array constants the step body needs, as numpy arrays with one
    trailing broadcast axis for the env batch (the JAX package's
    ``const_values`` with ``env_nd=1``: the keys this module reads, same
    values)."""
    cm = cc.cm

    def t(a):
        return np.asarray(a).reshape(np.shape(a) + (1,))

    # closed-form joint rotation: R(q) = Rj @ Rot(axis, q)
    #                                   = RjA cos q + RjB sin q + RjC
    a_ = cm.axis                                        # (L,K,3)
    aaT = np.einsum("lki,lkj->lkij", a_, a_)
    RjaaT = np.einsum("lkim,lkmj->lkij", cm.Rj, aaT)
    ske = np.zeros((cm.L, cm.K, 3, 3))
    ske[..., 0, 1] = -a_[..., 2]
    ske[..., 0, 2] = a_[..., 1]
    ske[..., 1, 0] = a_[..., 2]
    ske[..., 1, 2] = -a_[..., 0]
    ske[..., 2, 0] = -a_[..., 1]
    ske[..., 2, 1] = a_[..., 0]
    Rjsk = np.einsum("lkim,lkmj->lkij", cm.Rj, ske)

    def rot4(a):
        return t(np.transpose(a, (0, 2, 3, 1)))         # (L,3,3,K,1)

    cv = {
        "ax": t(np.moveaxis(cm.axis, -1, 1)),           # (L,3,K,1)
        "RjA": rot4(cm.Rj - RjaaT),
        "RjB": rot4(Rjsk),
        "RjC": rot4(RjaaT),
        "pj": t(np.moveaxis(cm.pj, -1, 1)),             # (L,3,K,1)
        "kp": t(cc.kp),                                 # (L,K,1)
        "kd_eff": t(cc.kd_eff),
        "effort": t(cc.effort),
        "implicit_d": t(cc.implicit_d),
        "lower": t(cc.lower),
        "upper": t(cc.upper),
        "qd_cap": t(cc.qd_cap),
        "damping": t(cm.damping),
        "armature": t(cm.armature),
        "grav": t(np.asarray(cc.gravity)),              # (3,1)
        "gravK": t(np.tile(np.asarray(cc.gravity)[:, None], (1, cm.K))),
    }
    for gi, g in enumerate(cm.groups):
        cv[f"goff{gi}"] = t(np.moveaxis(g.offs, -1, 0))  # (3,S,K,1)
        cv[f"grad{gi}"] = t(g.radius)                    # (S,K,1)
        cv[f"gmet{gi}"] = t(g.m_eff_t)
        cv[f"gimn{gi}"] = t(1.0 / np.maximum(g.m_eff, 1e-9))
        cv[f"gimt{gi}"] = t(1.0 / np.maximum(g.m_eff_t, 1e-9))
        cv[f"gvp{gi}"] = t(g.vmax)
        cv[f"gks{gi}"] = t(g.k_static)
        cv[f"gact{gi}"] = t(g.active.astype(np.float64))
    return {k: np.asarray(v, dtype) for k, v in cv.items()}


def const_tensors(cc: ChainConsts, device, dtype=torch.float32) -> dict:
    """const_values() as tensors on ``device``."""
    return {k: torch.as_tensor(v, dtype=dtype, device=device)
            for k, v in const_values(cc).items()}


# --------------------------------------------------------------- FK sweep

def fk_chain(cc: ChainConsts, cv, pos, quat, vel, q, qd):
    """Level-parallel FK. pos (3,N), quat (4,N), vel (6,N), q/qd (L,K,N).

    Returns dict with the base pose and per-level lists (index l):
      R_w[l] (3,3,K,N), p_w[l] (3,K,N), w[l]/v[l] (3,K,N) link frame,
      R_loc[l] (3,3,K,N)."""
    cm = cc.cm
    R0 = quat_ops.to_matrix(quat)                     # (3,3,N)
    w0 = vel[0:3]
    v0 = vel[3:6]
    n = pos.shape[-1]

    R_w, p_w, w_l, v_l, R_loc = [], [], [], [], []
    for l in range(cm.L):
        ax = cv["ax"][l]                              # (3,K,1)
        pj = cv["pj"][l]                              # (3,K,1)
        q_l, qd_l = q[l], qd[l]                       # (K,N)
        ccos = torch.cos(q_l)
        s = torch.sin(q_l)
        A_, B_, C_ = cv["RjA"][l], cv["RjB"][l], cv["RjC"][l]
        R = torch.stack([
            torch.stack([A_[i, j] * ccos + B_[i, j] * s + C_[i, j]
                         for j in range(3)])
            for i in range(3)])                       # (3,3,K,N)
        if l == 0:
            Rp = R0[:, :, None]                       # (3,3,1,N)
            pp = pos[:, None]
            wp = w0[:, None]
            vp = v0[:, None]
        else:
            Rp, pp, wp, vp = R_w[l - 1], p_w[l - 1], w_l[l - 1], v_l[l - 1]
        pjb = pj.expand(3, cm.K, n)
        R_w.append(lin.mm(Rp, R))
        p_w.append(pp + lin.mv(Rp, pjb))
        w_l.append(lin.mtv(R, wp) + ax * qd_l[None])
        v_l.append(lin.mtv(R, vp + cross(wp, pjb)))
        R_loc.append(R)
    return dict(R0=R0, p0=pos, w0=w0, v0=v0,
                R_w=R_w, p_w=p_w, w=w_l, v=v_l, R_loc=R_loc)


# ---------------------------------------------------- contact point state

def contact_points_group(cc: ChainConsts, cv, fk, gi):
    """World position / velocity of point group gi: (pos, vel) each
    (3,S,K,N) — the base group has K == 1."""
    g = cc.cm.groups[gi]
    offs = cv[f"goff{gi}"]                          # (3,S,K,1)
    if g.level < 0:
        R = fk["R0"][:, :, None, None]              # (3,3,1,1,N)
        p = fk["p0"][:, None, None]                 # (3,1,1,N)
        w = fk["w0"][:, None, None]
        v = fk["v0"][:, None, None]
    else:
        l = g.level
        R = fk["R_w"][l][:, :, None]                # (3,3,1,K,N)
        p = fk["p_w"][l][:, None]                   # (3,1,K,N)
        w = fk["w"][l][:, None]
        v = fk["v"][l][:, None]
    pos = p + lin.mv(R, offs)                       # (3,S,K,N)
    vel = lin.mv(R, v + cross(w, offs.expand(pos.shape)))
    return pos, vel


# --------------------------------------------------------- patch sampling

def sample_patch_plane(cc: ChainConsts, cv, ph, pr0, pc0, x, y):
    """Bilinear height + gradient at world (x, y) against the per-env
    patch ``ph`` (S, S, N) with window origin (pr0, pc0) (N,) in grid
    cells. x, y: (..., N). Indexes the four corners directly; the JAX
    package contracts one-hot rows instead, whose only two nonzero weights
    give the same values.

    With ``cc.wall_thresh > 0`` (trimesh) a query cell whose four corners
    spread more than the threshold collides as a flat floor at its min
    corner wherever that lies below the bilinear height (strictly: a
    query on the min corner itself keeps the bilinear plane)."""
    S = cc.patch_S
    hs = cc.horizontal_scale
    dt = ph.dtype
    fx = (x + cc.border_size) / hs - pr0.to(dt)
    fy = (y + cc.border_size) / hs - pc0.to(dt)
    fx = torch.clamp(fx, 0.0, S - 1.001)
    fy = torch.clamp(fy, 0.0, S - 1.001)
    ix = torch.floor(fx)
    iy = torch.floor(fy)
    tx = fx - ix
    ty = fy - iy
    n = ph.shape[-1]
    lead = x.shape[:-1]
    flat = ph.reshape(S * S, n)
    i00 = (ix.long() * S + iy.long()).reshape(-1, n)

    def corner(off):
        return torch.gather(flat, 0, i00 + off).reshape(lead + (n,))

    h00, h01, h10, h11 = corner(0), corner(1), corner(S), corner(S + 1)
    inv_hs = 1.0 / hs
    txp0 = (1.0 - tx) * h00 + tx * h10
    txp1 = (1.0 - tx) * h01 + tx * h11
    gxp0 = -inv_hs * h00 + inv_hs * h10
    gxp1 = -inv_hs * h01 + inv_hs * h11
    h = txp0 * (1.0 - ty) + txp1 * ty
    dhdy = txp0 * -inv_hs + txp1 * inv_hs
    dhdx = gxp0 * (1.0 - ty) + gxp1 * ty
    if cc.wall_thresh > 0.0:
        m4 = torch.minimum(torch.minimum(h00, h10), torch.minimum(h01, h11))
        big4 = torch.maximum(torch.maximum(h00, h10),
                             torch.maximum(h01, h11))
        mq = torch.where(big4 - m4 > cc.wall_thresh, m4, 1e9)
        steep = mq < h
        h = torch.where(steep, mq, h)
        dhdx = torch.where(steep, 0.0, dhdx)
        dhdy = torch.where(steep, 0.0, dhdy)
    return h, dhdx, dhdy


def plane_consts(cc: ChainConsts, cv, gi, h, dhdx, dhdy, x, y):
    """Per-policy-step plane constants for one point group: offset form
    c0 + normal + direction-aware apparent mass (harmonic blend of the
    calibrated vertical and tangential masses by the normal's direction
    cosines; nz = 1 reduces to the vertical mass)."""
    inv_norm = 1.0 / torch.sqrt(1.0 + dhdx * dhdx + dhdy * dhdy)
    nx, ny, nz = -dhdx * inv_norm, -dhdy * inv_norm, inv_norm
    nz2 = nz * nz
    gain = (1.0 / (nz2 * cv[f"gimn{gi}"] + (1.0 - nz2) * cv[f"gimt{gi}"])
            / cc.dt_inner) * cv[f"gact{gi}"]      # masked impulse gain
    return (h - dhdx * x - dhdy * y, dhdx, dhdy, nx, ny, nz, gain)


def contact_force_from_plane(cc: ChainConsts, cv, gi, plane, pos, vel,
                             mu_env, anchor=None):
    """Implicit impulse contact force (3,S,K,N) against a cached local
    plane: a Baumgarte-capped stopping impulse, a one-way static support
    spring (no force while separating faster than 5 cm/s, depth saturated
    at 15 mm) and regularized Coulomb friction capped at the tangential
    stopping impulse. With ``cc.warm_start`` and an anchor array
    (3,S,K,N), the tangential term is the anchored static-friction law and
    the return is (f, new_anchor); inactive (padding) points are pushed
    1e9 m clear of the surface so their anchors stay fresh."""
    dt_in = cc.dt_inner
    c0, dhdx, dhdy, nx, ny, nz, gain = plane
    x, y, z = pos[0], pos[1], pos[2]
    h = c0 + dhdx * x + dhdy * y
    met = cv[f"gmet{gi}"]
    depth = cv[f"grad{gi}"] + (h - z) * nz
    vx, vy, vz = vel[0], vel[1], vel[2]
    v_n = vx * nx + vy * ny + vz * nz
    v_push = torch.minimum(cc.baumgarte * depth / dt_in, cv[f"gvp{gi}"])
    fn_raw = (gain * torch.clamp_min(v_push - v_n, 0.0)
              + cv[f"gks{gi}"] * cv[f"gact{gi}"]
              * torch.clamp_max(depth, 0.015) * (v_n < 0.05))
    fn_mag = torch.where(depth > 0.0, fn_raw, 0.0)
    vtx = vx - v_n * nx
    vty = vy - v_n * ny
    vtz = vz - v_n * nz
    mu = 0.5 * (mu_env + cc.mu_terrain)
    if cc.warm_start and anchor is not None:
        f_t, new_anchor = anchored_tangential(
            cc, pos, fn_mag, mu, torch.stack([vtx, vty, vtz]),
            torch.stack([nx, ny, nz]), met, dt_in, anchor,
            depth=depth - (1.0 - cv[f"gact{gi}"]) * 1e9)
        f = torch.stack([fn_mag * nx + f_t[0],
                         fn_mag * ny + f_t[1],
                         fn_mag * nz + f_t[2]])
        return f, new_anchor
    vt = torch.sqrt(vtx * vtx + vty * vty + vtz * vtz)
    ft_over_vt = torch.minimum(mu * fn_mag / (vt + cc.slip_velocity),
                               met / dt_in)
    return torch.stack([fn_mag * nx - ft_over_vt * vtx,
                        fn_mag * ny - ft_over_vt * vty,
                        fn_mag * nz - ft_over_vt * vtz])


# ----------------------------------------------------------------- ABA

def aba_chain(cc: ChainConsts, cv, lp_base, lp_lvl, fk, qd, tau,
              f_base, n_base, f_lvl, n_lvl, implicit_extra):
    """Chain-layout Featherstone ABA: the parent of level l is level l-1
    of the same chain; the level-0 links reduce into the base with one
    sum over K.

    lp_base (10,N); lp_lvl (L,10,K,N); qd/tau (L,K,N);
    f_base/n_base (3,N) world external wrench on the base;
    f_lvl/n_lvl: per-level lists of (3,K,N) world wrenches;
    implicit_extra (L,K,N). Returns a0 (6,N), qdd (L,K,N).
    """
    cm = cc.cm
    dtype, dev = qd.dtype, qd.device
    L = cm.L
    n = qd.shape[-1]

    def pass1(par, R_w, w, v, f_ext, n_ext, g_const, g_shape):
        m = par[0]
        h = par[1:4]
        A = torch.stack([
            torch.stack([par[4], par[5], par[6]]),
            torch.stack([par[5], par[7], par[8]]),
            torch.stack([par[6], par[8], par[9]]),
        ])
        IA_B = lin.skew(h)
        IA_C = m[None, None] * lin.eye(m.shape, dtype, dev)
        n_m = lin.mv(A, w) + cross(h, v)
        f_m = m[None] * v - cross(h, w)
        pA_n = cross(w, n_m) + cross(v, f_m)
        pA_f = cross(w, f_m)
        gl = lin.mtv(R_w, g_const.expand(g_shape))
        f_tot = m[None] * gl + lin.mtv(R_w, f_ext)
        n_tot = cross(h, gl) + lin.mtv(R_w, n_ext)
        return [A, IA_B, IA_C], [pA_n - n_tot, pA_f - f_tot]

    bIA, bpA = pass1(lp_base, fk["R0"], fk["w0"], fk["v0"],
                     f_base, n_base, cv["grav"], (3, n))
    IA, pA = [], []
    for l in range(L):
        A_, p_ = pass1(lp_lvl[l], fk["R_w"][l], fk["w"][l], fk["v"][l],
                       f_lvl[l], n_lvl[l], cv["gravK"], (3, cm.K, n))
        IA.append(A_)
        pA.append(p_)

    c_ang, c_lin = [], []
    for l in range(L):
        Sqd = cv["ax"][l] * qd[l][None]
        c_ang.append(cross(fk["w"][l], Sqd))
        c_lin.append(cross(fk["v"][l], Sqd))

    # ---- pass 2: tips -> base ----
    per_level = [None] * L
    for l in range(L - 1, -1, -1):
        A_l, B_l, C_l = IA[l]
        pn_l, pf_l = pA[l]
        ax = cv["ax"][l]
        Ua = lin.mv(A_l, ax)
        Ul = lin.mtv(B_l, ax)
        D = (torch.sum(ax * Ua, dim=0) + cv["armature"][l]
             + implicit_extra[l])
        u = tau[l] - torch.sum(ax * pn_l, dim=0)
        di = 1.0 / D
        per_level[l] = (Ua, Ul, di, u)

        Ia_A = A_l - lin.outer_sym(Ua, di)
        Ia_B = B_l - di[None, None] * lin.outer(Ua, Ul)
        Ia_C = C_l - lin.outer_sym(Ul, di)
        ca, cl = c_ang[l], c_lin[l]
        pa_n = pn_l + lin.mv(Ia_A, ca) + lin.mv(Ia_B, cl) \
            + Ua * (di * u)[None]
        pa_f = pf_l + lin.mtv(Ia_B, ca) + lin.mv(Ia_C, cl) \
            + Ul * (di * u)[None]

        R = fk["R_loc"][l]
        pj = cv["pj"][l]
        pjb = pj.expand(3, cm.K, n)
        RA = lin.congruence_sym(R, Ia_A)
        RB = lin.mm(R, lin.mmt(Ia_B, R))
        RC = lin.congruence_sym(R, Ia_C)
        RBp = lin.mm_skew(RB, pj)              # RB @ p~
        pRC = lin.skew_mm(pj, RC)              # p~ @ RC
        A_p = (RA - RBp - lin.transpose(RBp)
               - lin.skew_mm(pj, lin.mm_skew(RC, pj)))
        B_p = RB + pRC
        Rf = lin.mv(R, pa_f)
        n_p = lin.mv(R, pa_n) + cross(pjb, Rf)

        if l > 0:
            IA[l - 1][0] = IA[l - 1][0] + A_p
            IA[l - 1][1] = IA[l - 1][1] + B_p
            IA[l - 1][2] = IA[l - 1][2] + RC
            pA[l - 1][0] = pA[l - 1][0] + n_p
            pA[l - 1][1] = pA[l - 1][1] + Rf
        else:
            bIA[0] = bIA[0] + torch.sum(A_p, dim=2)
            bIA[1] = bIA[1] + torch.sum(B_p, dim=2)
            bIA[2] = bIA[2] + torch.sum(RC, dim=2)
            bpA[0] = bpA[0] + torch.sum(n_p, dim=1)
            bpA[1] = bpA[1] + torch.sum(Rf, dim=1)

    # ---- base solve ----
    a0_ang, a0_lin = lin.solve66_sym(bIA[0], bIA[1], bIA[2],
                                     -bpA[0], -bpA[1])

    # ---- pass 3: base -> tips ----
    qdd = []
    a_ang_p, a_lin_p = a0_ang[:, None], a0_lin[:, None]
    for l in range(L):
        R = fk["R_loc"][l]
        pjb = cv["pj"][l].expand(3, cm.K, n)
        aab = a_ang_p.expand(3, cm.K, n)
        alb = a_lin_p.expand(3, cm.K, n)
        ap_ang = lin.mtv(R, aab) + c_ang[l]
        ap_lin = lin.mtv(R, alb + cross(aab, pjb)) + c_lin[l]
        Ua, Ul, di, u = per_level[l]
        qdd_l = di * (u - torch.sum(Ua * ap_ang, dim=0)
                      - torch.sum(Ul * ap_lin, dim=0))
        qdd.append(qdd_l)
        a_ang_p = ap_ang + cv["ax"][l] * qdd_l[None]
        a_lin_p = ap_lin
    return torch.cat([a0_ang, a0_lin], dim=0), torch.stack(qdd)


# ------------------------------------------------------------- integrate

def integrate_chain(cc: ChainConsts, cv, pos, quat, vel, q, qd, a0, qdd):
    dt = cc.dt_inner
    vel = vel + dt * a0
    vel = torch.cat([
        torch.clamp(vel[0:3], -cc.base_ang_cap, cc.base_ang_cap),
        torch.clamp(vel[3:6], -cc.base_lin_cap, cc.base_lin_cap)], dim=0)
    cap = cv["qd_cap"]
    qd = torch.clamp(qd + dt * qdd, -cap, cap)
    pos = pos + dt * quat_ops.rotate(quat, vel[3:6])
    dq = torch.cat([vel[0:3] * (0.5 * dt), torch.ones_like(quat[3:4])], dim=0)
    quat = quat_ops.mul(quat, dq)
    inv = 1.0 / torch.sqrt(torch.sum(quat * quat, dim=0).clamp_min(1e-18))
    quat = quat * inv[None]
    q = q + dt * qd
    # hard-limit plastic projection
    lo, hi = cv["lower"], cv["upper"]
    qd = torch.where((q > hi) & (qd > 0.0), 0.0, qd)
    qd = torch.where((q < lo) & (qd < 0.0), 0.0, qd)
    q = torch.clamp(q, lo, hi)
    return pos, quat, vel, q, qd


# ------------------------------------------------------------ full step

def pd_tau(cc: ChainConsts, cv, targets, q, qd):
    lim = cv["effort"]
    return torch.clamp(cv["kp"] * (targets - q) - cv["kd_eff"] * qd,
                       -lim, lim)


def limit_spring(cc: ChainConsts, cv, q, qd):
    """Joint-limit spring-damper torque + implicit diagonal bump."""
    over = torch.clamp_min(q - cv["upper"], 0.0)
    under = torch.clamp_min(cv["lower"] - q, 0.0)
    active = ((over > 0) | (under > 0)).to(q.dtype)
    tau = cc.limit_stiffness * (under - over) \
        - cc.limit_damping * active * qd
    extra = cc.dt_inner * (cc.limit_damping
                           + cc.dt_inner * cc.limit_stiffness) * active
    return tau, extra


def body_runs(g):
    """Host-side: contiguous slot runs [s0, s1) of the same report body,
    per chain: list of (s0, s1, k, body)."""
    runs = []
    S, K = g.body.shape
    for k in range(K):
        s = 0
        while s < S:
            if not g.active[s, k]:
                s += 1
                continue
            b = int(g.body[s, k])
            s1 = s + 1
            while s1 < S and g.active[s1, k] and int(g.body[s1, k]) == b:
                s1 += 1
            runs.append((s, s1, k, b))
            s = s1
    return runs


def compute_plane(cc: ChainConsts, cv, fk, ph, pr0, pc0):
    """Sample the terrain under every contact point and return the local
    contact planes: list per group of plane_consts() tuples."""
    plane = []
    for gi in range(len(cc.cm.groups)):
        ppos, _ = contact_points_group(cc, cv, fk, gi)
        x, y = ppos[0], ppos[1]
        h, dhdx, dhdy = sample_patch_plane(cc, cv, ph, pr0, pc0, x, y)
        plane.append(plane_consts(cc, cv, gi, h, dhdx, dhdy, x, y))
    return plane


def one_sim_dt(cc: ChainConsts, cv, lp_base, lp_lvl, mu_env, targets,
               state5, plane, anchors=None, patch=None):
    """One sim dt = ``substeps`` inner substeps against the cached planes
    ``plane``, or, with ``plane`` None, against planes sampled at the first
    substep from ``patch`` = (ph, pr0, pc0) (``plane_per_step`` off).

    anchors: per-group list of (3,S,K,N) static-friction anchors when
    ``cc.warm_start`` (updated every substep and returned), else None.

    Returns (state5', tau (L,K,N) last substep,
             body_f (3, n_bodies, N) net contact forces, last substep
             [, anchors' when cc.warm_start and anchors given])."""
    cm = cc.cm
    pos, quat, vel, q, qd = state5
    n = pos.shape[-1]
    dtype, dev = pos.dtype, pos.device
    has_damping = bool(np.any(cm.damping != 0.0))
    own_plane = plane is None
    if own_plane:
        plane = [None] * len(cm.groups)
    track_anchors = cc.warm_start and anchors is not None
    if track_anchors:
        anchors = list(anchors)
    tau = body_f = None
    for s in range(cc.substeps):
        fk = fk_chain(cc, cv, pos, quat, vel, q, qd)
        f_base = torch.zeros((3, n), dtype=dtype, device=dev)
        n_base = torch.zeros((3, n), dtype=dtype, device=dev)
        f_lvl = [torch.zeros((3, cm.K, n), dtype=dtype, device=dev)
                 for _ in range(cm.L)]
        n_lvl = [torch.zeros((3, cm.K, n), dtype=dtype, device=dev)
                 for _ in range(cm.L)]
        # per-report-body force accumulators (the net contact-force sensor)
        body_cols = [None] * cm.n_bodies
        for gi, g in enumerate(cm.groups):
            ppos, pvel = contact_points_group(cc, cv, fk, gi)
            if own_plane and s == 0:
                x, y = ppos[0], ppos[1]
                h, dhdx, dhdy = sample_patch_plane(cc, cv, *patch, x, y)
                plane[gi] = plane_consts(cc, cv, gi, h, dhdx, dhdy, x, y)
            if track_anchors:
                f, anchors[gi] = contact_force_from_plane(
                    cc, cv, gi, plane[gi], ppos, pvel, mu_env,
                    anchor=anchors[gi])
            else:
                f = contact_force_from_plane(cc, cv, gi, plane[gi], ppos,
                                             pvel, mu_env)
            for (s0, s1, k, b) in body_runs(g):
                col = f[:, s0:s1].sum(dim=1) if s1 - s0 > 1 else f[:, s0]
                col = col[:, k]
                body_cols[b] = col if body_cols[b] is None \
                    else body_cols[b] + col
            if g.level < 0:
                arm = ppos - fk["p0"][:, None, None]
                f_base = f_base + torch.sum(f, dim=(1, 2))
                n_base = n_base + torch.sum(cross(arm, f), dim=(1, 2))
            else:
                l = g.level
                arm = ppos - fk["p_w"][l][:, None]
                f_lvl[l] = f_lvl[l] + torch.sum(f, dim=1)
                n_lvl[l] = n_lvl[l] + torch.sum(cross(arm, f), dim=1)
        zero3 = torch.zeros((3, n), dtype=dtype, device=dev)
        body_f = torch.stack([c if c is not None else zero3
                              for c in body_cols], dim=1)  # (3, nb, N)

        if cc.torque_mode:
            tau = torch.clamp(targets, -cv["effort"], cv["effort"])
        else:
            tau = pd_tau(cc, cv, targets, q, qd)
        tau_lim, extra = limit_spring(cc, cv, q, qd)
        tau_total = tau + tau_lim
        if has_damping:
            tau_total = tau_total - cv["damping"] * qd
        imp = cv["implicit_d"] + extra
        a0, qdd = aba_chain(cc, cv, lp_base, lp_lvl, fk, qd, tau_total,
                            f_base, n_base, f_lvl, n_lvl, imp)
        pos, quat, vel, q, qd = integrate_chain(
            cc, cv, pos, quat, vel, q, qd, a0, qdd)
    if track_anchors:
        return (pos, quat, vel, q, qd), tau, body_f, anchors
    return (pos, quat, vel, q, qd), tau, body_f


def run_decimation_chain(cc: ChainConsts, lp_base, lp_lvl, mu_env,
                         targets, ph, pr0, pc0, pos, quat, vel, q, qd,
                         cv=None, anchors=None):
    """The full policy-step physics: decimation x substeps of the step
    body; the contact planes are sampled once from the entry state
    (``cc.plane_per_step``) or at the first substep of every sim dt;
    position drive, or held torques with ``cc.torque_mode``. Same contract
    as the CUDA kernel (chain_kernel.run_decimation).

    anchors: packed (3, n_points, N) static-friction anchors (needs
    ``cc.warm_start``), or None.

    Returns (pos, quat, vel, q, qd, tau_last (L,K,N),
             body_f_last (3, n_bodies, N)[, anchors' (3, n_points, N)])."""
    check_variant(cc)
    if cv is None:
        cv = const_tensors(cc, pos.device, pos.dtype)
    state5 = (pos, quat, vel, q, qd)
    plane = None
    if cc.plane_per_step:
        fk0 = fk_chain(cc, cv, pos, quat, vel, q, qd)
        plane = compute_plane(cc, cv, fk0, ph, pr0, pc0)
    tau_last = body_f_last = None
    track_anchors = cc.warm_start and anchors is not None
    groups = split_anchors(cc.cm, anchors) if track_anchors else None
    for _ in range(cc.decimation):
        out = one_sim_dt(cc, cv, lp_base, lp_lvl, mu_env, targets, state5,
                         plane, anchors=groups, patch=(ph, pr0, pc0))
        if track_anchors:
            state5, tau_last, body_f_last, groups = out
        else:
            state5, tau_last, body_f_last = out
    if track_anchors:
        return state5 + (tau_last, body_f_last, pack_anchors(groups))
    return state5 + (tau_last, body_f_last)
