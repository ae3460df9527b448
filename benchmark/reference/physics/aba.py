"""Featherstone articulated-body algorithm (ABA), floating base — stacked,
level-parallel, batch-last.

RBDA (Featherstone 2008) Table 7.1 adapted to a 6-dof floating base
(sec. 9.4): the base acceleration solves I^A_0 a_0 = -p^A_0 by a
symmetric 6x6 block Schur solve. Articulated inertia is kept as 3x3
blocks [[A, B], [B^T, C]]; gravity and contacts enter as external
wrenches. Link-indexed state is carried as per-link Python lists, as in
the JAX package. Used by the general stacked engine (engine.Engine) and
the apparent-mass probe; the chain paths run the chain layout
(chain_step.aba_chain). Revolute and prismatic joints (motion subspace
S = [axis; 0] or [0; axis]); levels without a prismatic joint skip the
blend. Model constants come from kinematics.model_consts (built once per
device and dtype).
"""
from __future__ import annotations

import torch

from benchmark.reference.ops import lin
from benchmark.reference.ops.quat import cross
from benchmark.reference.physics.kinematics import model_consts


def aba(model, inertia_params, fk, qd, tau, f_ext_w=None, n_ext_w=None,
        gravity=None, fixed_base=False, implicit_d=None):
    """Forward dynamics.

    inertia_params: (nl, 10, N); fk: kinematics.FK; qd, tau: (nq, N);
    f_ext_w / n_ext_w: optional (3, nl, N) world wrenches about each link
    origin; gravity: (3, 1, 1) world gravity on fk's device, None for
    none; implicit_d: optional (nq, 1) / (nq, N) tensor, extra
    joint-space diagonal added to D.
    Returns (a_base (6, N) base-frame spatial acceleration, qdd (nq, N)).
    """
    nq, nl = model.nq, model.nl
    dtype, dev = fk.p_w.dtype, fk.p_w.device
    mc = model_consts(model, dtype, dev)
    n = qd.shape[-1]

    # ---- pass 1: all links at once ----
    par = inertia_params.movedim(1, 0)                       # (10, nl, N)
    m = par[0]
    h = par[1:4]
    A = torch.stack([
        torch.stack([par[4], par[5], par[6]]),
        torch.stack([par[5], par[7], par[8]]),
        torch.stack([par[6], par[8], par[9]]),
    ])                                                       # (3,3,nl,N)
    IA_B = lin.skew(h)
    IA_C = m[None, None] * lin.eye(m.shape, dtype, dev)

    w, v = fk.v_ang, fk.v_lin
    n_m = lin.mv(A, w) + cross(h, v)
    f_m = m[None] * v - cross(h, w)
    pA_n = cross(w, n_m) + cross(v, f_m)
    pA_f = cross(w, f_m)
    f_tot = n_tot = 0.0
    if gravity is not None:
        g_l = lin.mtv(fk.R_w, gravity.expand(3, nl, n))
        f_tot = m[None] * g_l
        n_tot = cross(h, g_l)
    if f_ext_w is not None:
        f_tot = f_tot + lin.mtv(fk.R_w, f_ext_w)
        n_tot = n_tot + lin.mtv(fk.R_w, n_ext_w)
    pA_n = pA_n - n_tot
    pA_f = pA_f - f_tot

    # velocity-product accelerations c_j = v_child x (S qd)
    if mc.prism_all is None:
        Sqd_ang = mc.axes_all * qd[None]                     # (3, nq, N)
        c_ang = cross(w[:, 1:], Sqd_ang)                     # (3, nq, N)
        c_lin = cross(v[:, 1:], Sqd_ang)
    else:
        pm = mc.prism_all
        Sqd_ang = mc.axes_all * (1.0 - pm) * qd[None]
        Sqd_lin = mc.axes_all * pm * qd[None]
        c_ang = cross(w[:, 1:], Sqd_ang)
        c_lin = cross(w[:, 1:], Sqd_lin) + cross(v[:, 1:], Sqd_ang)

    if implicit_d is not None:
        D_extra = (mc.armature + implicit_d).expand(nq, n)
    else:
        D_extra = mc.armature.expand(nq, n)

    IA_cols = [[A[:, :, l], IA_B[:, :, l], IA_C[:, :, l]] for l in range(nl)]
    pA_cols = [[pA_n[:, l], pA_f[:, l]] for l in range(nl)]

    # ---- pass 2: inward sweep by level (deepest first) ----
    per_level = {}
    for lc in mc.levels[::-1]:
        idx, li, pi, it = lc.idx, lc.li, lc.pi, lc.idx_t
        axis3 = lc.axis
        A_l = torch.stack([IA_cols[l][0] for l in li], dim=2)
        B_l = torch.stack([IA_cols[l][1] for l in li], dim=2)
        C_l = torch.stack([IA_cols[l][2] for l in li], dim=2)
        pn_l = torch.stack([pA_cols[l][0] for l in li], dim=1)
        pf_l = torch.stack([pA_cols[l][1] for l in li], dim=1)

        # U = I^A S, D = S^T U, u = tau - S^T p^A
        if lc.pm is None:
            Ua = lin.mv(A_l, axis3)
            Ul = lin.mtv(B_l, axis3)
            D = torch.sum(axis3 * Ua, dim=0) + D_extra[it]
            u = tau[it] - torch.sum(axis3 * pn_l, dim=0)
        else:
            pm = lc.pm[None]                                 # (1, L, 1)
            Ua = lin.mv(A_l, axis3) * (1 - pm) + lin.mv(B_l, axis3) * pm
            Ul = lin.mtv(B_l, axis3) * (1 - pm) + lin.mv(C_l, axis3) * pm
            D = (torch.sum(axis3 * (Ua * (1 - pm) + Ul * pm), dim=0)
                 + D_extra[it])
            u = tau[it] - torch.sum(
                axis3 * (pn_l * (1 - pm) + pf_l * pm), dim=0)
        di = 1.0 / D
        per_level[idx[0]] = (Ua, Ul, di, u)

        Ia_A = A_l - di[None, None] * lin.outer(Ua, Ua)
        Ia_B = B_l - di[None, None] * lin.outer(Ua, Ul)
        Ia_C = C_l - di[None, None] * lin.outer(Ul, Ul)
        ca = c_ang[:, it]
        cl = c_lin[:, it]
        pa_n = pn_l + lin.mv(Ia_A, ca) + lin.mv(Ia_B, cl) + Ua * (di * u)[None]
        pa_f = pf_l + lin.mtv(Ia_B, ca) + lin.mv(Ia_C, cl) + Ul * (di * u)[None]

        R = fk.R_loc[:, :, it]
        p = fk.p_loc[:, it]
        pT = lin.skew(p)
        RA = lin.mm(R, lin.mmt(Ia_A, R))
        RB = lin.mm(R, lin.mmt(Ia_B, R))
        RC = lin.mm(R, lin.mmt(Ia_C, R))
        A_p = (RA - lin.mm(RB, pT) + lin.mm(pT, lin.transpose(RB))
               - lin.mm(pT, lin.mm(RC, pT)))
        B_p = RB + lin.mm(pT, RC)
        Rf = lin.mv(R, pa_f)
        n_p = lin.mv(R, pa_n) + cross(p, Rf)

        for j, pj in enumerate(pi):
            IA_cols[pj][0] = IA_cols[pj][0] + A_p[:, :, j]
            IA_cols[pj][1] = IA_cols[pj][1] + B_p[:, :, j]
            IA_cols[pj][2] = IA_cols[pj][2] + RC[:, :, j]
            pA_cols[pj][0] = pA_cols[pj][0] + n_p[:, j]
            pA_cols[pj][1] = pA_cols[pj][1] + Rf[:, j]

    # ---- base acceleration: I^A_0 a_0 = -p^A_0 ----
    if fixed_base:
        a0_ang = torch.zeros_like(pA_cols[0][0])
        a0_lin = torch.zeros_like(pA_cols[0][1])
    else:
        a0_ang, a0_lin = lin.solve66_sym(
            IA_cols[0][0], IA_cols[0][1], IA_cols[0][2],
            -pA_cols[0][0], -pA_cols[0][1])

    # ---- pass 3: outward sweep by level ----
    a_cols = [None] * nl
    a_cols[0] = (a0_ang, a0_lin)
    qdd = [None] * nq
    for lc in mc.levels:
        idx, li, pi, it = lc.idx, lc.li, lc.pi, lc.idx_t
        R = fk.R_loc[:, :, it]
        p = fk.p_loc[:, it]
        axis3 = lc.axis
        par_ang = torch.stack([a_cols[pj][0] for pj in pi], dim=1)
        par_lin = torch.stack([a_cols[pj][1] for pj in pi], dim=1)
        ap_ang = lin.mtv(R, par_ang) + c_ang[:, it]
        ap_lin = lin.mtv(R, par_lin + cross(par_ang, p)) + c_lin[:, it]
        Ua, Ul, di, u = per_level[idx[0]]
        qdd_l = di * (u - (torch.sum(Ua * ap_ang, dim=0)
                           + torch.sum(Ul * ap_lin, dim=0)))
        if lc.pm is None:
            al_ang, al_lin = ap_ang + axis3 * qdd_l[None], ap_lin
        else:
            pm = lc.pm[None]
            al_ang = ap_ang + axis3 * (1 - pm) * qdd_l[None]
            al_lin = ap_lin + axis3 * pm * qdd_l[None]
        for j, (lj, jj) in enumerate(zip(li, idx)):
            a_cols[lj] = (al_ang[:, j], al_lin[:, j])
            qdd[jj] = qdd_l[j]
    return torch.cat([a0_ang, a0_lin], dim=0), torch.stack(qdd)
