"""Host-side chain decomposition of a RobotModel.

Legged robots are star-shaped trees: a floating base with K independent
SERIAL chains (legs) hanging off it. In that case the whole tree walk
vectorizes with the CHAIN axis as a batch axis: level l of every
chain is processed in one (…, K, N) block, and the parent of level l is
simply level l-1 **in the same chain slot** — no gathers, scatters, or
permutations anywhere in FK or ABA. This module validates the structure
and precomputes every per-level constant the chain-structured engine
(chain_step.py / chain_kernel.py) needs.

Reference correspondence: this replaces the general tree bookkeeping the
PhysX articulation importer performs (legged_robot.py:645-740); the
chain layout is the answer to PhysX's internal articulation
batching.
"""
from __future__ import annotations

import dataclasses

import numpy as np


class NotChainStructured(Exception):
    """Raised when the model is not base + serial chains (fall back to the
    general stacked engine)."""


@dataclasses.dataclass(frozen=True)
class PointGroup:
    """A group of collision points owned by one tree level (or the base).

    For level groups, arrays are (S, K): S point slots per chain; slots a
    chain doesn't fill are masked inactive. For the base group K == 1 and
    arrays are (S, 1)."""
    level: int                 # -1 for base
    offs: np.ndarray           # (S, K, 3) point offset in link frame
    radius: np.ndarray         # (S, K)
    m_eff: np.ndarray          # (S, K) apparent mass (engine-provided)
    m_eff_t: np.ndarray        # (S, K) tangential (friction-cap) mass
    vmax: np.ndarray           # (S, K) per-point pushout-velocity cap
    k_static: np.ndarray       # (S, K) one-way support-spring stiffness
    active: np.ndarray         # (S, K) bool
    cp_index: np.ndarray       # (S, K) original index into model.cp_* (-1
    #                            for inactive slots)
    body: np.ndarray           # (S, K) report-body index of each point
    #                            (contact-sensor accumulation; 0 for
    #                            inactive slots, masked by `active`)


@dataclasses.dataclass(frozen=True)
class ChainModel:
    K: int                     # number of chains
    L: int                     # max chain length (levels)
    J: np.ndarray              # (L, K) dof index, -1 inactive
    LI: np.ndarray             # (L, K) link index (J+1 clamped to 0 for
    #                            inactive — points at base, fully masked)
    active: np.ndarray         # (L, K) bool
    # per-level joint constants
    axis: np.ndarray           # (L, K, 3) joint axis, child frame
    Rj: np.ndarray             # (L, K, 3, 3) fixed joint rotation
    pj: np.ndarray             # (L, K, 3) joint origin in parent frame
    # per-level dof properties (rows aligned with J)
    lower: np.ndarray          # (L, K)
    upper: np.ndarray          # (L, K)
    effort: np.ndarray         # (L, K)
    vel_limit: np.ndarray      # (L, K)
    damping: np.ndarray        # (L, K)
    armature: np.ndarray       # (L, K)
    # collision points
    groups: tuple              # tuple[PointGroup], base group first
    n_points: int              # == len(model.cp_link)
    n_bodies: int              # report bodies (contact-sensor rows)


def build_chain_model(model, m_eff, m_eff_t=None, vmax=None,
                      k_static=None) -> ChainModel:
    """Decompose `model` (RobotModel) into base + serial chains.

    m_eff: (P,) apparent contact masses (computed by the Engine; stored
    per point group here). m_eff_t: (P,) tangential masses for the
    friction cap (defaults to m_eff).

    Raises NotChainStructured if any non-base link has more than one
    child, or any prismatic joint is present (the general engine takes
    such a model).
    """
    nl = model.nl
    if np.any(model.joint_is_prismatic):
        raise NotChainStructured("prismatic joints")
    children = [[] for _ in range(nl)]
    for li in range(1, nl):
        children[model.link_parent[li]].append(li)
    for li in range(1, nl):
        if len(children[li]) > 1:
            raise NotChainStructured(f"link {li} has {len(children[li])} "
                                     "children")
    # chains start at base's children
    chains = []
    for root in children[0]:
        chain = [root]
        while children[chain[-1]]:
            chain.append(children[chain[-1]][0])
        chains.append(chain)
    if not chains:
        raise NotChainStructured("no joints")
    K = len(chains)
    L = max(len(c) for c in chains)

    J = np.full((L, K), -1, np.int32)
    for k, chain in enumerate(chains):
        for l, li in enumerate(chain):
            J[l, k] = li - 1            # joint j moves link j+1
    active = J >= 0
    LI = np.where(active, J + 1, 0).astype(np.int32)

    def dof_rows(arr, fill=0.0):
        out = np.full((L, K), fill, np.float64)
        out[active] = np.asarray(arr, np.float64)[J[active]]
        return out

    axis = np.zeros((L, K, 3))
    axis[..., 2] = 1.0                  # benign axis for inactive slots
    axis[active] = model.joint_axis[J[active]]
    Rj = np.broadcast_to(np.eye(3), (L, K, 3, 3)).copy()
    Rj[active] = model.joint_rot[J[active]]
    pj = np.zeros((L, K, 3))
    pj[active] = model.joint_pos[J[active]]

    # ---- collision point groups ----
    link_level = np.full(nl, -1, np.int32)  # base -1
    link_chain = np.zeros(nl, np.int32)
    for k, chain in enumerate(chains):
        for l, li in enumerate(chain):
            link_level[li] = l
            link_chain[li] = k

    P = len(model.cp_link)
    if m_eff_t is None:
        m_eff_t = m_eff
    if vmax is None:
        vmax = np.full(P, 0.5)
    if k_static is None:
        k_static = np.zeros(P)
    groups = []
    # base group
    base_sel = np.nonzero(model.cp_link == 0)[0]
    if len(base_sel):
        S = len(base_sel)
        groups.append(PointGroup(
            level=-1,
            offs=model.cp_pos[base_sel][:, None, :].copy(),
            radius=model.cp_radius[base_sel][:, None].copy(),
            m_eff=np.asarray(m_eff)[base_sel][:, None].copy(),
            m_eff_t=np.asarray(m_eff_t)[base_sel][:, None].copy(),
            vmax=np.asarray(vmax)[base_sel][:, None].copy(),
            k_static=np.asarray(k_static)[base_sel][:, None].copy(),
            active=np.ones((S, 1), bool),
            cp_index=base_sel[:, None].astype(np.int32),
            body=model.cp_body[base_sel][:, None].astype(np.int32)))
    for l in range(L):
        sel = np.nonzero(link_level[model.cp_link] == l)[0]
        if not len(sel):
            continue
        per_chain = [sel[link_chain[model.cp_link[sel]] == k]
                     for k in range(K)]
        S = max(len(pc) for pc in per_chain)
        offs = np.zeros((S, K, 3))
        radius = np.zeros((S, K))
        me = np.ones((S, K))
        met = np.ones((S, K))
        vmx = np.full((S, K), 0.5)
        kst = np.zeros((S, K))
        act = np.zeros((S, K), bool)
        cpi = np.full((S, K), -1, np.int32)
        bod = np.zeros((S, K), np.int32)
        for k, pc in enumerate(per_chain):
            n = len(pc)
            offs[:n, k] = model.cp_pos[pc]
            radius[:n, k] = model.cp_radius[pc]
            me[:n, k] = np.asarray(m_eff)[pc]
            met[:n, k] = np.asarray(m_eff_t)[pc]
            vmx[:n, k] = np.asarray(vmax)[pc]
            kst[:n, k] = np.asarray(k_static)[pc]
            act[:n, k] = True
            cpi[:n, k] = pc
            bod[:n, k] = model.cp_body[pc]
        groups.append(PointGroup(level=l, offs=offs, radius=radius,
                                 m_eff=me, m_eff_t=met, vmax=vmx,
                                 k_static=kst,
                                 active=act, cp_index=cpi, body=bod))

    return ChainModel(
        K=K, L=L, J=J, LI=LI, active=active,
        axis=axis, Rj=Rj, pj=pj,
        lower=dof_rows(model.dof_lower),
        upper=dof_rows(model.dof_upper, fill=1.0),
        effort=dof_rows(model.dof_effort),
        vel_limit=dof_rows(model.dof_vel_limit, fill=1.0),
        damping=dof_rows(model.dof_damping),
        armature=dof_rows(model.armature),
        groups=tuple(groups), n_points=P,
        n_bodies=model.num_bodies)
