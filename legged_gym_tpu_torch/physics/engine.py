"""The physics engine: constants, the apparent-mass probe and the general
stacked sim step (PD or held-torque drive + contact + self-collision +
body damping + ABA + integration), in plain torch ops on an explicit
device, batch-last.

A sim step is ``(state, params, targets | torques) -> (state', SimInfo)``
over ``sim.substeps`` inner substeps (``step_pos_targets`` /
``step_torques``). The env takes this general engine where the fused
chain step (chain_engine.py / chain_step.py, the CUDA kernel on the card)
does not apply: self-collision, per-link body damping, V / T control, an
applied UniNet, or ``sim.use_chain_engine = False``. The chain step is
held against it (tests/test_torch_general.py).

The apparent-mass probe and the self-collision rest filter run once at
construction on the CPU in float32 whatever device the env simulates on:
their results are host-side constants. Every per-step constant is built
once per (device, dtype) (``Engine.consts``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from legged_gym_tpu_torch.ops import lin
from legged_gym_tpu_torch.physics.aba import aba
from legged_gym_tpu_torch.physics.contact import (ContactConfig,
                                                  SelfCollision,
                                                  accumulate_body_forces,
                                                  accumulate_link_wrenches,
                                                  contact_forces,
                                                  self_collision_candidate_pairs)
from legged_gym_tpu_torch.physics.integrator import integrate
from legged_gym_tpu_torch.physics.kinematics import (contact_point_kinematics,
                                                     forward_kinematics)
from legged_gym_tpu_torch.physics.state import PhysicsState


@dataclasses.dataclass(frozen=True)
class SimConfig:
    dt: float = 0.005                 # sim dt (reference sim.dt)
    substeps: int = 4                 # inner contact substeps per sim dt
    gravity: tuple = (0.0, 0.0, -9.81)
    contact: ContactConfig = dataclasses.field(default_factory=ContactConfig)
    # joint-limit spring-damper beyond the URDF limits
    limit_stiffness: float = 300.0    # N*m/rad
    limit_damping: float = 6.0
    # joint velocity cap, scaled on top of the URDF velocity limit
    vel_limit_scale: float = 2.0
    # base velocity backstops
    max_base_ang_vel: float = 100.0
    max_base_lin_vel: float = 100.0
    # joint-space inertia floor added to the ABA diagonal [kg m^2]
    # (reflected rotor inertia; keeps 1/D finite for light distal links)
    armature_floor: float = 0.005


@dataclasses.dataclass(frozen=True)
class SimInfo:
    body_forces: torch.Tensor   # (3, nb, N) net contact force per report body
    torques: torch.Tensor       # (nq, N) applied joint torques (sensor)


class Engine:
    """One robot model under one SimConfig: host-side constants and the
    general stacked sim step."""

    def __init__(self, model, sim: SimConfig, grid=None, kp=None, kd=None,
                 fixed_base=False, lin_damping=0.0, ang_damping=0.0,
                 self_collision=False):
        """grid: TerrainGrid or None (plane). lin_damping / ang_damping:
        Isaac asset linear_damping / angular_damping, a mass- and
        inertia-proportional drag wrench per link (f = -c m v,
        n = -c I w). self_collision: Isaac asset.self_collisions == 0,
        sphere-set self-contact between points of distinct non-adjacent
        links (the candidate pairs; filter_self_collision_pairs drops
        those at rest overlap)."""
        self.model = model
        self.sim = sim
        self.grid = grid
        self.fixed_base = fixed_base
        self.lin_damping = float(lin_damping)
        self.ang_damping = float(ang_damping)
        self.sc_pairs = None
        if self_collision and len(model.cp_link):
            self.sc_pairs = self_collision_candidate_pairs(model)
        nq = model.nq
        self.kp = np.zeros(nq) if kp is None else np.asarray(kp, float)
        self.kd = np.zeros(nq) if kd is None else np.asarray(kd, float)
        self.torque_limit = np.asarray(model.dof_effort, float)
        self.dt_inner = sim.dt / sim.substeps
        # analytic LOWER bound of the apparent mass at each contact point:
        # 1/m_app = 1/m + max over unit force directions n of
        # (p x n)^T I_O^-1 (p x n) (single-link worst case)
        link_mass = np.zeros(model.nl)
        link_I_O = np.zeros((model.nl, 3, 3))
        for li in range(model.nl):
            params = np.zeros(10)
            for b in range(model.n_orig):
                if model.contrib_link[b] == li:
                    params += model.contrib[b]
            link_mass[li] = params[0]
            link_I_O[li] = np.array([[params[4], params[5], params[6]],
                                     [params[5], params[7], params[8]],
                                     [params[6], params[8], params[9]]])
        m_eff = []
        for k in range(len(model.cp_link)):
            li = int(model.cp_link[k])
            inv_m = 1.0 / max(link_mass[li], 1e-6)
            p = model.cp_pos[k]
            r2 = float(np.dot(p, p))
            if li > 0 and r2 > 1e-6:
                I_inv = np.linalg.inv(link_I_O[li] + 1e-10 * np.eye(3))
                phat = p / np.sqrt(r2)
                a = np.array([1.0, 0.0, 0.0])
                if abs(phat[0]) > 0.9:
                    a = np.array([0.0, 1.0, 0.0])
                u1 = np.cross(phat, a)
                u1 /= np.linalg.norm(u1)
                u2 = np.cross(phat, u1)
                B = np.stack([u1, u2], axis=1)
                inv_m = inv_m + r2 * np.linalg.eigvalsh(B.T @ I_inv @ B).max()
            m_eff.append(1.0 / inv_m)
        self.cp_m_eff = np.asarray(m_eff) if m_eff else np.zeros(0)
        # tangential (friction-cap) apparent mass, refined by the probe
        self.cp_m_eff_t = self.cp_m_eff.copy()
        # per-point pushout-velocity cap
        self.cp_vmax = np.full(len(self.cp_m_eff),
                               sim.contact.max_pushout_vel)
        # one-way static-support spring stiffness per point (set by the probe)
        self.cp_k_static = np.zeros(len(self.cp_m_eff))
        # implicit joint-space diagonal: URDF damping + PD kd + dt*kp,
        # plus the armature floor
        self._imp_pd = (self.dt_inner
                        * (self.kd + self.dt_inner * self.kp
                           + np.asarray(model.dof_damping))
                        + sim.armature_floor)[:, None]
        # the same without the PD servo: what a torque-driven joint sees
        self._imp_passive = (self.dt_inner * np.asarray(model.dof_damping)
                             + sim.armature_floor)[:, None]
        self._has_joint_damping = bool(np.any(model.dof_damping != 0.0))
        self._dev = {}

    @property
    def has_self_collision(self):
        return self.sc_pairs is not None and len(self.sc_pairs) > 0

    def filter_self_collision_pairs(self, q0, margin=1.2):
        """Drop the self-collision candidate pairs at or near overlap in
        the default pose ``q0``: the sphere set over-approximates the
        collision meshes near the hips, and a rest-pose overlap would
        inject permanent forces. A pair is kept if its rest center
        distance exceeds ``margin`` times the radius sum. One FK on the
        CPU in float32."""
        if not self.has_self_collision:
            return
        m = self.model
        dtype = torch.float32
        pos = torch.zeros((3, 1), dtype=dtype)
        pos[2] = 100.0
        quat = torch.tensor([[0.0], [0.0], [0.0], [1.0]], dtype=dtype)
        phys = PhysicsState(
            pos=pos, quat=quat, vel=torch.zeros((6, 1), dtype=dtype),
            q=torch.as_tensor(np.asarray(q0), dtype=dtype)[:, None],
            qd=torch.zeros((m.nq, 1), dtype=dtype))
        with torch.no_grad():
            cp_pos, _ = contact_point_kinematics(
                m, forward_kinematics(m, phys))
        p = cp_pos[:, :, 0].numpy()                          # (3, P)
        i, j = self.sc_pairs[:, 0], self.sc_pairs[:, 1]
        dist = np.linalg.norm(p[:, i] - p[:, j], axis=0)
        rsum = m.cp_radius[i] + m.cp_radius[j]
        self.sc_pairs = self.sc_pairs[dist > margin * rsum]
        self._dev = {}

    def calibrate_contact_mass(self, q0, inertia_params_fn, safety=0.7,
                               drive="pd"):
        """Replace the analytic apparent-mass lower bound with a numeric
        probe of the true step-response mass at every collision point:
        one engine substep (PD holding the pose, no contact, no gravity)
        per point and axis with a unit world force at that point;
        m_app = F * dt / dv. Probed at poses q0 * s for s in
        {1.0, 0.7, 1.3} (clamped to the hard limits), keeping the minimum.
        drive: which joint impedance the probe includes: "pd" for
        position-drive robots (the implicit servo dt*(kd+dt*kp) dominates
        the response) or "torque" for robots driven by held torques (the
        SEA net): those run with the passive impedance only, and probing
        with the servo overestimates the apparent mass, so the stopping
        impulse over-corrects and the stance micro-bounces.
        q0: (nq,) default joint positions.
        inertia_params_fn: n -> (nl, 10, n) nominal link inertias (CPU).
        """
        m = self.model
        P = len(m.cp_link)
        if P == 0:
            return
        dtype = torch.float32
        n = 3 * P            # env (3k + a): unit force along axis a at point k
        if drive not in ("pd", "torque"):
            raise ValueError(f"drive {drive!r}: 'pd' or 'torque'")
        implicit_d = torch.as_tensor(
            self._imp_pd if drive == "pd" else self._imp_passive,
            dtype=dtype)
        pt = torch.eye(P, dtype=dtype).repeat(1, 3)              # (P, 3P)
        ax = torch.eye(3, dtype=dtype).repeat_interleave(P, dim=1)  # (3, 3P)
        f_pts = ax[:, None, :] * pt[None]                        # (3, P, 3P)
        karo = torch.arange(P)

        def probe_at(q_pose):
            q = q_pose[:, None].expand(m.nq, n).clone()
            pos = torch.zeros((3, n), dtype=dtype)
            pos[2] = 100.0                                       # airborne
            quat = torch.zeros((4, n), dtype=dtype)
            quat[3] = 1.0
            phys = PhysicsState(pos=pos, quat=quat,
                                vel=torch.zeros((6, n), dtype=dtype), q=q,
                                qd=torch.zeros((m.nq, n), dtype=dtype))
            params = inertia_params_fn(n)
            tau = torch.zeros((m.nq, n), dtype=dtype)
            fk = forward_kinematics(m, phys)
            cp_pos, _ = contact_point_kinematics(m, fk)
            link_f, link_n = accumulate_link_wrenches(m, fk, cp_pos, f_pts)
            a0, qdd = aba(m, params, fk, phys.qd, tau, f_ext_w=link_f,
                          n_ext_w=link_n, fixed_base=self.fixed_base,
                          implicit_d=implicit_d)
            new = integrate(phys, a0, qdd, self.dt_inner)
            _, cp_vel2 = contact_point_kinematics(
                m, forward_kinematics(m, new))
            dv = torch.stack([cp_vel2[a][karo, a * P + karo]
                              for a in range(3)])                # (3, P)
            return self.dt_inner / torch.clamp_min(dv, 1e-9)

        q0t = torch.as_tensor(np.asarray(q0), dtype=dtype)
        lo = torch.as_tensor(m.dof_lower, dtype=dtype)
        hi = torch.as_tensor(m.dof_upper, dtype=dtype)
        with torch.no_grad():
            m_num = torch.stack([
                probe_at(torch.clamp(q0t * s, lo, hi))
                for s in (1.0, 0.7, 1.3)]).amin(dim=0).numpy()   # (3, P)
        self.cp_m_eff = np.maximum(self.cp_m_eff, safety * m_num[2])
        self.cp_m_eff_t = np.maximum(
            np.minimum(self.cp_m_eff_t, self.cp_m_eff),
            safety * np.minimum(m_num[0], m_num[1]))
        # one-way static-support spring: one point carries 1.2x a
        # four-foot share of the weight at 5 mm depth
        W = self.model.total_mass * 9.81
        self.cp_k_static = np.full(P, 1.2 * 0.3 * W / 0.005)
        self._dev = {}

    # ------------------------------------------------------ the sim step

    def consts(self, dtype, device):
        """Per-step constants on ``device``: built on the first call for
        each (device, dtype), after the probe and the pair filter."""
        key = (str(device), dtype)
        if key in self._dev:
            return self._dev[key]
        m, sim = self.model, self.sim

        def col(a):
            return torch.as_tensor(np.asarray(a, float), dtype=dtype,
                                   device=device)[:, None]

        lim = col(self.torque_limit)
        vcap = (col(m.dof_vel_limit * sim.vel_limit_scale)
                if sim.vel_limit_scale else None)
        c = {
            "kp": col(self.kp),
            "kd_eff": col(self.kd + self.dt_inner * self.kp),
            "lim": lim, "neg_lim": -lim,
            "imp_pd": col(self._imp_pd[:, 0]),
            "imp_passive": col(self._imp_passive[:, 0]),
            "dof_damping": col(m.dof_damping),
            "lower": col(m.dof_lower), "upper": col(m.dof_upper),
            "vcap": vcap,
            "m_eff": col(self.cp_m_eff), "m_eff_t": col(self.cp_m_eff_t),
            "vmax": col(self.cp_vmax), "k_static": col(self.cp_k_static),
            "gravity": torch.as_tensor(sim.gravity, dtype=dtype,
                                       device=device)[:, None, None],
            "sc": (SelfCollision(m, self.sc_pairs, self.cp_m_eff, dtype,
                                 device)
                   if self.has_self_collision else None),
        }
        self._dev[key] = c
        return c

    def _substep(self, state, inertia_params, friction, tau_fn, implicit_d,
                 patch=None, f_ws=None):
        """One inner substep: FK, contact kinematics and forces (terrain,
        then self-contact), link wrenches and body forces, body damping,
        joint damping, the joint-limit spring-damper (implicitly damped
        when active), ABA, the capped integration with hard limits.
        Returns (state', SimInfo, anchors' or None)."""
        m, sim = self.model, self.sim
        c = self.consts(state.pos.dtype, state.pos.device)
        fk = forward_kinematics(m, state)
        ws_out = None
        if len(m.cp_link):
            cp_pos, cp_vel = contact_point_kinematics(m, fk)
            out = contact_forces(m, self.grid, sim.contact, cp_pos, cp_vel,
                                 friction, dt=self.dt_inner,
                                 m_eff=c["m_eff"], m_eff_t=c["m_eff_t"],
                                 v_max=c["vmax"], f_prev=f_ws, patch=patch,
                                 k_static=c["k_static"])
            f_pts, ws_out = out if isinstance(out, tuple) else (out, None)
            if c["sc"] is not None:
                f_pts = f_pts + c["sc"](cp_pos, cp_vel, self.dt_inner)
            link_f, link_n = accumulate_link_wrenches(m, fk, cp_pos, f_pts)
            body_forces = accumulate_body_forces(m, f_pts)
        else:
            link_f = link_n = None
            body_forces = torch.zeros((3, m.num_bodies, state.n),
                                      dtype=state.pos.dtype,
                                      device=state.pos.device)
        if self.lin_damping != 0.0 or self.ang_damping != 0.0:
            # PhysX body damping analog: drag wrenches per link about its
            # origin, in the world frame (fk velocities are link-frame)
            par = inertia_params.movedim(1, 0)               # (10, nl, N)
            v_w = lin.mv(fk.R_w, fk.v_lin)                   # (3, nl, N)
            f_d = -self.lin_damping * par[0][None] * v_w
            w = fk.v_ang
            Iw = torch.stack([
                par[4] * w[0] + par[5] * w[1] + par[6] * w[2],
                par[5] * w[0] + par[7] * w[1] + par[8] * w[2],
                par[6] * w[0] + par[8] * w[1] + par[9] * w[2]])
            n_d = -self.ang_damping * lin.mv(fk.R_w, Iw)
            link_f = f_d if link_f is None else link_f + f_d
            link_n = n_d if link_n is None else link_n + n_d
        tau = tau_fn(state)
        tau_total = tau
        if self._has_joint_damping:
            tau_total = tau_total - c["dof_damping"] * state.qd
        k_lim, c_lim = sim.limit_stiffness, sim.limit_damping
        if k_lim > 0:
            over = torch.clamp_min(state.q - c["upper"], 0.0)
            under = torch.clamp_min(c["lower"] - state.q, 0.0)
            active = ((over > 0) | (under > 0)).to(state.pos.dtype)
            tau_total = tau_total + k_lim * (under - over) \
                - c_lim * active * state.qd
            implicit_d = implicit_d + self.dt_inner * (
                c_lim + self.dt_inner * k_lim) * active
        a0, qdd = aba(m, inertia_params, fk, state.qd, tau_total,
                      f_ext_w=link_f, n_ext_w=link_n, gravity=c["gravity"],
                      fixed_base=self.fixed_base, implicit_d=implicit_d)
        new_state = integrate(state, a0, qdd, self.dt_inner,
                              qd_cap=c["vcap"],
                              base_ang_cap=sim.max_base_ang_vel,
                              base_lin_cap=sim.max_base_lin_vel,
                              q_lower=c["lower"], q_upper=c["upper"])
        return new_state, SimInfo(body_forces=body_forces, torques=tau), \
            ws_out

    def _run_substeps(self, state, inertia_params, friction, tau_fn,
                      implicit_d, patch=None, f_ws=None):
        """``sim.substeps`` substeps; the anchors (when ``f_ws`` is given)
        carry across them; the sensors are the last substep's."""
        info = None
        for _ in range(self.sim.substeps):
            state, info, ws = self._substep(state, inertia_params, friction,
                                            tau_fn, implicit_d, patch=patch,
                                            f_ws=f_ws)
            if f_ws is not None:
                f_ws = ws
        if f_ws is not None:
            return state, info, f_ws
        return state, info

    def step_pos_targets(self, state, inertia_params, friction, targets,
                         patch=None, f_ws=None):
        """Position-drive sim step (reference legged_robot.py:93-96): the
        clipped PD torque to ``targets`` (nq, N), re-evaluated every
        substep, with the servo's implicit damping. patch: per-env
        TerrainPatch; f_ws: (3, P, N) anchors (warm start). Returns
        (state', SimInfo[, anchors'])."""
        c = self.consts(state.pos.dtype, state.pos.device)
        kp, kd_eff = c["kp"], c["kd_eff"]

        def tau_fn(s):
            return torch.clamp(kp * (targets - s.q) - kd_eff * s.qd,
                               c["neg_lim"], c["lim"])

        return self._run_substeps(state, inertia_params, friction, tau_fn,
                                  c["imp_pd"], patch=patch, f_ws=f_ws)

    def step_torques(self, state, inertia_params, friction, tau, patch=None,
                     f_ws=None):
        """Torque-drive sim step: ``tau`` (nq, N) held over the sim dt,
        clipped to the URDF effort limits (reference
        _compute_torques:392), with the passive joint impedance."""
        c = self.consts(state.pos.dtype, state.pos.device)
        tau_c = torch.clamp(tau, c["neg_lim"], c["lim"])

        def tau_fn(s):
            return tau_c

        return self._run_substeps(state, inertia_params, friction, tau_fn,
                                  c["imp_passive"], patch=patch, f_ws=f_ws)
