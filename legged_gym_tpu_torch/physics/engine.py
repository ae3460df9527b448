"""Engine constants: the PD gains, the implicit joint-space diagonal and
the calibrated per-contact-point apparent masses that the fused chain
step (chain_engine.py / chain_step.py) is built from.

Only the constructor and the apparent-mass probe of the JAX package's
``physics/engine.py`` are ported here; its general stacked step
(``_substep`` / ``step_pos_targets`` / ``step_torques``) is later work.
The probe runs once at construction on the CPU in float32 whatever device
the env simulates on: its results are host-side constants.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from legged_gym_tpu_torch.physics.aba import aba
from legged_gym_tpu_torch.physics.contact import (ContactConfig,
                                                  accumulate_link_wrenches)
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


class Engine:
    """Host-side constants of one robot model under one SimConfig."""

    def __init__(self, model, sim: SimConfig, kp=None, kd=None,
                 fixed_base=False, self_collision=False):
        if self_collision and len(model.cp_link):
            raise NotImplementedError(
                "self-collision needs the general engine, not ported yet")
        self.model = model
        self.sim = sim
        self.fixed_base = fixed_base
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

    def calibrate_contact_mass(self, q0, inertia_params_fn, safety=0.7):
        """Replace the analytic apparent-mass lower bound with a numeric
        probe of the true step-response mass at every collision point:
        one engine substep (PD holding the pose, no contact, no gravity)
        per point and axis with a unit world force at that point;
        m_app = F * dt / dv. Probed at poses q0 * s for s in
        {1.0, 0.7, 1.3} (clamped to the hard limits), keeping the minimum.
        The probe includes the implicit PD servo impedance (position drive,
        the only drive the port has).
        q0: (nq,) default joint positions.
        inertia_params_fn: n -> (nl, 10, n) nominal link inertias (CPU).
        """
        m = self.model
        P = len(m.cp_link)
        if P == 0:
            return
        dtype = torch.float32
        n = 3 * P            # env (3k + a): unit force along axis a at point k
        implicit_d = torch.as_tensor(self._imp_pd, dtype=dtype)
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
                          n_ext_w=link_n, gravity=(0.0, 0.0, 0.0),
                          fixed_base=self.fixed_base, implicit_d=implicit_d)
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
