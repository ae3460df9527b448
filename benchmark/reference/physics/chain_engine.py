"""Chain-layout engine: the whole policy-step physics (decimation x
substeps) as one call.

On a CUDA device the step runs as one launch of the hand-written kernel
(chain_kernel.run_decimation picks the wrapper of the configuration's
variant, K1-K4); on the CPU, or when the caller asks for it with
``plain=True`` (gradient MPC: the kernel has no backward), it runs the
plain PyTorch version (chain_step.run_decimation_chain). The
torque-drive step for per-sim-dt actuator nets (step_decimation_torque_fn)
is ``decimation`` launches of one sim dt each with the net evaluated in
between. Handles the joint-order
<-> chain-layout conversions (index gathers) and the per-env contact
window.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from benchmark.reference.physics import chain_kernel, chain_step
from benchmark.reference.physics.chains import (NotChainStructured,
                                                 build_chain_model)
from benchmark.reference.physics.state import PhysicsState

# default standalone contact window (cells); the env passes its own
CONTACT_PATCH_S = 16


class ChainEngine:
    """Built from a physics.engine.Engine; raises NotChainStructured if
    the model does not decompose into base + serial chains."""

    def __init__(self, engine, decimation, plane_per_step=True,
                 patch_S=CONTACT_PATCH_S):
        model = engine.model
        sim = engine.sim
        if engine.fixed_base:
            raise NotChainStructured("fixed base")
        if not sim.contact.implicit:
            raise NotChainStructured("explicit contact not supported")
        cm = build_chain_model(model, engine.cp_m_eff, engine.cp_m_eff_t,
                               engine.cp_vmax, k_static=engine.cp_k_static)
        self.engine = engine
        self.model = model
        self.cm = cm
        L, K = cm.L, cm.K

        def lvl(arr, fill=0.0):
            out = np.full((L, K), fill, float)
            out[cm.active] = np.asarray(arr, float)[cm.J[cm.active]]
            return out

        self.cc = chain_step.ChainConsts(
            cm=cm,
            dt_inner=engine.dt_inner,
            substeps=sim.substeps,
            decimation=decimation,
            gravity=tuple(sim.gravity),
            kp=lvl(engine.kp),
            kd_eff=lvl(engine.kd + engine.dt_inner * engine.kp),
            effort=lvl(engine.torque_limit),
            implicit_d=lvl(engine._imp_pd[:, 0]),
            limit_stiffness=sim.limit_stiffness,
            limit_damping=sim.limit_damping,
            lower=lvl(model.dof_lower, fill=-1e9),
            upper=lvl(model.dof_upper, fill=1e9),
            qd_cap=lvl(model.dof_vel_limit * sim.vel_limit_scale, fill=1e9),
            base_ang_cap=sim.max_base_ang_vel,
            base_lin_cap=sim.max_base_lin_vel,
            mu_terrain=sim.contact.terrain_friction,
            slip_velocity=sim.contact.slip_velocity,
            baumgarte=sim.contact.baumgarte,
            border_size=0.0,      # set by bind_grid
            horizontal_scale=1.0,
            wall_thresh=0.0,
            patch_S=patch_S,
            plane_per_step=plane_per_step,
            warm_start=sim.contact.warm_start,
            anchor_beta=sim.contact.anchor_beta,
            anchor_vmax=sim.contact.anchor_vmax,
            anchor_stale2=sim.contact.anchor_stale2,
            anchor_release_depth=sim.contact.anchor_release_depth)
        chain_step.check_variant(self.cc)

        # joint order <-> level layout as index gathers
        self._lvl_index = np.where(cm.active, cm.J, 0).reshape(-1)  # (L*K,)
        self._lvl_mask = cm.active.astype(np.float32)                # (L, K)
        inv = np.zeros(model.nq, np.int64)
        for l in range(L):
            for k in range(K):
                if cm.J[l, k] >= 0:
                    inv[cm.J[l, k]] = l * K + k
        self._from_index = inv                                       # (nq,)
        self._li_flat = cm.LI.reshape(-1)                            # (L*K,)
        self.grid = None
        self._dev_cache = {}
        self._cc_sea = None

    def bind_grid(self, grid):
        """Set the heightfield geometry (None = flat plane)."""
        if grid is None:
            self.cc = dataclasses.replace(self.cc, border_size=0.0,
                                          horizontal_scale=1.0,
                                          wall_thresh=0.0)
        else:
            self.cc = dataclasses.replace(
                self.cc, border_size=grid.border_size,
                horizontal_scale=grid.horizontal_scale,
                wall_thresh=grid.wall_thresh)
        chain_step.check_variant(self.cc)
        self.grid = grid
        self._dev_cache = {}
        self._cc_sea = None

    @property
    def cc_sea(self):
        """The torque-drive twin of ``cc``: one sim dt per launch
        (decimation 1), ``torque_mode`` on, and the PASSIVE joint impedance
        as implicit_d (a torque-driven joint has no PD servo term; the
        servo's impedance here would over-damp the SEA drive). Built once
        per bound grid."""
        if self._cc_sea is None:
            cm = self.cm
            imp = np.zeros((cm.L, cm.K), float)
            imp[cm.active] = np.asarray(
                self.engine._imp_passive[:, 0], float)[cm.J[cm.active]]
            self._cc_sea = dataclasses.replace(
                self.cc, decimation=1, torque_mode=True, implicit_d=imp)
        return self._cc_sea

    def _step_consts(self, cc, device):
        """The plain version's dict and, on CUDA, the kernel's table for
        one ChainConsts on ``device``."""
        table = None
        if torch.device(device).type == "cuda":
            table = torch.as_tensor(chain_kernel.const_table(cc),
                                    device=device)
        return {"cv": chain_step.const_tensors(cc, device), "table": table}

    def _consts(self, device):
        """Per-device constants: the plain version's dict, the kernel's
        table (on CUDA) and the index tensors."""
        key = str(device)
        if key not in self._dev_cache:
            c = {**self._step_consts(self.cc, device),
                 "lvl_index": torch.as_tensor(self._lvl_index,
                                              device=device),
                 "lvl_mask": torch.as_tensor(self._lvl_mask, device=device),
                 "from_index": torch.as_tensor(self._from_index,
                                               device=device),
                 "li_flat": torch.as_tensor(self._li_flat, dtype=torch.long,
                                            device=device)}
            self._dev_cache[key] = c
        return self._dev_cache[key]

    def _sea_consts(self, device):
        """_step_consts of ``cc_sea``, built once per device, not per
        launch."""
        c = self._consts(device)
        if "sea" not in c:
            c["sea"] = self._step_consts(self.cc_sea, device)
        return c["sea"]

    # ------------------------------------------------------ conversions

    def to_level(self, x):
        """(nq, N) -> (L, K, N)."""
        c = self._consts(x.device)
        cm = self.cm
        out = x[c["lvl_index"]].reshape(cm.L, cm.K, x.shape[-1])
        return out * c["lvl_mask"].to(x.dtype)[:, :, None]

    def from_level(self, x_lvl):
        """(L, K, N) -> (nq, N)."""
        c = self._consts(x_lvl.device)
        cm = self.cm
        return x_lvl.reshape(cm.L * cm.K, x_lvl.shape[-1])[c["from_index"]]

    def level_link_params(self, link_params):
        """(nl, 10, N) -> (lp_base (10, N), lp_lvl (L, 10, K, N))."""
        c = self._consts(link_params.device)
        cm = self.cm
        lp = link_params[c["li_flat"]]                      # (L*K, 10, N)
        lp = lp.reshape(cm.L, cm.K, 10, link_params.shape[-1])
        lp = lp.movedim(2, 1)                               # (L, 10, K, N)
        lp = lp * c["lvl_mask"].to(lp.dtype)[:, None, :, None]
        return link_params[0], lp

    def extract_contact_patch(self, grid, x, y):
        """(ph (S,S,N), r0 (N,), c0 (N,)) contact window per env centered
        at the base; zeros on a flat plane (grid None)."""
        S = self.cc.patch_S
        n = x.shape[-1]
        if grid is None:
            z = torch.zeros((S, S, n), dtype=x.dtype, device=x.device)
            zi = torch.zeros((n,), dtype=torch.int32, device=x.device)
            return z, zi, zi
        from benchmark.reference.terrain.heightfield import extract_patches
        h, r0, c0 = extract_patches(grid, x, y, S)
        return h.permute(1, 2, 0).contiguous(), r0, c0

    # ------------------------------------------------------- public step

    def init_anchors(self, n, device, dtype=torch.float32):
        """Far-sentinel static-friction anchors, packed (3, n_points, N)
        in the kernel's point order (chain_step.split_anchors gives the
        JAX package's per-group (3, S, K, N) views). The 1e6 sentinel is
        farther than sqrt(anchor_stale2) from any reachable contact point,
        so the stale rule re-snaps on first touch wherever the robot
        spawns. None when the contact law runs without warm start."""
        if not self.cc.warm_start:
            return None
        return chain_step.init_anchors(self.cm, n, device, dtype)

    def level_args(self, state: PhysicsState, link_params, friction,
                   targets, contact_patch=None):
        """The arguments of chain_kernel.run_decimation /
        run_decimation_chain (after ``cc``) for this state, in the chain
        layout, contiguous."""
        lp_base, lp_lvl = self.level_link_params(link_params)
        if contact_patch is not None:
            ph, r0, c0 = contact_patch
        else:
            ph, r0, c0 = self.extract_contact_patch(
                self.grid, state.pos[0], state.pos[1])
        args = [lp_base, lp_lvl, friction, self.to_level(targets), ph, r0,
                c0, state.pos, state.quat, state.vel, self.to_level(state.q),
                self.to_level(state.qd)]
        return [t.contiguous() for t in args]

    def step_decimation_pos(self, state: PhysicsState, link_params,
                            friction, targets, contact_patch=None,
                            anchors=None, plain=False):
        """Full policy-step physics, position drive. Returns
        (state', torques (nq, N), body_forces (3, nb, N)); body_forces is
        the net-contact-force sensor of the last substep. With
        ``cc.warm_start`` and ``anchors`` (init_anchors layout) a 4th
        element: the updated anchors. CUDA tensors launch the kernel of
        the configuration's variant (K1, K4, or K2 on trimesh / with
        per-sim-dt planes), or raise; CPU tensors run the plain version.
        ``plain``: run the plain version (chain_step.run_decimation_chain)
        on any device and count no launch — the differentiable path, the
        counterpart of the JAX package's ``use_pallas=False`` that
        gradient MPC takes (the kernel has no backward)."""
        c = self._consts(state.pos.device)
        args = self.level_args(state, link_params, friction, targets,
                               contact_patch)
        track_anchors = self.cc.warm_start and anchors is not None
        run = (chain_step.run_decimation_chain if plain
               else chain_kernel.run_decimation)
        kw = {} if plain else {"consts": c["table"]}
        out = run(self.cc, *args, anchors=anchors if track_anchors else None,
                  cv=c["cv"], **kw)
        pos, quat, vel, q_l, qd_l, tau_l, body_f = out[:7]
        new_state = PhysicsState(pos=pos, quat=quat, vel=vel,
                                 q=self.from_level(q_l),
                                 qd=self.from_level(qd_l))
        if track_anchors:
            return new_state, self.from_level(tau_l), body_f, out[7]
        return new_state, self.from_level(tau_l), body_f

    def step_decimation_torque_fn(self, state: PhysicsState, link_params,
                                  friction, tau_fn, carry,
                                  contact_patch=None, anchors=None):
        """Torque-drive policy step for per-sim-dt actuator nets (ANYmal's
        SEA LSTM, anymal.py:71-81): ``decimation`` segments of one sim dt
        each (kernel variant K3, one launch per segment on the card) with
        ``tau_fn``, ``(q (nq,N), qd (nq,N), carry) -> (tau (nq,N),
        carry')``, evaluated between them in plain torch ops. The contact
        window is read by every segment; the anchors thread through, each
        segment's output the next one's input.

        Returns (state', torques (nq, N) of the last segment,
        body_forces (3, nb, N), carry'[, anchors'])."""
        dev = state.pos.device
        cc = self.cc_sea
        c = self._sea_consts(dev)
        track_anchors = cc.warm_start and anchors is not None
        if not track_anchors:
            anchors = None
        # everything but the torques and the state is shared by the
        # segments (the targets slot is filled per segment below)
        (lp_base, lp_lvl, mu, _, ph, r0, c0, pos, quat, vel, q_lvl,
         qd_lvl) = self.level_args(state, link_params, friction, state.q,
                                   contact_patch)
        q, qd = state.q, state.qd
        tau_l = body_f = None
        for _ in range(self.cc.decimation):
            tau, carry = tau_fn(q, qd, carry)
            out = chain_kernel.run_decimation(
                cc, lp_base, lp_lvl, mu, self.to_level(tau).contiguous(),
                ph, r0, c0, pos, quat, vel, q_lvl, qd_lvl, anchors=anchors,
                cv=c["cv"], consts=c["table"])
            pos, quat, vel, q_lvl, qd_lvl, tau_l, body_f = out[:7]
            if track_anchors:
                anchors = out[7]
            q, qd = self.from_level(q_lvl), self.from_level(qd_lvl)
        new_state = PhysicsState(pos=pos, quat=quat, vel=vel, q=q, qd=qd)
        if track_anchors:
            return new_state, self.from_level(tau_l), body_f, carry, anchors
        return new_state, self.from_level(tau_l), body_f, carry
