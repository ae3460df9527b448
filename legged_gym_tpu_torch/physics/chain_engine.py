"""Chain-layout engine: the whole policy-step physics (decimation x
substeps) as one call.

On a CUDA device the step runs as one launch of the hand-written kernel
(chain_kernel.run_decimation_cuda); on the CPU it runs the plain PyTorch
version (chain_step.run_decimation_chain). Handles the joint-order <->
chain-layout conversions (index gathers) and the per-env contact window.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from legged_gym_tpu_torch.physics import chain_kernel, chain_step
from legged_gym_tpu_torch.physics.chains import (NotChainStructured,
                                                 build_chain_model)
from legged_gym_tpu_torch.physics.state import PhysicsState

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
            warm_start=sim.contact.warm_start)
        chain_step.check_k1(self.cc)

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
        chain_step.check_k1(self.cc)
        self.grid = grid
        self._dev_cache = {}

    def _consts(self, device):
        """Per-device constants: the plain version's dict, the kernel's
        table (on CUDA) and the index tensors."""
        key = str(device)
        if key not in self._dev_cache:
            c = {"cv": chain_step.const_tensors(self.cc, device),
                 "lvl_index": torch.as_tensor(self._lvl_index,
                                              device=device),
                 "lvl_mask": torch.as_tensor(self._lvl_mask, device=device),
                 "from_index": torch.as_tensor(self._from_index,
                                               device=device),
                 "li_flat": torch.as_tensor(self._li_flat, dtype=torch.long,
                                            device=device),
                 "table": None}
            if torch.device(device).type == "cuda":
                c["table"] = torch.as_tensor(
                    chain_kernel.const_table(self.cc), device=device)
            self._dev_cache[key] = c
        return self._dev_cache[key]

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
        from legged_gym_tpu_torch.terrain.heightfield import extract_patches
        h, r0, c0 = extract_patches(grid, x, y, S)
        return h.permute(1, 2, 0).contiguous(), r0, c0

    # ------------------------------------------------------- public step

    def level_args(self, state: PhysicsState, link_params, friction,
                   targets, contact_patch=None):
        """The arguments of run_decimation_cuda / run_decimation_chain
        (after ``cc``) for this state, in the chain layout, contiguous."""
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
                            friction, targets, contact_patch=None):
        """Full policy-step physics, position drive. Returns
        (state', torques (nq, N), body_forces (3, nb, N)); body_forces is
        the net-contact-force sensor of the last substep. CUDA tensors
        launch the kernel (or raise); CPU tensors run the plain version."""
        c = self._consts(state.pos.device)
        args = self.level_args(state, link_params, friction, targets,
                               contact_patch)
        pos, quat, vel, q_l, qd_l, tau_l, body_f = \
            chain_kernel.run_decimation_cuda(self.cc, *args, cv=c["cv"],
                                             consts=c["table"])
        new_state = PhysicsState(pos=pos, quat=quat, vel=vel,
                                 q=self.from_level(q_l),
                                 qd=self.from_level(qd_l))
        return new_state, self.from_level(tau_l), body_f
