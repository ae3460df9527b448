"""The locomotion environment: the reference's LeggedRobot task
(legged_robot.py:51-975) as one step function over batch-last tensors.

Two physics paths, chosen at construction as the JAX package chooses
them:
- the fused chain physics (physics/chain_engine.py: the CUDA kernel on
  the card, its plain version on the CPU) for position drive
  (``control_type="P"``, the Go1 UniNet output being discarded by the
  reference, config.ControlCfg) and for the SEA torque drive (ANYmal's
  actuator LSTM evaluated once per sim dt between kernel launches);
- the general stacked engine (physics/engine.py, plain torch ops) when
  self-collision pairs remain after the rest filter (anymal_c_flat), body
  damping is set, ``sim.use_chain_engine`` is off, an applied UniNet is
  configured, or the control type is V or T without the SEA net. A config
  that should take the chain path and cannot build it raises.
Plane, heightfield or trimesh terrain; with or without warm-start friction
anchors (per point group on the chain path, one stacked (3, P, N) array on
the general engine). With ``env.num_privileged_obs`` set, each Transition
also carries the asymmetric critic's privileged observations. The env
simulates exactly ``num_envs`` envs.

Layout: internal tensors are batch-LAST; the policy boundary (obs /
actions) is batch-first. Random draws come from one ``torch.Generator``
held by the env, on its device.

Behavioral parity notes (quirks deliberately mirrored from the JAX
package and the reference):
- obs after a reset mix pre-reset base velocities / heights with
  post-reset joint state (legged_robot.py:122-136);
- ``last_actions`` is always the previous step's actions;
- timeout at episode_length > max (strict);
- command resampling never fires on the step after reset.
"""
from __future__ import annotations

import dataclasses
import math
import os
from typing import Optional

import numpy as np
import torch

from legged_gym_tpu_torch import assets
from legged_gym_tpu_torch.model.robot import compile_model
from legged_gym_tpu_torch.ops import quat as quat_ops
from legged_gym_tpu_torch.physics.chain_engine import ChainEngine
from legged_gym_tpu_torch.physics.contact import (ANCHOR_SENTINEL,
                                                  ContactConfig)
from legged_gym_tpu_torch.physics.engine import Engine, SimConfig
from legged_gym_tpu_torch.physics.kinematics import (contact_point_kinematics,
                                                     forward_kinematics)
from legged_gym_tpu_torch.physics.params import (broadcast_nominal,
                                                 link_params_from_scales)
from legged_gym_tpu_torch.physics.state import PhysicsState
from legged_gym_tpu_torch.terrain.heightfield import (PatchExtractor,
                                                      TerrainPatch,
                                                      patch_sample_min3,
                                                      sample_bilinear)
from legged_gym_tpu_torch.terrain.terrain import Terrain, TerrainGrid


@dataclasses.dataclass(frozen=True)
class EnvState:
    """Everything that evolves across steps (batch-last)."""
    physics: PhysicsState
    episode_length: torch.Tensor     # (N,) int32
    common_step: int                 # global step counter (host side)
    # cached per-env terrain window, refreshed every `patch_refresh` steps
    # ((N,1,1)/(N,) dummies when there is no heightfield)
    patch: torch.Tensor              # (N, Sc, Sc) heights, meters
    patch_T: torch.Tensor            # (Sc, Sc, N) same, kernel layout
    patch_r0: torch.Tensor           # (N,) int32 window origin row
    patch_c0: torch.Tensor           # (N,) int32 window origin col
    commands: torch.Tensor           # (4, N) vx, vy, wz, heading
    actions: torch.Tensor            # (na, N) current (clipped) actions
    last_actions: torch.Tensor       # (na, N)
    last_dof_vel: torch.Tensor       # (nq, N)
    feet_air_time: torch.Tensor      # (nf, N)
    terrain_level: torch.Tensor      # (N,) int32
    env_origin: torch.Tensor         # (3, N)
    friction: torch.Tensor           # (N,)
    mass_scales: torch.Tensor        # (n_orig, N)
    link_params: torch.Tensor        # (nl, 10, N) randomized inertias
    lin_vel_x_range: torch.Tensor    # (2,) command-curriculum state
    episode_sums: dict               # name -> (N,)
    # static-friction anchor carry when cfg.sim.contact_warm_start, else
    # None: (3, n_points, N) in the chain layout's point order on the chain
    # path (physics/chain_step.py: split_anchors), (3, P, N) in the model's
    # point order on the general engine
    contact_ws: Optional[torch.Tensor] = None
    # actuator-net state: {"h", "c"} each (2, 8, nq, N) for the SEA LSTM,
    # {"pos_err", "vel"} each (12, 5, N) for an applied UniNet, else {}
    actuator_state: dict = dataclasses.field(default_factory=dict)

    @property
    def n(self):
        return self.physics.n


@dataclasses.dataclass(frozen=True)
class Transition:
    """Per-step outputs for the learner (batch-first at this boundary)."""
    obs: torch.Tensor                # (N, obs_dim)
    reward: torch.Tensor             # (N,)
    done: torch.Tensor               # (N,) bool (term | timeout)
    time_out: torch.Tensor           # (N,) bool
    episode_sums: dict               # name -> () float, finished envs
    episode_count: torch.Tensor      # () float
    episode_length_sum: torch.Tensor  # () float
    terrain_level_mean: torch.Tensor  # () float
    max_command_x: torch.Tensor      # () float
    torques: torch.Tensor            # (nq, N) applied joint torques
    feet_contact_z: torch.Tensor     # (nf, N) vertical foot contact force
    # (N, num_privileged_obs) for an asymmetric critic, else None
    privileged_obs: Optional[torch.Tensor] = None


def _match_gains(dof_names, table, kind):
    out = np.zeros(len(dof_names))
    for i, name in enumerate(dof_names):
        hit = False
        for key, val in table.items():
            if key in name:
                out[i] = val
                hit = True
        if not hit:
            print(f"[legged_env] PD gain of joint {name} not in {kind} dict "
                  "-> 0 (reference legged_robot.py:700-707)")
    return out


class LeggedEnv:
    """Host-side constructor + step/reset methods on ``device``."""

    def __init__(self, cfg, seed=0, device="cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        self.dtype = torch.float32
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        ctrl = cfg.control
        # actuator networks (anymal.py:52-55, go1.py:44-47); with the
        # reference's discard quirk (config.ControlCfg) a net's output
        # never reaches the dynamics and its compute is skipped
        self._sea = None
        self._uninet = None
        if ctrl.use_actuator_network and not ctrl.actuator_net_discard_output:
            net_file = assets.resolve(ctrl.actuator_net_file)
            if "lstm" in os.path.basename(net_file):
                from legged_gym_tpu_torch.actuators.sea_lstm import SEANet
                self._sea = SEANet(net_file).to(self.device)
            else:
                from legged_gym_tpu_torch.actuators.uninet import UniNet
                self._uninet = UniNet(net_file).to(self.device)
        if self._sea is None and ctrl.control_type not in ("P", "V", "T"):
            raise ValueError(f"control_type {ctrl.control_type!r}: P, V "
                             "or T")
        self.num_envs = cfg.env.num_envs
        self.dt = cfg.control.decimation * cfg.sim.dt     # policy dt
        self.max_episode_length_s = cfg.env.episode_length_s
        self.max_episode_length = int(
            math.ceil(self.max_episode_length_s / self.dt))

        # --- robot model ---
        self.model = compile_model(
            assets.resolve(cfg.asset.file),
            collapse_fixed_joints=cfg.asset.collapse_fixed_joints,
            armature=cfg.asset.armature)
        m = self.model
        self.num_dof = m.nq
        self.num_actions = cfg.env.num_actions
        if self.num_actions != m.nq:
            raise ValueError(f"num_actions {self.num_actions} != model dofs "
                             f"{m.nq}")
        self.default_dof_pos = np.array(
            [cfg.init_state.default_joint_angles.get(n, 0.0)
             for n in m.dof_names])
        self.p_gains = _match_gains(m.dof_names, cfg.control.stiffness, "P")
        self.d_gains = _match_gains(m.dof_names, cfg.control.damping, "D")

        # hard + soft dof limits (_process_dof_props, legged_robot.py:284-310)
        self.dof_lower = np.asarray(m.dof_lower, float)
        self.dof_upper = np.asarray(m.dof_upper, float)
        mid = 0.5 * (self.dof_lower + self.dof_upper)
        rng_ = self.dof_upper - self.dof_lower
        soft = cfg.rewards.soft_dof_pos_limit
        self.soft_dof_lower = mid - 0.5 * rng_ * soft
        self.soft_dof_upper = mid + 0.5 * rng_ * soft
        self.dof_vel_limit = np.asarray(m.dof_vel_limit, float)
        self.torque_limit = np.asarray(m.dof_effort, float)

        # body index groups (legged_robot.py:684-690)
        self.feet_idx = np.array(m.match_bodies(cfg.asset.foot_name),
                                 dtype=np.int64)
        self.penal_idx = np.array(
            sum([m.match_bodies(s) for s in cfg.asset.penalize_contacts_on],
                []), dtype=np.int64)
        self.term_idx = np.array(
            sum([m.match_bodies(s)
                 for s in cfg.asset.terminate_after_contacts_on], []),
            dtype=np.int64)
        self.hip_idx = np.array(m.match_dofs("hip"), dtype=np.int64)

        # --- terrain ---
        mesh = cfg.terrain.mesh_type
        if mesh not in ("heightfield", "trimesh"):
            cfg.terrain.curriculum = False
        self.terrain = None
        self.grid: Optional[TerrainGrid] = None
        if mesh in ("heightfield", "trimesh"):
            self.terrain = Terrain(cfg.terrain, self.num_envs, seed=seed)
            self.grid = self.terrain.grid(self.device)
        self.custom_origins = mesh in ("heightfield", "trimesh")
        self._init_origins(seed)

        # --- engine, then the fused chain physics where it applies ---
        self._warm_start = bool(cfg.sim.contact_warm_start)
        simcfg = SimConfig(
            dt=cfg.sim.dt, substeps=cfg.sim.substeps,
            gravity=((0.0, 0.0, 0.0) if cfg.asset.disable_gravity
                     else tuple(cfg.sim.gravity)),
            contact=ContactConfig(
                warm_start=self._warm_start,
                anchor_release_depth=cfg.sim.contact_anchor_release_depth,
                terrain_friction=cfg.terrain.static_friction))
        # Isaac semantics: self_collisions == 0 enables intra-actor
        # collision (legged_robot.py:711-720; anymal_c_flat)
        self.engine = Engine(self.model, simcfg, grid=self.grid,
                             kp=self.p_gains, kd=self.d_gains,
                             fixed_base=cfg.asset.fix_base_link,
                             lin_damping=cfg.asset.linear_damping,
                             ang_damping=cfg.asset.angular_damping,
                             self_collision=cfg.asset.self_collisions == 0)
        self.engine.filter_self_collision_pairs(self.default_dof_pos)
        # numeric apparent-mass probe at the default pose: with the
        # implicit PD servo impedance for position-drive robots, without it
        # for the torque drives (SEA, V, T: probing with the servo
        # overestimates the mass and the over-corrected stopping impulse
        # micro-bounces the stance)
        torque_drive = (self._sea is not None
                        or ctrl.control_type in ("V", "T"))
        self.engine.calibrate_contact_mass(
            self.default_dof_pos,
            lambda n: broadcast_nominal(self.model, n, self.dtype),
            drive="torque" if torque_drive else "pd")
        # the general engine where the chain step does not apply (the JAX
        # package's legged_env.py:250-275, 345-352), with no fallback: a
        # chain-path config whose chain model does not build raises
        self.general_reasons = [why for why, hit in (
            ("self-collision", self.engine.has_self_collision),
            ("body damping", bool(cfg.asset.linear_damping
                                  or cfg.asset.angular_damping)),
            ("use_chain_engine off", not cfg.sim.use_chain_engine),
            ("applied UniNet", self._uninet is not None),
            (f"control_type {ctrl.control_type}",
             self._sea is None and ctrl.control_type != "P")) if hit]
        self.chain_engine = None
        if not self.general_reasons:
            self.chain_engine = ChainEngine(
                self.engine, decimation=cfg.control.decimation,
                patch_S=self.contact_patch_S,
                plane_per_step=cfg.sim.contact_plane_per_step)
            self.chain_engine.bind_grid(self.grid)

        # --- height scan (legged_robot.py:802-816) ---
        self.measure_heights = (cfg.terrain.measure_heights
                                and mesh != "none")
        px = np.asarray(cfg.terrain.measured_points_x)
        py = np.asarray(cfg.terrain.measured_points_y)
        gx, gy = np.meshgrid(px, py, indexing="ij")
        self.height_points = np.stack([gx.ravel(), gy.ravel()])  # (2, P)
        self.num_height_points = self.height_points.shape[1]

        # --- observation bookkeeping ---
        s = cfg.normalization.obs_scales
        self.obs_scales = s
        self.commands_scale = np.array(
            [s["lin_vel"], s["lin_vel"], s["ang_vel"]])
        self.obs_dim = 9 + 3 + 2 * m.nq + self.num_actions
        if self.measure_heights:
            self.obs_dim += self.num_height_points
        if self.obs_dim != cfg.env.num_observations:
            raise ValueError(f"obs dim {self.obs_dim} != cfg "
                             f"{cfg.env.num_observations}")
        self.noise_vec = self._build_noise_vec()

        # privileged observations for an asymmetric critic (the VecEnv
        # privileged_obs contract, base_task.py:70-78,101-110; the
        # reference allocates the buffer but ships no producer; the JAX
        # package's layout: noiseless obs + ground friction + base-mass
        # scale + feet contact forces)
        self.num_privileged_obs = None
        if cfg.env.num_privileged_obs is not None:
            expect = self.obs_dim + 2 + 3 * len(self.feet_idx)
            if cfg.env.num_privileged_obs != expect:
                raise ValueError(
                    f"num_privileged_obs={cfg.env.num_privileged_obs} but "
                    f"the privileged layout for this robot has {expect} "
                    f"dims (obs {self.obs_dim} + friction 1 + base-mass 1 "
                    f"+ 3x{len(self.feet_idx)} feet forces)")
            self.num_privileged_obs = expect

        # --- rewards (nonzero scales x dt, legged_robot.py:574-598) ---
        self.reward_scales = {}
        for name, scale in cfg.rewards.scales.items():
            if scale != 0.0:
                self.reward_scales[name] = scale * self.dt
        self.reward_names = [n for n in self.reward_scales
                             if n != "termination"]

        # command resample / push cadence (legged_robot.py:770-779)
        self.resample_interval = int(cfg.commands.resampling_time / self.dt)
        self.push_interval = int(
            math.ceil(cfg.domain_rand.push_interval_s / self.dt))
        self._device_constants()

    def _device_constants(self):
        """Per-step constants, uploaded once."""
        dev, dt = self.device, self.dtype

        def col(a):
            return torch.as_tensor(np.asarray(a), dtype=dt,
                                   device=dev)[:, None]

        self._dflt = col(self.default_dof_pos)
        self._soft_lo = col(self.soft_dof_lower)
        self._soft_hi = col(self.soft_dof_upper)
        self._vel_lim = col(self.dof_vel_limit)
        self._torque_lim = col(self.torque_limit)
        self._neg_torque_lim = -self._torque_lim
        self._kp = col(self.p_gains)
        self._kd = col(self.d_gains)
        self._commands_scale = col(self.commands_scale)
        self._noise_vec = col(self.noise_vec)
        self._gvec = col([0.0, 0.0, -1.0])
        self._fwd = col([1.0, 0.0, 0.0])
        self._spawn_pos = col(self.cfg.init_state.pos)
        self._spawn_rot = col(self.cfg.init_state.rot)
        pts = torch.as_tensor(self.height_points, dtype=dt, device=dev)
        self._scan_p3 = torch.cat([pts, torch.zeros_like(pts[:1])])
        self._cp_radius = col(self.model.cp_radius)

        def idx(a):
            return torch.as_tensor(a, dtype=torch.long, device=dev)

        self._feet = idx(self.feet_idx)
        self._penal = idx(self.penal_idx)
        self._term = idx(self.term_idx)
        self._hip = idx(self.hip_idx)
        self._is_base = torch.as_tensor(self.model.orig_is_base,
                                        device=dev)[:, None]
        self._terrain_types = torch.as_tensor(self.terrain_types,
                                              dtype=torch.int64, device=dev)
        self._terrain_origins = torch.as_tensor(
            np.asarray(self.terrain_origins), dtype=dt, device=dev)
        if self.grid is not None:
            self._cell_patches_t = torch.as_tensor(self._cell_patches,
                                                   device=dev)
            self._cell_r0_t = torch.as_tensor(self._cell_r0, device=dev)
            self._cell_c0_t = torch.as_tensor(self._cell_c0, device=dev)

    def _init_origins(self, seed):
        """Spawn origins (reference _get_env_origins, legged_robot.py:742-767)."""
        n = self.num_envs
        rng = np.random.default_rng(seed + 1)
        if self.custom_origins:
            tcfg = self.cfg.terrain
            max_init = min(tcfg.max_init_terrain_level, tcfg.num_rows - 1)
            if not tcfg.curriculum:
                max_init = tcfg.num_rows - 1
            self.init_terrain_levels = rng.integers(
                0, max_init + 1, size=n).astype(np.int32)
            self.terrain_types = (np.arange(n) //
                                  (n / tcfg.num_cols)).astype(np.int32)
            self.max_terrain_level = tcfg.num_rows
            self.terrain_origins = self.terrain.env_origins  # (rows, cols, 3)
            origins = self.terrain_origins[
                self.init_terrain_levels, self.terrain_types]
        else:
            self.init_terrain_levels = np.zeros(n, dtype=np.int32)
            self.terrain_types = np.zeros(n, dtype=np.int32)
            self.max_terrain_level = 1
            self.terrain_origins = np.zeros((1, max(n, 1), 3))
            cols = int(np.floor(np.sqrt(n)))
            rows = int(np.ceil(n / cols))
            xx, yy = np.meshgrid(np.arange(rows), np.arange(cols),
                                 indexing="ij")
            sp = self.cfg.env.env_spacing
            origins = np.zeros((n, 3))
            origins[:, 0] = sp * xx.ravel()[:n]
            origins[:, 1] = sp * yy.ravel()[:n]
        self.init_env_origins = origins.T                    # (3, N)

        # terrain window cache: a 4 m window per env in the state,
        # re-extracted every `patch_refresh` steps; reset envs get their
        # cell's static origin-centered window
        self.patch_cache_S = 40
        self.patch_refresh = 4
        self._patch_extractor = None
        # contact window handed to the physics: the center crop of the
        # cache (+-1.2 m)
        self.contact_patch_S = 24
        if self.grid is not None:
            Sc = self.patch_cache_S
            self._patch_extractor = PatchExtractor(self.grid, size=Sc)
            G = self.terrain.height_field_raw.astype(np.float32) \
                * self.cfg.terrain.vertical_scale
            R, C = G.shape
            hs = self.grid.horizontal_scale
            border = self.grid.border_size
            org = np.asarray(self.terrain_origins, float).reshape(-1, 3)
            r0s = np.clip(((org[:, 0] + border) / hs).astype(np.int32)
                          - Sc // 2, 0, R - Sc)
            c0s = np.clip(((org[:, 1] + border) / hs).astype(np.int32)
                          - Sc // 2, 0, C - Sc)
            self._cell_patches = np.stack(
                [G[r:r + Sc, c:c + Sc] for r, c in zip(r0s, c0s)])
            self._cell_r0 = r0s.astype(np.int32)
            self._cell_c0 = c0s.astype(np.int32)
            self._cells_ncols = np.asarray(self.terrain_origins).shape[1]

    def _env_cells(self, terrain_level):
        """(N,) flat terrain-cell index per env."""
        return terrain_level.to(torch.int64) * self._cells_ncols \
            + self._terrain_types

    def _cell_patch_lookup(self, cells):
        """Static origin-centered windows per env by cell index (a gather).
        Returns (patch (N, Sc, Sc), patch_T (Sc, Sc, N), r0, c0)."""
        ph = self._cell_patches_t[cells]
        return (ph, ph.permute(1, 2, 0).contiguous(),
                self._cell_r0_t[cells], self._cell_c0_t[cells])

    def _build_noise_vec(self):
        """Additive-noise scale per obs slot (legged_robot.py:477-500)."""
        cfg = self.cfg
        ns, s = cfg.noise.noise_scales, cfg.normalization.obs_scales
        lvl = cfg.noise.noise_level
        nq, na = self.num_dof, self.num_actions
        v = np.zeros(self.obs_dim)
        v[0:3] = ns["lin_vel"] * lvl * s["lin_vel"]
        v[3:6] = ns["ang_vel"] * lvl * s["ang_vel"]
        v[6:9] = ns["gravity"] * lvl
        v[12:12 + nq] = ns["dof_pos"] * lvl * s["dof_pos"]
        v[12 + nq:12 + 2 * nq] = ns["dof_vel"] * lvl * s["dof_vel"]
        if self.measure_heights:
            v[12 + 2 * nq + na:] = (ns["height_measurements"] * lvl
                                    * s["height_measurements"])
        return v

    # ----------------------------------------------------------- random

    def _uniform(self, shape, lo, hi):
        u = torch.rand(shape, generator=self.generator, dtype=self.dtype,
                       device=self.device)
        return lo + (hi - lo) * u

    # ------------------------------------------------------------- resets

    def _draw_friction(self, n):
        """64-bucket friction randomization (reference quirk,
        legged_robot.py:259-282)."""
        dr = self.cfg.domain_rand
        if not dr.randomize_friction:
            return torch.full((n,), self.cfg.terrain.static_friction,
                              dtype=self.dtype, device=self.device)
        lo, hi = dr.friction_range
        buckets = self._uniform((dr.num_friction_buckets,), lo, hi)
        idx = torch.randint(0, dr.num_friction_buckets, (n,),
                            generator=self.generator, device=self.device)
        return buckets[idx]

    def _draw_mass_scales(self, n):
        """Per-original-body mass scales: base + U(added_mass_range) kg,
        limbs x (1 + U(added_limb_percentage))
        (_process_rigid_body_props, legged_robot.py:312-335)."""
        dr = self.cfg.domain_rand
        m = self.model
        scales = torch.ones((m.n_orig, n), dtype=self.dtype,
                            device=self.device)
        if dr.randomize_base_mass:
            base_mass = float(m.contrib[m.orig_is_base, 0].sum())
            add = self._uniform((n,), *dr.added_mass_range)
            base_scale = 1.0 + add / max(base_mass, 1e-9)
            scales = torch.where(self._is_base, base_scale[None, :], scales)
        if dr.randomize_limb_mass:
            mult = 1.0 + self._uniform((m.n_orig, n),
                                       *dr.added_limb_percentage)
            scales = torch.where(self._is_base, scales, scales * mult)
        return scales

    def _link_params(self, mass_scales, n):
        dr = self.cfg.domain_rand
        if dr.randomize_base_mass or dr.randomize_limb_mass:
            return link_params_from_scales(self.model, mass_scales,
                                           self.dtype)
        return broadcast_nominal(self.model, n, self.dtype,
                                 self.device).contiguous()

    def _draw_reset_physics(self, origins):
        """Fresh physics state for every env (selected by mask at reset):
        dofs = default x U(0.5, 1.5), qd = 0 (_reset_dofs:399-413); root
        at origin (+-1 m xy on terrain), world vel U(-0.5, 0.5)
        (_reset_root_states:414-434)."""
        n = origins.shape[-1]
        ist = self.cfg.init_state
        lo, hi = ist.dof_spawn_range
        q = self._dflt * self._uniform((self.num_dof, n), lo, hi)
        pos = origins + self._spawn_pos
        if self.custom_origins:
            dxy = self._uniform((2, n), -1.0, 1.0)
            pos = torch.cat([pos[:2] + dxy, pos[2:]], dim=0)
        quat = self._spawn_rot.expand(4, n)
        sv = float(ist.spawn_vel)
        base_vel = self._uniform((6, n), -sv, sv)
        pos = self._depenetrate_spawn(pos, quat, q)
        return PhysicsState.from_world_vel(
            pos=pos, quat=quat, lin_vel_w=base_vel[:3],
            ang_vel_w=base_vel[3:], q=q, qd=torch.zeros_like(q))

    def _depenetrate_spawn(self, pos, quat, q):
        """Lift the drawn base so no collision point starts underground:
        one FK on the drawn pose, ground sampled at the base xy."""
        if self.cfg.asset.fix_base_link or len(self.model.cp_link) == 0:
            return pos
        probe = PhysicsState(pos=pos, quat=quat,
                             vel=torch.zeros((6, pos.shape[-1]),
                                             dtype=self.dtype,
                                             device=self.device),
                             q=q, qd=torch.zeros_like(q))
        cp_pos, _ = contact_point_kinematics(
            self.model, forward_kinematics(self.model, probe))
        ground, _, _ = sample_bilinear(self.grid, pos[0], pos[1])
        clearance = torch.amin(cp_pos[2] - self._cp_radius, dim=0) - ground
        lift = torch.clamp_min(0.005 - clearance, 0.0)
        return torch.cat([pos[:2], pos[2:] + lift[None]], dim=0)

    def _resample_commands(self, commands, mask):
        """New commands where mask (reference _resample_commands:353-368).
        Returns (commands, vx_unit); vx is scaled by the curriculum range
        in _apply_vx_and_deadband."""
        cfg = self.cfg.commands
        n = commands.shape[-1]
        r = cfg.ranges
        vx = self._uniform((n,), 0.0, 1.0)
        vy = self._uniform((n,), *r["lin_vel_y"])
        new = commands.clone()
        new[1] = torch.where(mask, vy, commands[1])
        if cfg.heading_command:
            h = self._uniform((n,), *r["heading"])
            new[3] = torch.where(mask, h, commands[3])
        else:
            w = self._uniform((n,), *r["ang_vel_yaw"])
            new[2] = torch.where(mask, w, commands[2])
        return new, vx

    def _apply_vx_and_deadband(self, commands, vx_unit, lin_vel_x_range,
                               mask):
        lo, hi = lin_vel_x_range[0], lin_vel_x_range[1]
        vx = lo + (hi - lo) * vx_unit
        new = commands.clone()
        new[0] = torch.where(mask, vx, commands[0])
        # zero-out small commands (legged_robot.py:367-368)
        small = torch.sqrt(new[0] ** 2 + new[1] ** 2) <= 0.2
        kill = mask & small
        new[0] = torch.where(kill, 0.0, new[0])
        new[1] = torch.where(kill, 0.0, new[1])
        return new

    # ------------------------------------------------------------ reset()

    def initial_state(self) -> EnvState:
        """State after the global reset (reference BaseTask.reset:111-115;
        run one zero-action step to populate obs, as reset() does)."""
        n = self.num_envs
        dev = self.device
        friction = self._draw_friction(n)
        mass_scales = self._draw_mass_scales(n)
        origins = torch.as_tensor(self.init_env_origins, dtype=self.dtype,
                                  device=dev)
        physics = self._draw_reset_physics(origins)
        lin_vel_x_range = torch.as_tensor(
            self.cfg.commands.ranges["lin_vel_x"], dtype=self.dtype,
            device=dev)
        commands = torch.zeros((4, n), dtype=self.dtype, device=dev)
        ones = torch.ones(n, dtype=torch.bool, device=dev)
        commands, vx_unit = self._resample_commands(commands, ones)
        commands = self._apply_vx_and_deadband(commands, vx_unit,
                                               lin_vel_x_range, ones)
        lvl = torch.as_tensor(self.init_terrain_levels, device=dev)
        if self.grid is not None:
            patch0, patch0_T, pr0, pc0 = self._cell_patch_lookup(
                self._env_cells(lvl))
        else:
            patch0 = torch.zeros((n, 1, 1), dtype=self.dtype, device=dev)
            patch0_T = torch.zeros((1, 1, n), dtype=self.dtype, device=dev)
            pr0 = pc0 = torch.zeros((n,), dtype=torch.int32, device=dev)

        def zeros(rows):
            return torch.zeros((rows, n), dtype=self.dtype, device=dev)

        return EnvState(
            physics=physics,
            episode_length=torch.zeros(n, dtype=torch.int32, device=dev),
            common_step=0,
            patch=patch0, patch_T=patch0_T, patch_r0=pr0, patch_c0=pc0,
            commands=commands,
            actions=zeros(self.num_actions),
            last_actions=zeros(self.num_actions),
            last_dof_vel=zeros(self.num_dof),
            feet_air_time=zeros(len(self.feet_idx)),
            terrain_level=lvl,
            env_origin=origins,
            friction=friction, mass_scales=mass_scales,
            link_params=self._link_params(mass_scales, n),
            lin_vel_x_range=lin_vel_x_range,
            episode_sums={name: torch.zeros(n, dtype=self.dtype, device=dev)
                          for name in self.reward_scales},
            contact_ws=self._init_contact_ws(n),
            actuator_state=self._init_actuator_state(n))

    def _init_contact_ws(self, n):
        """Far-sentinel anchors in the layout of the env's physics path, or
        None without warm start."""
        if not self._warm_start:
            return None
        if self.chain_engine is not None:
            return self.chain_engine.init_anchors(n, self.device, self.dtype)
        return torch.full((3, len(self.model.cp_link), n), ANCHOR_SENTINEL,
                          dtype=self.dtype, device=self.device)

    def _init_actuator_state(self, n):
        if self._uninet is not None:
            return self._uninet.init_state(n, self.dtype, self.device)
        if self._sea is None:
            return {}
        h, c = self._sea.init_state(self.num_dof * n, self.dtype,
                                    self.device)
        shape = (2, self._sea.hidden, self.num_dof, n)
        return {"h": h.reshape(shape), "c": c.reshape(shape)}

    def reset(self):
        """(state, obs): global reset + one zero-action step."""
        state = self.initial_state()
        zeros = torch.zeros((self.num_envs, self.num_actions),
                            dtype=self.dtype, device=self.device)
        state, tr = self.step(state, zeros)
        return state, tr.obs

    # -------------------------------------------------------------- step()

    def step(self, state: EnvState, actions) -> tuple:
        """One policy step. actions: (N, num_actions) on the env's device."""
        cfg = self.cfg
        n = state.n
        dev = self.device
        clip_a = cfg.normalization.clip_actions
        a = torch.clamp(actions.T.to(self.dtype), -clip_a, clip_a)

        # cached per-env terrain window, re-extracted every patch_refresh
        # steps; the physics gets its center crop
        patch = None
        contact_patch = None
        if self.grid is not None:
            if state.common_step % self.patch_refresh == 0:
                tp = self._patch_extractor(state.physics.pos[0],
                                           state.physics.pos[1])
                ph_c, pr0, pc0 = tp.h, tp.r0, tp.c0
                ph_T = ph_c.permute(1, 2, 0).contiguous()
            else:
                ph_c, ph_T = state.patch, state.patch_T
                pr0, pc0 = state.patch_r0, state.patch_c0
            patch = TerrainPatch(h=ph_c, r0=pr0, c0=pc0)
            if self.chain_engine is not None:
                lo = (self.patch_cache_S - self.contact_patch_S) // 2
                hi = lo + self.contact_patch_S
                contact_patch = (ph_T[lo:hi, lo:hi].contiguous(), pr0 + lo,
                                 pc0 + lo)

        # ---- actuation + decimation x sim (legged_robot.py:89-99) ----
        anchors = state.contact_ws if self._warm_start else None
        if self.chain_engine is None:
            physics, torques, contact_f, actuator_state, contact_ws = \
                self._general_physics(state, a, patch, anchors)
        else:
            physics, torques, contact_f, actuator_state, contact_ws = \
                self._chain_physics(state, a, contact_patch, anchors)

        # ---- post-physics bookkeeping ----
        episode_length = state.episode_length + 1
        common_step = state.common_step + 1

        base_lin_vel = physics.base_lin_vel()
        base_ang_vel = physics.base_ang_vel()
        projected_gravity = quat_ops.rotate_inverse(
            physics.quat, self._gvec.expand(3, n))

        # command resampling + heading controller (:337-352)
        resample = (episode_length % self.resample_interval) == 0
        commands, vx_unit = self._resample_commands(state.commands, resample)
        commands = self._apply_vx_and_deadband(
            commands, vx_unit, state.lin_vel_x_range, resample)
        if cfg.commands.heading_command:
            fwd = quat_ops.rotate(physics.quat, self._fwd.expand(3, n))
            heading = torch.atan2(fwd[1], fwd[0])
            commands = torch.cat([commands[:2], torch.clamp(
                0.5 * quat_ops.wrap_to_pi(commands[3] - heading),
                -1.0, 1.0)[None], commands[3:]], dim=0)

        # height scan (:818-854)
        if self.measure_heights:
            measured = self._get_heights(physics, patch)   # (P, N)
        else:
            measured = torch.zeros((1, n), dtype=self.dtype, device=dev)

        # random pushes (:436-441): set world-frame base xy velocity; the
        # rewards / obs of this step keep the pre-push velocity
        if cfg.domain_rand.push_robots and \
                common_step % self.push_interval == 0:
            mx = cfg.domain_rand.max_push_vel_xy
            push_xy = self._uniform((2, n), -mx, mx)
            lin_w = torch.cat([push_xy, physics.world_lin_vel()[2:]], dim=0)
            v_b = quat_ops.rotate_inverse(physics.quat, lin_w)
            physics = dataclasses.replace(
                physics, vel=torch.cat([physics.vel[0:3], v_b], dim=0))

        # ---- termination (:143-148) ----
        if len(self.term_idx):
            tf = contact_f[:, self._term]                   # (3, k, N)
            term = torch.any(torch.linalg.vector_norm(tf, dim=0) > 1.0,
                             dim=0)
        else:
            term = torch.zeros(n, dtype=torch.bool, device=dev)
        time_out = episode_length > self.max_episode_length
        done = term | time_out

        # ---- rewards (:195-212, 857-966) ----
        feet_air_time = state.feet_air_time
        ctx = dict(
            physics=physics, base_lin_vel=base_lin_vel,
            base_ang_vel=base_ang_vel,
            projected_gravity=projected_gravity, commands=commands,
            torques=torques, contact_forces=contact_f,
            measured_heights=measured, last_actions=state.last_actions,
            actions=a, last_dof_vel=state.last_dof_vel,
            term=term, time_out=time_out)

        # stateful feet_air_time term (:941-949)
        if len(self.feet_idx):
            fz = contact_f[2, self._feet]                   # (nf, N)
            contact = fz > 1.0
            first_contact = (feet_air_time > 0.0) & contact
            feet_air_time = feet_air_time + self.dt
            rew_air = torch.sum((feet_air_time - 0.5) * first_contact, dim=0)
            rew_air = rew_air * (
                torch.linalg.vector_norm(commands[:2], dim=0) > 0.1)
            feet_air_time = feet_air_time * (~contact)
            ctx["feet_air_time_reward"] = rew_air

        reward = torch.zeros(n, dtype=self.dtype, device=dev)
        episode_sums = dict(state.episode_sums)
        for name in self.reward_names:
            r = self._reward(name, ctx) * self.reward_scales[name]
            reward = reward + r
            episode_sums[name] = episode_sums[name] + r
        if cfg.rewards.only_positive_rewards:
            reward = torch.clamp_min(reward, 0.0)
        if "termination" in self.reward_scales:
            r = ((term & ~time_out).to(self.dtype)
                 * self.reward_scales["termination"])
            reward = reward + r
            episode_sums["termination"] = episode_sums["termination"] + r

        # ---- masked reset (:150-193) ----
        donef = done.to(self.dtype)

        # terrain curriculum (:443-463)
        terrain_level = state.terrain_level
        env_origin = state.env_origin
        if cfg.terrain.curriculum:
            dist = torch.linalg.vector_norm(physics.pos[:2]
                                            - env_origin[:2], dim=0)
            move_up = dist > self.terrain.env_length / 2
            move_down = (dist < torch.linalg.vector_norm(commands[:2], dim=0)
                         * self.max_episode_length_s * 0.5) & ~move_up
            new_lvl = (terrain_level + move_up.to(torch.int32)
                       - move_down.to(torch.int32))
            rand_lvl = torch.randint(0, self.max_terrain_level, (n,),
                                     generator=self.generator, device=dev,
                                     dtype=torch.int32)
            new_lvl = torch.where(new_lvl >= self.max_terrain_level,
                                  rand_lvl, torch.clamp_min(new_lvl, 0))
            terrain_level = torch.where(done, new_lvl, terrain_level)
            looked_up = self._terrain_origins[
                terrain_level.to(torch.int64), self._terrain_types].T
            env_origin = torch.where(done[None, :], looked_up, env_origin)

        # command curriculum (:465-474): every max_episode_length common
        # steps, gated on the mean tracking reward of finishing envs
        lin_vel_x_range = state.lin_vel_x_range
        if cfg.commands.curriculum and "tracking_lin_vel" in \
                self.reward_scales and \
                common_step % self.max_episode_length == 0:
            count = torch.sum(donef)
            mean_track = torch.sum(
                episode_sums["tracking_lin_vel"] * donef) / torch.clamp_min(
                    count, 1.0)
            crit = (mean_track / self.max_episode_length
                    > 0.8 * self.reward_scales["tracking_lin_vel"])
            fire = (count > 0) & crit
            mc = cfg.commands.max_curriculum
            widened = torch.stack([
                torch.clamp(lin_vel_x_range[0] - 0.5, -mc, 0.0),
                torch.clamp(lin_vel_x_range[1] + 0.5, 0.0, mc)])
            lin_vel_x_range = torch.where(fire, widened, lin_vel_x_range)

        # new physics for reset envs
        physics = physics.where(done, self._draw_reset_physics(env_origin))

        # resample commands of reset envs (:165)
        commands, vx_unit = self._resample_commands(commands, done)
        commands = self._apply_vx_and_deadband(commands, vx_unit,
                                               lin_vel_x_range, done)

        # domain-rand redraw on reset (extension; off by default)
        friction, mass_scales, link_params = (state.friction,
                                              state.mass_scales,
                                              state.link_params)
        if cfg.domain_rand.resample_on_reset:
            new_f = self._draw_friction(n)
            new_m = self._draw_mass_scales(n)
            friction = torch.where(done, new_f, friction)
            mass_scales = torch.where(done[None, :], new_m, mass_scales)
            link_params = self._link_params(mass_scales, n)

        # reset envs: swap in their (possibly new) cell's static window
        if self.grid is not None:
            rp, rpT, rr0, rc0 = self._cell_patch_lookup(
                self._env_cells(terrain_level))
            ph_c = torch.where(done[:, None, None], rp, ph_c)
            ph_T = torch.where(done[None, None, :], rpT, ph_T)
            pr0 = torch.where(done, rr0, pr0)
            pc0 = torch.where(done, rc0, pc0)
        else:
            ph_c, ph_T = state.patch, state.patch_T
            pr0, pc0 = state.patch_r0, state.patch_c0

        feet_air_time = feet_air_time * (~done)[None, :]
        ep_len_sum = torch.sum(episode_length * done)
        episode_length = torch.where(done, 0, episode_length)
        # actuator recurrent state zeroed per reset env (anymal.py:56-60)
        actuator_state = {k: v * (~done).to(v.dtype)
                          for k, v in actuator_state.items()}

        # episode logging sums over envs that finished this step
        ep_out = {name: torch.sum(episode_sums[name] * donef)
                  / self.max_episode_length_s for name in episode_sums}
        episode_sums = {name: s * (1.0 - donef)
                        for name, s in episode_sums.items()}

        # ---- observations (:214-231) ----
        obs, obs_clean = self._compute_obs(
            physics, base_lin_vel, base_ang_vel, projected_gravity, commands,
            a, measured)
        clip_o = cfg.normalization.clip_observations
        obs = torch.clamp(obs, -clip_o, clip_o)
        priv_obs = None
        if self.num_privileged_obs is not None:
            # what the real robot cannot sense: noiseless obs, the true
            # ground friction, the base-mass scale, the feet contact forces
            feet_f = contact_f[:, self._feet].reshape(3 * len(self.feet_idx),
                                                      n)
            priv_obs = torch.cat([
                torch.clamp(obs_clean, -clip_o, clip_o),
                friction[None, :],
                mass_scales[:1],
                feet_f * 0.01,
            ], dim=0).T                                     # (N, P)

        if self._warm_start:
            # fresh spawns start with no remembered stick anchors: back to
            # the far sentinel, so the stale rule re-snaps on first touch
            contact_ws = torch.where(done, ANCHOR_SENTINEL, contact_ws)

        new_state = EnvState(
            physics=physics, episode_length=episode_length,
            common_step=common_step, commands=commands, actions=a,
            patch=ph_c, patch_T=ph_T, patch_r0=pr0, patch_c0=pc0,
            last_actions=a, last_dof_vel=physics.qd,
            feet_air_time=feet_air_time, terrain_level=terrain_level,
            env_origin=env_origin, friction=friction,
            mass_scales=mass_scales, link_params=link_params,
            lin_vel_x_range=lin_vel_x_range, episode_sums=episode_sums,
            contact_ws=contact_ws, actuator_state=actuator_state)
        tr = Transition(
            obs=obs.T, reward=reward, done=done, time_out=time_out,
            episode_sums=ep_out, episode_count=torch.sum(donef),
            episode_length_sum=ep_len_sum.to(self.dtype),
            terrain_level_mean=torch.mean(terrain_level.to(self.dtype)),
            max_command_x=lin_vel_x_range[1],
            torques=torques,
            feet_contact_z=(contact_f[2, self._feet] if len(self.feet_idx)
                            else torch.zeros((0, n), dtype=self.dtype,
                                             device=dev)),
            privileged_obs=priv_obs)
        return new_state, tr

    # ------------------------------------------------------------- teleop

    def set_commands(self, state: EnvState, vx, vy, wz):
        """Override every env's velocity command (the reference's teleop
        hook _change_cmds, legged_robot.py:970-975; consumed by
        play_joy.py:119). Returns a new state; the heading slot is kept."""
        c = state.commands
        vel = torch.tensor([vx, vy, wz], dtype=self.dtype, device=c.device)
        c = torch.cat([vel[:, None].expand(3, c.shape[-1]), c[3:]], dim=0)
        return dataclasses.replace(state, commands=c)

    # ------------------------------------------------------------ physics

    def _sea_tau_fn(self, a, n):
        """The SEA net as ``(q, qd, carry) -> (tau, carry')``: input per sim
        dt = (pos target - q, qd) with targets NOT clipped to the soft
        limits (anymal.py:71-81); the LSTM state advances per sim dt."""
        targets = a * self.cfg.control.action_scale + self._dflt
        nq = self.num_dof

        def sea_tau(q, qd, act):
            tau, (h, c) = self._sea(
                (targets - q).reshape(nq * n), qd.reshape(nq * n),
                (act["h"].reshape(2, -1, nq * n),
                 act["c"].reshape(2, -1, nq * n)))
            return tau.reshape(nq, n), {"h": h.reshape(act["h"].shape),
                                        "c": c.reshape(act["c"].shape)}

        return sea_tau

    def _chain_physics(self, state, a, contact_patch, anchors):
        """The policy step's physics on the fused chain step. Returns
        (physics, torques, body forces, actuator state, anchors)."""
        if self._sea is not None:
            # SEA torque drive: one kernel launch per sim dt with the LSTM
            # evaluated between them
            out = self.chain_engine.step_decimation_torque_fn(
                state.physics, state.link_params, state.friction,
                self._sea_tau_fn(a, state.n), state.actuator_state,
                contact_patch=contact_patch, anchors=anchors)
            physics, torques, contact_f, actuator_state = out[:4]
        else:
            targets = torch.clamp(
                a * self.cfg.control.action_scale + self._dflt,
                self._soft_lo, self._soft_hi)
            out = self.chain_engine.step_decimation_pos(
                state.physics, state.link_params, state.friction, targets,
                contact_patch=contact_patch, anchors=anchors)
            physics, torques, contact_f = out[:3]
            actuator_state = state.actuator_state
        return (physics, torques, contact_f, actuator_state,
                out[-1] if anchors is not None else None)

    def _general_physics(self, state, a, patch, ws):
        """The policy step's physics on the general stacked engine:
        ``decimation`` sim dts with the drive's torque evaluated per sim dt
        (the JAX package's legged_env.py:770-911). The anchors ``ws``
        (None without warm start) and the actuator state carry across the
        sim dts; the sensors are the last sim dt's. Returns (physics,
        torques, body forces, actuator state, anchors)."""
        cfg = self.cfg
        eng = self.engine
        lp, fric = state.link_params, state.friction
        scale = cfg.control.action_scale
        ctrl = cfg.control.control_type
        phys, act = state.physics, state.actuator_state
        if self._sea is not None:
            sea_tau = self._sea_tau_fn(a, state.n)
        elif ctrl == "P":
            targets = torch.clamp(a * scale + self._dflt, self._soft_lo,
                                  self._soft_hi)
        elif ctrl == "V":
            # velocity drive (legged_robot.py:385-388): last_qd is the qd
            # at the end of the previous policy step (refreshed only in
            # post_physics_step), held over the decimation loop
            vel_t = a * scale
            qd_last = state.physics.qd
        for _ in range(cfg.control.decimation):
            if self._sea is not None:
                tau, act = sea_tau(phys.q, phys.qd, act)
            elif ctrl == "P" and self._uninet is not None:
                # applied-UniNet extension (the reference discards the
                # output, go1.py:68-76): dVel enters the PD damping term as
                # a velocity target
                dvel, act = self._uninet(targets, phys.q, phys.qd, act)
                tau = torch.clamp(
                    self._kp * (targets - phys.q)
                    - self._kd * (phys.qd - dvel),
                    self._neg_torque_lim, self._torque_lim)
            elif ctrl == "P":
                tau = None
            elif ctrl == "V":
                tau = (self._kp * (vel_t - phys.qd)
                       - self._kd * (phys.qd - qd_last) / cfg.sim.dt)
            else:                                           # "T"
                tau = a * scale
            if tau is None:
                out = eng.step_pos_targets(phys, lp, fric, targets,
                                           patch=patch, f_ws=ws)
            else:
                out = eng.step_torques(phys, lp, fric, tau, patch=patch,
                                       f_ws=ws)
            phys, info = out[0], out[1]
            if ws is not None:
                ws = out[2]
        return phys, info.torques, info.body_forces, act, ws

    # ------------------------------------------------------- observations

    def _get_heights(self, physics, patch):
        """Yaw-rotated height scan, min-of-3-cells rule (:818-854), against
        the env's cached terrain window."""
        if self.grid is None:
            return torch.zeros((self.num_height_points, physics.n),
                               dtype=self.dtype, device=self.device)
        rot = quat_ops.yaw_rotate(physics.quat[:, None, :],
                                  self._scan_p3[:, :, None])   # (3, P, N)
        x = rot[0] + physics.pos[0][None, :]
        y = rot[1] + physics.pos[1][None, :]
        return patch_sample_min3(self.grid, patch, x, y)

    def _compute_obs(self, physics, base_lin_vel, base_ang_vel,
                     projected_gravity, commands, actions, measured):
        """(obs, noiseless obs), each (obs_dim, N), before clipping."""
        s = self.obs_scales
        parts = [
            base_lin_vel * s["lin_vel"],
            base_ang_vel * s["ang_vel"],
            projected_gravity,
            commands[:3] * self._commands_scale,
            (physics.q - self._dflt) * s["dof_pos"],
            physics.qd * s["dof_vel"],
            actions,
        ]
        if self.measure_heights:
            h = torch.clamp(physics.pos[2][None, :] - 0.5 - measured,
                            -1.0, 1.0) * s["height_measurements"]
            parts.append(h)
        clean = torch.cat(parts, dim=0)                  # (obs_dim, N)
        obs = clean
        if self.cfg.noise.add_noise:
            noise = (2.0 * torch.rand(obs.shape, generator=self.generator,
                                      dtype=self.dtype, device=self.device)
                     - 1.0) * self._noise_vec
            obs = obs + noise
        return obs, clean

    # ------------------------------------------------------- reward terms
    # formulas: legged_robot.py:857-966 (fork variant incl. energy,
    # hip_motion), cassie.py:43-46 (no_fly)

    def _reward(self, name, ctx):
        return getattr(self, "_reward_" + name)(ctx)

    def _reward_lin_vel_z(self, c):
        return torch.square(c["base_lin_vel"][2])

    def _reward_ang_vel_xy(self, c):
        return torch.sum(torch.square(c["base_ang_vel"][:2]), dim=0)

    def _reward_orientation(self, c):
        return torch.sum(torch.square(c["projected_gravity"][:2]), dim=0)

    def _reward_base_height(self, c):
        h = torch.mean(c["physics"].pos[2][None, :] - c["measured_heights"],
                       dim=0)
        return torch.square(h - self.cfg.rewards.base_height_target)

    def _reward_torques(self, c):
        return torch.sum(torch.square(c["torques"]), dim=0)

    def _reward_energy(self, c):
        return torch.sum(torch.square(c["torques"] * c["physics"].qd), dim=0)

    def _reward_dof_vel(self, c):
        return torch.sum(torch.square(c["physics"].qd), dim=0)

    def _reward_dof_acc(self, c):
        return torch.sum(
            torch.square((c["last_dof_vel"] - c["physics"].qd) / self.dt),
            dim=0)

    def _reward_action_rate(self, c):
        return torch.sum(torch.square(c["last_actions"] - c["actions"]),
                         dim=0)

    def _reward_collision(self, c):
        if not len(self.penal_idx):
            return torch.zeros(c["physics"].n, dtype=self.dtype,
                               device=self.device)
        f = c["contact_forces"][:, self._penal]
        return torch.sum(
            (torch.linalg.vector_norm(f, dim=0) > 0.1).to(self.dtype), dim=0)

    def _reward_dof_pos_limits(self, c):
        q = c["physics"].q
        out = torch.clamp_max(q - self._soft_lo, 0.0) * -1.0 \
            + torch.clamp_min(q - self._soft_hi, 0.0)
        return torch.sum(out, dim=0)

    def _reward_dof_vel_limits(self, c):
        lim = self._vel_lim * self.cfg.rewards.soft_dof_vel_limit
        return torch.sum(
            torch.clamp(torch.abs(c["physics"].qd) - lim, 0.0, 1.0), dim=0)

    def _reward_torque_limits(self, c):
        lim = self._torque_lim * self.cfg.rewards.soft_torque_limit
        return torch.sum(torch.clamp_min(torch.abs(c["torques"]) - lim, 0.0),
                         dim=0)

    def _reward_tracking_lin_vel(self, c):
        err = torch.sum(
            torch.square(c["commands"][:2] - c["base_lin_vel"][:2]), dim=0)
        return torch.exp(-err / self.cfg.rewards.tracking_sigma)

    def _reward_tracking_ang_vel(self, c):
        err = torch.square(c["commands"][2] - c["base_ang_vel"][2])
        return torch.exp(-err / self.cfg.rewards.tracking_sigma)

    def _reward_feet_air_time(self, c):
        return c["feet_air_time_reward"]

    def _reward_stumble(self, c):
        f = c["contact_forces"][:, self._feet]              # (3, nf, N)
        lateral = torch.linalg.vector_norm(f[:2], dim=0)
        return torch.any(lateral > 5.0 * torch.abs(f[2]),
                         dim=0).to(self.dtype)

    _reward_feet_stumble = _reward_stumble

    def _reward_stand_still(self, c):
        dq = torch.sum(torch.abs(c["physics"].q - self._dflt), dim=0)
        return dq * (torch.linalg.vector_norm(c["commands"][:2], dim=0) < 0.1)

    def _reward_feet_contact_forces(self, c):
        f = c["contact_forces"][:, self._feet]
        return torch.sum(torch.clamp_min(
            torch.linalg.vector_norm(f, dim=0)
            - self.cfg.rewards.max_contact_force, 0.0), dim=0)

    def _reward_hip_motion(self, c):
        q = c["physics"].q[self._hip]
        return torch.sum(torch.abs(q - self._dflt[self._hip]), dim=0)

    def _reward_no_fly(self, c):
        """Cassie: exactly one foot in contact (cassie.py:43-46)."""
        f = c["contact_forces"][2, self._feet]
        single = torch.sum((f > 0.1).to(self.dtype), dim=0) == 1
        return single.to(self.dtype)
