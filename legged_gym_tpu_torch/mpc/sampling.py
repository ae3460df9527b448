"""Model-predictive control over the same physics the RL env steps (the
JAX package's mpc/sampling.py, its north-star extension; BASELINE.json
configs 4-5).

Three planners:
- MPPI: K noisy action sequences around a nominal, softmax(-cost / T)
  reweighting;
- CEM: elite refit of a diagonal Gaussian over sequences, n iterations;
- GradientMPC: Adam on the action sequence by differentiating THROUGH the
  physics rollout (torch.autograd through the plain chain step).

The K candidate rollouts are K envs of one batch-last physics step: on
the chain path each horizon step is one launch of the fused CUDA kernel
over K envs (K1, K4 with friction anchors, K2 on trimesh), the candidates
tiled from one start state. The kernel has no backward, so GradientMPC
asks the chain engine for its plain version (``plain=True``), which counts
no launch. Robots off the chain path (the general stacked engine) scan
``engine.step_pos_targets`` over the decimation.

The cost is built from the env's own reward terms (tracking rewards,
orientation shaping, termination contact — legged_robot.py:857-966
semantics) so PPO and MPC optimize the same objective. Random draws come
from a ``torch.Generator``; ``plan(noise=)`` takes the standard-normal
draws instead (the parity tests replay the JAX package's).

Split over ranks (``mesh``, parallel/sharding.py), each rank rolls out
K / world candidates: the draws are taken for all K and cut to the rank's;
the (K,) costs are gathered; MPPI's softmax weights come from the global
costs and the weighted sequence is summed over ranks; CEM's top-k over the
global costs is the same on every rank, and the elites' mean and
population std are summed over ranks in two passes. The plan and the best
cost are replicated.
"""
from __future__ import annotations

import dataclasses

import torch

from legged_gym_tpu_torch.ops import quat as quat_ops
from legged_gym_tpu_torch.parallel.sharding import (EnvMesh, all_sum,
                                                    shard_env_state)
from legged_gym_tpu_torch.physics.state import PhysicsState


@dataclasses.dataclass(frozen=True)
class MPCConfig:
    horizon: int = 16             # policy steps to look ahead (0.32 s)
    num_samples: int = 1024       # K rollouts per solve
    noise_std: float = 0.3        # action-space exploration std
    temperature: float = 0.1      # MPPI softmax temperature
    cem_iters: int = 3
    cem_elite_frac: float = 0.1
    gd_iters: int = 8
    gd_lr: float = 0.05
    termination_cost: float = 100.0


def _tile(x, k):
    """A (..., 1) tensor as (..., K), materialized once (the kernel takes
    contiguous inputs only)."""
    return x.expand(*x.shape[:-1], k).contiguous()


def _tile_state(phys, k):
    """A 1-env PhysicsState (batch-last, N=1) tiled to K candidates."""
    return PhysicsState(*(_tile(t, k) for t in (
        phys.pos, phys.quat, phys.vel, phys.q, phys.qd)))


class SamplingMPC:
    """MPPI / CEM planner bound to a LeggedEnv's engine and reward model."""

    differentiable = False      # GradientMPC needs d(rollout)/d(actions)

    def __init__(self, env, cfg: MPCConfig = MPCConfig(), method="mppi",
                 mesh=None):
        """``mesh``: an EnvMesh (a 1-D split over ranks) to roll out
        ``cfg.num_samples / world`` candidates on each rank;
        ``num_samples`` must divide by the world size."""
        if mesh is not None:
            if not isinstance(mesh, EnvMesh):
                raise ValueError(f"mesh: a 1-D env split (EnvMesh), not "
                                 f"{type(mesh).__name__}")
            if cfg.num_samples % mesh.world_size:
                raise ValueError(
                    f"num_samples {cfg.num_samples} must be divisible by "
                    f"the world size {mesh.world_size}")
        if method not in ("mppi", "cem"):
            raise ValueError(f"method {method!r}: mppi or cem")
        self.env = env
        self.cfg = cfg
        self.method = method
        self.mesh = mesh

    # ---- rollout cost ----
    def rollout_cost(self, phys0, link_params, friction, commands, seqs,
                     contact_patch=None, anchors=None):
        """seqs: (H, na, K) action sequences; phys0 batched over K;
        commands (3,) vx, vy, wz. Returns (K,) total cost. No resets: bad
        candidates accumulate the termination-contact penalty instead of
        teleporting.

        anchors: the static-friction anchor carry (chain_engine
        init_anchors layout, batched over K) for warm-start robots
        (aliengo), threaded through the horizon and discarded at its end.
        contact_patch: a terrain window (ph (S,S,K), r0, c0) shared by every
        step of the horizon (all K candidates start from one robot state,
        and horizon * dt * |v| is far inside the window)."""
        env = self.env
        ce = env.chain_engine
        sigma = env.cfg.rewards.tracking_sigma
        scale = env.cfg.control.action_scale
        track_ws = (ce is not None and anchors is not None
                    and ce.cc.warm_start)
        anc = anchors if track_ws else None
        phys = phys0
        cost = torch.zeros(seqs.shape[-1], dtype=seqs.dtype,
                           device=seqs.device)
        for a in seqs:                                         # (na, K)
            targets = torch.clamp(a * scale + env._dflt, env._soft_lo,
                                  env._soft_hi)
            if ce is not None:
                out = ce.step_decimation_pos(
                    phys, link_params, friction, targets,
                    contact_patch=contact_patch, anchors=anc,
                    plain=self.differentiable)
                phys, contact_f = out[0], out[2]
                if track_ws:
                    anc = out[3]
            else:
                phys, contact_f = self._general_step(phys, link_params,
                                                     friction, targets)

            blv = phys.base_lin_vel()
            bav = phys.base_ang_vel()
            err_lin = torch.sum(torch.square(commands[:2, None] - blv[:2]),
                                dim=0)
            err_ang = torch.square(commands[2] - bav[2])
            r = torch.exp(-err_lin / sigma) + 0.5 * torch.exp(-err_ang / sigma)
            c = -r * env.dt
            # flat-orientation shaping (orientation:869 analog)
            g = quat_ops.rotate_inverse(phys.quat,
                                        env._gvec.expand(3, phys.n))
            c = c + 0.1 * torch.sum(torch.square(g[:2]), dim=0) * env.dt
            if len(env.term_idx):
                bad = torch.any(torch.linalg.vector_norm(
                    contact_f[:, env._term], dim=0) > 1.0, dim=0)
                c = c + self.cfg.termination_cost * bad * env.dt
            cost = cost + c
        return cost

    def _general_step(self, phys, link_params, friction, targets):
        """One policy step on the general stacked engine: ``decimation``
        sim dts, the terrain window extracted around the step's start
        state. Returns (state', the last sim dt's body forces)."""
        from legged_gym_tpu_torch.terrain.heightfield import (
            TerrainPatch, extract_patches)

        env = self.env
        patch = None
        if env.grid is not None:
            patch = TerrainPatch(*extract_patches(env.grid, phys.pos[0],
                                                  phys.pos[1]))
        for _ in range(env.cfg.control.decimation):
            phys, info = env.engine.step_pos_targets(
                phys, link_params, friction, targets, patch=patch)[:2]
        return phys, info.body_forces

    def _shared_patch(self, phys_single, k):
        """One terrain window around the (single) start state, tiled over
        the K candidates (see rollout_cost); None off the chain path or on
        a plane."""
        env = self.env
        ce = env.chain_engine
        if env.grid is None or ce is None:
            return None
        ph, r0, c0 = ce.extract_contact_patch(env.grid, phys_single.pos[0],
                                              phys_single.pos[1])
        return _tile(ph, k), _tile(r0, k), _tile(c0, k)

    def _anchors_k(self, anchors, k, device):
        """An N=1 anchor carry (the env's CURRENT anchors, so the plan
        starts from the executed stance's stick state) tiled over the K
        candidates; fresh sentinel anchors when none are supplied; None
        without warm start."""
        ce = self.env.chain_engine
        if ce is None or not ce.cc.warm_start:
            return None
        if anchors is None:
            return ce.init_anchors(k, device)
        return _tile(anchors, k)

    def _tiled(self, phys_single, link_params, friction, anchors, k):
        return (_tile_state(phys_single, k), _tile(link_params, k),
                _tile(friction, k), self._shared_patch(phys_single, k),
                self._anchors_k(anchors, k, phys_single.pos.device))

    # ---- planners ----
    def plan(self, generator, phys_single, link_params, friction, commands,
             nominal=None, anchors=None, noise=None):
        """One MPC solve for a single robot state (N=1 slices of the env
        state; anchors: the matching N=1 slice of EnvState.contact_ws for
        warm-start robots). Returns (action_seq (H, na), info).

        The standard-normal draws come from ``generator`` (on the state's
        device), or from ``noise``: (H, na, K) for MPPI, (cem_iters, H, na,
        K) for CEM, over all K candidates also when split over ranks. The
        tiled inputs are materialized once per solve, at this rank's
        K."""
        cfg = self.cfg
        mesh = self.mesh
        h, na, k = cfg.horizon, self.env.num_actions, cfg.num_samples
        dev = phys_single.pos.device
        if nominal is None:
            nominal = torch.zeros((h, na), device=dev)
        # this rank's candidates (all of them unsplit)
        mine = slice(0, k) if mesh is None else mesh.env_slice(k)
        k_here = mine.stop - mine.start

        def draw(i):
            if noise is not None:
                full = noise if self.method == "mppi" else noise[i]
            else:
                full = torch.randn((h, na, k), generator=generator,
                                   device=dev)
            return shard_env_state(full, mesh, k)

        with torch.no_grad():
            phys_k, lp_k, fr_k, cpatch, anc_k = self._tiled(
                phys_single, link_params, friction, anchors, k_here)

            def cost_of(seqs):
                """The (K,) costs of every rank's candidates."""
                cost = self.rollout_cost(phys_k, lp_k, fr_k, commands, seqs,
                                         contact_patch=cpatch, anchors=anc_k)
                return cost if mesh is None else mesh.gather_envs(cost, k)

            if self.method == "mppi":
                seqs = nominal[:, :, None] + draw(0) * cfg.noise_std
                cost = cost_of(seqs)
                w = torch.softmax(-cost / cfg.temperature, dim=0)   # (K,)
                new_seq = all_sum(torch.sum(seqs * w[mine], dim=-1), mesh)
                return new_seq, {"cost": torch.sum(cost * w),
                                 "best_cost": cost.min()}

            # CEM
            n_elite = max(1, int(k * cfg.cem_elite_frac))
            mean = nominal
            std = torch.full((h, na), cfg.noise_std, device=dev)
            elites = []
            for i in range(cfg.cem_iters):
                seqs = mean[:, :, None] + std[:, :, None] * draw(i)
                cost = cost_of(seqs)
                elite_idx = torch.topk(cost, n_elite, largest=False).indices
                # the elites this rank holds; mean, then the population
                # std (as jnp.std), over all ranks'
                held = (elite_idx >= mine.start) & (elite_idx < mine.stop)
                elite = seqs[:, :, elite_idx[held] - mine.start]
                mean = all_sum(elite.sum(dim=-1), mesh) / n_elite
                var = all_sum(torch.square(elite - mean[:, :, None])
                              .sum(dim=-1), mesh) / n_elite
                std = torch.sqrt(var) + 1e-3
                elites.append(elite_idx)
            return mean, {"best_cost": cost.min(),
                          "elite_idx": torch.stack(elites)}


class GradientMPC(SamplingMPC):
    """First-order trajectory optimization by differentiating through the
    rollout (the plain chain step is end-to-end differentiable)."""

    differentiable = True

    def cost_and_grad(self, seq, phys_single, link_params, friction,
                      commands, contact_patch=None, anchors=None):
        """(cost (), d cost / d seq (H, na)) of one action sequence."""
        seq = seq.detach().requires_grad_(True)
        with torch.enable_grad():
            cost = self.rollout_cost(phys_single, link_params, friction,
                                     commands, seq[:, :, None],
                                     contact_patch=contact_patch,
                                     anchors=anchors)[0]
            (grad,) = torch.autograd.grad(cost, seq)
        return cost.detach(), grad

    def plan(self, generator, phys_single, link_params, friction, commands,
             nominal=None, anchors=None, noise=None):
        """``gd_iters`` Adam steps on the sequence from ``nominal`` (zeros);
        ``generator`` and ``noise`` are unused (no draws). Returns
        (action_seq (H, na), {"cost_trace", "best_cost"})."""
        cfg = self.cfg
        h, na = cfg.horizon, self.env.num_actions
        dev = phys_single.pos.device
        seq = (torch.zeros((h, na), device=dev) if nominal is None
               else nominal.detach())
        _, _, _, cpatch, anc1 = self._tiled(phys_single, link_params,
                                            friction, anchors, 1)
        m = torch.zeros_like(seq)
        v = torch.zeros_like(seq)
        costs = []
        for it in range(cfg.gd_iters):
            c, g = self.cost_and_grad(seq, phys_single, link_params,
                                      friction, commands,
                                      contact_patch=cpatch, anchors=anc1)
            t = float(it + 1)
            m = 0.9 * m + 0.1 * g
            v = 0.999 * v + 0.001 * g * g
            mh = m / (1.0 - 0.9 ** t)
            vh = v / (1.0 - 0.999 ** t)
            seq = seq - cfg.gd_lr * mh / (torch.sqrt(vh) + 1e-8)
            costs.append(c)
        costs = torch.stack(costs)
        return seq, {"cost_trace": costs, "best_cost": costs[-1]}
