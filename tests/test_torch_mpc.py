"""The PyTorch port's MPC planners (mpc/sampling.py) against the JAX
package's, on the CPU.

Both packages get the same start state (the port's, settled with zero
actions and carried over as numpy), the same action sequences and the
same standard-normal draws (the JAX keys' draws, injected with
``plan(noise=)``). One robot, the 2-dof hopper of tests/test_mpc.py (it
decomposes into one chain), on heightfield with friction anchors at one
sim dt per policy step:
- on the chain step: rollout costs with the shared contact window and
  the env's anchors tiled over the candidates, and GradientMPC's gradient
  through the plain chain step, the JAX side op by op
  (``jax.disable_jit``), as the port's other tests run the JAX chain step;
- on the general stacked engine (the same env with its chain step hidden
  from the planner): rollout costs, MPPI and CEM plans, the JAX side
  jitted, as tests/test_mpc.py jits it.
A full robot would cost 12-14 s to build as a JAX env here and 90 s for
one op-by-op gradient: go1 and aliengo's rollout costs are held in
tests/test_torch_mpc_robots.py; their planners run on the card
(chip_smoke.py phase 6).
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from legged_gym_tpu.config import LeggedRobotCfg as JaxLeggedRobotCfg
from legged_gym_tpu.envs.legged_env import LeggedEnv as JaxLeggedEnv
from legged_gym_tpu.mpc import sampling as jax_mpc
from legged_gym_tpu.physics.state import PhysicsState as JaxPhysicsState
from legged_gym_tpu_torch.config import LeggedRobotCfg
from legged_gym_tpu_torch.envs.legged_env import LeggedEnv
from legged_gym_tpu_torch.mpc import GradientMPC, MPCConfig, SamplingMPC
from legged_gym_tpu_torch.physics import chain_kernel, chain_step

# one intra-op thread: the tensors are a few envs wide and the test
# workers share the cores
torch.set_num_threads(1)

K, H = 8, 2
SETTLE = 16             # zero-action steps: the foot is down, anchors live
COST_ATOL = 1e-4        # the (K,) rollout costs, port vs JAX
PLAN_ATOL = 1e-4        # planned (H, na) sequences, port vs JAX

HOPPER = """
<robot name="hopper">
  <link name="base">
    <inertial><mass value="3.0"/><origin xyz="0 0 0"/>
      <inertia ixx="0.02" iyy="0.02" izz="0.02" ixy="0" ixz="0" iyz="0"/>
    </inertial>
    <collision><origin xyz="0 0 0"/><geometry><sphere radius="0.08"/></geometry></collision>
  </link>
  <link name="thigh">
    <inertial><mass value="0.5"/><origin xyz="0 0 -0.1"/>
      <inertia ixx="0.002" iyy="0.002" izz="0.0005" ixy="0" ixz="0" iyz="0"/>
    </inertial>
  </link>
  <joint name="hip_joint" type="revolute">
    <parent link="base"/><child link="thigh"/>
    <origin xyz="0 0 -0.05"/><axis xyz="0 1 0"/>
    <limit lower="-1.5" upper="1.5" effort="30" velocity="20"/>
  </joint>
  <link name="shank_foot">
    <inertial><mass value="0.2"/><origin xyz="0 0 -0.1"/>
      <inertia ixx="0.001" iyy="0.001" izz="0.0002" ixy="0" ixz="0" iyz="0"/>
    </inertial>
    <collision><origin xyz="0 0 -0.2"/><geometry><sphere radius="0.03"/></geometry></collision>
  </link>
  <joint name="knee_joint" type="revolute">
    <parent link="thigh"/><child link="shank_foot"/>
    <origin xyz="0 0 -0.2"/><axis xyz="0 1 0"/>
    <limit lower="-2.0" upper="2.0" effort="30" velocity="20"/>
  </joint>
</robot>
"""


def _hopper_cfg(cls, path):
    """tests/test_mpc.py's hopper config on a 2 x 2 heightfield, with
    friction anchors and one sim dt per policy step."""
    cfg = cls()
    cfg.sim.contact_warm_start = True
    cfg.control.decimation = 1
    cfg.env.num_envs = 2
    cfg.env.num_actions = 2
    cfg.env.num_observations = 9 + 3 + 2 * 2 + 2
    cfg.asset.file = str(path)
    cfg.asset.foot_name = "foot"
    cfg.init_state.pos = [0.0, 0.0, 0.5]
    cfg.init_state.default_joint_angles = {"hip_joint": 0.2,
                                           "knee_joint": -0.4}
    cfg.control.stiffness = {"joint": 20.0}
    cfg.control.damping = {"joint": 0.5}
    cfg.terrain.mesh_type = "heightfield"
    cfg.terrain.curriculum = False
    cfg.terrain.num_rows = 2
    cfg.terrain.num_cols = 2
    cfg.terrain.measure_heights = False
    cfg.noise.add_noise = False
    cfg.domain_rand.push_robots = False
    return cfg


class Case:
    """Both packages' envs and one settled N=1 start state: the port's
    tensors and the same values as JAX arrays."""

    def __init__(self, jenv, tenv, settle):
        self.jenv, self.tenv = jenv, tenv
        zeros = torch.zeros((tenv.num_envs, tenv.num_actions))
        state = tenv.initial_state()
        for _ in range(settle):
            state, tr = tenv.step(state, zeros)
            assert not tr.done.any()
        p = state.physics
        self.phys = type(p)(*(t[..., :1].contiguous() for t in (
            p.pos, p.quat, p.vel, p.q, p.qd)))
        self.lp = state.link_params[..., :1].contiguous()
        self.fr = state.friction[:1].contiguous()
        self.anchors = (None if state.contact_ws is None
                        else state.contact_ws[..., :1].contiguous())
        j = lambda t: jnp.asarray(t.numpy())   # noqa: E731
        self.phys_j = JaxPhysicsState(
            pos=j(self.phys.pos), quat=j(self.phys.quat),
            vel=j(self.phys.vel), q=j(self.phys.q), qd=j(self.phys.qd))
        self.lp_j, self.fr_j = j(self.lp), j(self.fr)
        self.anchors_j = None
        if self.anchors is not None:
            # the port's packed anchors as the JAX chain path's groups
            self.anchors_j = [j(a.contiguous()) for a in
                              chain_step.split_anchors(
                                  tenv.chain_engine.cm, self.anchors)]


class GeneralView:
    """An env with its chain step hidden: the planners take their
    general-engine branch (``env.chain_engine`` None) on the same
    engine."""
    chain_engine = None

    def __init__(self, env):
        self._env = env

    def __getattr__(self, name):
        return getattr(self._env, name)


@pytest.fixture(scope="module")
def hopper(tmp_path_factory):
    path = tmp_path_factory.mktemp("mpc") / "hopper.urdf"
    path.write_text(HOPPER)
    jenv = JaxLeggedEnv(_hopper_cfg(JaxLeggedRobotCfg, path))
    tenv = LeggedEnv(_hopper_cfg(LeggedRobotCfg, path), device="cpu")
    assert tenv.chain_engine.cc.warm_start and tenv.grid is not None
    assert jenv.chain_engine is not None
    return Case(jenv, tenv, settle=SETTLE)


@pytest.fixture(scope="module")
def hopper_general(hopper):
    case = copy.copy(hopper)
    case.jenv, case.tenv = GeneralView(hopper.jenv), GeneralView(hopper.tenv)
    case.anchors = case.anchors_j = None
    return case


def _commands():
    return np.array([0.4, 0.1, 0.2], np.float32)


def _seqs(case, seed):
    return np.random.default_rng(seed).normal(
        0.0, 0.3, (H, case.tenv.num_actions, K)).astype(np.float32)


def _jax_cost_fn(case, contact_patch=None, anchors=None):
    """The JAX rollout cost of (H, na, K) sequences from the case's start
    state tiled over K; on the general engine jitted once per case and
    kept (the plan tests reuse the compiled function)."""
    if getattr(case, "jax_cost", None) is not None:
        return case.jax_cost
    jm = jax_mpc.SamplingMPC(case.jenv, MPCConfig(horizon=H, num_samples=K))
    phys = jax_mpc._tile_state(case.phys_j, K)
    lp = jnp.broadcast_to(case.lp_j, case.lp_j.shape[:-1] + (K,))
    fr = jnp.broadcast_to(case.fr_j, (K,))

    def cost(seqs):
        return jm.rollout_cost(phys, lp, fr, jnp.asarray(_commands()), seqs,
                               contact_patch=contact_patch, anchors=anchors)
    if case.tenv.chain_engine is None:
        case.jax_cost = jax.jit(cost)
        return case.jax_cost
    return cost


@pytest.mark.parametrize("path", ["hopper", "hopper_general"])
def test_rollout_cost_matches_jax(path, request):
    """(K,) costs of K tiled candidates over H steps at atol 1e-4: the
    chain step with the shared heightfield window and the env's anchors
    tiled and threaded through the horizon; the general engine."""
    case = request.getfixturevalue(path)
    cfg = MPCConfig(horizon=H, num_samples=K)
    tm = SamplingMPC(case.tenv, cfg)
    jm = jax_mpc.SamplingMPC(case.jenv, cfg)
    seqs = _seqs(case, 1)
    phys_k, lp_k, fr_k, cpatch, anc_k = tm._tiled(
        case.phys, case.lp, case.fr, case.anchors, K)
    chain = path == "hopper"
    assert (cpatch is not None) == chain and (anc_k is not None) == chain
    launched = dict(chain_kernel.launches)
    cost_t = tm.rollout_cost(phys_k, lp_k, fr_k,
                             torch.as_tensor(_commands()),
                             torch.as_tensor(seqs), contact_patch=cpatch,
                             anchors=anc_k)
    assert chain_kernel.launches == launched      # the CPU runs plain
    with jax.disable_jit(chain):
        jcp = jm._shared_patch(case.phys_j, K)
        if chain:
            for a, b in zip(jcp, cpatch):
                np.testing.assert_array_equal(np.asarray(a), b.numpy())
            live = anc_k < 1e5
            assert int(live.sum()) > 0         # the stance's stick anchors
            for a, b in zip(jm._anchors_k(case.anchors_j, K),
                            chain_step.split_anchors(case.tenv.chain_engine.cm,
                                                     anc_k)):
                np.testing.assert_array_equal(np.asarray(a), b.numpy())
        cost_j = _jax_cost_fn(case, jcp, jm._anchors_k(
            case.anchors_j, K))(jnp.asarray(seqs))
    assert cost_t.shape == (K,) and torch.isfinite(cost_t).all()
    np.testing.assert_allclose(cost_t.numpy(), np.asarray(cost_j),
                               atol=COST_ATOL)
    # the candidates are distinct rollouts
    assert float(cost_t.max() - cost_t.min()) > 1e-6


def test_mppi_plan_matches_jax(hopper_general):
    """MPPI against the JAX package's plan with PRNGKey(1), its draws
    injected (``plan(noise=)``): the plan at atol 1e-4 (T = 0.1 scales a
    cost difference by 10), the weighted and the best cost at 1e-4."""
    case = hopper_general
    cfg = MPCConfig(horizon=H, num_samples=K)
    key = jax.random.PRNGKey(1)
    noise = np.asarray(jax.random.normal(key, (H, 2, K)))
    jm = jax_mpc.SamplingMPC(case.jenv, cfg)
    seq_j, info_j = jax.jit(jm.plan)(key, case.phys_j, case.lp_j,
                                     case.fr_j, jnp.asarray(_commands()))
    seq_t, info_t = SamplingMPC(case.tenv, cfg).plan(
        None, case.phys, case.lp, case.fr, torch.as_tensor(_commands()),
        noise=torch.as_tensor(noise.copy()))
    assert seq_t.shape == (H, 2)
    np.testing.assert_allclose(seq_t.numpy(), np.asarray(seq_j),
                               atol=PLAN_ATOL)
    np.testing.assert_allclose(float(info_t["cost"]),
                               float(info_j["cost"]), atol=COST_ATOL)
    np.testing.assert_allclose(float(info_t["best_cost"]),
                               float(info_j["best_cost"]), atol=COST_ATOL)


def test_cem_plan_and_elites_match_jax(hopper_general):
    """CEM, 2 iterations, 2 elites of 8: the elite sets equal to
    ``jax.lax.top_k``'s in every iteration, the plan at atol 1e-4."""
    case = hopper_general
    cfg = MPCConfig(horizon=H, num_samples=K, cem_iters=2,
                    cem_elite_frac=0.25)
    key = jax.random.PRNGKey(3)
    keys = jax.random.split(key, cfg.cem_iters)
    noise = np.stack([np.asarray(jax.random.normal(k, (H, 2, K)))
                      for k in keys])
    jm = jax_mpc.SamplingMPC(case.jenv, cfg, method="cem")
    seq_j, info_j = jax.jit(jm.plan)(key, case.phys_j, case.lp_j,
                                     case.fr_j, jnp.asarray(_commands()))
    # the elites of the JAX iterations, by the plan's own steps
    cost_fn = _jax_cost_fn(case)
    mean = jnp.zeros((H, 2))
    std = jnp.full((H, 2), cfg.noise_std)
    elites_j = []
    for i in range(cfg.cem_iters):
        seqs = mean[:, :, None] + std[:, :, None] * noise[i]
        _, idx = jax.lax.top_k(-cost_fn(seqs), 2)
        elites_j.append(sorted(np.asarray(idx).tolist()))
        mean = seqs[:, :, idx].mean(axis=-1)
        std = seqs[:, :, idx].std(axis=-1) + 1e-3
    np.testing.assert_allclose(np.asarray(mean), np.asarray(seq_j),
                               atol=1e-6)
    seq_t, info_t = SamplingMPC(case.tenv, cfg, method="cem").plan(
        None, case.phys, case.lp, case.fr,
        torch.as_tensor(_commands()), noise=torch.as_tensor(noise.copy()))
    assert [sorted(e.tolist()) for e in info_t["elite_idx"]] == elites_j
    np.testing.assert_allclose(seq_t.numpy(), np.asarray(seq_j),
                               atol=PLAN_ATOL)
    np.testing.assert_allclose(float(info_t["best_cost"]),
                               float(info_j["best_cost"]), atol=COST_ATOL)


def test_gradient_mpc_gradient_matches_jax(hopper, hopper_general):
    """d cost / d actions through the plain chain step over H = 2 policy
    steps against ``jax.value_and_grad``: cost at atol 1e-4, gradient at
    rtol 1e-3 (with an atol of 1e-3 of its largest entry, for the entries
    near zero). The plain step runs on request (``plain=True``) and counts
    no launch. The rollout runs without anchors: through the anchored
    friction law the gradient is NaN in both packages. The plan's Adam
    steps (on the general engine, where no anchors are drawn) give a finite
    cost trace."""
    case = hopper
    cfg = MPCConfig(horizon=H, gd_iters=2)
    seq = np.random.default_rng(4).normal(0.0, 0.3, (H, 2)).astype(
        np.float32)
    tm = GradientMPC(case.tenv, cfg)
    launched = dict(chain_kernel.launches)
    cost_t, grad_t = tm.cost_and_grad(
        torch.as_tensor(seq), case.phys, case.lp, case.fr,
        torch.as_tensor(_commands()),
        contact_patch=tm._shared_patch(case.phys, 1))
    assert chain_kernel.launches == launched
    jm = jax_mpc.GradientMPC(case.jenv, cfg)
    with jax.disable_jit():
        jcp = jm._shared_patch(case.phys_j, 1)
        cost_j, grad_j = jax.value_and_grad(lambda s: jm.rollout_cost(
            case.phys_j, case.lp_j, case.fr_j, jnp.asarray(_commands()),
            s[:, :, None], contact_patch=jcp)[0])(jnp.asarray(seq))
    grad_j = np.asarray(grad_j)
    assert np.abs(grad_j).max() > 0
    np.testing.assert_allclose(float(cost_t), float(cost_j), atol=COST_ATOL)
    np.testing.assert_allclose(grad_t.numpy(), grad_j, rtol=1e-3,
                               atol=1e-3 * np.abs(grad_j).max())
    plan, info = GradientMPC(hopper_general.tenv, cfg).plan(
        None, case.phys, case.lp, case.fr, torch.as_tensor(_commands()))
    assert plan.shape == (H, 2) and info["cost_trace"].shape == (2,)
    assert torch.isfinite(info["cost_trace"]).all()
    assert torch.isfinite(plan).all()


def test_plain_chain_step_carries_a_gradient(hopper):
    """ChainEngine.step_decimation_pos(plain=True): the new state and the
    torques are differentiable functions of the targets."""
    case = hopper
    ce = case.tenv.chain_engine
    targets = (case.tenv._dflt.clone() + 0.1).requires_grad_(True)
    state, tau, _ = ce.step_decimation_pos(case.phys, case.lp, case.fr,
                                           targets, plain=True)
    (g,) = torch.autograd.grad(state.q.sum() + tau.sum(), targets)
    assert torch.isfinite(g).all() and float(g.abs().max()) > 0


def test_mesh_and_method_are_checked(hopper):
    # a mesh must be a 1-D env split (tests/test_torch_sharding.py holds
    # the split planners and the world-size check)
    with pytest.raises(ValueError, match="1-D env split"):
        SamplingMPC(hopper.tenv, MPCConfig(), mesh=object())
    with pytest.raises(ValueError):
        SamplingMPC(hopper.tenv, MPCConfig(), method="ilqr")
