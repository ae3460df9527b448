"""The port's env axis split over ranks (legged_gym_tpu_torch/parallel)
against the port's unsharded run of the same seed, on the CPU: two ranks
of one gloo process group, spawned by ``parallel.run_ranks``.

- PPO on go1 rough as the JAX package's own sharding test builds it
  (tests/test_sharding.py:30-42: 235 obs, trimesh 3 x 2 with curriculum,
  16 envs, 4 steps per env), through PPORunner with the episode lengths
  randomized, the feed-forward policy and the LSTM policy (env-axis
  minibatches: a rank's share of a minibatch varies). Two findings set
  how it is held:
  * the policy's MLP gives other last bits on 8 rows than on 16 (the
    CPU's matrix products block by the row count, as cuBLAS does on the
    card), so a sharded rollout's actions differ from the unsharded ones
    by rounding: evaluated in two halves of 8 rows, with nothing else
    split, one iteration ends 1.2e-4 away in a parameter;
  * Adam's first step from zero moments moves every parameter by
    lr * g / (|g| + eps), so an element whose gradient is zero up to
    rounding moves by a rounding-decided amount: in the first minibatch
    one critic weight's gradient sums to 1.4e-8 unsplit and to 5.6e-8
    as two ranks' sums (others of that minibatch are ~1e-1), and the
    parameters end 1.2e-4 apart after one sharded update of the
    unsharded batch.
  So the rollout and the update are held apart: each rank's first
  rollout against its envs of the unsharded one (ROLLOUT_ATOL), and the
  sharded update of the second iteration, from the unsharded run's
  checkpoint after the first (read by every rank) and on the unsharded
  rollout's batch, against the unsharded update: loss within 1e-4
  relative and every parameter within 1e-4 (tests/test_sharding.py:
  83-91), the learning rate and the global metrics equal, the parameters
  equal on the two ranks. The whole 2-iteration run is held on its loss
  (1e-4 relative, as the JAX test) and on equal parameters across ranks;
  its parameter drift is printed;
- MPPI and CEM on the 2-dof hopper of tests/test_torch_mpc.py (K 32, 16
  per rank, H 3): the plans equal the unsharded ones at rtol 2e-4 /
  atol 2e-5 (tests/test_mpc.py:172-215 holds the JAX planners so);
- ``scripts.bench_scaling.run`` at 16 envs on 1 and 2 CPU ranks;
- the helpers: env slices, shard_env_state / shard_batch, a failing rank
  reported with its traceback while the other waits in a collective, the
  planner's world-size check, ``--shard`` without torchrun.

The unsharded port is held against the JAX package by
tests/test_torch_ppo.py and tests/test_torch_mpc.py, so nothing here
imports JAX: the spawned ranks import this module afresh.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

from legged_gym_tpu_torch import registry
from legged_gym_tpu_torch.config import LeggedRobotCfg
from legged_gym_tpu_torch.envs.legged_env import LeggedEnv
from legged_gym_tpu_torch.mpc import MPCConfig, SamplingMPC
from legged_gym_tpu_torch.parallel import (EnvMesh, all_sum, run_ranks,
                                           shard_batch, shard_env_state)
from legged_gym_tpu_torch.rl.ppo import batch_envs
from legged_gym_tpu_torch.rl.runner import PPORunner, fetch_metrics

# one intra-op thread: the tensors are a few envs wide and the test
# workers share the cores (run_ranks sets the same in each rank)
torch.set_num_threads(1)

WORLD = 2
NUM_ENVS = 16
JOIN_S = 60.0                   # run_ranks' timeout per spawn
LOSS_RTOL = 1e-4                # tests/test_sharding.py:83-91
PARAM_ATOL = 1e-4
# a rank's rollout against its envs of the unsharded one: the policy's
# rows differ by rounding (module docstring), 4 steps carry that to
# ~1e-6 here
ROLLOUT_ATOL = 1e-4
PLAN_RTOL, PLAN_ATOL = 2e-4, 2e-5
K, H = 32, 3
SETTLE = 16

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


# ------------------------------------------------------------ the runs

def _rough_cfgs(recurrent):
    """go1 rough at 16 envs as tests/test_sharding.py:_build makes it."""
    cfg, tcfg = registry.get_cfgs("go1")
    cfg.env.num_envs = NUM_ENVS
    cfg.env.num_observations = 235
    cfg.terrain.mesh_type = "trimesh"
    cfg.terrain.measure_heights = True
    cfg.terrain.curriculum = True
    cfg.terrain.num_rows = 3
    cfg.terrain.num_cols = 2
    tcfg.runner.num_steps_per_env = 4
    if recurrent:
        tcfg.runner.policy_class_name = "ActorCriticRecurrent"
        tcfg.policy.rnn_hidden_size = 64
    return cfg, tcfg


def _runner(mesh, recurrent):
    """PPORunner on go1 rough (split over ``mesh``), its env state drawn
    with randomized episode lengths."""
    cfg, tcfg = _rough_cfgs(recurrent)
    env, _ = registry.make_env(cfg=cfg, device="cpu", mesh=mesh)
    runner = PPORunner(env, tcfg, seed=0)
    runner._ensure_env_state(init_at_random_ep_len=True)
    return runner


def _state(runner):
    ts = runner.train_state
    return {"params": [p.detach().clone() for p in ts.params],
            "lr": float(ts.lr)}


def _two_iterations(mesh, recurrent, ckpt=None):
    """Two whole iterations, as their rollouts and updates: the first
    rollout's batch, the second's, and the state and metrics after the
    second; with ``ckpt`` the state after the first is saved there."""
    runner = _runner(mesh, recurrent)
    ts, fn = runner.train_state, runner.learn_fn
    env_state, obs, first = fn.rollout(ts, runner.env_state, runner.obs)
    fn.update(ts, first)
    if ckpt is not None:
        runner.save(ckpt)
    _, _, second = fn.rollout(ts, env_state, obs)
    metrics = fetch_metrics(fn.update(ts, second))
    return {"rollout": first, "batch": second, "metrics": metrics,
            **_state(runner)}


def _update(mesh, recurrent, ckpt, batch):
    """The PPO update from the checkpoint ``ckpt`` on ``batch`` (a global
    rollout batch, cut to this rank's envs)."""
    runner = _runner(mesh, recurrent)
    runner.load(ckpt)
    batch = batch_envs(batch, mesh.env_slice(NUM_ENVS))
    metrics = fetch_metrics(runner.learn_fn.update(runner.train_state,
                                                   batch))
    return {"metrics": metrics, **_state(runner)}


def _hopper_cfg(path):
    """tests/test_torch_mpc.py's hopper: 2 x 2 heightfield, friction
    anchors, one sim dt per policy step."""
    cfg = LeggedRobotCfg()
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


def _plans(mesh, urdf):
    """MPPI and CEM plans (and best costs) from the hopper's settled env 0,
    K candidates (split over ``mesh``'s ranks), draws from one seed."""
    env = LeggedEnv(_hopper_cfg(urdf), device="cpu")
    zeros = torch.zeros((env.num_envs, env.num_actions))
    state = env.initial_state()
    with torch.no_grad():
        for _ in range(SETTLE):
            state, _ = env.step(state, zeros)
    p = state.physics
    one = [t[..., :1].contiguous() for t in (p.pos, p.quat, p.vel, p.q,
                                             p.qd)]
    args = (type(p)(*one), state.link_params[..., :1].contiguous(),
            state.friction[:1].contiguous(),
            torch.tensor([0.4, 0.1, 0.2]))
    out = {}
    for method in ("mppi", "cem"):
        planner = SamplingMPC(env, MPCConfig(horizon=H, num_samples=K),
                              method, mesh=mesh)
        seq, info = planner.plan(torch.Generator().manual_seed(7), *args,
                                 anchors=state.contact_ws[..., :1]
                                 .contiguous())
        out[method] = (seq, float(info["best_cost"]))
    return out


def _rank_all(mesh, urdf, seconds):
    """Everything one rank runs, in one spawn; ``seconds``: by policy, the
    unsharded run's (checkpoint after the first iteration, second
    rollout's batch)."""
    out = {"plans": _plans(mesh, urdf), "rank": mesh.rank}
    for policy, recurrent in (("ff", False), ("lstm", True)):
        ckpt, batch = seconds[policy]
        out[policy] = {"run": _two_iterations(mesh, recurrent),
                       "update": _update(mesh, recurrent, ckpt, batch)}
    return out


@pytest.fixture(scope="module")
def hopper_urdf(tmp_path_factory):
    path = tmp_path_factory.mktemp("sharding") / "hopper.urdf"
    path.write_text(HOPPER)
    return str(path)


@pytest.fixture(scope="module")
def unsharded(hopper_urdf, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ckpt")
    out = {"plans": _plans(None, hopper_urdf)}
    for policy, recurrent in (("ff", False), ("lstm", True)):
        ckpt = str(tmp / f"{policy}.ckpt")
        out[policy] = dict(_two_iterations(None, recurrent, ckpt),
                           ckpt=ckpt)
    return out


@pytest.fixture(scope="module")
def sharded(hopper_urdf, unsharded):
    seconds = {k: (unsharded[k]["ckpt"], unsharded[k]["batch"])
               for k in ("ff", "lstm")}
    return run_ranks(_rank_all, WORLD, backend="gloo", device="cpu",
                     timeout_s=JOIN_S, args=(hopper_urdf, seconds))


def _finite(m):
    flat = [v for v in m.values() if isinstance(v, float)]
    return all(np.isfinite(flat + list(m["episode"].values())))


# --------------------------------------------------------------- tests

@pytest.mark.parametrize("policy", ["ff", "lstm"])
def test_sharded_rollout_matches_unsharded(policy, sharded, unsharded):
    ref = unsharded[policy]["rollout"]
    for r in sharded:
        mine = batch_envs(ref, slice(r["rank"] * NUM_ENVS // WORLD,
                                     (r["rank"] + 1) * NUM_ENVS // WORLD))
        got = r[policy]["run"]["rollout"]
        for k in ("obs", "action", "logp", "mean", "value", "reward",
                  "last_value"):
            torch.testing.assert_close(got[k], mine[k], atol=ROLLOUT_ATOL,
                                       rtol=0, msg=k)
        for k in ("done", "time_out", "ep_count", "ep_len_sum"):
            assert torch.equal(got[k], mine[k]), k
        for k, v in mine["ep_sums"].items():
            torch.testing.assert_close(got["ep_sums"][k], v,
                                       atol=ROLLOUT_ATOL, rtol=0, msg=k)


@pytest.mark.parametrize("policy", ["ff", "lstm"])
def test_sharded_update_matches_unsharded(policy, sharded, unsharded):
    ref = unsharded[policy]
    for r in sharded:
        m = r[policy]["update"]["metrics"]
        assert _finite(m), m
        loss, ref_loss = m["loss"], ref["metrics"]["loss"]
        assert abs(loss - ref_loss) < LOSS_RTOL * max(1.0, abs(ref_loss)), \
            (loss, ref_loss)
        err = max(float((a - b).abs().max())
                  for a, b in zip(r[policy]["update"]["params"],
                                  ref["params"]))
        assert err < PARAM_ATOL, f"sharded-vs-unsharded param drift {err}"
        assert r[policy]["update"]["lr"] == ref["lr"]
        # the global metrics: sums over every rank's envs
        for k in ("episode_count", "mean_episode_length", "terrain_level",
                  "max_command_x", "mean_step_reward", "kl", "kl_max",
                  "surrogate_loss", "value_loss"):
            assert m[k] == pytest.approx(ref["metrics"][k], rel=1e-4,
                                         abs=1e-6), k
    # the replicated state is equal on every rank, to the bit
    for a, b in zip(sharded[0][policy]["update"]["params"],
                    sharded[1][policy]["update"]["params"]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("policy", ["ff", "lstm"])
def test_sharded_training_run(policy, sharded, unsharded):
    """Two whole iterations: the loss as the JAX package's test holds it,
    the replicated state equal on the ranks; the drift is printed."""
    ref = unsharded[policy]
    runs = [r[policy]["run"] for r in sharded]
    for run in runs:
        m = run["metrics"]
        assert _finite(m), m
        assert abs(m["loss"] - ref["metrics"]["loss"]) < LOSS_RTOL * max(
            1.0, abs(ref["metrics"]["loss"])), (m["loss"], ref["metrics"])
    for a, b in zip(runs[0]["params"], runs[1]["params"]):
        assert torch.equal(a, b)
    drift = max(float((a - b).abs().max())
                for a, b in zip(runs[0]["params"], ref["params"]))
    print(f"{policy}, 2 iterations, 2 ranks vs unsharded: max parameter "
          f"drift {drift:.3e}, loss {runs[0]['metrics']['loss']:.7f} vs "
          f"{ref['metrics']['loss']:.7f}")


@pytest.mark.parametrize("method", ["mppi", "cem"])
def test_sharded_planner_matches_unsharded(method, sharded, unsharded):
    seq_ref, best_ref = unsharded["plans"][method]
    for r in sharded:
        seq, best = r["plans"][method]
        torch.testing.assert_close(seq, seq_ref, rtol=PLAN_RTOL,
                                   atol=PLAN_ATOL)
        assert best == pytest.approx(best_ref, rel=PLAN_RTOL, abs=PLAN_ATOL)
    assert torch.equal(sharded[0]["plans"][method][0],
                       sharded[1]["plans"][method][0])


def _fake_mesh(rank=0, world=WORLD):
    """An EnvMesh with no process group: enough for what needs no
    collective."""
    return EnvMesh(rank=rank, world_size=world, device=torch.device("cpu"))


def test_planner_checks_the_world_size(hopper_urdf):
    env = LeggedEnv(_hopper_cfg(hopper_urdf), device="cpu")
    with pytest.raises(ValueError, match="divisible by the world size 3"):
        SamplingMPC(env, MPCConfig(num_samples=32), mesh=_fake_mesh(0, 3))
    with pytest.raises(ValueError, match="1-D env split"):
        SamplingMPC(env, MPCConfig(num_samples=32), mesh=object())
    SamplingMPC(env, MPCConfig(num_samples=32), mesh=_fake_mesh(1, 4))


def test_env_slices_and_shard_helpers():
    mesh = _fake_mesh(rank=1)
    assert mesh.env_slice(16) == slice(8, 16)
    with pytest.raises(ValueError, match="do not divide"):
        mesh.env_slice(15)

    @dataclasses.dataclass(frozen=True)
    class State:
        pos: torch.Tensor
        common_step: int
        sums: dict

    state = State(pos=torch.arange(48.0).reshape(3, 16), common_step=5,
                  sums={"a": torch.arange(16.0), "range": torch.ones(2)})
    part = shard_env_state(state, mesh, 16)
    assert torch.equal(part.pos, state.pos[:, 8:]) and part.pos.is_contiguous()
    assert part.common_step == 5
    assert torch.equal(part.sums["a"], torch.arange(8.0, 16.0))
    assert torch.equal(part.sums["range"], torch.ones(2))
    obs = torch.arange(32.0).reshape(16, 2)
    assert torch.equal(shard_batch((obs, obs[:, 0]), mesh)[1],
                       obs[8:, 0])
    # without a mesh one process holds every env: the input itself
    assert shard_env_state(state, None, 16) is state
    assert shard_batch(obs, None) is obs
    assert all_sum(obs, None) is obs


def _fails_on_rank_1(mesh):
    if mesh.rank == 1:
        raise ValueError("rank 1 breaks on purpose")
    mesh.all_sum(torch.ones(1))      # rank 0 waits here for rank 1
    return "unreachable"


def test_run_ranks_reports_a_failing_rank():
    with pytest.raises(RuntimeError,
                       match="rank 1 of 2 failed(.|\n)*breaks on purpose"):
        run_ranks(_fails_on_rank_1, WORLD, backend="gloo", device="cpu",
                  timeout_s=JOIN_S)


def test_bench_scaling_on_cpu_ranks(capsys):
    from legged_gym_tpu_torch.scripts import bench_scaling

    out = bench_scaling.run(NUM_ENVS, [1, 2], steps=2, device="cpu",
                            timeout_s=JOIN_S)
    lines = [json.loads(line) for line in
             capsys.readouterr().out.strip().splitlines()]
    assert [line["ranks"] for line in lines] == [1, 2]
    for line in lines:
        assert line["backend"] == "gloo" and line["device"] == "cpu"
        assert line["env_steps_per_s"] > 0
        assert line["sharding_speedup_vs_unsharded"] > 0
    assert out[1]["sharding_speedup_vs_unsharded"] == 1.0


def test_shard_flag_needs_torchrun(monkeypatch):
    from legged_gym_tpu_torch.scripts import train
    from legged_gym_tpu_torch.utils import helpers

    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    args = helpers.get_args(["--task", "go1", "--shard", "--device", "cpu"])
    with pytest.raises(RuntimeError, match="torchrun"):
        train.train(args)
