"""The PyTorch port's evaluation path against the JAX package, on the CPU:
the policy export (PPORunner.export_policy), scripts.play end to end,
teleop's LeggedEnv.set_commands and the privileged observations, the
Logger and the trajectory renderer, and the two CLIs' ``--help``.
"""
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from legged_gym_tpu import registry as jax_registry
from legged_gym_tpu.config import TrainCfg as JaxTrainCfg
from legged_gym_tpu.model.robot import compile_model as jax_compile_model
from legged_gym_tpu.rl.runner import PPORunner as JaxPPORunner
from legged_gym_tpu.utils import render as jax_render
from legged_gym_tpu_torch import assets, interop, registry
from legged_gym_tpu_torch.config import TrainCfg
from legged_gym_tpu_torch.rl.runner import PPORunner
from legged_gym_tpu_torch.scripts import play as play_script
from legged_gym_tpu_torch.scripts import teleop as teleop_script
from legged_gym_tpu_torch.utils import helpers, render
from legged_gym_tpu_torch.utils.logger import Logger
from test_torch_general_env import _jax_state_from_torch

# one intra-op thread: the tensors are a few envs wide and the test
# workers share the cores
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GO1_PRIV = 48 + 2 + 12   # obs + (friction, base mass) + 3 x 4 feet forces


class StubEnv:
    """What a runner reads of an env before it steps."""
    obs_dim, num_actions, num_envs = 6, 3, 2
    num_privileged_obs = None
    device = "cpu"


def _train_cfg(cls, recurrent):
    tcfg = cls()
    tcfg.policy.actor_hidden_dims = [16, 8]
    tcfg.policy.critic_hidden_dims = [16, 8]
    if recurrent:
        tcfg.runner.policy_class_name = "ActorCriticRecurrent"
        tcfg.policy.rnn_hidden_size = 8
        tcfg.policy.rnn_num_layers = 2
    return tcfg


@pytest.mark.parametrize("recurrent", [False, True],
                         ids=["feed_forward", "lstm"])
def test_export_policy_matches_jax(recurrent, tmp_path):
    """The port's export of the JAX runner's weights (carried by interop)
    has the JAX export's key set and equal arrays: w{i} (in, out), b{i},
    activation, and lstm_w{i} / lstm_b{i} / rnn_hidden_size /
    rnn_num_layers for an LSTM actor."""
    jrunner = JaxPPORunner(StubEnv(), _train_cfg(JaxTrainCfg, recurrent))
    trunner = PPORunner(StubEnv(), _train_cfg(TrainCfg, recurrent))
    assert trunner.recurrent == jrunner.recurrent == recurrent
    trunner.train_state.model = interop.actor_critic_from_jax(
        jax.tree.map(np.asarray, jrunner.train_state.params))
    jpath = jrunner.export_policy(str(tmp_path / "jax" / "policy.npz"))
    tpath = trunner.export_policy(str(tmp_path / "torch" / "policy.npz"))
    with np.load(jpath) as jz, np.load(tpath) as tz:
        assert set(jz.files) == set(tz.files)
        assert ("lstm_w1" in tz.files) == recurrent
        for k in jz.files:
            assert jz[k].dtype == tz[k].dtype, k
            np.testing.assert_array_equal(jz[k], tz[k], err_msg=k)


def test_exported_policy_replays_the_inference_policy(tmp_path):
    """play.exported_policy, a plain numpy reader of the export, gives the
    stateful inference policy's actions within 1e-5 over three calls; both
    start again from a zero carry after reset_memory()."""
    runner = PPORunner(StubEnv(), _train_cfg(TrainCfg, recurrent=True))
    policy = runner.get_inference_policy()
    plain = play_script.exported_policy(
        runner.export_policy(str(tmp_path / "policy.npz")))
    obs = torch.as_tensor(np.random.default_rng(0).normal(
        size=(2, StubEnv.obs_dim)).astype(np.float32))
    first = policy(obs)
    for i in range(3):
        got = policy(obs) if i else first
        np.testing.assert_allclose(plain(obs.numpy()), got.numpy(),
                                   atol=1e-5)
    assert not torch.allclose(policy(obs), first)    # the carry moved
    policy.reset_memory()
    plain.reset_memory()
    assert torch.equal(policy(obs), first)
    np.testing.assert_allclose(plain(obs.numpy()), first.numpy(), atol=1e-5)


def _teleop_edits(cfg):
    """The JAX package's scripts/teleop.py:157-162 config edits."""
    cfg.env.num_envs = 1
    cfg.noise.add_noise = False
    cfg.domain_rand.push_robots = False
    cfg.commands.heading_command = False
    cfg.commands.resampling_time = 1e9
    return cfg


def test_teleop_cfg_is_the_jax_teleop_cfg():
    cfg, _ = teleop_script.teleop_cfg("go1")
    want = _teleop_edits(registry.get_cfgs("go1")[0])
    assert dataclasses.asdict(cfg) == dataclasses.asdict(want)


def _go1_priv_cfg(reg, priv=GO1_PRIV):
    """go1 as teleop drives it, but with 4 envs, observation noise on
    (the privileged half must stay noiseless) and the privileged
    observations of an asymmetric critic."""
    cfg = _teleop_edits(reg.get_cfgs("go1")[0])
    cfg.env.num_envs = 4
    cfg.noise.add_noise = True
    cfg.env.num_privileged_obs = priv
    return cfg


def test_set_commands_and_privileged_obs_match_jax():
    """From a state carried over from the port, set_commands(0.5, 0.0, 0.2)
    then one step with zero actions, the JAX env op by op: the commands
    still hold the set values after the step (resampling_time 1e9, no
    heading command), in both packages; the privileged observations (the
    noiseless obs, friction, base-mass scale, feet forces x 0.01) at
    5e-3, the env tests' obs tolerance."""
    jenv, _ = jax_registry.make_env(cfg=_go1_priv_cfg(jax_registry))
    tenv, _ = registry.make_env(cfg=_go1_priv_cfg(registry), device="cpu")
    assert tenv.num_privileged_obs == jenv.num_privileged_obs == GO1_PRIV
    state = tenv.initial_state()
    zeros = torch.zeros((4, tenv.num_actions))
    with torch.no_grad():
        for _ in range(5):
            state, _ = tenv.step(state, zeros)
    state_j = jenv.set_commands(_jax_state_from_torch(jenv, state),
                                0.5, 0.0, 0.2)
    state = tenv.set_commands(state, 0.5, 0.0, 0.2)
    np.testing.assert_array_equal(state.commands.numpy(),
                                  np.asarray(state_j.commands))
    with jax.disable_jit():
        s_j, tr_j = jenv.step(state_j, jnp.zeros((4, tenv.num_actions)))
    with torch.no_grad():
        s_t, tr_t = tenv.step(state, zeros)
    want = np.array([0.5, 0.0, 0.2], np.float32)[:, None]
    np.testing.assert_array_equal(s_t.commands[:3].numpy(),
                                  np.broadcast_to(want, (3, 4)))
    np.testing.assert_array_equal(np.asarray(s_j.commands[:3]),
                                  s_t.commands[:3].numpy())
    p_t, p_j = tr_t.privileged_obs.numpy(), np.asarray(tr_j.privileged_obs)
    assert p_t.shape == (4, GO1_PRIV)
    np.testing.assert_allclose(p_t, p_j, atol=5e-3)
    np.testing.assert_array_equal(p_t[:, 48], s_t.friction.numpy())
    np.testing.assert_array_equal(p_t[:, 49], s_t.mass_scales[0].numpy())
    # the feet's vertical forces, x 0.01, in the feet block (x, y, z) per
    # foot
    np.testing.assert_allclose(p_t[:, 50:].reshape(4, 3, 4)[:, 2].T,
                               0.01 * tr_t.feet_contact_z.numpy(), rtol=1e-6)
    # noise on: the actor's obs differ from the noiseless half by at most
    # the noise scale
    d = np.abs(p_t[:, :48] - tr_t.obs.numpy())
    assert 0 < d.max() <= float(np.max(tenv.noise_vec)) + 1e-6


def test_wrong_privileged_dim_raises():
    with pytest.raises(ValueError, match="privileged layout"):
        registry.make_env(cfg=_go1_priv_cfg(registry, priv=17), device="cpu")


def test_logger_and_render_trajectory(tmp_path, monkeypatch):
    """A 3-step go1 trajectory on heightfield: the Logger's state and reward
    logs and its dashboard (saved as a file without a display); the
    renderer's link positions against the JAX package's (its FK), its
    height-scan points on the terrain, and the GIF and PNG strip."""
    monkeypatch.setenv("MPLBACKEND", "Agg")
    monkeypatch.chdir(tmp_path)
    cfg, _ = registry.get_cfgs("go1")
    cfg.env.num_envs = 2
    cfg.env.num_observations = 235
    cfg.terrain.mesh_type = "heightfield"
    cfg.terrain.measure_heights = True
    cfg.terrain.num_rows = cfg.terrain.num_cols = 2
    env, _ = registry.make_env(cfg=cfg, device="cpu")
    logger = Logger(env.dt)
    frames = []
    with torch.no_grad():
        state, _ = env.reset()
        for _ in range(3):
            state, tr = env.step(state, torch.zeros((2, env.num_actions)))
            p = state.physics
            frames.append((p.pos.numpy(), p.quat.numpy(), p.q.numpy()))
            logger.log_states({"base_vel_x": float(p.vel[3, 0]),
                               "dof_pos": float(p.q[1, 0])})
            logger.log_rewards({"tracking": 0.5}, 2)
    assert len(logger.state_log["dof_pos"]) == 3
    assert logger.rew_log["rew_tracking"] == 3.0
    assert logger.num_episodes == 6
    logger.print_rewards()
    logger._plot()
    assert os.path.isfile(tmp_path / "play_states.png")

    pos, quat, q = render.stack_frames(frames)
    pw = render.link_positions(env.model, pos[:, 1], quat[:, 1], q[:, 1])
    jmodel = jax_compile_model(assets.resolve(cfg.asset.file),
                               collapse_fixed_joints=True,
                               armature=cfg.asset.armature)
    with jax.disable_jit():
        pw_j = jax_render.link_positions(jmodel, pos[:, 1], quat[:, 1],
                                         q[:, 1])
    assert pw.shape == (3, env.model.nl, 3)
    np.testing.assert_allclose(pw, pw_j, atol=1e-5)
    scan = render.scan_points_world(env, pos[:, 1], quat[:, 1])
    assert scan.shape == (3, env.num_height_points, 3)
    assert np.isfinite(scan).all()
    files = render.render_trajectory(env, frames, str(tmp_path / "r.gif"),
                                     env_index=1, stride=1, strip_every=1)
    assert files == [str(tmp_path / "r.gif"), str(tmp_path / "r_strip.png")]
    assert all(os.path.getsize(f) > 0 for f in files)


def test_play_end_to_end_on_cpu(tmp_path, monkeypatch):
    """scripts.play.play with --record on the CPU from a go1 checkpoint
    under a temporary log root: the export has the JAX key set and replays
    the inference policy, the rollout is finite, the recording is
    written, and the run's checkpoint was the one loaded."""
    monkeypatch.setenv("MPLBACKEND", "Agg")
    cfg, tcfg = registry.get_cfgs("go1")
    cfg.env.num_envs = 2
    env, _ = registry.make_env(cfg=cfg, device="cpu")
    runner = PPORunner(env, tcfg, seed=4)
    runner.current_iteration = 7
    root = str(tmp_path / tcfg.runner.experiment_name)
    runner.save(os.path.join(root, "run", "model_7.ckpt"))
    args = helpers.get_args(["--task", "go1", "--num_envs", "2",
                             "--device", "cpu", "--record",
                             "--record_steps", "2"])
    out = play_script.play(args, num_steps=3, log_root=root)
    assert out["runner"].current_iteration == 7
    for a, b in zip(out["runner"].train_state.params,
                    runner.train_state.params):
        assert torch.equal(a.detach(), b.detach())
    assert out["export"] == os.path.join(root, "exported", "policies",
                                         "policy.npz")
    with np.load(out["export"]) as z:
        assert set(z.files) == {"w0", "b0", "w1", "b1", "w2", "b2", "w3",
                                "b3", "activation"}
    obs = out["obs"]
    assert obs.shape == (2, env.obs_dim) and torch.isfinite(obs).all()
    np.testing.assert_allclose(
        play_script.exported_policy(out["export"])(obs.numpy()),
        out["policy"](obs).numpy(), atol=1e-5)
    exported = os.path.join(root, "exported")
    assert os.path.isfile(os.path.join(exported, "rollout.gif"))
    assert os.path.isfile(os.path.join(exported, "rollout_strip.png"))


@pytest.mark.parametrize("mod", ["legged_gym_tpu_torch.scripts.play",
                                 "legged_gym_tpu_torch.scripts.teleop"])
def test_cli_help_exits_zero(mod):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run([sys.executable, "-m", mod, "--help"],
                       capture_output=True, text=True, env=env, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "--task" in r.stdout and "--device" in r.stdout
    assert "not ported" not in r.stdout
