"""The PyTorch port's PPO (rl/ppo.py, rl/runner.py, scripts/train.py)
against the JAX package, on the CPU.

The whole-iteration comparison runs one ``learn_iteration`` of each
package on a stub env written twice (jnp and torch) with deterministic
resets. Weights and Adam state are carried across by ``interop``; the JAX
side's random draws are replayed into the port: the test repeats the key
chain of ``legged_gym_tpu/rl/ppo.py`` (split into roll / perm keys, one
split per policy step, ``jax.random.normal`` for the action noise,
``jax.random.permutation`` for the minibatches) and injects the numbers.
"""
import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from legged_gym_tpu.config import AlgorithmCfg as JaxAlgorithmCfg
from legged_gym_tpu.config import PolicyCfg as JaxPolicyCfg
from legged_gym_tpu.envs.legged_env import Transition as JaxTransition
from legged_gym_tpu.rl import networks as jax_nets
from legged_gym_tpu.rl import ppo as jax_ppo
from legged_gym_tpu_torch import interop, registry
from legged_gym_tpu_torch.config import AlgorithmCfg, PolicyCfg
from legged_gym_tpu_torch.envs.legged_env import Transition
from legged_gym_tpu_torch.rl import networks as nets
from legged_gym_tpu_torch.rl import ppo
from legged_gym_tpu_torch.rl.runner import PPORunner, fetch_metrics
from legged_gym_tpu_torch.utils import helpers

# one intra-op thread: the tensors are a few envs wide and the test
# workers share the cores (more threads only spin and slow them)
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_ENVS, T_STEPS, MAX_LEN = 16, 16, 10


# ------------------------------------------------- the stub env, twice

class JaxPointEnv:
    """1-D point mass: obs = (pos, 1), the action pushes it, reward =
    -pos^2. Episodes time out after MAX_LEN steps or terminate when
    |pos| > 1.2; a finished env restarts at 0.3 sin(7 pos) — no random
    draw, so both packages see the same env."""
    num_envs, num_actions, obs_dim = N_ENVS, 1, 2

    @staticmethod
    def obs_of(pos):
        return jnp.stack([pos, jnp.ones_like(pos)], axis=-1)

    def step(self, state, actions):
        pos = state["pos"] + 0.1 * jnp.tanh(actions[:, 0])
        t = state["t"] + 1
        reward = -jnp.square(pos)
        ep_sum = state["ep_sum"] + reward
        time_out = t >= MAX_LEN
        done = time_out | (jnp.abs(pos) > 1.2)
        donef = done.astype(jnp.float32)
        tr = JaxTransition(
            obs=self.obs_of(jnp.where(done, 0.3 * jnp.sin(7.0 * pos), pos)),
            privileged_obs=None, reward=reward, done=done,
            time_out=time_out,
            episode_sums={"neg_sq": jnp.sum(ep_sum * donef)},
            episode_count=jnp.sum(donef),
            episode_length_sum=jnp.sum(t * done).astype(jnp.float32),
            terrain_level_mean=jnp.mean(pos), max_command_x=jnp.max(pos),
            torques=jnp.zeros((1, N_ENVS)),
            feet_contact_z=jnp.zeros((0, N_ENVS)))
        new = {"pos": jnp.where(done, 0.3 * jnp.sin(7.0 * pos), pos),
               "t": jnp.where(done, 0, t),
               "ep_sum": ep_sum * (1.0 - donef)}
        return new, tr


class TorchPointEnv:
    num_envs, num_actions, obs_dim = N_ENVS, 1, 2

    @staticmethod
    def obs_of(pos):
        return torch.stack([pos, torch.ones_like(pos)], dim=-1)

    def step(self, state, actions):
        pos = state["pos"] + 0.1 * torch.tanh(actions[:, 0])
        t = state["t"] + 1
        reward = -torch.square(pos)
        ep_sum = state["ep_sum"] + reward
        time_out = t >= MAX_LEN
        done = time_out | (torch.abs(pos) > 1.2)
        donef = done.to(torch.float32)
        new_pos = torch.where(done, 0.3 * torch.sin(7.0 * pos), pos)
        tr = Transition(
            obs=self.obs_of(new_pos), reward=reward, done=done,
            time_out=time_out,
            episode_sums={"neg_sq": torch.sum(ep_sum * donef)},
            episode_count=torch.sum(donef),
            episode_length_sum=torch.sum(t * done).to(torch.float32),
            terrain_level_mean=torch.mean(pos), max_command_x=torch.max(pos),
            torques=torch.zeros((1, N_ENVS)),
            feet_contact_z=torch.zeros((0, N_ENVS)))
        new = {"pos": new_pos, "t": torch.where(done, 0, t),
               "ep_sum": ep_sum * (1.0 - donef)}
        return new, tr


def _initial_state(seed=0):
    rng = np.random.default_rng(seed)
    return {"pos": rng.normal(0.0, 0.6, N_ENVS).astype(np.float32),
            "t": rng.integers(0, MAX_LEN, N_ENVS).astype(np.int32),
            "ep_sum": np.zeros(N_ENVS, np.float32)}


def _np_tree(x):
    return jax.tree.map(np.asarray, x)


def _jax_draws(key, n_steps, tn):
    """The draws ``learn_iteration`` of the JAX package makes from
    ``TrainState.key``: (noise (T, N, A), permutation (tn,))."""
    _, k_roll, k_perm = jax.random.split(key, 3)
    noise = []
    k = k_roll
    for _ in range(n_steps):
        k, k_act = jax.random.split(k)
        noise.append(np.asarray(jax.random.normal(
            k_act, (N_ENVS, 1), jnp.float32)))
    return np.stack(noise), np.asarray(jax.random.permutation(k_perm, tn))


def _one_iteration_each(alg_kw, pol_kw=None):
    """One learn_iteration of each package from the same weights, Adam
    state, env state and random draws."""
    pol_kw = pol_kw or dict(actor_hidden_dims=[32, 32],
                            critic_hidden_dims=[32, 32])
    jpol, jalg = JaxPolicyCfg(**pol_kw), JaxAlgorithmCfg(**alg_kw)
    tpol, talg = PolicyCfg(**pol_kw), AlgorithmCfg(**alg_kw)
    assert dataclasses.asdict(jalg) == dataclasses.asdict(talg)
    jts = jax_ppo.init_train_state(jax.random.PRNGKey(0), 2, 1, jpol, jalg)
    # make the Adam state non-trivial: one earlier step's worth of moments
    rng = np.random.default_rng(5)
    fake = jax.tree.map(lambda p: jnp.asarray(
        rng.normal(0.0, 0.02, p.shape).astype(np.float32)), jts.params)
    _, opt_state = jax_ppo.make_optimizer(jalg).update(
        fake, jts.opt_state, jts.params)
    jts = dataclasses.replace(jts, opt_state=opt_state)
    tts = interop.train_state_from_jax(
        _np_tree(jts.params), _np_tree(jts.opt_state), np.asarray(jts.lr))
    assert tts.opt_state.count == 1

    s0 = _initial_state()
    jstate = {k: jnp.asarray(v) for k, v in s0.items()}
    tstate = {k: torch.as_tensor(v.copy()) for k, v in s0.items()}
    noise, perm = _jax_draws(jts.key, T_STEPS, T_STEPS * N_ENVS)

    jlearn = jax.jit(jax_ppo.make_learn_fn(JaxPointEnv(), jpol, jalg,
                                           T_STEPS))
    jts2, jstate2, jobs2, jm = jlearn(jts, jstate,
                                      JaxPointEnv.obs_of(jstate["pos"]))
    tlearn = ppo.make_learn_fn(TorchPointEnv(), tpol, talg, T_STEPS)
    tts2, tstate2, tobs2, tm = tlearn(
        tts, tstate, TorchPointEnv.obs_of(tstate["pos"]),
        noise=torch.as_tensor(noise), perm=torch.as_tensor(perm.copy()))
    assert tts2 is tts
    np.testing.assert_allclose(np.asarray(jobs2), tobs2.numpy(), atol=1e-5)
    np.testing.assert_array_equal(np.asarray(jstate2["t"]),
                                  tstate2["t"].numpy())
    return jts2, _np_tree(jm), tts2, fetch_metrics(tm)


SCALARS = ("loss", "surrogate_loss", "value_loss", "kl", "kl_max",
           "noise_std", "mean_step_reward", "mean_episode_length")


def _compare_metrics(jm, tm, rtol, atol):
    assert set(jm) == set(tm) and set(jm["episode"]) == set(tm["episode"])
    for name in SCALARS:
        np.testing.assert_allclose(tm[name], float(jm[name]), rtol=rtol,
                                   atol=atol, err_msg=name)
    assert tm["episode_count"] == float(jm["episode_count"]) > 0
    for name in ("terrain_level", "max_command_x"):
        np.testing.assert_allclose(tm[name], float(jm[name]), rtol=1e-5,
                                   atol=1e-6, err_msg=name)
    np.testing.assert_allclose(tm["episode"]["neg_sq"],
                               float(jm["episode"]["neg_sq"]), rtol=1e-5)


def _max_weight_diff(jts, tts):
    want = interop.param_list_from_jax(tts.model, _np_tree(jts.params))
    return max(float((w - p.detach()).abs().max())
               for w, p in zip(want, tts.model.parameters()))


# ------------------------------------------------------------- the tests

def test_entropy_and_kl_match_jax():
    rng = np.random.default_rng(0)
    mu_o, mu_n = rng.normal(size=(2, 64, 12)).astype(np.float32)
    std_o, std_n = rng.uniform(0.2, 1.5, (2, 64, 12)).astype(np.float32)
    np.testing.assert_allclose(
        np.asarray(jax_nets.gaussian_entropy(jnp.asarray(std_n))),
        nets.gaussian_entropy(torch.as_tensor(std_n)).numpy(), rtol=1e-6)
    np.testing.assert_allclose(
        np.asarray(jax_nets.gaussian_kl(*map(jnp.asarray,
                                             (mu_o, std_o, mu_n, std_n)))),
        nets.gaussian_kl(*map(torch.as_tensor,
                              (mu_o, std_o, mu_n, std_n))).numpy(),
        rtol=1e-5, atol=1e-6)
    # the 1e-5 inside the log: KL of a distribution with itself is not 0
    same = nets.gaussian_kl(*map(torch.as_tensor,
                                 (mu_o, std_o, mu_o, std_o)))
    np.testing.assert_allclose(same.numpy(), 12 * np.log1p(1e-5), rtol=2e-2)
    x = rng.normal(size=(64, 12)).astype(np.float32)
    np.testing.assert_allclose(
        np.asarray(jax_nets.gaussian_log_prob(*map(jnp.asarray,
                                                   (x, mu_n, std_n)))),
        nets.gaussian_log_prob(*map(torch.as_tensor,
                                    (x, mu_n, std_n))).numpy(), rtol=1e-5)


def test_gae_and_timeout_bootstrap():
    gamma, lam = 0.99, 0.95
    rng = np.random.default_rng(0)
    T, N = 8, 4
    rewards = rng.normal(size=(T, N)).astype(np.float32)
    values = rng.normal(size=(T, N)).astype(np.float32)
    dones = (rng.random((T, N)) < 0.2).astype(np.float32)
    last_value = rng.normal(size=N).astype(np.float32)

    def gae_step(carry, xs):
        adv_next, v_next = carry
        r, v, nd = xs
        delta = r + gamma * v_next * nd - v
        adv = delta + gamma * lam * nd * adv_next
        return (adv, v), adv

    _, want = jax.lax.scan(
        gae_step, (jnp.zeros(N), jnp.asarray(last_value)),
        (jnp.asarray(rewards), jnp.asarray(values),
         jnp.asarray(1.0 - dones)), reverse=True)
    got = ppo.compute_gae(torch.as_tensor(rewards), torch.as_tensor(values),
                          torch.as_tensor(1.0 - dones),
                          torch.as_tensor(last_value), gamma, lam)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    # timeout bootstrap: gamma * V(state before the step) on time_out steps
    time_out = np.zeros((T, N), bool)
    time_out[1, 0] = time_out[5, 3] = True
    boot = ppo.bootstrap_timeouts(torch.as_tensor(rewards),
                                  torch.as_tensor(values),
                                  torch.as_tensor(time_out), gamma).numpy()
    np.testing.assert_allclose(boot, rewards + gamma * values * time_out,
                               rtol=1e-6)
    assert boot[1, 0] != rewards[1, 0] and boot[0, 0] == rewards[0, 0]


def test_optimizer_matches_optax_chain():
    """clip_by_global_norm (scale only at or above the threshold) then
    bias-corrected Adam, three steps, below and above the threshold."""
    rng = np.random.default_rng(1)
    shapes = [(5, 3), (3,), (4, 5), (1,)]
    alg = AlgorithmCfg(max_grad_norm=1.0)
    tx = jax_ppo.make_optimizer(alg)
    jparams = [jnp.zeros(s) for s in shapes]
    jstate = tx.init(jparams)
    topt = ppo.make_optimizer(alg)
    tstate = topt.init([torch.zeros(s) for s in shapes])
    for scale, clipped in ((0.01, False), (3.0, True), (0.05, False)):
        grads = [(scale * rng.normal(size=s)).astype(np.float32)
                 for s in shapes]
        norm = np.sqrt(sum((g ** 2).sum() for g in grads))
        assert (norm >= 1.0) == clipped
        ju, jstate = tx.update([jnp.asarray(g) for g in grads], jstate,
                               jparams)
        tu = topt.update([torch.as_tensor(g.copy()) for g in grads], tstate)
        for a, b in zip(ju, tu):
            np.testing.assert_allclose(np.asarray(a), b.numpy(), rtol=2e-5,
                                       atol=1e-6)
    assert tstate.count == 3 == int(jstate[1].count)
    assert isinstance(jstate[1], optax.ScaleByAdamState)


def test_one_minibatch_step_matches_jax():
    """One epoch x one minibatch = one optimizer step: weights at atol
    1e-6, the lr equal, the metrics at rtol 1e-4."""
    jts, jm, tts, tm = _one_iteration_each(
        dict(num_learning_epochs=1, num_mini_batches=1))
    assert tts.opt_state.count == 2
    assert _max_weight_diff(jts, tts) <= 1e-6
    assert float(tts.lr) == float(jts.lr)
    assert tm["lr"] == float(jm["lr"])
    _compare_metrics(jm, tm, rtol=1e-4, atol=1e-7)
    # Adam moments too
    adam = _np_tree(jts.opt_state)[1]
    for want, got in zip(interop.param_list_from_jax(tts.model, adam.mu),
                         tts.opt_state.mu):
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-7)


def test_learn_iteration_matches_jax():
    """A whole iteration (16 steps, 5 epochs x 4 minibatches = 20 optimizer
    steps on one shared permutation). The eight scalar metrics at rtol
    1e-4 and the lr after the iteration equal. Weights after all 20 steps
    at atol 2e-6: the two packages sum minibatch means and matrix products
    in another order, and Adam's u = m / (sqrt(v) + eps) turns a float32
    rounding of a small gradient into a relative error of the step;
    measured 1.2e-7 after 20 steps (1.5e-8 after one), and 2e-6 is 0.2% of
    one Adam step at this lr (1e-3)."""
    jts, jm, tts, tm = _one_iteration_each({})
    assert tts.opt_state.count == 21 == int(_np_tree(jts.opt_state)[1].count)
    _compare_metrics(jm, tm, rtol=1e-4, atol=1e-7)
    assert float(tts.lr) == float(jts.lr)
    assert 1e-5 <= float(tts.lr) <= 1e-2
    assert float(tts.lr) != AlgorithmCfg().learning_rate   # it adapted
    assert _max_weight_diff(jts, tts) <= 2e-6


def test_ppo_learns_point_env():
    """The port's own draws: reward on the point env improves."""
    env = TorchPointEnv()
    pol = PolicyCfg(actor_hidden_dims=[32, 32], critic_hidden_dims=[32, 32])
    alg = AlgorithmCfg(num_mini_batches=2, learning_rate=1e-3)
    ts = ppo.init_train_state(0, env.obs_dim, env.num_actions, pol, alg,
                              device="cpu")
    learn = ppo.make_learn_fn(env, pol, alg, num_steps=16)
    state = {k: torch.as_tensor(v) for k, v in _initial_state(1).items()}
    obs = env.obs_of(state["pos"])
    rewards = []
    for _ in range(40):
        ts, state, obs, metrics = learn(ts, state, obs)
        rewards.append(float(metrics["mean_step_reward"]))
    assert np.isfinite(rewards).all()
    assert np.mean(rewards[-5:]) > np.mean(rewards[:5]), rewards
    assert 1e-5 <= float(metrics["lr"]) <= 1e-2
    # two states from one seed start from the same weights, device or not
    ts2 = ppo.init_train_state(0, env.obs_dim, env.num_actions, pol, alg,
                               device="cpu")
    ts3 = ppo.init_train_state(0, env.obs_dim, env.num_actions, pol, alg,
                               device="cpu")
    for a, b in zip(ts2.params, ts3.params):
        assert torch.equal(a, b)


def test_recurrent_and_asymmetric_configs_build():
    """The recurrent policy and the asymmetric critic build where the
    port raised before they were ported; rnn_type other than lstm still
    raises, as in the JAX package."""
    pol = PolicyCfg(actor_hidden_dims=[8], critic_hidden_dims=[8],
                    rnn_type="lstm", rnn_hidden_size=4)
    alg = AlgorithmCfg()
    ts = ppo.init_train_state(0, 2, 1, pol, alg, device="cpu")
    assert isinstance(ts.model, nets.ActorCriticRecurrent)
    ppo.make_learn_fn(TorchPointEnv(), pol, alg, 4)
    ts = ppo.init_train_state(0, 2, 1, PolicyCfg(), alg, critic_obs_dim=5,
                              device="cpu")
    assert ts.model.critic[0].in_features == 5
    assert ts.model.actor[0].in_features == 2

    class AsymEnv(TorchPointEnv):
        num_privileged_obs = 5

    ppo.make_learn_fn(AsymEnv(), PolicyCfg(), alg, 4)
    with pytest.raises(NotImplementedError):
        nets.ActorCritic.from_cfg(2, 1, PolicyCfg(rnn_type="gru"))
    with pytest.raises(NotImplementedError):
        ppo.init_train_state(0, 2, 1, PolicyCfg(rnn_type="gru"), alg,
                             device="cpu")


# ------------------------------------------------- runner, registry, CLI

@pytest.fixture(scope="module")
def go1_env():
    cfg, _ = registry.get_cfgs("go1")
    cfg.env.num_envs = 8
    env, _ = registry.make_env(cfg=cfg, device="cpu")
    return env


def _small_train_cfg():
    _, tcfg = registry.get_cfgs("go1")
    tcfg.policy.actor_hidden_dims = [32, 16]
    tcfg.policy.critic_hidden_dims = [32, 16]
    tcfg.runner.num_steps_per_env = 4
    return tcfg


def test_save_load_round_trip(go1_env, tmp_path):
    runner = PPORunner(go1_env, _small_train_cfg(), log_dir=None, seed=3)
    runner.learn(2, init_at_random_ep_len=True)
    assert int(runner.env_state.episode_length.max()) > 8   # randomized
    path = str(tmp_path / "model_2.ckpt")
    runner.save(path)
    ts = runner.train_state
    want = [p.detach().clone() for p in ts.params]
    want_mu = [m.clone() for m in ts.opt_state.mu]
    want_nu = [m.clone() for m in ts.opt_state.nu]
    want_lr, want_count = float(ts.lr), ts.opt_state.count
    want_draw = torch.randn(4, generator=ts.noise_generator)

    other = PPORunner(go1_env, _small_train_cfg(), log_dir=None, seed=9)
    assert not torch.equal(other.train_state.params[1], want[1])
    other.load(path)
    ts2 = other.train_state
    assert other.current_iteration == 2
    assert ts2.opt_state.count == want_count == 2 * 20
    assert float(ts2.lr) == want_lr
    for a, b in zip(ts2.params, want):
        assert torch.equal(a.detach(), b)
    for a, b in zip(ts2.opt_state.mu + ts2.opt_state.nu, want_mu + want_nu):
        assert torch.equal(a, b)
    assert torch.equal(torch.randn(4, generator=ts2.noise_generator),
                       want_draw)
    # the loaded runner goes on training; the inference policy is the actor
    other.learn(1)
    assert other.current_iteration == 3
    obs = torch.zeros((8, go1_env.obs_dim))
    act = other.get_inference_policy()(obs)
    assert tuple(act.shape) == (8, go1_env.num_actions)
    assert not act.requires_grad


def test_make_runner_run_dir_and_resume(go1_env, tmp_path):
    """registry.make_runner: logs/<stamp>_<run_name>/ with metrics.jsonl in
    the JAX package's layout, config.json and model_<it>.ckpt; --resume
    picks the last run's last checkpoint."""
    tcfg = _small_train_cfg()
    tcfg.runner.run_name = "unit"
    tcfg.runner.save_interval = 2
    runner, _ = registry.make_runner(go1_env, train_cfg=tcfg,
                                     log_root=str(tmp_path))
    runner.learn(3)
    run_dir = runner.log_dir
    assert os.path.dirname(run_dir) == str(tmp_path)
    assert run_dir.endswith("_unit")
    files = set(os.listdir(run_dir))
    assert {"metrics.jsonl", "config.json", "model_2.ckpt",
            "model_3.ckpt"} <= files
    rows = [json.loads(line) for line in
            open(os.path.join(run_dir, "metrics.jsonl"))]
    assert [r["iteration"] for r in rows] == [0, 1, 2]
    with open(os.path.join(REPO, "docs", "runs", "go1_flat_1800",
                           "metrics.jsonl")) as fh:
        jax_row = json.loads(fh.readline())
    assert set(rows[0]) == set(jax_row)
    assert set(rows[0]["episode"]) == set(jax_row["episode"])
    assert all(np.isfinite(v) for r in rows for v in r.values()
               if isinstance(v, float))
    snap = json.load(open(os.path.join(run_dir, "config.json")))
    assert snap["env_cfg"]["env"]["num_envs"] == 8

    args = helpers.get_args(["--resume", "--device", "cpu"])
    tcfg2 = _small_train_cfg()
    resumed, tcfg2 = registry.make_runner(go1_env, train_cfg=tcfg2,
                                          args=args, log_root=str(tmp_path))
    assert tcfg2.runner.resume and resumed.current_iteration == 3
    for a, b in zip(resumed.train_state.params, runner.train_state.params):
        assert torch.equal(a.detach(), b.detach())
    assert helpers.get_load_path(str(tmp_path), checkpoint=2).endswith(
        "model_2.ckpt")
    with pytest.raises(ValueError):
        helpers.get_load_path(str(tmp_path / "nothing"))


def test_get_args_flags():
    a = helpers.get_args([])
    assert a.device == "cuda" and a.task == "go1"
    for flag in ("shard", "multihost", "coordinator_address",
                 "num_processes", "process_id"):
        assert not hasattr(a, flag)
    a = helpers.get_args(["--task", "aliengo", "--num_envs", "64", "--seed",
                          "7", "--max_iterations", "5", "--headless",
                          "--experiment_name", "e", "--run_name", "r",
                          "--load_run", "x", "--checkpoint", "4"])
    cfg, tcfg = registry.get_cfgs("aliengo")
    cfg, tcfg = helpers.update_cfg_from_args(cfg, tcfg, a)
    assert cfg.env.num_envs == 64 and tcfg.seed == 7
    assert tcfg.runner.max_iterations == 5
    assert (tcfg.runner.experiment_name, tcfg.runner.run_name,
            tcfg.runner.load_run, tcfg.runner.checkpoint) == ("e", "r", "x",
                                                              4)
    assert registry.task_names() == [
        "anymal_c_rough", "anymal_c_flat", "anymal_b", "a1", "cassie",
        "a1_src", "go1", "aliengo"]


def _run_train(argv, cwd=None):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    # one intra-op thread: the tensors are tiny, and the test workers
    # already share the cores
    env["OMP_NUM_THREADS"] = "1"
    return subprocess.run(
        [sys.executable, "-m", "legged_gym_tpu_torch.scripts.train"] + argv,
        capture_output=True, text=True, env=env, timeout=300, cwd=cwd)


def test_train_cli_help_exits_zero():
    r = _run_train(["--help"])
    assert r.returncode == 0, r.stderr[-2000:]
    assert "--task" in r.stdout and "--device" in r.stdout
    assert "--shard" not in r.stdout


@pytest.mark.parametrize("task", ["go1", "aliengo"])
def test_train_cli_two_iterations_on_cpu(task, monkeypatch):
    """scripts.train's main end to end on the CPU, in this process: two
    iterations at 8 envs of the task's config with a 4-step horizon, the
    metrics it logged finite, the last checkpoint written."""
    from legged_gym_tpu_torch.scripts import train as train_script

    get_cfgs = registry.get_cfgs

    def short_horizon(name):
        env_cfg, train_cfg = get_cfgs(name)
        train_cfg.runner.num_steps_per_env = 4
        return env_cfg, train_cfg

    monkeypatch.setattr(registry, "get_cfgs", short_horizon)
    exp = f"pytest_{task}_{os.getpid()}"
    monkeypatch.setattr(sys, "argv", [
        "train", "--task", task, "--num_envs", "8", "--device", "cpu",
        "--max_iterations", "2", "--experiment_name", exp, "--run_name",
        "cli", "--headless"])
    train_script.main()
    root = os.path.join(helpers.LOG_ROOT, exp)
    try:
        runs = os.listdir(root)
        assert len(runs) == 1 and runs[0].endswith("_cli")
        run_dir = os.path.join(root, runs[0])
        rows = [json.loads(line) for line in
                open(os.path.join(run_dir, "metrics.jsonl"))]
        assert [r_["iteration"] for r_ in rows] == [0, 1]
        for row in rows:
            flat = [v for v in row.values() if isinstance(v, float)]
            flat += list(row["episode"].values())
            assert np.isfinite(flat).all(), row
            assert np.float32(1e-5) <= np.float32(row["lr"]) <= 1e-2
        assert os.path.isfile(os.path.join(run_dir, "model_2.ckpt"))
    finally:
        import shutil
        shutil.rmtree(root, ignore_errors=True)
