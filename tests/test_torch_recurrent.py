"""The PyTorch port's recurrent policy (LSTM memory) and asymmetric critic
(rl/networks.py, rl/ppo.py) against the JAX package, on the CPU.

The LSTM is held against the JAX ``lstm_apply`` and against
``torch.nn.LSTM``'s semantics. One whole recurrent + asymmetric
``learn_iteration`` runs in each package on the stub point env of
tests/test_torch_ppo.py, extended with privileged observations, from the
same weights, Adam state, LSTM carries and replayed random draws. The port
alone learns the memory-cue task of tests/test_ppo.py, which needs BPTT
through the whole window.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from legged_gym_tpu.config import AlgorithmCfg as JaxAlgorithmCfg
from legged_gym_tpu.config import PolicyCfg as JaxPolicyCfg
from legged_gym_tpu.rl import networks as jax_nets
from legged_gym_tpu.rl import ppo as jax_ppo
from legged_gym_tpu_torch import interop
from legged_gym_tpu_torch.config import AlgorithmCfg, PolicyCfg
from legged_gym_tpu_torch.envs.legged_env import Transition
from legged_gym_tpu_torch.rl import networks as nets
from legged_gym_tpu_torch.rl import ppo
from legged_gym_tpu_torch.rl.runner import fetch_metrics
from test_torch_ppo import (N_ENVS, T_STEPS, JaxPointEnv, TorchPointEnv,
                            _compare_metrics, _initial_state, _max_weight_diff,
                            _np_tree)

# one intra-op thread: the tensors are a few envs wide and the test
# workers share the cores
torch.set_num_threads(1)

HIDDEN, LAYERS = 8, 2
PRIV_DIM = 3


def _priv(pos, t):
    """Privileged observations of the point env: what the actor cannot
    see (pos^2 and the episode clock)."""
    return pos, pos * pos, t / 10.0


class JaxAsymPointEnv(JaxPointEnv):
    num_privileged_obs = PRIV_DIM

    def step(self, state, actions):
        new, tr = super().step(state, actions)
        priv = jnp.stack(_priv(new["pos"], new["t"].astype(jnp.float32)),
                         axis=-1)
        return new, dataclasses.replace(tr, privileged_obs=priv)


class TorchAsymPointEnv(TorchPointEnv):
    num_privileged_obs = PRIV_DIM

    def step(self, state, actions):
        new, tr = super().step(state, actions)
        priv = torch.stack(_priv(new["pos"], new["t"].to(torch.float32)),
                           dim=-1)
        return new, dataclasses.replace(tr, privileged_obs=priv)


# ------------------------------------------------------------- the LSTM

def test_lstm_matches_jax_and_torch_lstm():
    """One step of the port's 2-layer LSTM against the JAX lstm_apply (atol
    1e-6) and torch.nn.LSTM with the same weights (gate order i, f, g, o;
    carry (N, L, 2, h)), as tests/test_ppo.py:151 holds the JAX one."""
    rng = np.random.default_rng(0)
    in_dim, n = 5, 3
    x = rng.normal(size=(n, in_dim)).astype(np.float32)
    carry = rng.normal(size=(n, LAYERS, 2, HIDDEN)).astype(np.float32)
    lstm = nets.LSTM(in_dim, HIDDEN, LAYERS,
                     generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        for b in lstm.b:
            b.copy_(torch.as_tensor(rng.normal(size=b.shape)))
        out_t, carry_t = lstm(torch.as_tensor(x), torch.as_tensor(carry))
    params = [{"w": jnp.asarray(w.detach().numpy()),
               "b": jnp.asarray(b.detach().numpy())}
              for w, b in zip(lstm.w, lstm.b)]
    out_j, carry_j = jax_nets.lstm_apply(params, jnp.asarray(x),
                                         jnp.asarray(carry))
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=1e-6)
    np.testing.assert_allclose(carry_t.numpy(), np.asarray(carry_j),
                               atol=1e-6)

    ref = torch.nn.LSTM(in_dim, HIDDEN, num_layers=LAYERS)
    with torch.no_grad():
        for l, (w, b) in enumerate(zip(lstm.w, lstm.b)):
            d = in_dim if l == 0 else HIDDEN
            getattr(ref, f"weight_ih_l{l}").copy_(w[:d].T)
            getattr(ref, f"weight_hh_l{l}").copy_(w[d:].T)
            getattr(ref, f"bias_ih_l{l}").copy_(b)
            getattr(ref, f"bias_hh_l{l}").zero_()
        c = torch.as_tensor(carry)
        out_r, (h_r, c_r) = ref(torch.as_tensor(x)[None],
                                (c[:, :, 0].transpose(0, 1).contiguous(),
                                 c[:, :, 1].transpose(0, 1).contiguous()))
    np.testing.assert_allclose(out_t.numpy(), out_r[0].numpy(), atol=1e-6)
    np.testing.assert_allclose(carry_t[:, :, 0].transpose(0, 1).numpy(),
                               h_r.numpy(), atol=1e-6)
    np.testing.assert_allclose(carry_t[:, :, 1].transpose(0, 1).numpy(),
                               c_r.numpy(), atol=1e-6)


def test_recurrent_model_from_cfg():
    """ActorCritic.from_cfg builds the recurrent model from a PolicyCfg
    with rnn_type; its parameters cross to and from the JAX layout."""
    pol = PolicyCfg(actor_hidden_dims=[16], critic_hidden_dims=[16],
                    rnn_type="lstm", rnn_hidden_size=HIDDEN,
                    rnn_num_layers=LAYERS)
    model = nets.ActorCritic.from_cfg(
        4, 2, pol, generator=torch.Generator().manual_seed(0),
        critic_obs_dim=6)
    assert isinstance(model, nets.ActorCriticRecurrent)
    assert [tuple(w.shape) for w in model.memory_a.w] == [
        (4 + HIDDEN, 4 * HIDDEN), (2 * HIDDEN, 4 * HIDDEN)]
    assert tuple(model.memory_c.w[0].shape) == (6 + HIDDEN, 4 * HIDDEN)
    bound = 1.0 / np.sqrt(HIDDEN)
    assert all(float(w.detach().abs().max()) <= bound
               for w in model.memory_a.w)
    jparams = jax_nets.init_actor_critic(
        jax.random.PRNGKey(0), 4, 2,
        JaxPolicyCfg(**dataclasses.asdict(pol)), critic_obs_dim=6)
    back = interop.actor_critic_from_jax(_np_tree(jparams))
    assert isinstance(back, nets.ActorCriticRecurrent)
    assert [tuple(p.shape) for p in back.parameters()] == [
        tuple(p.shape) for p in model.parameters()]
    obs = torch.randn(3, 4)
    mem = nets.init_memory(3, pol)
    mean, _ = nets.actor_mean_rnn(back, obs, mem["a"])
    want, _ = jax_nets.actor_mean_rnn(jparams, jnp.asarray(obs.numpy()),
                                      jax.nn.elu, jnp.asarray(
                                          mem["a"].numpy()))
    np.testing.assert_allclose(mean.detach().numpy(), np.asarray(want),
                               atol=1e-6)


# ------------------------------------- one recurrent asymmetric iteration

def _jax_draws(key, n_steps):
    """The draws of the JAX recurrent ``learn_iteration``: (noise (T, N,
    1), a permutation of the N envs)."""
    _, k_roll, k_perm = jax.random.split(key, 3)
    noise = []
    k = k_roll
    for _ in range(n_steps):
        k, k_act = jax.random.split(k)
        noise.append(np.asarray(jax.random.normal(
            k_act, (N_ENVS, 1), jnp.float32)))
    return np.stack(noise), np.asarray(jax.random.permutation(k_perm,
                                                              N_ENVS))


def test_recurrent_asymmetric_learn_iteration_matches_jax():
    """One iteration (16 steps, 5 epochs x 4 env minibatches of 4 = 20
    optimizer steps, BPTT over the 16-step window from the window-start
    carries) from the same weights, Adam state, non-zero LSTM carries and
    draws: the eight scalar metrics at rtol 1e-4, the lr equal, the
    carried pack at atol 1e-5, the weights at atol 2e-6 (the tolerances
    of tests/test_torch_ppo.py's feed-forward iteration)."""
    pol_kw = dict(actor_hidden_dims=[16, 16], critic_hidden_dims=[16, 16],
                  rnn_type="lstm", rnn_hidden_size=HIDDEN,
                  rnn_num_layers=LAYERS)
    jpol, jalg = JaxPolicyCfg(**pol_kw), JaxAlgorithmCfg()
    tpol, talg = PolicyCfg(**pol_kw), AlgorithmCfg()
    jts = jax_ppo.init_train_state(jax.random.PRNGKey(0), 2, 1, jpol, jalg,
                                   critic_obs_dim=PRIV_DIM)
    rng = np.random.default_rng(5)
    fake = jax.tree.map(lambda p: jnp.asarray(
        rng.normal(0.0, 0.02, p.shape).astype(np.float32)), jts.params)
    _, opt_state = jax_ppo.make_optimizer(jalg).update(
        fake, jts.opt_state, jts.params)
    jts = dataclasses.replace(jts, opt_state=opt_state)
    tts = interop.train_state_from_jax(
        _np_tree(jts.params), _np_tree(jts.opt_state), np.asarray(jts.lr))
    assert isinstance(tts.model, nets.ActorCriticRecurrent)

    s0 = _initial_state()
    jstate = {k: jnp.asarray(v) for k, v in s0.items()}
    tstate = {k: torch.as_tensor(v.copy()) for k, v in s0.items()}
    mem = {k: rng.normal(0.0, 0.5, (N_ENVS, LAYERS, 2, HIDDEN)).astype(
        np.float32) for k in ("a", "c")}
    priv0 = np.stack(_priv(s0["pos"], s0["t"].astype(np.float32)), axis=-1)
    jpack = ((JaxPointEnv.obs_of(jstate["pos"]), jnp.asarray(priv0)),
             {k: jnp.asarray(v) for k, v in mem.items()})
    tpack = ((TorchPointEnv.obs_of(tstate["pos"]), torch.as_tensor(priv0)),
             {k: torch.as_tensor(v) for k, v in mem.items()})
    noise, perm = _jax_draws(jts.key, T_STEPS)

    jlearn = jax.jit(jax_ppo.make_learn_fn(JaxAsymPointEnv(), jpol, jalg,
                                           T_STEPS))
    jts2, _, jpack2, jm = jlearn(jts, jstate, jpack)
    tlearn = ppo.make_learn_fn(TorchAsymPointEnv(), tpol, talg, T_STEPS)
    tts2, _, tpack2, tm = tlearn(tts, tstate, tpack,
                                 noise=torch.as_tensor(noise),
                                 perm=torch.as_tensor(perm.copy()))
    (jobs, jpriv), jmem = jpack2
    (tobs, tpriv), tmem = tpack2
    np.testing.assert_allclose(tobs.numpy(), np.asarray(jobs), atol=1e-5)
    np.testing.assert_allclose(tpriv.numpy(), np.asarray(jpriv), atol=1e-5)
    for k in ("a", "c"):
        np.testing.assert_allclose(tmem[k].numpy(), np.asarray(jmem[k]),
                                   atol=1e-5, err_msg=k)
    tm = fetch_metrics(tm)
    _compare_metrics(_np_tree(jm), tm, rtol=1e-4, atol=1e-7)
    assert tts2.opt_state.count == 21
    assert float(tts2.lr) == float(jts2.lr)
    assert _max_weight_diff(jts2, tts2) <= 2e-6


# ------------------------------------------------------ BPTT learns memory

class MemoryCueEnv:
    """tests/test_ppo.py's memory task: a +-1 cue is observable only on the
    first step of each episode and reward = cue * tanh(action) on every
    step, so beating the memoryless ceiling (1/8) needs the LSTM to carry
    the cue, which trains only with gradients through time."""
    num_envs, num_actions, obs_dim, ep_len = 64, 1, 2, 8

    def __init__(self, seed):
        self.gen = torch.Generator().manual_seed(seed)

    def _cue(self, shape):
        return torch.sign(torch.randn(shape, generator=self.gen))

    def reset(self):
        cue = self._cue((self.num_envs,))
        state = {"cue": cue, "t": torch.zeros(self.num_envs,
                                              dtype=torch.int32)}
        return state, self._obs(cue, state["t"])

    @staticmethod
    def _obs(cue, t):
        visible = (t == 0).to(torch.float32)
        return torch.stack([cue * visible, torch.ones_like(cue)], dim=-1)

    def step(self, state, actions):
        reward = state["cue"] * torch.tanh(actions[:, 0])
        t = state["t"] + 1
        done = t >= self.ep_len
        cue = torch.where(done, self._cue(state["cue"].shape), state["cue"])
        t = torch.where(done, 0, t)
        zero = torch.zeros(())
        tr = Transition(
            obs=self._obs(cue, t), reward=reward, done=done, time_out=done,
            episode_sums={}, episode_count=done.to(torch.float32).sum(),
            episode_length_sum=(done * self.ep_len).to(torch.float32).sum(),
            terrain_level_mean=zero, max_command_x=zero,
            torques=torch.zeros((1, self.num_envs)),
            feet_contact_z=torch.zeros((0, self.num_envs)))
        return {"cue": cue, "t": t}, tr


def test_recurrent_bptt_learns_memory_task():
    """tests/test_ppo.py:232 on the port, 150 iterations: reward above 0.4
    where a memoryless policy earns at most 0.125."""
    env = MemoryCueEnv(seed=1)
    pol = PolicyCfg(actor_hidden_dims=[32], critic_hidden_dims=[32],
                    rnn_type="lstm", rnn_hidden_size=16, rnn_num_layers=1)
    alg = AlgorithmCfg(num_mini_batches=2, learning_rate=5e-3,
                       desired_kl=0.03)
    ts = ppo.init_train_state(0, env.obs_dim, env.num_actions, pol, alg,
                              device="cpu")
    learn = ppo.make_learn_fn(env, pol, alg, num_steps=16)
    state, obs = env.reset()
    pack = (obs, nets.init_memory(env.num_envs, pol))
    for _ in range(150):
        ts, state, pack, metrics = learn(ts, state, pack)
    assert isinstance(pack, tuple) and set(pack[1]) == {"a", "c"}
    r = float(metrics["mean_step_reward"])
    assert r > 0.4, (f"memory task reward {r:.3f}: the LSTM gradients do "
                     f"not flow through time")


def test_gru_raises():
    with pytest.raises(NotImplementedError):
        nets.ActorCritic.from_cfg(2, 1, PolicyCfg(rnn_type="gru"))
