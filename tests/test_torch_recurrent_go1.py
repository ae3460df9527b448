"""The first PPO iteration of go1 rough with the recurrent policy (LSTM
512, one layer, 512-256-128 heads) and the asymmetric critic (249
privileged observations), in both packages on the CPU, from the same
weights, env state and draws: the iteration's mean KL and the learning
rate that the adaptive schedule leaves.

On this config the first iteration's KL is far above the schedule's
target and the lr falls to its floor; this test shows that the JAX
package does the same, so the spike is not the port's. It compiles the
JAX package's whole iteration (24 env steps and the BPTT update), so it
is marked slow.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from legged_gym_tpu import registry as jax_registry
from legged_gym_tpu.rl import ppo as jax_ppo
from legged_gym_tpu_torch import interop, registry
from legged_gym_tpu_torch.rl import ppo
from legged_gym_tpu_torch.rl.runner import fetch_metrics

N_ENVS, T_STEPS = 64, 24
PRIV = 235 + 2 + 12
# the envs that fall in the rollout are reset from each package's own
# draws, so the rollouts differ there: the KL is held at 10%
KL_RTOL = 0.1


def _cfgs(reg):
    """go1 rough (bench.py's variant) at N_ENVS envs with privileged
    observations, pushes off; the recurrent policy."""
    cfg, tcfg = reg.get_cfgs("go1")
    cfg.env.num_envs = N_ENVS
    cfg.env.num_observations = 235
    cfg.env.num_privileged_obs = PRIV
    cfg.terrain.mesh_type = "heightfield"
    cfg.terrain.measure_heights = True
    cfg.terrain.curriculum = True
    cfg.domain_rand.push_robots = False
    tcfg.policy.rnn_type = "lstm"
    tcfg.policy.rnn_hidden_size = 512
    tcfg.policy.rnn_num_layers = 1
    return cfg, tcfg


def _np(x):
    return jax.tree.map(np.asarray, x)


@pytest.mark.slow
def test_first_iteration_kl_matches_jax():
    jcfg, jtcfg = _cfgs(jax_registry)
    tcfg_env, ttcfg = _cfgs(registry)
    jenv, _ = jax_registry.make_env(cfg=jcfg)
    tenv, _ = registry.make_env(cfg=tcfg_env, device="cpu")
    na = tenv.num_actions

    # one start: the JAX env's reset and one zero-action step (the
    # runner's privileged pack), carried to the port
    jstate, _ = jenv.reset(jax.random.PRNGKey(0))
    jstate, jtr = jax.jit(jenv.step)(jstate, jnp.zeros((N_ENVS, na)))
    tstate = interop.env_state_from_jax(_np(jstate))
    obs = np.array(jtr.obs)
    priv = np.array(jtr.privileged_obs)
    mem = {k: np.zeros((N_ENVS, 1, 2, 512), np.float32) for k in "ac"}

    jts = jax_ppo.init_train_state(jax.random.PRNGKey(1), obs.shape[1], na,
                                   jtcfg.policy, jtcfg.algorithm,
                                   critic_obs_dim=PRIV)
    tts = interop.train_state_from_jax(_np(jts.params), _np(jts.opt_state),
                                       np.asarray(jts.lr))
    # the draws learn_iteration makes from the JAX key
    _, k_roll, k_perm = jax.random.split(jts.key, 3)
    noise, k = [], k_roll
    for _ in range(T_STEPS):
        k, k_act = jax.random.split(k)
        noise.append(np.asarray(jax.random.normal(k_act, (N_ENVS, na))))
    perm = np.asarray(jax.random.permutation(k_perm, N_ENVS))

    jlearn = jax.jit(jax_ppo.make_learn_fn(jenv, jtcfg.policy,
                                           jtcfg.algorithm, T_STEPS))
    jpack = ((jnp.asarray(obs), jnp.asarray(priv)),
             {k: jnp.asarray(v) for k, v in mem.items()})
    jts2, _, _, jm = jlearn(jts, jstate, jpack)
    tlearn = ppo.make_learn_fn(tenv, ttcfg.policy, ttcfg.algorithm,
                               T_STEPS)
    tpack = ((torch.as_tensor(obs), torch.as_tensor(priv)),
             {k: torch.as_tensor(v) for k, v in mem.items()})
    tts2, _, _, tm = tlearn(tts, tstate, tpack,
                            noise=torch.as_tensor(np.stack(noise)),
                            perm=torch.as_tensor(perm.copy()))
    tm = fetch_metrics(tm)
    kl_j, kl_t = float(jm["kl"]), tm["kl"]
    print(f"first iteration: kl JAX {kl_j:.4f}, port {kl_t:.4f}; lr JAX "
          f"{float(jts2.lr):.3e}, port {float(tts2.lr):.3e}; desired kl "
          f"{ttcfg.algorithm.desired_kl}")
    np.testing.assert_allclose(kl_t, kl_j, rtol=KL_RTOL)
    assert float(tts2.lr) == pytest.approx(float(jts2.lr), rel=1e-6)
