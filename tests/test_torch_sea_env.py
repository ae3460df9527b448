"""The SEA torque path of the PyTorch port at the env level against the JAX
package, on the CPU: anymal_c on the plane (``anymal_c_flat`` with
``self_collisions = 1``, so that both packages run the chain path) through
the JAX env's compiled step. Noise, pushes and domain randomisation are off;
the JAX env's state is carried over leaf by leaf
(interop.env_state_from_jax), the LSTM carry and the anchors included.

tests/test_torch_sea.py holds the modules of this path (the SEA net, the
constants, the plain K3 step, the kernel source's host build) and the
trimesh env; this file is apart because compiling the JAX step (16 unrolled
substeps with the LSTM between) takes two minutes here.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from legged_gym_tpu import registry as jax_registry
from legged_gym_tpu_torch import registry as torch_registry
from legged_gym_tpu_torch.interop import anchors_from_jax, env_state_from_jax

# one intra-op thread: the tensors are a few envs wide and the test
# workers share the cores (more threads only spin and slow them)
torch.set_num_threads(1)

N = 4


def _cfg(reg):
    cfg, _ = reg.get_cfgs("anymal_c_flat")
    cfg.env.num_envs = N
    cfg.asset.self_collisions = 1   # self-contact needs the general engine
    cfg.noise.add_noise = False
    cfg.domain_rand.push_robots = False
    cfg.domain_rand.randomize_friction = False
    cfg.domain_rand.randomize_base_mass = False
    cfg.domain_rand.randomize_limb_mass = False
    return cfg


@pytest.fixture(scope="module")
def envs():
    jenv, _ = jax_registry.make_env(cfg=_cfg(jax_registry))
    tenv, _ = torch_registry.make_env(cfg=_cfg(torch_registry), device="cpu")
    return jenv, tenv


@pytest.fixture(scope="module")
def jax_step(envs):
    return jax.jit(envs[0].step)


def _np_tree(x):
    return jax.tree.map(np.asarray, x)


def _jax_reset(jenv, step, seed):
    state = jenv.initial_state(jax.random.PRNGKey(seed))
    return step(state, jnp.zeros((N, jenv.num_actions)))[0]


def test_one_step_from_settled_jax_state(envs, jax_step):
    """obs / reward 5e-3, done equal, q 1e-4, LSTM state 1e-4, anchors
    1e-4, from the state the JAX env reached after 25 zero-action steps."""
    jenv, tenv = envs
    assert jenv._chain_path and jenv._sea is not None
    assert tenv._sea is not None and tenv.grid is None
    zeros_j = jnp.zeros((N, jenv.num_actions))
    state = _jax_reset(jenv, jax_step, 0)
    for _ in range(25):
        state, _ = jax_step(state, zeros_j)
    s_j, tr_j = jax_step(state, zeros_j)
    assert not np.asarray(tr_j.done).any()
    s0 = env_state_from_jax(_np_tree(state))
    assert tuple(s0.actuator_state["h"].shape) == (2, 8, 12, N)
    assert float(s0.actuator_state["h"].abs().max()) > 0.0
    assert tuple(s0.contact_ws.shape) == (3, 22, N)
    s_t, tr_t = tenv.step(s0, torch.zeros((N, tenv.num_actions)))
    np.testing.assert_allclose(np.asarray(tr_j.obs), tr_t.obs.numpy(),
                               atol=5e-3)
    np.testing.assert_allclose(np.asarray(tr_j.reward), tr_t.reward.numpy(),
                               atol=5e-3)
    np.testing.assert_array_equal(np.asarray(tr_j.done), tr_t.done.numpy())
    np.testing.assert_allclose(np.asarray(s_j.physics.q),
                               s_t.physics.q.numpy(), atol=1e-4)
    # torques: 20 N*m x the LSTM head, of order 30 N*m
    np.testing.assert_allclose(np.asarray(tr_j.torques),
                               tr_t.torques.numpy(), atol=5e-3, rtol=1e-3)
    for k in ("h", "c"):
        np.testing.assert_allclose(np.asarray(s_j.actuator_state[k]),
                                   s_t.actuator_state[k].numpy(), atol=1e-4)
    np.testing.assert_allclose(
        anchors_from_jax(_np_tree(s_j.contact_ws)).numpy(),
        s_t.contact_ws.numpy(), atol=1e-4)
    # standing: the feet carry the 52 kg
    assert float(tr_t.feet_contact_z.sum(0).min()) > 300.0


def test_rollout_from_reset(envs, jax_step):
    """25 zero-action steps from a shared reset: pos within 1e-2, q within
    2e-2, as the JAX package holds its own two engines
    (tests/test_chain_engine.py); done flags agree at every step, and the
    configuration is compared over the envs that never finished (a
    finished env is re-drawn from each package's own random stream)."""
    jenv, tenv = envs
    state_j = _jax_reset(jenv, jax_step, 1)
    state_t = env_state_from_jax(_np_tree(state_j))
    zeros_j = jnp.zeros((N, jenv.num_actions))
    zeros_t = torch.zeros((N, tenv.num_actions))
    alive = np.ones(N, bool)
    for _ in range(25):
        state_j, tr_j = jax_step(state_j, zeros_j)
        state_t, tr_t = tenv.step(state_t, zeros_t)
        np.testing.assert_array_equal(np.asarray(tr_j.done),
                                      tr_t.done.numpy())
        alive &= ~tr_t.done.numpy()
    assert alive.sum() >= N // 2, alive
    np.testing.assert_allclose(np.asarray(state_j.physics.pos)[:, alive],
                               state_t.physics.pos.numpy()[:, alive],
                               atol=1e-2)
    np.testing.assert_allclose(np.asarray(state_j.physics.q)[:, alive],
                               state_t.physics.q.numpy()[:, alive],
                               atol=2e-2)
    for k in ("h", "c"):
        np.testing.assert_allclose(
            np.asarray(state_j.actuator_state[k])[..., alive],
            state_t.actuator_state[k].numpy()[..., alive], atol=2e-2)
    assert torch.isfinite(tr_t.obs).all()
    assert state_t.common_step == int(state_j.common_step)
