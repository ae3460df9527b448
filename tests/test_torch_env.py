"""The PyTorch port's terrain and env against the JAX package, on the CPU.

Inputs are made once and handed to both packages (their random streams
cannot match): the JAX env's state is carried over leaf by leaf
(interop.env_state_from_jax) and both envs step from it with the same
actions. Noise, pushes and domain randomization are off.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from legged_gym_tpu import registry as jax_registry
from legged_gym_tpu.terrain import heightfield as jax_hf
from legged_gym_tpu.terrain.terrain import Terrain as JaxTerrain
from legged_gym_tpu_torch import registry as torch_registry
from legged_gym_tpu_torch.interop import env_state_from_jax
from legged_gym_tpu_torch.terrain import heightfield as torch_hf
from legged_gym_tpu_torch.terrain.terrain import Terrain as TorchTerrain

# one intra-op thread: the tensors are a few envs wide and the test
# workers share the cores (more threads only spin and slow them)
torch.set_num_threads(1)

N = 8


def _cfg(reg):
    cfg, _ = reg.get_cfgs("go1")
    cfg.env.num_envs = N
    cfg.env.num_observations = 235
    cfg.terrain.mesh_type = "heightfield"
    cfg.terrain.measure_heights = True
    cfg.terrain.curriculum = True
    cfg.terrain.num_rows = 3
    cfg.terrain.num_cols = 2
    cfg.terrain.border_size = 5.0
    cfg.noise.add_noise = False
    cfg.domain_rand.push_robots = False
    cfg.domain_rand.randomize_friction = False
    cfg.domain_rand.randomize_base_mass = False
    cfg.domain_rand.randomize_limb_mass = False
    return cfg


@pytest.fixture(scope="module")
def envs():
    jenv, _ = jax_registry.make_env(cfg=_cfg(jax_registry))
    tenv, _ = torch_registry.make_env(cfg=_cfg(torch_registry),
                                      device="cpu")
    return jenv, tenv


@pytest.fixture(scope="module")
def jax_step(envs):
    return jax.jit(envs[0].step)


def _np_tree(x):
    return jax.tree.map(np.asarray, x)


def test_terrain_heights_bit_identical():
    cfg_j = _cfg(jax_registry).terrain
    cfg_t = _cfg(torch_registry).terrain
    for curriculum in (True, False):
        cfg_j.curriculum = cfg_t.curriculum = curriculum
        tj = JaxTerrain(cfg_j, N, seed=3)
        tt = TorchTerrain(cfg_t, N, seed=3)
        np.testing.assert_array_equal(tj.height_field_raw,
                                      tt.height_field_raw)
        np.testing.assert_array_equal(tj.env_origins, tt.env_origins)
        np.testing.assert_array_equal(np.asarray(tj.grid().height),
                                      tt.grid("cpu").height.numpy())


def test_patch_gather_and_min3_match_one_hot(envs):
    jenv, tenv = envs
    rng = np.random.default_rng(0)
    R, C = tenv.grid.height.shape
    hs, b = tenv.grid.horizontal_scale, tenv.grid.border_size
    # base positions anywhere on the grid, including the clamped edges
    x = rng.uniform(-b - 1.0, R * hs - b + 1.0, N).astype(np.float32)
    y = rng.uniform(-b - 1.0, C * hs - b + 1.0, N).astype(np.float32)
    for S in (40, 24):
        jp = jax_hf.PatchExtractor(jenv.grid, size=S)(jnp.asarray(x),
                                                      jnp.asarray(y))
        tp = torch_hf.PatchExtractor(tenv.grid, size=S)(torch.as_tensor(x),
                                                        torch.as_tensor(y))
        np.testing.assert_array_equal(np.asarray(jp.h), tp.h.numpy())
        np.testing.assert_array_equal(np.asarray(jp.r0), tp.r0.numpy())
        np.testing.assert_array_equal(np.asarray(jp.c0), tp.c0.numpy())
    # scan points around each base, some outside the window
    px = (x[None] + rng.uniform(-2.5, 2.5, (187, N))).astype(np.float32)
    py = (y[None] + rng.uniform(-2.5, 2.5, (187, N))).astype(np.float32)
    hj = jax_hf.patch_sample_min3(jenv.grid, jp, jnp.asarray(px),
                                  jnp.asarray(py))
    ht = torch_hf.patch_sample_min3(tenv.grid, tp, torch.as_tensor(px),
                                    torch.as_tensor(py))
    np.testing.assert_array_equal(np.asarray(hj), ht.numpy())
    # global samplers
    np.testing.assert_array_equal(
        np.asarray(jax_hf.sample_min3(jenv.grid, jnp.asarray(px),
                                      jnp.asarray(py))),
        torch_hf.sample_min3(tenv.grid, torch.as_tensor(px),
                             torch.as_tensor(py)).numpy())
    for a, b_ in zip(jax_hf.sample_bilinear(jenv.grid, jnp.asarray(px),
                                            jnp.asarray(py)),
                     torch_hf.sample_bilinear(tenv.grid, torch.as_tensor(px),
                                              torch.as_tensor(py))):
        np.testing.assert_allclose(np.asarray(a), b_.numpy(), atol=1e-5)


def test_env_static_tables_match(envs):
    jenv, tenv = envs
    assert tenv.num_envs == N and tenv.obs_dim == jenv.obs_dim == 235
    for name in ("default_dof_pos", "p_gains", "d_gains", "soft_dof_lower",
                 "soft_dof_upper", "noise_vec", "height_points",
                 "init_env_origins", "init_terrain_levels", "terrain_types",
                 "_cell_r0", "_cell_c0"):
        np.testing.assert_array_equal(np.asarray(getattr(jenv, name)),
                                      np.asarray(getattr(tenv, name)),
                                      err_msg=name)
    np.testing.assert_array_equal(
        jenv._cell_patches.reshape(tenv._cell_patches.shape),
        tenv._cell_patches)
    assert jenv.reward_scales == tenv.reward_scales
    assert (jenv.resample_interval, jenv.push_interval,
            jenv.max_episode_length) == (tenv.resample_interval,
                                         tenv.push_interval,
                                         tenv.max_episode_length)


def _jax_reset(jenv, jax_step, seed):
    """env.reset through the jitted step (an eager JAX step is slow)."""
    state = jenv.initial_state(jax.random.PRNGKey(seed))
    return jax_step(state, jnp.zeros((N, jenv.num_actions)))[0]


def _compare_step(tr_j, tr_t, s_j, s_t, atol):
    np.testing.assert_allclose(np.asarray(tr_j.obs), tr_t.obs.numpy(),
                               atol=atol)
    np.testing.assert_allclose(np.asarray(tr_j.reward), tr_t.reward.numpy(),
                               atol=atol)
    np.testing.assert_array_equal(np.asarray(tr_j.done), tr_t.done.numpy())
    np.testing.assert_allclose(np.asarray(s_j.physics.q),
                               s_t.physics.q.numpy(), atol=atol)


def test_one_step_from_settled_jax_state(envs, jax_step):
    """One step from a shared settled state (zero actions) matches obs,
    reward, done and q at atol 1e-4."""
    jenv, tenv = envs
    zeros_j = jnp.zeros((N, jenv.num_actions))
    state = _jax_reset(jenv, jax_step, 0)
    for _ in range(25):
        state, _ = jax_step(state, zeros_j)
    s_j, tr_j = jax_step(state, zeros_j)
    assert not np.asarray(tr_j.done).any()
    s_t, tr_t = tenv.step(env_state_from_jax(_np_tree(state)),
                          torch.zeros((N, tenv.num_actions)))
    _compare_step(tr_j, tr_t, s_j, s_t, atol=1e-4)
    np.testing.assert_allclose(np.asarray(tr_j.torques),
                               tr_t.torques.numpy(), atol=1e-3)


def test_twenty_step_rollout_from_reset(envs, jax_step):
    """From the JAX reset state, 20 steps with the same random actions stay
    together in configuration: pos atol 2e-2, q atol 5e-2 (the long-horizon
    tolerances of tests/test_chain_engine.py)."""
    jenv, tenv = envs
    state_j = _jax_reset(jenv, jax_step, 1)
    state_t = env_state_from_jax(_np_tree(state_j))
    acts = np.random.default_rng(2).normal(
        0.0, 0.5, (20, N, jenv.num_actions)).astype(np.float32)
    for i in range(20):
        state_j, tr_j = jax_step(state_j, jnp.asarray(acts[i]))
        state_t, tr_t = tenv.step(state_t, torch.as_tensor(acts[i]))
        np.testing.assert_array_equal(np.asarray(tr_j.done),
                                      tr_t.done.numpy())
    np.testing.assert_allclose(np.asarray(state_j.physics.pos),
                               state_t.physics.pos.numpy(), atol=2e-2)
    np.testing.assert_allclose(np.asarray(state_j.physics.q),
                               state_t.physics.q.numpy(), atol=5e-2)
    assert state_t.common_step == int(state_j.common_step)
    assert torch.isfinite(tr_t.obs).all()
