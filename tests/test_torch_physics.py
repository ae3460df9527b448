"""The PyTorch port's physics constants and fused step against the JAX
package, on the CPU.

The JAX Pallas kernel is covered through its plain reference,
``legged_gym_tpu.physics.chain_step.run_decimation_chain``; the port's
plain version (``legged_gym_tpu_torch.physics.chain_step``) is what the
CUDA kernel is held against on the card. Inputs are made once from a numpy
seed and handed to both packages.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from legged_gym_tpu import registry as jax_registry
from legged_gym_tpu.physics import chain_step as jax_chain_step
from legged_gym_tpu.physics.params import \
    link_params_from_scales as jax_link_params
from legged_gym_tpu_torch import registry as torch_registry
from legged_gym_tpu_torch.physics import chain_step, chain_kernel
from legged_gym_tpu_torch.physics.params import link_params_from_scales

# one intra-op thread: the tensors are a few envs wide and the test
# workers share the cores (more threads only spin and slow them)
torch.set_num_threads(1)

N = 8
# keys of const_values that derive from the numeric apparent-mass probe
# (float32 ABA summed in another order): held at rtol 1e-4
PROBED = ("gme", "gmet", "gimn", "gimt")


def _cfg(reg):
    cfg, _ = reg.get_cfgs("go1")
    cfg.env.num_envs = N
    cfg.env.num_observations = 235
    cfg.terrain.mesh_type = "heightfield"
    cfg.terrain.measure_heights = True
    cfg.terrain.num_rows = 3
    cfg.terrain.num_cols = 2
    cfg.terrain.border_size = 5.0
    return cfg


@pytest.fixture(scope="module")
def envs():
    jenv, _ = jax_registry.make_env(cfg=_cfg(jax_registry))
    tenv, _ = torch_registry.make_env(cfg=_cfg(torch_registry),
                                      device="cpu")
    return jenv, tenv


@pytest.fixture(scope="module")
def jax_run(envs):
    cc = envs[0].chain_engine.cc
    return jax.jit(lambda *a: jax_chain_step.run_decimation_chain(cc, *a))


def test_model_and_engine_constants(envs):
    jenv, tenv = envs
    jm, tm = jenv.model, tenv.model
    assert (tm.nq, tm.nl, len(tm.cp_link)) == (12, 13, 92)
    for f in ("link_parent", "joint_pos", "joint_rot", "joint_axis",
              "dof_lower", "dof_upper", "dof_vel_limit", "dof_effort",
              "contrib", "contrib_link", "cp_link", "cp_body", "cp_pos",
              "cp_radius"):
        np.testing.assert_array_equal(getattr(jm, f), getattr(tm, f),
                                      err_msg=f)
    je, te = jenv.engine, tenv.engine
    # numpy-copied constants: exact
    np.testing.assert_array_equal(je._imp_pd, te._imp_pd)
    np.testing.assert_array_equal(je.cp_k_static, te.cp_k_static)
    np.testing.assert_array_equal(je.cp_vmax, te.cp_vmax)
    # probed apparent masses: f32 ABA in another summation order
    np.testing.assert_allclose(je.cp_m_eff, te.cp_m_eff, rtol=1e-4)
    np.testing.assert_allclose(je.cp_m_eff_t, te.cp_m_eff_t, rtol=1e-4)


def test_chain_constants(envs):
    jenv, tenv = envs
    jcc, tcc = jenv.chain_engine.cc, tenv.chain_engine.cc
    for f in ("dt_inner", "substeps", "decimation", "gravity",
              "limit_stiffness", "limit_damping", "base_ang_cap",
              "base_lin_cap", "mu_terrain", "slip_velocity", "baumgarte",
              "border_size", "horizontal_scale", "wall_thresh", "patch_S",
              "plane_per_step", "warm_start", "torque_mode"):
        assert getattr(jcc, f) == getattr(tcc, f), f
    for f in ("kp", "kd_eff", "effort", "implicit_d", "lower", "upper",
              "qd_cap"):
        np.testing.assert_array_equal(getattr(jcc, f), getattr(tcc, f),
                                      err_msg=f)
    jcv = jax_chain_step.const_values(jcc, env_nd=1)
    tcv = chain_step.const_values(tcc)
    # the port keeps the arrays its step reads: not Rj, iota, gme{gi}
    assert set(tcv) <= set(jcv)
    assert len(tcv) == len(jcv) - 2 - len(tcc.cm.groups)
    for k in tcv:
        if k.rstrip("0123456789") in PROBED:
            np.testing.assert_allclose(jcv[k], tcv[k], rtol=1e-4,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(jcv[k], tcv[k], err_msg=k)
    # the kernel's constant table holds exactly the plain version's values
    table = chain_kernel.const_table(tcc)
    assert table.dtype == np.float32
    assert table.size == (chain_kernel.N_SCALAR
                          + tcc.cm.L * tcc.cm.K * chain_kernel.JSTRIDE
                          + 92 * chain_kernel.PSTRIDE)


def _inputs(tenv, seed):
    """A fresh-reset go1 state on the heightfield, from a numpy seed."""
    rng = np.random.default_rng(seed)
    m = tenv.model
    origins = tenv.init_env_origins
    q = (tenv.default_dof_pos[:, None]
         * rng.uniform(0.5, 1.5, (m.nq, N))).astype(np.float32)
    pos = (origins + np.asarray(tenv.cfg.init_state.pos)[:, None]).astype(
        np.float32)
    pos[:2] += rng.uniform(-1.0, 1.0, (2, N)).astype(np.float32)
    quat = np.zeros((4, N), np.float32)
    quat[3] = 1.0
    pos = tenv._depenetrate_spawn(torch.as_tensor(pos), torch.as_tensor(quat),
                                  torch.as_tensor(q)).numpy()
    vel = rng.uniform(-0.5, 0.5, (6, N)).astype(np.float32)
    scales = rng.uniform(0.8, 1.2, (m.n_orig, N)).astype(np.float32)
    lp = link_params_from_scales(m, torch.as_tensor(scales)).numpy()
    np.testing.assert_allclose(
        np.asarray(jax_link_params(m, jnp.asarray(scales))), lp, rtol=1e-6,
        atol=1e-7)
    fric = rng.uniform(0.5, 1.25, N).astype(np.float32)
    targets = np.broadcast_to(tenv.default_dof_pos[:, None],
                              (m.nq, N)).astype(np.float32)
    return dict(pos=pos, quat=quat, vel=vel, q=q,
                qd=np.zeros((m.nq, N), np.float32), lp=lp, fric=fric,
                targets=targets)


def _level_args(env, inp, torch_side):
    """run_decimation_chain arguments in the chain layout, built by the
    port's ChainEngine (exact index gathers) from the shared inputs."""
    ce = env.chain_engine
    t = {k: torch.as_tensor(v) for k, v in inp.items()}
    lp_base, lp_lvl = ce.level_link_params(t["lp"])
    ph, r0, c0 = ce.extract_contact_patch(env.grid, t["pos"][0],
                                          t["pos"][1])
    args = (lp_base, lp_lvl, t["fric"], ce.to_level(t["targets"]), ph, r0,
            c0, t["pos"], t["quat"], t["vel"], ce.to_level(t["q"]),
            ce.to_level(t["qd"]))
    if torch_side:
        return [a.contiguous() for a in args]
    return [jnp.asarray(a.numpy()) for a in args]


def _check_patch(jenv, tenv, inp):
    jph, jr0, jc0 = jenv.chain_engine.extract_contact_patch(
        jenv.grid, jnp.asarray(inp["pos"][0]), jnp.asarray(inp["pos"][1]))
    tph, tr0, tc0 = tenv.chain_engine.extract_contact_patch(
        tenv.grid, torch.as_tensor(inp["pos"][0]),
        torch.as_tensor(inp["pos"][1]))
    np.testing.assert_array_equal(np.asarray(jph), tph.numpy())
    np.testing.assert_array_equal(np.asarray(jr0), tr0.numpy())
    np.testing.assert_array_equal(np.asarray(jc0), tc0.numpy())


# body_f: net contact force per report body, up to a few hundred N on
# landing; f32 sums over up to 9 points in another order, amplified by the
# stiff impulse law, give errors of order 1e-3 of the force
BODY_F_ATOL, BODY_F_RTOL = 5e-2, 1e-3


def _compare(ref, out, atol=5e-3):
    for i, name in enumerate(("pos", "quat", "vel", "q", "qd", "tau")):
        np.testing.assert_allclose(np.asarray(ref[i]), out[i].numpy(),
                                   atol=atol, err_msg=name)
    np.testing.assert_allclose(np.asarray(ref[6]), out[6].numpy(),
                               atol=BODY_F_ATOL, rtol=BODY_F_RTOL,
                               err_msg="body_f")


def test_plain_step_matches_jax_from_reset(envs, jax_run):
    jenv, tenv = envs
    inp = _inputs(tenv, seed=0)
    _check_patch(jenv, tenv, inp)
    ref = jax_run(*_level_args(tenv, inp, torch_side=False))
    out = chain_step.run_decimation_chain(
        tenv.chain_engine.cc, *_level_args(tenv, inp, torch_side=True))
    _compare(ref, out)


def test_plain_step_matches_jax_settled(envs, jax_run):
    """Settle 30 policy steps with the JAX step, then one step of each
    from the shared settled state: q within 2e-5."""
    jenv, tenv = envs
    inp = _inputs(tenv, seed=1)
    ce = tenv.chain_engine
    args = _level_args(tenv, inp, torch_side=False)
    state = args[7:]
    for _ in range(30):
        state = jax_run(*args[:7], *state)[:5]
    ph, r0, c0 = jenv.chain_engine.extract_contact_patch(
        jenv.grid, state[0][0], state[0][1])
    args = list(args[:4]) + [ph, r0, c0] + list(state)
    ref = jax_run(*args)
    out = chain_step.run_decimation_chain(
        ce.cc, *[torch.as_tensor(np.array(a)) for a in args])
    _compare(ref, out)
    np.testing.assert_allclose(np.asarray(ref[3]), out[3].numpy(), atol=2e-5)
    # settled: the robots stand on the terrain
    assert np.all(np.asarray(ref[6])[2].sum(axis=0) > 50.0)
