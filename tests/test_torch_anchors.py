"""Warm-start friction anchors (kernel variant K4) of the PyTorch port
against the JAX package, on the CPU, for aliengo.

The JAX Pallas kernel is covered through its plain reference,
``legged_gym_tpu.physics.chain_step.run_decimation_chain`` with anchors;
the port's plain version is what the CUDA kernel is held against on the
card, and the kernel source itself runs here through its host C++ build.
Inputs are made once from a numpy seed (or by the JAX env) and handed to
both packages. The card-only case carries the ``cuda`` marker.
"""
import dataclasses
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from legged_gym_tpu import registry as jax_registry
from legged_gym_tpu.physics import chain_step as jax_chain_step
from legged_gym_tpu.physics import contact as jax_contact
from legged_gym_tpu_torch import registry as torch_registry
from legged_gym_tpu_torch.interop import anchors_from_jax, env_state_from_jax
from legged_gym_tpu_torch.physics import chain_kernel, chain_step
from legged_gym_tpu_torch.physics import contact as torch_contact
from legged_gym_tpu_torch.scripts.kernel_numerics import (anchor_errors,
                                                        kernel_args,
                                                        per_env_errors,
                                                        tolerances)

# one intra-op thread: the tensors are a few envs wide and the test
# workers share the cores (more threads only spin and slow them)
torch.set_num_threads(1)

N = 8
LIVE = 1e5      # anchors below this are live, at 1e6 they are the sentinel
# probed apparent masses: float32 ABA summed in another order
PROBED = ("gme", "gmet", "gimn", "gimt")


def _cfg(reg):
    cfg, _ = reg.get_cfgs("aliengo")
    cfg.env.num_envs = N
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


@pytest.fixture(scope="module")
def settled_jax_state(envs, jax_step):
    """The JAX env's state after a reset and 25 zero-action steps, shared
    by the tests that start from a settled stance."""
    jenv = envs[0]
    zeros_j = jnp.zeros((N, jenv.num_actions))
    state = _jax_reset(jenv, jax_step, 0)
    for _ in range(25):
        state, _ = jax_step(state, zeros_j)
    return state


@pytest.fixture(scope="module")
def jax_run(envs):
    cc = envs[0].chain_engine.cc
    return jax.jit(lambda *a: jax_chain_step.run_decimation_chain(
        cc, *a[:-1], anchors=a[-1]))


def _np_tree(x):
    return jax.tree.map(np.asarray, x)


def _jax_groups(cm, packed_np):
    """Packed (3, n_points, N) -> the JAX package's per-group list."""
    return [jnp.asarray(a.numpy()) for a in chain_step.split_anchors(
        cm, torch.as_tensor(packed_np))]


# ------------------------------------------------------- the anchor law

def test_anchored_tangential_every_branch():
    """fresh (released or stale), loaded, near-but-unloaded and inactive
    points: force and new anchor at atol 1e-5 / rtol 1e-5."""
    rng = np.random.default_rng(0)
    P = 12
    shape = (P, N)
    cp = rng.uniform(-1.0, 1.0, (3,) + shape).astype(np.float32)
    anchor = (cp + rng.normal(0.0, 0.01, cp.shape)).astype(np.float32)
    anchor[:, 0] = jax_contact.ANCHOR_SENTINEL          # never touched
    anchor[:, 1] = cp[:, 1] + 0.2                         # stale (> 10 cm)
    depth = rng.uniform(-0.004, 0.01, shape).astype(np.float32)
    depth[2] = -0.05                                      # released
    depth[3] = depth[3] - 1e9                             # inactive point
    fn = rng.uniform(5.0, 80.0, shape).astype(np.float32)
    fn[4] = 0.0                                           # near, unloaded
    fn[5] = 5e-4                                          # below `loaded`
    fn[2] = 0.0
    fn[3] = 0.0
    fn[6] = 0.05                                          # cone clips hard
    mu = rng.uniform(0.5, 1.1, shape).astype(np.float32)
    nrm = rng.normal(0.0, 0.2, (3,) + shape).astype(np.float32)
    nrm[2] = 1.0
    nrm /= np.linalg.norm(nrm, axis=0, keepdims=True)
    vt = rng.normal(0.0, 0.2, (3,) + shape).astype(np.float32)
    vt -= (vt * nrm).sum(0, keepdims=True) * nrm
    m_t = rng.uniform(0.2, 2.0, (P, 1)).astype(np.float32)
    dt = 0.005
    jcfg = jax_contact.ContactConfig(warm_start=True,
                                     anchor_release_depth=0.02)
    tcfg = torch_contact.ContactConfig(warm_start=True,
                                       anchor_release_depth=0.02)
    assert torch_contact.ANCHOR_SENTINEL == jax_contact.ANCHOR_SENTINEL
    for f in ("anchor_beta", "anchor_vmax", "anchor_stale2",
              "anchor_release_depth", "warm_start"):
        assert getattr(jcfg, f) == getattr(tcfg, f), f

    # every branch is present in the inputs
    near = depth > -0.02
    stale = ((cp - anchor) ** 2).sum(0) > 0.01
    fresh = ~near | stale
    loaded = fn > 1e-3
    assert (~near).any() and stale.any() and (near & ~stale).any()
    assert (~fresh & loaded).any() and (~fresh & ~loaded).any()

    j = lambda a: jnp.asarray(a)
    t = lambda a: torch.as_tensor(a)
    for use_depth in (True, False):
        f_j, a_j = jax_contact.anchored_tangential(
            jcfg, j(cp), j(fn), j(mu), j(vt), j(nrm), j(m_t), dt, j(anchor),
            depth=j(depth) if use_depth else None)
        f_t, a_t = torch_contact.anchored_tangential(
            tcfg, t(cp), t(fn), t(mu), t(vt), t(nrm), t(m_t), dt, t(anchor),
            depth=t(depth) if use_depth else None)
        np.testing.assert_allclose(np.asarray(f_j), f_t.numpy(), atol=1e-5,
                                   rtol=1e-5)
        np.testing.assert_allclose(np.asarray(a_j), a_t.numpy(), atol=1e-5,
                                   rtol=1e-5)
    # a sliding point drags its anchor, a sticking loaded one keeps it near
    assert not np.allclose(a_t.numpy()[:, 6], anchor[:, 6])


# ------------------------------------------------------------ constants

def test_aliengo_chain_constants(envs):
    jenv, tenv = envs
    jcc, tcc = jenv.chain_engine.cc, tenv.chain_engine.cc
    assert jenv._chain_path and tcc.warm_start
    cm = tcc.cm
    assert (cm.L, cm.K, cm.n_bodies) == (3, 4, 17)
    assert [g.offs.shape[0] for g in cm.groups] == [8, 2, 8, 9]
    assert chain_step.n_points(cm) == 84
    assert chain_kernel.model_layout(cm) == (3, 4, 8, (2, 8, 9), 17)
    for f in ("dt_inner", "substeps", "decimation", "gravity", "mu_terrain",
              "slip_velocity", "baumgarte", "patch_S", "plane_per_step",
              "warm_start", "anchor_beta", "anchor_vmax", "anchor_stale2",
              "anchor_release_depth", "torque_mode", "wall_thresh"):
        assert getattr(jcc, f) == getattr(tcc, f), f
    assert tcc.anchor_release_depth == 0.02
    jcv = jax_chain_step.const_values(jcc, env_nd=1)
    tcv = chain_step.const_values(tcc)
    for k in tcv:
        rtol = 1e-4 if k.rstrip("0123456789") in PROBED else 1e-5
        np.testing.assert_allclose(jcv[k], tcv[k], rtol=rtol, atol=0,
                                   err_msg=k)
    table = chain_kernel.const_table(tcc)
    assert table.size == (chain_kernel.N_SCALAR
                          + 12 * chain_kernel.JSTRIDE
                          + 84 * chain_kernel.PSTRIDE)
    np.testing.assert_allclose(table[18:22], [0.5, 1.0, 0.01, 0.02],
                               rtol=1e-7)


def test_variant_check_accepts_every_variant_with_anchors(envs):
    """The check accepts every variant (K4 combined with K2 and K3
    included), names the variant each selects, and the wrapper runs it with
    anchors in and out; only a configuration that makes no sense is
    refused. (tests/test_torch_trimesh.py and test_torch_sea.py hold these
    combinations against the JAX package and the kernel's host build.)"""
    tenv = envs[1]
    cc = tenv.chain_engine.cc
    chain_step.check_variant(cc)
    chain_step.check_variant(dataclasses.replace(cc, warm_start=False))
    assert chain_step.variant(cc, anchored=True) == "K4"
    assert chain_step.variant(cc) == "K1"
    state = tenv.initial_state()
    args = kernel_args(tenv, state)
    for flag, name in (({"plane_per_step": False}, "K2"),
                       ({"wall_thresh": 0.075}, "K2"),
                       ({"torque_mode": True, "decimation": 1}, "K3")):
        c2 = dataclasses.replace(cc, **flag)
        chain_step.check_variant(c2)
        assert chain_step.variant(c2, anchored=True) == name
        out = chain_kernel.run_decimation(c2, *args,
                                          anchors=state.contact_ws)
        assert len(out) == 8
        assert tuple(out[7].shape) == tuple(state.contact_ws.shape)
        assert out[7].data_ptr() != state.contact_ws.data_ptr()
        assert all(bool(torch.isfinite(o).all()) for o in out)
    with pytest.raises(ValueError):
        chain_step.check_variant(dataclasses.replace(cc, wall_thresh=-1.0))


# ------------------------------------------------ the step with anchors

def _compare(ref, out, atol=5e-3):
    """Six state outputs at the JAX package's kernel-vs-twin tolerance
    (tests/test_chain_engine.py:140-144); anchors within the same where
    live in both, and the live / sentinel pattern equal."""
    for i, name in enumerate(("pos", "quat", "vel", "q", "qd", "tau")):
        np.testing.assert_allclose(np.asarray(ref[i]), out[i].numpy(),
                                   atol=atol, err_msg=name)
    anc_j = anchors_from_jax(_np_tree(ref[7])).numpy()
    anc_t = out[7].numpy()
    np.testing.assert_array_equal(anc_j < LIVE, anc_t < LIVE)
    live = anc_j < LIVE
    np.testing.assert_allclose(anc_j[live], anc_t[live], atol=atol)
    return live


def _reset_args(tenv):
    state = tenv.initial_state()
    return kernel_args(tenv, state), state.contact_ws


def test_plain_step_with_anchors_matches_jax_from_reset(envs, jax_run):
    jenv, tenv = envs
    cc = tenv.chain_engine.cc
    args, anchors = _reset_args(tenv)
    assert (anchors == torch_contact.ANCHOR_SENTINEL).all()
    ref = jax_run(*[jnp.asarray(a.numpy()) for a in args],
                  _jax_groups(cc.cm, anchors.numpy()))
    out = chain_step.run_decimation_chain(cc, *args, anchors=anchors)
    assert len(out) == 8 and tuple(out[7].shape) == (3, 84, N)
    live = _compare(ref, out)
    # every anchor snapped to its point in the first substep
    assert live.all()


def test_plain_step_with_anchors_matches_jax_settled(envs, jax_run):
    """Settle 30 policy steps with the JAX step (anchors riding along),
    then one step of each from the shared state with live anchors."""
    jenv, tenv = envs
    cc = tenv.chain_engine.cc
    args, anchors = _reset_args(tenv)
    jargs = [jnp.asarray(a.numpy()) for a in args]
    state, anc = jargs[7:], _jax_groups(cc.cm, anchors.numpy())
    for _ in range(30):
        out = jax_run(*jargs[:7], *state, anc)
        state, anc = out[:5], out[7]
    ref = jax_run(*jargs[:7], *state, anc)
    targs = args[:7] + [torch.as_tensor(np.array(a)) for a in state]
    out = chain_step.run_decimation_chain(
        cc, *targs, anchors=anchors_from_jax(_np_tree(anc)))
    _compare(ref, out)
    np.testing.assert_allclose(np.asarray(ref[3]), out[3].numpy(), atol=5e-5)
    # settled: most robots stand on loaded feet (aliengo's spawn transient
    # is violent, a few envs are still hopping)
    assert np.mean(np.asarray(ref[6])[2].sum(axis=0) > 50.0) >= 0.5
    # without anchors the same state gives another tangential force
    k1 = chain_step.run_decimation_chain(cc, *targs)
    assert len(k1) == 7
    assert not torch.allclose(k1[2], out[2], atol=1e-6)


def test_host_build_of_k4_matches_plain(envs, settled_jax_state):
    """The kernel source compiled with the host C++ compiler for aliengo's
    layout (-DS_L0=2), anchors in and out, against the plain version, on a
    fresh reset and on the settled state."""
    if shutil.which("c++") is None and shutil.which("g++") is None:
        pytest.skip("no host C++ compiler")
    tenv = envs[1]
    cc = tenv.chain_engine.cc
    for settled in (False, True):
        state = env_state_from_jax(_np_tree(settled_jax_state)) \
            if settled else tenv.initial_state()
        args = kernel_args(tenv, state)
        ref = chain_step.run_decimation_chain(cc, *args,
                                              anchors=state.contact_ws)
        out = chain_kernel.run_decimation_host(cc, *args,
                                               anchors=state.contact_ws)
        errs = {k: float(v.max())
                for k, v in per_env_errors(ref[:7], out[:7]).items()}
        tol = tolerances(settled)
        for name, v in errs.items():
            assert v <= tol[name], (name, errs)
        assert errs["q"] < 1e-4, errs
        err, n_live, n_diff = anchor_errors(ref[7], out[7])
        assert n_diff == 0 and n_live == 3 * 84 * N
        assert err < 1e-5, err
        # the K1 entry of the same library still answers without anchors
        k1 = chain_kernel.run_decimation_host(cc, *args)
        k1_ref = chain_step.run_decimation_chain(cc, *args)
        assert len(k1) == 7
        torch.testing.assert_close(k1[3], k1_ref[3], atol=1e-4, rtol=0)
    layout = chain_kernel.library_layout(chain_kernel.load_library(
        "host", layout=chain_kernel.model_layout(cc.cm)))
    assert layout["S"] == (8, 2, 8, 9) and layout["NPTS"] == 84


def test_wrapper_contract_with_anchors(envs):
    tenv = envs[1]
    cc = tenv.chain_engine.cc
    state = tenv.initial_state()
    args = kernel_args(tenv, state)
    before = dict(chain_kernel.launches)
    out = chain_kernel.run_decimation(cc, *args, anchors=state.contact_ws)
    ref = chain_step.run_decimation_chain(cc, *args,
                                          anchors=state.contact_ws)
    # CPU tensors ran the plain version: no launch counted, same bits
    assert chain_kernel.launches == before
    for r, o in zip(ref, out):
        torch.testing.assert_close(o, r, rtol=0, atol=0)
    with pytest.raises(ValueError):
        chain_kernel.run_decimation(
            dataclasses.replace(cc, warm_start=False), *args,
            anchors=state.contact_ws)
    with pytest.raises(ValueError):
        chain_kernel.run_decimation(
            cc, *args, anchors=state.contact_ws.to("meta"))
    if shutil.which("c++") or shutil.which("g++"):
        with pytest.raises(ValueError):
            chain_kernel.run_decimation_host(
                cc, *args, anchors=state.contact_ws[:, :80].contiguous())
    # go1's library refuses aliengo's model
    with pytest.raises(NotImplementedError):
        chain_kernel.check_model(cc, dict(
            L=3, K=4, NG=4, S=(8, 4, 8, 9), NB=17, N_CONST=0,
            N_SCALAR=chain_kernel.N_SCALAR, JSTRIDE=chain_kernel.JSTRIDE,
            PSTRIDE=chain_kernel.PSTRIDE))


# ------------------------------------------------------------- the env

def _jax_reset(jenv, jax_step, seed):
    state = jenv.initial_state(jax.random.PRNGKey(seed))
    return jax_step(state, jnp.zeros((N, jenv.num_actions)))[0]


def test_env_one_step_from_settled_jax_state(envs, jax_step,
                                            settled_jax_state):
    jenv, tenv = envs
    zeros_j = jnp.zeros((N, jenv.num_actions))
    state = settled_jax_state
    s_j, tr_j = jax_step(state, zeros_j)
    assert not np.asarray(tr_j.done).any()
    s0 = env_state_from_jax(_np_tree(state))
    assert tuple(s0.contact_ws.shape) == (3, 84, N)
    s_t, tr_t = tenv.step(s0, torch.zeros((N, tenv.num_actions)))
    np.testing.assert_allclose(np.asarray(tr_j.obs), tr_t.obs.numpy(),
                               atol=1e-4)
    np.testing.assert_allclose(np.asarray(tr_j.reward), tr_t.reward.numpy(),
                               atol=1e-4)
    np.testing.assert_array_equal(np.asarray(tr_j.done), tr_t.done.numpy())
    np.testing.assert_allclose(np.asarray(s_j.physics.q),
                               s_t.physics.q.numpy(), atol=1e-4)
    np.testing.assert_allclose(np.asarray(tr_j.torques),
                               tr_t.torques.numpy(), atol=1e-3)
    np.testing.assert_allclose(
        anchors_from_jax(_np_tree(s_j.contact_ws)).numpy(),
        s_t.contact_ws.numpy(), atol=1e-4)


def test_env_twenty_step_rollout_from_reset(envs, jax_step):
    """20 steps with the same random actions. Aliengo's spawn transient is
    chaotic: once a contact switches a step apart in the two packages, a
    rounding-level difference grows 3-10x per policy step (measured here:
    2e-4 on q at step 8, 1e-1 in 2 of 8 envs at step 20; go1 stays within
    5e-2). Held: through step 8 every env agrees — done flags, the live /
    sentinel pattern of the anchors, q within 5e-3; after 20 steps at
    least 5 of 8 envs are still within the long-horizon tolerances of
    tests/test_chain_engine.py (pos 2e-2, q 5e-2) and all is finite."""
    jenv, tenv = envs
    state_j = _jax_reset(jenv, jax_step, 1)
    state_t = env_state_from_jax(_np_tree(state_j))
    acts = np.random.default_rng(2).normal(
        0.0, 0.5, (20, N, jenv.num_actions)).astype(np.float32)
    for i in range(20):
        state_j, tr_j = jax_step(state_j, jnp.asarray(acts[i]))
        state_t, tr_t = tenv.step(state_t, torch.as_tensor(acts[i]))
        if i < 8:
            np.testing.assert_array_equal(np.asarray(tr_j.done),
                                          tr_t.done.numpy())
            np.testing.assert_array_equal(
                anchors_from_jax(_np_tree(state_j.contact_ws)).numpy()
                < LIVE, state_t.contact_ws.numpy() < LIVE)
            np.testing.assert_allclose(np.asarray(state_j.physics.q),
                                       state_t.physics.q.numpy(), atol=5e-3)
    pos_err = np.abs(np.asarray(state_j.physics.pos)
                     - state_t.physics.pos.numpy()).max(axis=0)
    q_err = np.abs(np.asarray(state_j.physics.q)
                   - state_t.physics.q.numpy()).max(axis=0)
    assert np.sum((pos_err <= 2e-2) & (q_err <= 5e-2)) >= 5, (pos_err, q_err)
    assert state_t.common_step == int(state_j.common_step)
    assert torch.isfinite(tr_t.obs).all()
    assert torch.isfinite(state_t.contact_ws).all()


def test_finished_envs_get_sentinel_anchors(envs):
    tenv = envs[1]
    state, _ = tenv.reset()
    assert (state.contact_ws < LIVE).all()
    ep = state.episode_length.clone()
    ep[[1, 5]] = tenv.max_episode_length          # time out on this step
    state = dataclasses.replace(state, episode_length=ep)
    state, tr = tenv.step(state, torch.zeros((N, tenv.num_actions)))
    done = tr.done.numpy()
    assert done[[1, 5]].all() and tr.time_out[[1, 5]].all()
    ws = state.contact_ws.numpy()
    assert (ws[..., done] == torch_contact.ANCHOR_SENTINEL).all()
    assert (ws[..., ~done] < LIVE).all()
    # and they snap again on the next step
    state, _ = tenv.step(state, torch.zeros((N, tenv.num_actions)))
    assert (state.contact_ws < LIVE).all()


# ------------------------------------------------------------ card check

@pytest.mark.cuda
def test_k4_kernel_matches_plain_on_card():
    """K4 at aliengo's own 4096 envs on the card, fresh and settled (a
    machine without JAX runs its twin in tests/test_torch_kernel.py)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "false)")
    env, _ = torch_registry.make_env("aliengo", device="cuda")
    cc = env.chain_engine.cc
    state = env.initial_state()
    zeros = torch.zeros((env.num_envs, env.num_actions), device="cuda")
    for settled in (False, True):
        args = kernel_args(env, state)
        ref = chain_step.run_decimation_chain(cc, *args,
                                              anchors=state.contact_ws)
        out = chain_kernel.run_decimation(cc, *args,
                                          anchors=state.contact_ws)
        torch.cuda.synchronize()
        tol = tolerances(settled)
        for name, v in per_env_errors(ref[:7], out[:7]).items():
            assert float(v.max()) <= tol[name], name
        err, _, n_diff = anchor_errors(ref[7], out[7])
        assert err <= 5e-3 and n_diff == 0
        for _ in range(30):
            state, _ = env.step(state, zeros)
