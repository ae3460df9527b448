"""Trimesh terrain, the wall rule and per-sim-dt contact planes (kernel
variant K2), and the generalised kernel layout, of the PyTorch port against
the JAX package on the CPU: cassie (L=6 x K=2, trimesh) and a1 (no contact
points on its hips).

The JAX Pallas kernel is covered through its plain reference
(``chain_step.run_decimation_chain``) and in interpret mode
(``run_decimation_pallas(..., interpret=True)``); the port's plain version
is what the CUDA kernel is held against on the card, and the kernel source
itself runs here through its host C++ build. Inputs are made once from a
numpy seed (or by the JAX env) and handed to both packages. The card-only
cases of these paths are in tests/test_torch_kernel.py, which imports no JAX
and so runs on a machine without it.
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
from legged_gym_tpu.physics.pallas_step import run_decimation_pallas
from legged_gym_tpu.terrain import heightfield as jax_hf
from legged_gym_tpu.terrain import terrain as jax_terrain
from legged_gym_tpu_torch import registry as torch_registry
from legged_gym_tpu_torch.interop import env_state_from_jax
from legged_gym_tpu_torch.physics import chain_kernel, chain_step
from legged_gym_tpu_torch.scripts.kernel_numerics import (kernel_args,
                                                        per_env_errors,
                                                        tolerances)
from legged_gym_tpu_torch.terrain import heightfield as torch_hf
from legged_gym_tpu_torch.terrain import terrain as torch_terrain

# one intra-op thread: the tensors are a few envs wide and the test
# workers share the cores (more threads only spin and slow them)
torch.set_num_threads(1)

N = 4
# probed apparent masses: float32 ABA summed in another order
PROBED = ("gme", "gmet", "gimn", "gimt")
HAS_CXX = bool(shutil.which("c++") or shutil.which("g++"))


def _cfg(reg, task):
    cfg, _ = reg.get_cfgs(task)
    cfg.env.num_envs = N
    cfg.terrain.num_rows = 2
    cfg.terrain.num_cols = 2
    cfg.noise.add_noise = False
    cfg.domain_rand.push_robots = False
    cfg.domain_rand.randomize_friction = False
    cfg.domain_rand.randomize_base_mass = False
    cfg.domain_rand.randomize_limb_mass = False
    return cfg


def _pair(task):
    jenv, _ = jax_registry.make_env(cfg=_cfg(jax_registry, task))
    tenv, _ = torch_registry.make_env(cfg=_cfg(torch_registry, task),
                                      device="cpu")
    return jenv, tenv


@pytest.fixture(scope="module")
def cassie():
    return _pair("cassie")


@pytest.fixture(scope="module")
def cassie_step(cassie):
    return jax.jit(cassie[0].step)


@pytest.fixture(scope="module")
def a1():
    return _pair("a1")


@pytest.fixture(scope="module")
def a1_step(a1):
    return jax.jit(a1[0].step)


def _np_tree(x):
    return jax.tree.map(np.asarray, x)


def _jax_reset(jenv, step, seed):
    state = jenv.initial_state(jax.random.PRNGKey(seed))
    return step(state, jnp.zeros((N, jenv.num_actions)))[0]


def _settled(jenv, step, seed=0, steps=25):
    state = _jax_reset(jenv, step, seed)
    zeros = jnp.zeros((N, jenv.num_actions))
    for _ in range(steps):
        state, _ = step(state, zeros)
    return state


@pytest.fixture(scope="module")
def cassie_settled(cassie, cassie_step):
    """The JAX env's state after a reset and 25 zero-action steps, shared
    by every test that starts from a settled cassie."""
    return _settled(cassie[0], cassie_step)


@pytest.fixture(scope="module")
def a1_settled(a1, a1_step):
    return _settled(a1[0], a1_step)


# -------------------------------------------------------------- layouts

def _jax_layout(cm):
    size = {g.level: g.offs.shape[0] for g in cm.groups}
    return (cm.L, cm.K, size.get(-1, 0),
            tuple(size.get(l, 0) for l in range(cm.L)), cm.n_bodies)


def check_layout_and_constants(jenv, tenv, want_layout):
    """model_layout equals what the JAX package's chain model gives;
    const_values equal to rtol 1e-5 (1e-4 for the probed masses); the
    constant table has one record per joint and point."""
    jcc, tcc = jenv.chain_engine.cc, tenv.chain_engine.cc
    layout = chain_kernel.model_layout(tcc.cm)
    assert layout == _jax_layout(jcc.cm) == want_layout
    for f in ("dt_inner", "substeps", "decimation", "gravity", "mu_terrain",
              "slip_velocity", "baumgarte", "patch_S", "plane_per_step",
              "warm_start", "anchor_release_depth", "torque_mode",
              "wall_thresh", "border_size", "horizontal_scale"):
        assert getattr(jcc, f) == getattr(tcc, f), f
    jcv = jax_chain_step.const_values(jcc, env_nd=1)
    tcv = chain_step.const_values(tcc)
    for k in tcv:
        rtol = 1e-4 if k.rstrip("0123456789") in PROBED else 1e-5
        np.testing.assert_allclose(jcv[k], tcv[k], rtol=rtol, atol=0,
                                   err_msg=k)
    L, K, s_base, s_lvls, _ = layout
    n_pts = s_base + K * sum(s_lvls)
    assert chain_step.n_points(tcc.cm) == n_pts
    table = chain_kernel.const_table(tcc)
    assert table.size == (chain_kernel.N_SCALAR + L * K * chain_kernel.JSTRIDE
                          + n_pts * chain_kernel.PSTRIDE)
    assert table[22] == np.float32(tcc.wall_thresh)
    return layout


def test_cassie_layout_and_constants(cassie):
    jenv, tenv = cassie
    check_layout_and_constants(jenv, tenv,
                               (6, 2, 1, (0, 0, 0, 0, 0, 2), 13))
    assert tenv.chain_engine.cc.wall_thresh == pytest.approx(0.075)
    assert chain_step.variant(tenv.chain_engine.cc) == "K2"
    # anchors of a layout with empty levels pack and split consistently
    cm = tenv.chain_engine.cc.cm
    packed = torch.arange(3 * 5 * N, dtype=torch.float32).reshape(3, 5, N)
    groups = chain_step.split_anchors(cm, packed)
    assert [tuple(g.shape) for g in groups] == [(3, 1, 1, N), (3, 2, 2, N)]
    assert torch.equal(chain_step.pack_anchors(groups), packed)


def test_a1_layout_and_constants(a1):
    jenv, tenv = a1
    check_layout_and_constants(jenv, tenv, (3, 4, 8, (0, 8, 9), 17))
    assert chain_step.variant(tenv.chain_engine.cc) == "K1"


def test_model_layout_refuses_padded_groups(a1):
    cm = a1[1].chain_engine.cc.cm
    g = cm.groups[1]
    act = g.active.copy()
    act[-1, 0] = False
    padded = dataclasses.replace(
        cm, groups=(cm.groups[0], dataclasses.replace(g, active=act))
        + cm.groups[2:])
    with pytest.raises(NotImplementedError):
        chain_kernel.model_layout(padded)
    short = dataclasses.replace(cm, active=cm.active & (cm.J != cm.J[2, 3]))
    with pytest.raises(NotImplementedError):
        chain_kernel.model_layout(short)


# ------------------------------------------------------ terrain, samplers

def test_trimesh_terrain_identical():
    cfg_j = _cfg(jax_registry, "cassie").terrain
    cfg_t = _cfg(torch_registry, "cassie").terrain
    tj = jax_terrain.Terrain(cfg_j, N, seed=3)
    tt = torch_terrain.Terrain(cfg_t, N, seed=3)
    np.testing.assert_array_equal(tj.height_field_raw, tt.height_field_raw)
    np.testing.assert_array_equal(tj.vertices, tt.vertices)
    np.testing.assert_array_equal(tj.triangles, tt.triangles)
    gj, gt = tj.grid(), tt.grid("cpu")
    assert gj.wall_thresh == gt.wall_thresh == pytest.approx(0.075)
    np.testing.assert_array_equal(np.asarray(gj.height), gt.height.numpy())
    hf = np.array([[0, 0, 40], [0, 0, 40], [0, 0, 0]], np.int16)
    for thr in (0.75, None):
        vj, fj = jax_terrain.convert_heightfield_to_trimesh(hf, 0.1, 0.005,
                                                            thr)
        vt, ft = torch_terrain.convert_heightfield_to_trimesh(hf, 0.1, 0.005,
                                                              thr)
        np.testing.assert_array_equal(vj, vt)
        np.testing.assert_array_equal(fj, ft)


def _grids(h, wall):
    raw = (h / 0.005).astype(np.int16)
    gj = jax_terrain.TerrainGrid(
        height=jnp.asarray(h), raw=jnp.asarray(raw), horizontal_scale=0.1,
        vertical_scale=0.005, border_size=0.0, wall_thresh=wall)
    gt = torch_terrain.TerrainGrid(
        height=torch.as_tensor(h), raw=raw, horizontal_scale=0.1,
        vertical_scale=0.005, border_size=0.0, wall_thresh=wall)
    return gj, gt


def _step_and_slope():
    step = np.zeros((64, 64), np.float32)
    step[20:, :] = 0.2                       # one 0.2 m step at x = 2.0
    slope = np.zeros((64, 64), np.float32)
    slope[:, :] = np.arange(64, dtype=np.float32)[:, None] * 0.005
    return step, slope


def test_sample_bilinear_wall_rule_matches_jax():
    """Global sampler on a step grid and a gentle slope, exact to 1e-6,
    the query on the min corner of a riser cell included (there the global
    rule collapses the cell: spread > threshold)."""
    step, slope = _step_and_slope()
    x = np.array([1.95, 1.99, 2.0, 2.05, 1.9, 1.23, 3.71], np.float32)
    y = np.array([3.0, 3.0, 3.0, 3.0, 3.0, 2.0, 2.5], np.float32)
    for h in (step, slope):
        for wall in (0.075, 0.0):
            gj, gt = _grids(h, wall)
            out_j = jax_hf.sample_bilinear(gj, jnp.asarray(x), jnp.asarray(y))
            out_t = torch_hf.sample_bilinear(gt, torch.as_tensor(x),
                                             torch.as_tensor(y))
            for a, b in zip(out_j, out_t):
                np.testing.assert_allclose(np.asarray(a), b.numpy(),
                                           atol=1e-6)
    gj, gt = _grids(step, 0.075)
    h1, dx1, _ = torch_hf.sample_bilinear(gt, torch.as_tensor(x),
                                          torch.as_tensor(y))
    # a vertical riser: the lower tread up to the gridline, the upper after
    np.testing.assert_allclose(h1[:2].numpy(), 0.0, atol=1e-6)
    np.testing.assert_allclose(dx1[:2].numpy(), 0.0, atol=1e-6)
    np.testing.assert_allclose(h1[2:4].numpy(), 0.2, atol=1e-6)
    # the gentle slope is untouched by the rule
    gj0, gt0 = _grids(slope, 0.0)
    gjw, gtw = _grids(slope, 0.075)
    for a, b in zip(torch_hf.sample_bilinear(gt0, torch.as_tensor(x),
                                             torch.as_tensor(y)),
                    torch_hf.sample_bilinear(gtw, torch.as_tensor(x),
                                             torch.as_tensor(y))):
        assert torch.equal(a, b)


def test_sample_patch_plane_wall_rule_matches_jax(cassie):
    """The kernel's sampler (per-env window) on the same grids, exact to
    1e-6; on the min corner of a riser cell it keeps the bilinear plane
    (strict mq < h) where the global sampler collapses the cell."""
    jenv, tenv = cassie
    S = 24
    step, slope = _step_and_slope()
    rng = np.random.default_rng(0)
    # (2 slots, 2 chains, N envs) queries around x = 2.0, some on gridlines
    x = rng.uniform(1.6, 2.4, (2, 2, N)).astype(np.float32)
    y = rng.uniform(2.5, 3.5, (2, 2, N)).astype(np.float32)
    x[0, 0, 0], x[0, 1, 0], x[1, 0, 0] = 1.9, 2.0, 1.95
    r0 = np.array([8, 9, 10, 11], np.int32)
    c0 = np.array([20, 21, 19, 22], np.int32)
    for h in (step, slope):
        ph = np.stack([h[r:r + S, c:c + S] for r, c in zip(r0, c0)], -1)
        for wall in (0.075, 0.0):
            jcc = dataclasses.replace(jenv.chain_engine.cc, wall_thresh=wall,
                                      border_size=0.0, patch_S=S)
            tcc = dataclasses.replace(tenv.chain_engine.cc, wall_thresh=wall,
                                      border_size=0.0, patch_S=S)
            jcv = {k: jnp.asarray(v) for k, v in
                   jax_chain_step.const_values(jcc, env_nd=1).items()}
            out_j = jax_chain_step.sample_patch_plane(
                jcc, jcv, jnp.asarray(ph), jnp.asarray(r0), jnp.asarray(c0),
                jnp.asarray(x), jnp.asarray(y))
            out_t = chain_step.sample_patch_plane(
                tcc, None, torch.as_tensor(ph), torch.as_tensor(r0),
                torch.as_tensor(c0), torch.as_tensor(x), torch.as_tensor(y))
            for a, b in zip(out_j, out_t):
                np.testing.assert_allclose(np.asarray(a), b.numpy(),
                                           atol=1e-6)
            if wall > 0 and h is step:
                ht, dxt, _ = out_t
                assert float(ht[0, 0, 0]) == 0.0      # min corner: h = 0
                assert float(ht[1, 0, 0]) == 0.0      # mid riser: collapsed
                assert float(dxt[1, 0, 0]) == 0.0
                # ...but the min corner keeps its bilinear gradient
                assert float(dxt[0, 0, 0]) == pytest.approx(2.0, abs=1e-4)
                assert float(ht[0, 1, 0]) == pytest.approx(0.2, abs=1e-6)


# ---------------------------------------------------------- the plain K2

def _riser_args(tenv, state_t):
    """Kernel arguments of a settled cassie whose contact window gets a
    0.1 m riser under a toe: the rows beyond the cell of the left toe's
    first contact point are raised, so that point sits in a cell with a
    0.1 m corner spread (a wall under the rule, a ramp without it)."""
    args = kernel_args(tenv, state_t)
    cc = tenv.chain_engine.cc
    cv = chain_step.const_tensors(cc, "cpu")
    fk = chain_step.fk_chain(cc, cv, *args[7:])
    toe, _ = chain_step.contact_points_group(cc, cv, fk, 1)   # (3,S,K,N)
    hs = tenv.grid.horizontal_scale
    row = torch.floor((toe[0, 0, 0] + tenv.grid.border_size) / hs).long() \
        - args[5].long()
    assert ((row > 0) & (row < cc.patch_S - 2)).all()
    rows = torch.arange(cc.patch_S)[:, None, None]
    args[4] = (args[4] + 0.1 * (rows > row[None, None, :])).contiguous()
    return args


def _six(ref, out, atol=5e-3):
    for i, name in enumerate(("pos", "quat", "vel", "q", "qd", "tau")):
        np.testing.assert_allclose(np.asarray(ref[i]), np.asarray(out[i]),
                                   atol=atol, err_msg=name)


@pytest.mark.parametrize("flag", [{}, {"plane_per_step": False}],
                         ids=["wall", "wall+plane_per_dt"])
def test_plain_k2_matches_jax_and_pallas_interpret(cassie, cassie_settled,
                                                   flag):
    """cassie on trimesh, one policy step from a settled state next to a
    riser: the port's plain version against the JAX plain version and the
    Pallas kernel in interpret mode, atol 5e-3 on the six outputs; the host
    build of the kernel source against the plain version."""
    jenv, tenv = cassie
    state_t = env_state_from_jax(_np_tree(cassie_settled))
    args = _riser_args(tenv, state_t)
    jcc = dataclasses.replace(jenv.chain_engine.cc, **flag)
    tcc = dataclasses.replace(tenv.chain_engine.cc, **flag)
    jargs = [jnp.asarray(a.numpy()) for a in args]
    # eager: compiling the unrolled 6-level step takes longer than running it
    ref = jax_chain_step.run_decimation_chain(jcc, *jargs)
    out = chain_step.run_decimation_chain(tcc, *args)
    _six(ref, [o.numpy() for o in out])
    np.testing.assert_allclose(np.asarray(ref[6]), out[6].numpy(), atol=0.5)
    assert float(out[6][2].sum()) > 100.0            # standing on its toes
    pal = run_decimation_pallas(jcc, *jargs, interpret=True)
    _six(pal, [o.numpy() for o in out])
    if HAS_CXX:
        host = chain_kernel.run_decimation_host(tcc, *args)
        errs = {k: float(v.max())
                for k, v in per_env_errors(out, host).items()}
        tol = tolerances(settled=True)
        assert all(errs[k] <= tol[k] for k in errs), errs
        assert errs["q"] < 1e-4, errs
    if not flag:
        # the wall rule is exercised: without it the step differs
        flat = chain_step.run_decimation_chain(
            dataclasses.replace(tcc, wall_thresh=0.0), *args)
        assert float((flat[2] - out[2]).abs().max()) > 1e-3


# --------------------------------------------------------------- the envs

def _compare_env_step(jenv, tenv, step, state_j, obs_atol=5e-3):
    zeros_j = jnp.zeros((N, jenv.num_actions))
    s_j, tr_j = step(state_j, zeros_j)
    s_t, tr_t = tenv.step(env_state_from_jax(_np_tree(state_j)),
                          torch.zeros((N, tenv.num_actions)))
    np.testing.assert_allclose(np.asarray(tr_j.obs), tr_t.obs.numpy(),
                               atol=obs_atol)
    np.testing.assert_allclose(np.asarray(tr_j.reward), tr_t.reward.numpy(),
                               atol=obs_atol)
    np.testing.assert_array_equal(np.asarray(tr_j.done), tr_t.done.numpy())
    np.testing.assert_allclose(np.asarray(s_j.physics.q),
                               s_t.physics.q.numpy(), atol=1e-4)
    return s_j, s_t


def _compare_rollout(jenv, tenv, step, seed, steps, pos_atol, q_atol):
    """Zero-action rollout from a shared reset. Done flags agree at every
    step; an env that finished was re-drawn from each package's own random
    stream, so the configuration is compared over the envs that never
    finished (at least half of them)."""
    state_j = _jax_reset(jenv, step, seed)
    state_t = env_state_from_jax(_np_tree(state_j))
    zeros_j = jnp.zeros((N, jenv.num_actions))
    zeros_t = torch.zeros((N, tenv.num_actions))
    alive = np.ones(N, bool)
    for _ in range(steps):
        state_j, tr_j = step(state_j, zeros_j)
        state_t, tr_t = tenv.step(state_t, zeros_t)
        np.testing.assert_array_equal(np.asarray(tr_j.done),
                                      tr_t.done.numpy())
        alive &= ~tr_t.done.numpy()
    assert alive.sum() >= N // 2, alive
    np.testing.assert_allclose(np.asarray(state_j.physics.pos)[:, alive],
                               state_t.physics.pos.numpy()[:, alive],
                               atol=pos_atol)
    np.testing.assert_allclose(np.asarray(state_j.physics.q)[:, alive],
                               state_t.physics.q.numpy()[:, alive],
                               atol=q_atol)
    assert torch.isfinite(tr_t.obs).all()
    assert state_t.common_step == int(state_j.common_step)


def test_cassie_env_one_step_from_settled_state(cassie, cassie_step,
                                                cassie_settled):
    jenv, tenv = cassie
    assert tenv.grid.wall_thresh > 0 and tenv.obs_dim == jenv.obs_dim == 169
    _compare_env_step(jenv, tenv, cassie_step, cassie_settled)


def test_cassie_env_rollout_from_reset(cassie, cassie_step):
    _compare_rollout(*cassie, cassie_step, seed=1, steps=25, pos_atol=1e-2,
                     q_atol=2e-2)


def test_cassie_spawn_uses_the_wall_rule(cassie):
    """The spawn's ground probe (sample_bilinear with the wall rule): the
    port's depenetration lift equals the JAX package's on the same draw."""
    jenv, tenv = cassie
    rng = np.random.default_rng(5)
    org = np.asarray(tenv.init_env_origins, np.float32)
    pos = org + np.array([[0.0], [0.0], [1.0]], np.float32)
    pos[:2] += rng.uniform(-3.5, 3.5, (2, N)).astype(np.float32)
    pos[2] -= 0.6                                   # feet start underground
    quat = np.tile(np.array([[0.0], [0.0], [0.0], [1.0]], np.float32), (1, N))
    q = np.tile(np.asarray(tenv.default_dof_pos, np.float32)[:, None], (1, N))
    out_j = jenv._depenetrate_spawn(jnp.asarray(pos), jnp.asarray(quat),
                                    jnp.asarray(q))
    out_t = tenv._depenetrate_spawn(torch.as_tensor(pos),
                                    torch.as_tensor(quat), torch.as_tensor(q))
    np.testing.assert_allclose(np.asarray(out_j), out_t.numpy(), atol=1e-5)
    assert (out_t[2].numpy() > pos[2] + 0.05).all()


def test_a1_env_one_step_and_rollout(a1, a1_step, a1_settled):
    """a1 runs K1 on a layout without a level-0 point group."""
    jenv, tenv = a1
    _compare_env_step(jenv, tenv, a1_step, a1_settled, obs_atol=1e-3)
    _compare_rollout(jenv, tenv, a1_step, seed=1, steps=20, pos_atol=2e-2,
                     q_atol=5e-2)


@pytest.mark.skipif(not HAS_CXX, reason="no host C++ compiler")
def test_host_build_of_a1_layout_matches_plain(a1, a1_settled):
    """On a fresh reset and on the settled state."""
    tenv = a1[1]
    cc = tenv.chain_engine.cc
    for settled in (False, True):
        state = env_state_from_jax(_np_tree(a1_settled)) if settled \
            else tenv.initial_state()
        args = kernel_args(tenv, state)
        ref = chain_step.run_decimation_chain(cc, *args)
        out = chain_kernel.run_decimation_host(cc, *args)
        errs = {k: float(v.max()) for k, v in per_env_errors(ref, out).items()}
        tol = tolerances(settled)
        assert all(errs[k] <= tol[k] for k in errs), errs
        assert errs["q"] < 1e-4, errs
    assert float(ref[6][2].sum()) > 100.0
    lay = chain_kernel.library_layout(chain_kernel.load_library(
        "host", layout=chain_kernel.model_layout(cc.cm)))
    assert (lay["L"], lay["K"], lay["S"], lay["NPTS"]) == (3, 4, (8, 0, 8, 9),
                                                           76)
