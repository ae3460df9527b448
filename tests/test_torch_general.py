"""The general stacked engine of the PyTorch port against the JAX package,
on the CPU: the contact and self-collision laws, the windowed bilinear
sampler, the self-collision pair lists, the applied UniNet and one sim dt
of ``Engine.step_pos_targets`` / ``step_torques``; then the port's own
check of its plain chain step against its general engine (the JAX
package's tests/test_chain_engine.py, in torch only).

Inputs are made once from a numpy seed (or settled by the port's env) and
handed to both packages. The JAX engines are built with the port's probed
constants (cp_m_eff, ...; held against the JAX probe in
tests/test_torch_sea.py and tests/test_torch_physics.py), so each one-sim-dt
case compiles one small JAX program and no JAX env.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from legged_gym_tpu import assets as jax_assets
from legged_gym_tpu.actuators.uninet import UniNet as JaxUniNet
from legged_gym_tpu.model.robot import compile_model as jax_compile_model
from legged_gym_tpu.physics import contact as jax_contact
from legged_gym_tpu.physics import engine as jax_engine
from legged_gym_tpu.physics.state import PhysicsState as JaxPhysicsState
from legged_gym_tpu.terrain import heightfield as jax_hf
from legged_gym_tpu.terrain import terrain as jax_terrain
from legged_gym_tpu_torch import assets as torch_assets
from legged_gym_tpu_torch import registry as torch_registry
from legged_gym_tpu_torch.actuators.uninet import UniNet
from legged_gym_tpu_torch.model.robot import compile_model
from legged_gym_tpu_torch.physics import contact as torch_contact
from legged_gym_tpu_torch.physics.chain_engine import ChainEngine
from legged_gym_tpu_torch.physics.engine import Engine, SimConfig
from legged_gym_tpu_torch.terrain import heightfield as torch_hf
from legged_gym_tpu_torch.terrain import terrain as torch_terrain
from legged_gym_tpu_torch.terrain.heightfield import (TerrainPatch,
                                                      extract_patches)

# one intra-op thread: the tensors are a few envs wide and the test
# workers share the cores (more threads only spin and slow them)
torch.set_num_threads(1)

N = 4
GO1 = "{ASSETS}/robots/go1/urdf/go1.urdf"
ANYMAL = "{ASSETS}/robots/anymal_c/urdf/anymal_c.urdf"
UNINET = "{ASSETS}/actuator_nets/go1_net.pt"
# contact and self-collision laws on random inputs
LAW_RTOL, LAW_ATOL = 1e-5, 1e-4          # N
# one sim dt from a settled state (tests/test_chain_engine.py:72-82)
Q_ATOL, QD_ATOL, TAU_ATOL = 2e-5, 5e-3, 5e-3
BODY_F_ATOL, BODY_F_RTOL = 2e-2, 5e-3


def _models(urdf, **kw):
    return (jax_compile_model(jax_assets.resolve(urdf), **kw),
            compile_model(torch_assets.resolve(urdf), **kw))


@pytest.fixture(scope="module")
def go1_models():
    return _models(GO1)


@pytest.fixture(scope="module")
def anymal_models():
    return _models(ANYMAL)


def _grids(h, wall, hs=0.1, border=1.0):
    raw = np.round(h / 0.005).astype(np.int16)
    gj = jax_terrain.TerrainGrid(
        height=jnp.asarray(h), raw=jnp.asarray(raw), horizontal_scale=hs,
        vertical_scale=0.005, border_size=border, wall_thresh=wall)
    gt = torch_terrain.TerrainGrid(
        height=torch.as_tensor(h), raw=raw, horizontal_scale=hs,
        vertical_scale=0.005, border_size=border, wall_thresh=wall)
    return gj, gt


def _terrain(kind, rng):
    """A 60 x 60 grid: 'plane' (None), 'heightfield' (rough, smooth
    enough for the bilinear law) or 'trimesh' (a 0.2 slope with steps of
    0.1-0.2 m, the wall rule on)."""
    if kind == "plane":
        return None, None
    if kind == "heightfield":
        h = rng.uniform(-0.05, 0.05, (60, 60)).astype(np.float32)
        return _grids(h, 0.0)
    h = (rng.integers(0, 3, (12, 12)) * 0.1).astype(np.float32)
    h = np.kron(h, np.ones((5, 5), np.float32)) \
        + 0.02 * np.arange(60, dtype=np.float32)[:, None]
    return _grids(h, 0.075)


def _patches(grid_t, x, y, size=32):
    """The same per-env window for both packages: (JAX TerrainPatch,
    port TerrainPatch)."""
    h, r0, c0 = extract_patches(grid_t, torch.as_tensor(x),
                                torch.as_tensor(y), size)
    pj = jax_hf.TerrainPatch(h=jnp.asarray(h.numpy()),
                             r0=jnp.asarray(r0.numpy()),
                             c0=jnp.asarray(c0.numpy()))
    return pj, TerrainPatch(h=h, r0=r0, c0=c0)


def _close(a, b, rtol, atol, msg=""):
    np.testing.assert_allclose(np.asarray(a), b.numpy() if torch.is_tensor(b)
                               else np.asarray(b), rtol=rtol, atol=atol,
                               err_msg=msg)


# ---------------------------------------------------------- the samplers

@pytest.mark.parametrize("kind", ["heightfield", "trimesh"])
def test_patch_sample_bilinear_matches_jax(kind):
    """The windowed sampler (four corner gathers and, on trimesh, the wall
    grid) against the JAX package's one-hot contractions, and against the
    global sampler away from the window's edge; rtol 1e-5 / atol 1e-4."""
    rng = np.random.default_rng(1)
    gj, gt = _terrain(kind, rng)
    cx = rng.uniform(1.0, 3.0, N).astype(np.float32)
    cy = rng.uniform(1.0, 3.0, N).astype(np.float32)
    pj, pt = _patches(gt, cx, cy)
    x = (cx[None] + rng.uniform(-1.2, 1.2, (9, N))).astype(np.float32)
    y = (cy[None] + rng.uniform(-1.2, 1.2, (9, N))).astype(np.float32)
    out_j = jax_hf.patch_sample_bilinear(gj, pj, jnp.asarray(x),
                                         jnp.asarray(y))
    out_t = torch_hf.patch_sample_bilinear(gt, pt, torch.as_tensor(x),
                                           torch.as_tensor(y))
    glob = torch_hf.sample_bilinear(gt, torch.as_tensor(x),
                                    torch.as_tensor(y))
    for a, b, c, name in zip(out_j, out_t, glob, ("h", "dhdx", "dhdy")):
        _close(a, b, LAW_RTOL, LAW_ATOL, name)
        _close(c, b, LAW_RTOL, LAW_ATOL, name)
    assert float(out_t[1].abs().max()) > 0.1
    if kind == "trimesh":
        walled = torch_hf._wall_grid(pt.h, gt.wall_thresh) < 1e8
        np.testing.assert_array_equal(
            walled.numpy(),
            np.asarray(jax_hf._wall_grid(pj.h, gj.wall_thresh)) < 1e8)
        assert walled.any()


# --------------------------------------------------------- the contact law

def _contact_inputs(model, rng, grid_t):
    """Random points within 3 cm of the surface, random velocities,
    per-point masses of a robot's order, anchors half live and half stale
    or at the sentinel."""
    P = len(model.cp_link)
    x = rng.uniform(1.0, 3.0, (P, N)).astype(np.float32)
    y = rng.uniform(1.0, 3.0, (P, N)).astype(np.float32)
    ground = (np.zeros_like(x) if grid_t is None else torch_hf.sample_bilinear(
        grid_t, torch.as_tensor(x), torch.as_tensor(y))[0].numpy())
    z = (ground + model.cp_radius[:, None]
         + rng.uniform(-0.03, 0.01, (P, N))).astype(np.float32)
    pos = np.stack([x, y, z])
    vel = rng.normal(0.0, 0.5, (3, P, N)).astype(np.float32)
    anchors = (pos + rng.normal(0.0, 0.01, (3, P, N))).astype(np.float32)
    anchors[:, ::3] = torch_contact.ANCHOR_SENTINEL
    anchors[:, 1::4] += 0.2                                   # stale
    masses = dict(
        m_eff=rng.uniform(0.3, 2.0, P), m_eff_t=rng.uniform(0.1, 1.0, P),
        v_max=rng.uniform(0.5, 1.5, P), k_static=rng.uniform(1e3, 3e4, P))
    friction = rng.uniform(0.5, 1.25, N).astype(np.float32)
    return pos, vel, anchors, masses, friction


@pytest.mark.parametrize("anchored", [False, True], ids=["plain", "anchors"])
@pytest.mark.parametrize("kind", ["plane", "heightfield", "trimesh"])
def test_contact_forces_match_jax(go1_models, kind, anchored):
    """contact_forces on random inputs (the per-env window on the
    heightfield, the global sampler with the wall rule on trimesh), with
    and without the anchored static friction: forces and new anchors at
    rtol 1e-5 / atol 1e-4 N (m for anchors).

    On trimesh the JAX package's windowed sampler (one-hot contractions)
    and its global one differ by one float32 ulp in h at some points,
    which the law's depth / dt turns into up to 3e-3 N (ROADMAP.md Queue
    3); the port's windowed sampler equals the global one in h, and
    test_patch_sample_bilinear_matches_jax holds it on trimesh."""
    jm, tm = go1_models
    rng = np.random.default_rng(2)
    gj, gt = _terrain(kind, rng)
    pos, vel, anchors, masses, friction = _contact_inputs(tm, rng, gt)
    pj = pt = None
    if kind == "heightfield":
        pj, pt = _patches(gt, pos[0].mean(0), pos[1].mean(0))
    cfg_j = jax_contact.ContactConfig(warm_start=anchored)
    cfg_t = torch_contact.ContactConfig(warm_start=anchored)
    dt = 0.005
    out_j = jax_contact.contact_forces(
        jm, gj, cfg_j, jnp.asarray(pos), jnp.asarray(vel),
        jnp.asarray(friction), dt=dt, patch=pj,
        f_prev=jnp.asarray(anchors) if anchored else None, **masses)
    out_t = torch_contact.contact_forces(
        tm, gt, cfg_t, torch.as_tensor(pos), torch.as_tensor(vel),
        torch.as_tensor(friction), dt=dt, patch=pt,
        f_prev=torch.as_tensor(anchors) if anchored else None,
        **{k: torch.as_tensor(v, dtype=torch.float32)[:, None]
           for k, v in masses.items()})
    if anchored:
        (f_j, a_j), (f_t, a_t) = out_j, out_t
        _close(a_j, a_t, LAW_RTOL, LAW_ATOL, "anchors")
        assert (a_t.numpy() != anchors).any()
    else:
        f_j, f_t = out_j, out_t
    _close(f_j, f_t, LAW_RTOL, LAW_ATOL, "f_pts")
    assert float(f_t[2].max()) > 10.0 and float(f_t[2].min()) == 0.0
    # the per-link and per-body sums are a gather in point order
    bj = jax_contact.accumulate_body_forces(jm, f_j)
    bt = torch_contact.accumulate_body_forces(tm, f_t)
    _close(bj, bt, LAW_RTOL, LAW_ATOL, "body forces")


def test_self_collision_forces_match_jax(anymal_models):
    """SelfCollision against the JAX package's self_collision_forces on
    anymal's candidate pairs, points packed in a 0.3 m box so that many
    pairs overlap: rtol 1e-5 / atol 1e-4 N; no net force on the robot;
    the per-point source table is as wide as the most pairs one point is
    in; a second call gives the same forces."""
    jm, tm = anymal_models
    pairs = torch_contact.self_collision_candidate_pairs(tm)
    rng = np.random.default_rng(3)
    P = len(tm.cp_link)
    pos = rng.uniform(-0.15, 0.15, (3, P, N)).astype(np.float32)
    vel = rng.normal(0.0, 1.0, (3, P, N)).astype(np.float32)
    m_eff = rng.uniform(0.3, 3.0, P)
    f_j = jax_contact.self_collision_forces(
        jm, jnp.asarray(pairs), jnp.asarray(pos), jnp.asarray(vel), 0.00125,
        m_eff)
    sc = torch_contact.SelfCollision(tm, pairs, m_eff)
    f_t = sc(torch.as_tensor(pos), torch.as_tensor(vel), 0.00125)
    _close(f_j, f_t, LAW_RTOL, LAW_ATOL, "self-collision")
    assert float(f_t.abs().max()) > 100.0
    # an equal and opposite pair: no net force on the robot
    torch.testing.assert_close(f_t.sum(dim=1), torch.zeros(3, N), rtol=0,
                               atol=1e-2)
    assert sc.table.shape == (P, int(
        np.bincount(pairs.ravel(), minlength=P).max()))
    again = sc(torch.as_tensor(pos), torch.as_tensor(vel), 0.00125)
    assert torch.equal(again, f_t)


def test_self_collision_pairs_are_jax_pair_lists(anymal_models):
    """The candidate pairs and the rest filter give the JAX package's pair
    lists: anymal's 150 at the default margin, and a shorter list at a
    margin wide enough to drop some."""
    jm, tm = anymal_models
    cand = torch_contact.self_collision_candidate_pairs(tm)
    np.testing.assert_array_equal(
        cand, jax_contact.self_collision_candidate_pairs(jm))
    assert cand.dtype == np.int32 and cand.shape == (150, 2)
    cfg, _ = torch_registry.get_cfgs("anymal_c_flat")
    q0 = np.array([cfg.init_state.default_joint_angles[n]
                   for n in tm.dof_names])
    kept = []
    for margin in (1.2, 4.0):
        je = jax_engine.Engine(jm, jax_engine.SimConfig(),
                               self_collision=True)
        te = Engine(tm, SimConfig(), self_collision=True)
        je.filter_self_collision_pairs(q0, margin=margin)
        te.filter_self_collision_pairs(q0, margin=margin)
        np.testing.assert_array_equal(te.sc_pairs, je.sc_pairs)
        kept.append(len(te.sc_pairs))
    assert kept[0] == 150 and 0 < kept[1] < 150
    assert Engine(tm, SimConfig()).sc_pairs is None


# -------------------------------------------------------------- UniNet

def test_uninet_matches_jax_over_three_calls():
    """UniNet from the same .pt file in both packages, three calls of
    history on random inputs: dVel and the (12, 5, N) history buffers at
    rtol 1e-4 / atol 1e-5 (tests/test_actuators.py)."""
    path = torch_assets.resolve(UNINET)
    net, jnet = UniNet(path), JaxUniNet(path)
    assert isinstance(net, torch.nn.Module)
    for l, (w, b) in enumerate(jnet.weights):
        np.testing.assert_array_equal(getattr(net, f"w{l}").numpy(),
                                      np.asarray(w))
        np.testing.assert_array_equal(getattr(net, f"b{l}")[:, 0].numpy(),
                                      np.asarray(b))
    rng = np.random.default_rng(4)
    st, sj = net.init_state(N), jnet.init_state(N)
    assert tuple(st["pos_err"].shape) == (12, 5, N)
    for _ in range(3):
        tq, q = (rng.normal(0.0, 0.3, (12, N)).astype(np.float32)
                 for _ in range(2))
        qd = rng.normal(0.0, 3.0, (12, N)).astype(np.float32)
        d_t, st = net(*(torch.as_tensor(a) for a in (tq, q, qd)), st)
        d_j, sj = jnet(*(jnp.asarray(a) for a in (tq, q, qd)), sj)
        _close(d_j, d_t, 1e-4, 1e-5, "dVel")
        for k in ("pos_err", "vel"):
            _close(sj[k], st[k], 1e-4, 1e-5, k)
    assert float(d_t.abs().min()) > 0.0
    assert (st["vel"][:, 2:].abs() > 0).all() and (st["vel"][:, :2] == 0).all()


# ------------------------------------------------- one sim dt vs the JAX engine

def _env_cfg(task, n=N, **over):
    cfg, _ = torch_registry.get_cfgs(task)
    cfg.env.num_envs = n
    cfg.terrain.num_rows = 2
    cfg.terrain.num_cols = 2
    cfg.noise.add_noise = False
    cfg.domain_rand.push_robots = False
    cfg.domain_rand.randomize_friction = False
    cfg.domain_rand.randomize_base_mass = False
    cfg.domain_rand.randomize_limb_mass = False
    for path, value in over.items():
        obj = cfg
        *head, last = path.split(".")
        for h in head:
            obj = getattr(obj, h)
        setattr(obj, last, value)
    return cfg


def _settle(tenv, steps=20):
    state = tenv.initial_state()
    zeros = torch.zeros((tenv.num_envs, tenv.num_actions))
    for _ in range(steps):
        state, tr = tenv.step(state, zeros)
        assert not tr.done.any()
    return state


def _jax_engine_like(tenv):
    """The JAX package's Engine for the port env's robot, terrain and
    gains, with the port's probed constants and pair list."""
    te = tenv.engine
    c = te.sim.contact
    sim = jax_engine.SimConfig(
        dt=te.sim.dt, substeps=te.sim.substeps, gravity=te.sim.gravity,
        contact=jax_contact.ContactConfig(
            warm_start=c.warm_start, terrain_friction=c.terrain_friction,
            anchor_release_depth=c.anchor_release_depth))
    grid = None
    if tenv.grid is not None:
        g = tenv.grid
        grid = jax_terrain.TerrainGrid(
            height=jnp.asarray(g.height.numpy()), raw=jnp.asarray(g.raw),
            horizontal_scale=g.horizontal_scale,
            vertical_scale=g.vertical_scale, border_size=g.border_size,
            wall_thresh=g.wall_thresh)
    cfg = tenv.cfg
    jm = jax_compile_model(
        jax_assets.resolve(cfg.asset.file),
        collapse_fixed_joints=cfg.asset.collapse_fixed_joints,
        armature=cfg.asset.armature)
    je = jax_engine.Engine(jm, sim, grid=grid, kp=te.kp, kd=te.kd,
                           fixed_base=te.fixed_base,
                           lin_damping=te.lin_damping,
                           ang_damping=te.ang_damping)
    for name in ("cp_m_eff", "cp_m_eff_t", "cp_vmax", "cp_k_static"):
        setattr(je, name, getattr(te, name).copy())
    je.sc_pairs = None if te.sc_pairs is None else te.sc_pairs.copy()
    return je


def _jax_phys(p):
    j = lambda t: jnp.asarray(t.numpy())
    return JaxPhysicsState(pos=j(p.pos), quat=j(p.quat), vel=j(p.vel),
                           q=j(p.q), qd=j(p.qd))


def _compare_sim_dt(out_j, out_t, anchored=False):
    (pj, ij), (pt, it) = out_j[:2], out_t[:2]
    _close(pj.q, pt.q, 0, Q_ATOL, "q")
    _close(pj.qd, pt.qd, 0, QD_ATOL, "qd")
    _close(pj.pos, pt.pos, 0, Q_ATOL, "pos")
    _close(ij.torques, it.torques, TAU_ATOL, TAU_ATOL, "tau")
    _close(ij.body_forces, it.body_forces, BODY_F_RTOL, BODY_F_ATOL,
           "body_f")
    assert float(it.body_forces[2].sum()) > 100.0        # standing
    if anchored:
        _close(out_j[2], out_t[2], 0, 1e-4, "anchors")


@pytest.mark.parametrize("case", ["go1_heightfield", "anymal_self_contact",
                                  "go1_body_damping"])
def test_one_sim_dt_matches_jax_engine(case):
    """Engine.step_pos_targets / step_torques, one sim dt from a state the
    port's env settled on the general engine, against the JAX engine's
    (one jitted sim dt): q / pos 2e-5, qd 5e-3, tau 5e-3, body_f 2e-2 +
    5e-3 rel (tests/test_chain_engine.py:72-82)."""
    if case == "go1_heightfield":
        cfg = _env_cfg("go1", **{"terrain.mesh_type": "heightfield",
                                 "sim.use_chain_engine": False})
    elif case == "anymal_self_contact":
        cfg = _env_cfg("anymal_c_flat")
    else:
        cfg = _env_cfg("go1", **{"asset.linear_damping": 0.3,
                                 "asset.angular_damping": 0.5})
    tenv, _ = torch_registry.make_env(cfg=cfg, device="cpu")
    assert tenv.chain_engine is None
    state = _settle(tenv)
    te, je = tenv.engine, _jax_engine_like(tenv)
    phys, lp, fric = state.physics, state.link_params, state.friction
    rng = np.random.default_rng(5)
    if case == "anymal_self_contact":
        assert te.has_self_collision and tenv._warm_start
        tau = rng.normal(0.0, 30.0, phys.q.shape).astype(np.float32)
        ws = state.contact_ws
        assert tuple(ws.shape) == (3, 22, N)
        assert float((ws < 1e5).float().mean()) > 0.15
        step_j = jax.jit(lambda p, t, w: je.step_torques(
            p, jnp.asarray(lp.numpy()), jnp.asarray(fric.numpy()), t,
            f_ws=w))
        out_j = step_j(_jax_phys(phys), jnp.asarray(tau),
                       jnp.asarray(ws.numpy()))
        out_t = te.step_torques(phys, lp, fric, torch.as_tensor(tau),
                                f_ws=ws)
        _compare_sim_dt(out_j, out_t, anchored=True)
        return
    assert te.grid is tenv.grid
    targets = (tenv._dflt + torch.as_tensor(
        rng.normal(0.0, 0.2, phys.q.shape).astype(np.float32)))
    pj = pt = None
    if tenv.grid is not None:
        pt = TerrainPatch(h=state.patch, r0=state.patch_r0,
                          c0=state.patch_c0)
        pj = jax_hf.TerrainPatch(h=jnp.asarray(pt.h.numpy()),
                                 r0=jnp.asarray(pt.r0.numpy()),
                                 c0=jnp.asarray(pt.c0.numpy()))
    step_j = jax.jit(lambda p, t, pa: je.step_pos_targets(
        p, jnp.asarray(lp.numpy()), jnp.asarray(fric.numpy()), t, patch=pa))
    out_j = step_j(_jax_phys(phys), jnp.asarray(targets.numpy()), pj)
    out_t = te.step_pos_targets(phys, lp, fric, targets, patch=pt)
    _compare_sim_dt(out_j, out_t)
    if case == "go1_body_damping":
        # the drag is there: the same step without it differs
        te.lin_damping, te.ang_damping = 0.0, 0.0
        undamped = te.step_pos_targets(phys, lp, fric, targets, patch=pt)
        assert float((undamped[0].vel - out_t[0].vel).abs().max()) > 1e-5


# ----------------------------------------- the port's chain vs general engine

def _general_rollout(env, phys, lp, fric, targets, steps):
    """``steps`` policy steps of the general engine, the window extracted
    per policy step (tests/test_chain_engine.py:_ref_rollout)."""
    eng = env.engine
    info = None
    for _ in range(steps):
        patch = None
        if env.grid is not None:
            h, r0, c0 = extract_patches(env.grid, phys.pos[0], phys.pos[1])
            patch = TerrainPatch(h=h, r0=r0, c0=c0)
        for _ in range(env.cfg.control.decimation):
            phys, info = eng.step_pos_targets(phys, lp, fric, targets,
                                              patch=patch)
    return phys, info


def _chain_rollout(ce, phys, lp, fric, targets, steps):
    out = None
    for _ in range(steps):
        out = ce.step_decimation_pos(phys, lp, fric, targets)
        phys = out[0]
    return phys, out[1], out[2]


@pytest.mark.parametrize("mesh", ["plane", "heightfield"])
def test_port_chain_matches_port_general_engine(mesh):
    """The port's plain chain step with the plane re-sampled per sim dt
    against its general engine on go1 at 8 envs, with
    tests/test_chain_engine.py's tolerances: one settled step (q 2e-5, qd
    5e-3, body_f 2e-2 + 5e-3 rel, tau 5e-3 + 5e-3 rel), 20 steps from a
    reset (pos, q 5e-3), and the default per-policy-step plane close to
    the exact one (pos 2e-2, q 5e-2)."""
    n = 8
    cfg = _env_cfg("go1", n=n, **{"terrain.mesh_type": mesh})
    env, _ = torch_registry.make_env(cfg=cfg, device="cpu")
    assert env.chain_engine is not None
    ce = ChainEngine(env.engine, decimation=cfg.control.decimation,
                     plane_per_step=False)
    ce.bind_grid(env.grid)
    state, _ = env.reset()
    phys, lp, fric = state.physics, state.link_params, state.friction
    targets = env._dflt.expand(env.num_dof, n).clone()
    with torch.no_grad():
        p_set, _ = _general_rollout(env, phys, lp, fric, targets, 30)
        p_ref1, info1 = _general_rollout(env, p_set, lp, fric, targets, 1)
        p_new1, tau1, body_f1 = _chain_rollout(ce, p_set, lp, fric,
                                               targets, 1)
        _close(p_ref1.q, p_new1.q, 0, 2e-5, "q")
        _close(p_ref1.qd, p_new1.qd, 0, 5e-3, "qd")
        _close(info1.body_forces, body_f1, 5e-3, 2e-2, "body_f")
        _close(info1.torques, tau1, 5e-3, 5e-3, "tau")
        assert float(body_f1[2].sum()) > 100.0
        p_ref, _ = _general_rollout(env, phys, lp, fric, targets, 20)
        p_new, _, _ = _chain_rollout(ce, phys, lp, fric, targets, 20)
        _close(p_ref.pos, p_new.pos, 0, 5e-3, "pos")
        _close(p_ref.q, p_new.q, 0, 5e-3, "q")
        p_fast, _, _ = _chain_rollout(env.chain_engine, phys, lp, fric,
                                      targets, 20)
        _close(p_ref.pos, p_fast.pos, 0, 2e-2, "pos (plane per step)")
        _close(p_ref.q, p_fast.q, 0, 5e-2, "q (plane per step)")
