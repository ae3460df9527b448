"""The general tree's prismatic joints and the explicit spring contact law
of the PyTorch port against the JAX package, on the CPU.

- Prismatic joints: a model written inline (a floating base with a
  prismatic slider, a revolute knee after it, and a revolute tail on the
  base, so the first tree level mixes a prismatic and a revolute joint),
  compiled by both packages' ``model/robot.py``: forward kinematics,
  contact-point kinematics and ABA with external wrenches on a seeded
  random state at atol 1e-5, then three ``Engine.step_pos_targets`` sim
  dts on the plane at the JAX package's engine tolerance, 5e-3
  (tests/test_chain_engine.py:140-144); the env takes the general engine
  for it from its config, and the chain engine refuses it.
- The explicit law (``ContactConfig(implicit=False)``): ``contact_forces``
  on seeded points near a plane and a small heightfield at atol 1e-4 N,
  then one general-engine sim dt of the 2-dof hopper of
  tests/test_torch_mpc.py with it; the chain engine refuses it.

No JAX env is built: the JAX side is a few small jitted functions of the
two models.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from legged_gym_tpu.model.robot import compile_model as jax_compile_model
from legged_gym_tpu.physics import aba as jax_aba
from legged_gym_tpu.physics import contact as jax_contact
from legged_gym_tpu.physics import engine as jax_engine
from legged_gym_tpu.physics import kinematics as jax_kin
from legged_gym_tpu.physics.state import PhysicsState as JaxPhysicsState
from legged_gym_tpu.terrain import terrain as jax_terrain
from legged_gym_tpu_torch.config import LeggedRobotCfg
from legged_gym_tpu_torch.envs.legged_env import LeggedEnv
from legged_gym_tpu_torch.model.robot import compile_model
from legged_gym_tpu_torch.physics import aba, contact, kinematics
from legged_gym_tpu_torch.physics.chain_engine import ChainEngine
from legged_gym_tpu_torch.physics.chains import NotChainStructured
from legged_gym_tpu_torch.physics.engine import Engine, SimConfig
from legged_gym_tpu_torch.physics.params import broadcast_nominal
from legged_gym_tpu_torch.physics.state import PhysicsState
from legged_gym_tpu_torch.terrain import terrain as torch_terrain

# one intra-op thread: the tensors are a few envs wide and the test
# workers share the cores
torch.set_num_threads(1)

N = 4
FK_ATOL = 1e-5                 # forward kinematics and ABA
STEP_ATOL = 5e-3               # sim dts (tests/test_chain_engine.py:140-144)
LAW_ATOL = 1e-4                # N, the contact law on random points

SLIDER = """
<robot name="slider">
  <link name="base">
    <inertial><mass value="2.0"/><origin xyz="0 0 0"/>
      <inertia ixx="0.02" iyy="0.03" izz="0.02" ixy="0" ixz="0" iyz="0"/>
    </inertial>
    <collision><origin xyz="0 0 0"/><geometry><sphere radius="0.08"/></geometry></collision>
  </link>
  <link name="carriage">
    <inertial><mass value="0.4"/><origin xyz="0 0 -0.02"/>
      <inertia ixx="0.001" iyy="0.001" izz="0.001" ixy="0" ixz="0" iyz="0"/>
    </inertial>
  </link>
  <joint name="slide_joint" type="prismatic">
    <parent link="base"/><child link="carriage"/>
    <origin xyz="0.02 0 -0.05"/><axis xyz="0 0.6 0.8"/>
    <limit lower="-0.1" upper="0.1" effort="60" velocity="3"/>
  </joint>
  <link name="leg_foot">
    <inertial><mass value="0.2"/><origin xyz="0 0 -0.1"/>
      <inertia ixx="0.001" iyy="0.001" izz="0.0002" ixy="0" ixz="0" iyz="0"/>
    </inertial>
    <collision><origin xyz="0 0 -0.2"/><geometry><sphere radius="0.03"/></geometry></collision>
  </link>
  <joint name="knee_joint" type="revolute">
    <parent link="carriage"/><child link="leg_foot"/>
    <origin xyz="0 0 -0.05"/><axis xyz="0 1 0"/>
    <limit lower="-1.5" upper="1.5" effort="30" velocity="20"/>
  </joint>
  <link name="tail">
    <inertial><mass value="0.3"/><origin xyz="-0.1 0 0"/>
      <inertia ixx="0.0005" iyy="0.001" izz="0.001" ixy="0" ixz="0" iyz="0"/>
    </inertial>
  </link>
  <joint name="tail_joint" type="revolute">
    <parent link="base"/><child link="tail"/>
    <origin xyz="-0.1 0 0"/><axis xyz="0 0 1"/>
    <limit lower="-1.0" upper="1.0" effort="10" velocity="20"/>
  </joint>
</robot>
"""

HOPPER = """
<robot name="hopper">
  <link name="base">
    <inertial><mass value="3.0"/><origin xyz="0 0 0"/>
      <inertia ixx="0.02" iyy="0.02" izz="0.02" ixy="0" ixz="0" iyz="0"/>
    </inertial>
    <collision><origin xyz="0 0 0"/><geometry><sphere radius="0.08"/></geometry></collision>
  </link>
  <link name="thigh">
    <inertial><mass value="0.5"/><origin xyz="0 0 -0.1"/>
      <inertia ixx="0.002" iyy="0.002" izz="0.0005" ixy="0" ixz="0" iyz="0"/>
    </inertial>
  </link>
  <joint name="hip_joint" type="revolute">
    <parent link="base"/><child link="thigh"/>
    <origin xyz="0 0 -0.05"/><axis xyz="0 1 0"/>
    <limit lower="-1.5" upper="1.5" effort="30" velocity="20"/>
  </joint>
  <link name="shank_foot">
    <inertial><mass value="0.2"/><origin xyz="0 0 -0.1"/>
      <inertia ixx="0.001" iyy="0.001" izz="0.0002" ixy="0" ixz="0" iyz="0"/>
    </inertial>
    <collision><origin xyz="0 0 -0.2"/><geometry><sphere radius="0.03"/></geometry></collision>
  </link>
  <joint name="knee_joint" type="revolute">
    <parent link="thigh"/><child link="shank_foot"/>
    <origin xyz="0 0 -0.2"/><axis xyz="0 1 0"/>
    <limit lower="-2.0" upper="2.0" effort="30" velocity="20"/>
  </joint>
</robot>
"""


@pytest.fixture(scope="module")
def urdfs(tmp_path_factory):
    d = tmp_path_factory.mktemp("general_tree")
    out = {}
    for name, text in (("slider", SLIDER), ("hopper", HOPPER)):
        (d / f"{name}.urdf").write_text(text)
        out[name] = str(d / f"{name}.urdf")
    return out


def _models(path):
    return jax_compile_model(path), compile_model(path)


def _close(j, t, atol, rtol=0.0, msg=""):
    np.testing.assert_allclose(np.asarray(j), t.detach().numpy(), atol=atol,
                               rtol=rtol, err_msg=msg)


def _states(nq, rng, z=0.0):
    """A seeded random state in both packages: any orientation, joint
    and base rates of a walking robot (~0.3 rad/s, m/s)."""
    quat = rng.normal(size=(4, N))
    quat /= np.linalg.norm(quat, axis=0, keepdims=True)
    st = dict(pos=rng.normal(0.0, 0.3, (3, N)) + np.array([[0], [0], [z]]),
              quat=quat, vel=rng.normal(0.0, 0.3, (6, N)),
              q=rng.normal(0.0, 0.1, (nq, N)),
              qd=rng.normal(0.0, 0.3, (nq, N)))
    st = {k: v.astype(np.float32) for k, v in st.items()}
    return (JaxPhysicsState(**{k: jnp.asarray(v) for k, v in st.items()}),
            PhysicsState(**{k: torch.as_tensor(v) for k, v in st.items()}))


# ------------------------------------------------------- prismatic joints

def test_prismatic_kinematics_and_aba_match_jax(urdfs):
    jm, tm = _models(urdfs["slider"])
    assert list(tm.joint_is_prismatic) == list(jm.joint_is_prismatic)
    assert int(tm.joint_is_prismatic.sum()) == 1
    levels = kinematics.tree_levels(tm)
    assert any(tm.joint_is_prismatic[lv].any()
               and not tm.joint_is_prismatic[lv].all() for lv in levels)
    rng = np.random.default_rng(11)
    js, ts = _states(tm.nq, rng)
    f_pts = rng.normal(0.0, 1.0, (3, len(tm.cp_link), N)).astype(np.float32)
    lp = broadcast_nominal(tm, N)
    tau = rng.normal(0.0, 0.5, (tm.nq, N)).astype(np.float32)
    imp = np.full(tm.nq, 0.01, np.float32)

    @jax.jit
    def jax_side(js, f_pts, lp, tau):
        jfk = jax_kin.forward_kinematics(jm, js)
        jp, jv = jax_kin.contact_point_kinematics(jm, jfk)
        jf, jn = jax_contact.accumulate_link_wrenches(jm, jfk, jp, f_pts)
        return jfk, jp, jv, jax_aba.aba(jm, lp, jfk, js.qd, tau, f_ext_w=jf,
                                        n_ext_w=jn, implicit_d=imp)

    jfk, jp, jv, (ja0, jqdd) = jax_side(js, jnp.asarray(f_pts),
                                        jnp.asarray(lp.numpy()),
                                        jnp.asarray(tau))
    tfk = kinematics.forward_kinematics(tm, ts)
    tp, tv = kinematics.contact_point_kinematics(tm, tfk)
    for f in ("R_w", "p_w", "v_ang", "v_lin", "R_loc", "p_loc"):
        _close(getattr(jfk, f), getattr(tfk, f), FK_ATOL, msg=f)
    _close(jp, tp, FK_ATOL, msg="cp_pos")
    _close(jv, tv, FK_ATOL, msg="cp_vel")
    # the slider moves its child along the axis by q
    j = int(np.nonzero(tm.joint_is_prismatic)[0][0])
    axis = torch.as_tensor(tm.joint_axis[j], dtype=torch.float32)
    off = tfk.p_loc[:, j] - torch.as_tensor(tm.joint_pos[j],
                                            dtype=torch.float32)[:, None]
    torch.testing.assert_close(off, axis[:, None] * ts.q[j][None],
                               atol=1e-6, rtol=0)

    tf, tn = contact.accumulate_link_wrenches(tm, tfk, tp,
                                              torch.as_tensor(f_pts))
    ta0, tqdd = aba.aba(tm, lp, tfk, ts.qd, torch.as_tensor(tau),
                        f_ext_w=tf, n_ext_w=tn,
                        gravity=torch.tensor([0.0, 0.0, -9.81]).view(3, 1, 1),
                        implicit_d=torch.as_tensor(imp)[:, None])
    _close(ja0, ta0, FK_ATOL, msg="a_base")
    _close(jqdd, tqdd, FK_ATOL, msg="qdd")


def _engines(jm, tm, contact_cfg_kw, kp, kd):
    """The port's Engine and the JAX package's on the same model, the
    JAX one given the port's apparent-mass constants."""
    te = Engine(tm, SimConfig(contact=contact.ContactConfig(**contact_cfg_kw)),
                kp=kp, kd=kd)
    je = jax_engine.Engine(
        jm, jax_engine.SimConfig(
            contact=jax_contact.ContactConfig(**contact_cfg_kw)),
        kp=kp, kd=kd)
    for name in ("cp_m_eff", "cp_m_eff_t", "cp_vmax", "cp_k_static"):
        setattr(je, name, getattr(te, name).copy())
    return je, te


def _standing(tm, base_z, rng):
    """N robots upright over the plane with the foot near the ground and
    small random joint states and velocities."""
    q = rng.normal(0.0, 0.05, (tm.nq, N)).astype(np.float32)
    quat = np.zeros((4, N), np.float32)
    quat[3] = 1.0
    st = dict(pos=np.stack([rng.normal(0.0, 0.1, N), rng.normal(0.0, 0.1, N),
                            np.full(N, base_z)]).astype(np.float32),
              quat=quat,
              vel=rng.normal(0.0, 0.2, (6, N)).astype(np.float32),
              q=q, qd=rng.normal(0.0, 0.3, (tm.nq, N)).astype(np.float32))
    return (JaxPhysicsState(**{k: jnp.asarray(v) for k, v in st.items()}),
            PhysicsState(**{k: torch.as_tensor(v) for k, v in st.items()}))


@pytest.mark.parametrize("case", ["slider_3_steps", "hopper_explicit"])
def test_general_engine_steps_match_jax(case, urdfs):
    """Engine.step_pos_targets from a state touching the plane: the slider
    model three sim dts with the implicit law, the hopper one sim dt with
    the explicit spring; every output at 5e-3."""
    name, steps, kw = (("slider", 3, {}) if case == "slider_3_steps"
                       else ("hopper", 1, {"implicit": False}))
    jm, tm = _models(urdfs[name])
    kp = np.full(tm.nq, 40.0)
    kd = np.full(tm.nq, 1.0)
    je, te = _engines(jm, tm, kw, kp, kd)
    rng = np.random.default_rng(3)
    base_z = 0.385 if name == "slider" else 0.475
    js, ts = _standing(tm, base_z, rng)
    lp = broadcast_nominal(tm, N)
    fric = np.full(N, 1.0, np.float32)
    targets = np.zeros((tm.nq, N), np.float32)
    step_j = jax.jit(lambda s: je.step_pos_targets(
        s, jnp.asarray(lp.numpy()), jnp.asarray(fric), jnp.asarray(targets)))
    touching = 0
    for _ in range(steps):
        js, ji = step_j(js)
        ts, ti = te.step_pos_targets(ts, lp, torch.as_tensor(fric),
                                     torch.as_tensor(targets))
        for f in ("pos", "quat", "vel", "q", "qd"):
            _close(getattr(js, f), getattr(ts, f), STEP_ATOL, msg=f)
        _close(ji.torques, ti.torques, STEP_ATOL, STEP_ATOL, "tau")
        _close(ji.body_forces, ti.body_forces, STEP_ATOL, STEP_ATOL,
               "body_f")
        touching += int((ti.body_forces[2].sum(dim=0) > 1.0).sum())
    assert touching > 0, "no robot touched the ground"
    assert torch.isfinite(ts.q).all()


def test_env_and_chain_engine_route_the_general_tree(urdfs):
    """The env takes the general engine for a prismatic model from its
    config; ChainEngine refuses a prismatic model and the explicit law
    when built directly."""
    cfg = LeggedRobotCfg()
    cfg.env.num_envs = 2
    cfg.env.num_actions = 3
    cfg.env.num_observations = 9 + 3 + 2 * 3 + 3
    cfg.asset.file = urdfs["slider"]
    cfg.asset.foot_name = "foot"
    cfg.init_state.pos = [0.0, 0.0, 0.45]
    cfg.init_state.default_joint_angles = {}
    cfg.control.stiffness = {"joint": 40.0}
    cfg.control.damping = {"joint": 1.0}
    cfg.terrain.mesh_type = "plane"
    cfg.terrain.measure_heights = False
    cfg.noise.add_noise = False
    cfg.domain_rand.push_robots = False
    env = LeggedEnv(cfg, device="cpu")
    assert env.general_reasons == ["prismatic joints"]
    assert env.chain_engine is None
    state, obs = env.reset()
    state, tr = env.step(state, torch.zeros((2, 3)))
    assert torch.isfinite(tr.obs).all() and tuple(tr.obs.shape) == (2, 21)
    with pytest.raises(NotChainStructured, match="prismatic"):
        ChainEngine(env.engine, decimation=4)

    _, tm = _models(urdfs["hopper"])
    explicit = Engine(tm, SimConfig(
        contact=contact.ContactConfig(implicit=False)))
    with pytest.raises(NotChainStructured, match="explicit contact"):
        ChainEngine(explicit, decimation=4)


# ------------------------------------------------------ the explicit law

def _grids(kind, rng):
    """None (the plane), or a 24 x 24 heightfield in both packages."""
    if kind == "plane":
        return None, None
    h = rng.uniform(-0.04, 0.04, (24, 24)).astype(np.float32)
    raw = np.round(h / 0.005).astype(np.int16)
    gj = jax_terrain.TerrainGrid(
        height=jnp.asarray(h), raw=jnp.asarray(raw), horizontal_scale=0.1,
        vertical_scale=0.005, border_size=1.0, wall_thresh=0.0)
    gt = torch_terrain.TerrainGrid(
        height=torch.as_tensor(h), raw=raw, horizontal_scale=0.1,
        vertical_scale=0.005, border_size=1.0, wall_thresh=0.0)
    return gj, gt


@pytest.mark.parametrize("kind", ["plane", "heightfield"])
def test_explicit_contact_law_matches_jax(kind, urdfs):
    """contact_forces with ContactConfig(implicit=False) on seeded points
    within 4 cm of the surface (about half of them penetrating): the
    spring-damper normal force and the uncapped regularized friction, at
    atol 1e-4 N."""
    jm, tm = _models(urdfs["hopper"])
    rng = np.random.default_rng(7 if kind == "plane" else 8)
    gj, gt = _grids(kind, rng)
    p = len(tm.cp_link)
    pos = np.stack([rng.uniform(-0.5, 0.5, (p, N)),
                    rng.uniform(-0.5, 0.5, (p, N)),
                    rng.uniform(-0.04, 0.08, (p, N))]).astype(np.float32)
    vel = rng.normal(0.0, 0.5, (3, p, N)).astype(np.float32)
    fric = rng.uniform(0.5, 1.25, N).astype(np.float32)
    jcfg = jax_contact.ContactConfig(implicit=False)
    tcfg = contact.ContactConfig(implicit=False)
    assert (tcfg.stiffness, tcfg.damping) == (jcfg.stiffness, jcfg.damping)
    with jax.disable_jit():
        fj = jax_contact.contact_forces(jm, gj, jcfg, jnp.asarray(pos),
                                        jnp.asarray(vel), jnp.asarray(fric))
    m_eff = torch.ones((p, 1))
    ft = contact.contact_forces(tm, gt, tcfg, torch.as_tensor(pos),
                                torch.as_tensor(vel), torch.as_tensor(fric),
                                0.005, m_eff)
    _close(fj, ft, LAW_ATOL, 1e-5)
    fn = ft.norm(dim=0)
    assert int((fn > 0).sum()) >= p * N // 4, "too few points in contact"
    # explicit: no impulse cap, so some friction exceeds what the implicit
    # law's m_eff / dt cap (here 200 N) would allow -- checked against the
    # implicit law on the same points
    fi = contact.contact_forces(tm, gt, contact.ContactConfig(),
                                torch.as_tensor(pos), torch.as_tensor(vel),
                                torch.as_tensor(fric), 0.005, m_eff)
    assert not torch.allclose(fi, ft)
