"""The SEA torque path of the PyTorch port (ANYmal: actuator LSTM, kernel
variant K3 combined with friction anchors K4 and the trimesh wall rule)
against the JAX package, on the CPU.

The JAX Pallas kernel is covered through its plain reference
(``chain_step.run_decimation_chain``) and in interpret mode; the port's
plain version is what the CUDA kernel is held against on the card, and the
kernel source itself runs here through its host C++ build. Inputs are made
once from a numpy seed (or by the JAX env) and handed to both packages.
Card-only cases carry the ``cuda`` marker.
"""
import dataclasses
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from legged_gym_tpu import assets as jax_assets
from legged_gym_tpu import registry as jax_registry
from legged_gym_tpu.actuators.sea_lstm import SEANet as JaxSEANet
from legged_gym_tpu.physics import chain_step as jax_chain_step
from legged_gym_tpu.physics.pallas_step import run_decimation_pallas
from legged_gym_tpu_torch import assets as torch_assets
from legged_gym_tpu_torch import registry as torch_registry
from legged_gym_tpu_torch.actuators.sea_lstm import SEANet
from legged_gym_tpu_torch.interop import anchors_from_jax, env_state_from_jax
from legged_gym_tpu_torch.physics import chain_kernel, chain_step
from legged_gym_tpu_torch.physics import contact as torch_contact
from legged_gym_tpu_torch.physics.params import broadcast_nominal
from legged_gym_tpu_torch.scripts.kernel_numerics import (anchor_errors,
                                                        kernel_args,
                                                        per_env_errors,
                                                        tolerances)

# one intra-op thread: the tensors are a few envs wide and the test
# workers share the cores (more threads only spin and slow them)
torch.set_num_threads(1)

N = 4
LIVE = 1e5      # anchors below this are live, at 1e6 they are the sentinel
# probed apparent masses: float32 ABA summed in another order
PROBED = ("gme", "gmet", "gimn", "gimt")
HAS_CXX = bool(shutil.which("c++") or shutil.which("g++"))
NET = "{ASSETS}/actuator_nets/anydrive_v3_lstm.pt"


def _cfg(reg, task, n=N):
    cfg, _ = reg.get_cfgs(task)
    cfg.env.num_envs = n
    cfg.terrain.num_rows = 2
    cfg.terrain.num_cols = 2
    cfg.asset.self_collisions = 1   # self-contact needs the general engine
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
def flat():
    return _pair("anymal_c_flat")


@pytest.fixture(scope="module")
def rough():
    return _pair("anymal_c_rough")


@pytest.fixture(scope="module")
def rough_settled(rough):
    """anymal_c_rough after a reset and 25 zero-action steps of the port's
    env: the shared settled state (compiling the JAX env's step, 16
    unrolled substeps with the LSTM between, takes minutes here; one eager
    JAX step from this state takes seconds)."""
    tenv = rough[1]
    state, _ = tenv.reset()
    zeros = torch.zeros((N, tenv.num_actions))
    for _ in range(25):
        state, tr = tenv.step(state, zeros)
        assert not tr.done.any()
    return state


@pytest.fixture(scope="module")
def flat_settled(flat):
    """anymal_c on the plane after 30 zero-action steps of the port's env
    from its initial state, shared by the host-build cases."""
    tenv = flat[1]
    state = tenv.initial_state()
    zeros = torch.zeros((N, tenv.num_actions))
    for _ in range(30):
        state, _ = tenv.step(state, zeros)
    return state


def _np_tree(x):
    return jax.tree.map(np.asarray, x)


def _jax_state_from_torch(jenv, tenv, state_t):
    """The port's EnvState as the JAX package's (the reverse of
    interop.env_state_from_jax), for a state the port's env settled."""
    j = lambda t: jnp.asarray(t.numpy())
    base = jenv.initial_state(jax.random.PRNGKey(0))
    p = state_t.physics
    fields = {f: j(getattr(state_t, f)) for f in (
        "episode_length", "patch", "patch_T", "patch_r0", "patch_c0",
        "commands", "actions", "last_actions", "last_dof_vel",
        "feet_air_time", "terrain_level", "env_origin", "friction",
        "mass_scales", "link_params", "lin_vel_x_range")}
    return dataclasses.replace(
        base, physics=dataclasses.replace(
            base.physics, pos=j(p.pos), quat=j(p.quat), vel=j(p.vel),
            q=j(p.q), qd=j(p.qd)),
        common_step=jnp.asarray(state_t.common_step, jnp.int32),
        episode_sums={k: j(v) for k, v in state_t.episode_sums.items()},
        actuator_state={k: j(v) for k, v in state_t.actuator_state.items()},
        contact_ws=_jax_groups(tenv.chain_engine.cm, state_t.contact_ws),
        **fields)


# ------------------------------------------------------------- the SEA net

def test_sea_net_matches_jax_and_torchscript():
    """Same weights as the JAX SEANet; equal to it and to the TorchScript
    module on random inputs over 5 steps, atol 1e-5."""
    path = torch_assets.resolve(NET)
    assert path == jax_assets.resolve(NET)
    net = SEANet(path)
    jnet = JaxSEANet(path)
    script = torch.jit.load(path, map_location="cpu")
    assert isinstance(net, torch.nn.Module) and net.hidden == jnet.hidden == 8
    for l in (0, 1):
        for ours, theirs in (("w_ih", "w_ih"), ("w_hh", "w_hh")):
            np.testing.assert_array_equal(
                getattr(net, f"{ours}{l}").numpy(),
                np.asarray(jnet.layers[l][theirs]))
        np.testing.assert_array_equal(getattr(net, f"b{l}")[:, 0].numpy(),
                                      np.asarray(jnet.layers[l]["b"]))
    np.testing.assert_array_equal(net.w_out.numpy(), np.asarray(jnet.w_out))
    np.testing.assert_array_equal(net.in_scale[:, 0].numpy(),
                                  np.asarray(jnet.in_scale))
    assert net.out_scale == jnet.out_scale == 20.0

    B = 7
    rng = np.random.default_rng(0)
    state = net.init_state(B)
    jstate = jnet.init_state(B)
    hc = (torch.zeros(2, B, 8), torch.zeros(2, B, 8))
    for _ in range(5):
        pos_err = rng.normal(size=B).astype(np.float32)
        vel = (3.0 * rng.normal(size=B)).astype(np.float32)
        tau, state = net(torch.as_tensor(pos_err), torch.as_tensor(vel),
                         state)
        tau_j, jstate = jnet(jnp.asarray(pos_err), jnp.asarray(vel), jstate)
        x = torch.stack([torch.as_tensor(pos_err),
                         torch.as_tensor(vel)], dim=-1)[:, None, :]
        with torch.no_grad():
            tau_s, hc = script(x, hc)
        np.testing.assert_allclose(tau.numpy(), np.asarray(tau_j), atol=1e-5)
        np.testing.assert_allclose(tau.numpy(), tau_s.numpy(), atol=1e-5)
    for ours, theirs, scripted in zip(state, jstate, hc):
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs),
                                   atol=1e-5)
        # ours is (2, 8, B), the TorchScript module's (2, B, 8)
        np.testing.assert_allclose(ours.numpy().transpose(0, 2, 1),
                                   scripted.numpy(), atol=1e-5)


# ------------------------------------------------- layouts and constants

def _jax_layout(cm):
    size = {g.level: g.offs.shape[0] for g in cm.groups}
    return (cm.L, cm.K, size.get(-1, 0),
            tuple(size.get(l, 0) for l in range(cm.L)), cm.n_bodies)


def _check_constants(jenv, tenv, want_layout):
    jce, tce = jenv.chain_engine, tenv.chain_engine
    assert jenv._sea is not None and tenv._sea is not None
    assert chain_kernel.model_layout(tce.cm) == _jax_layout(jce.cm) \
        == want_layout
    # the SEA path's constants: decimation 1, torque mode, passive
    # impedance (the JAX package builds them inside its first torque step)
    imp = np.zeros((jce.cm.L, jce.cm.K))
    imp[jce.cm.active] = np.asarray(
        jce.engine._imp_passive[:, 0])[jce.cm.J[jce.cm.active]]
    jsea = dataclasses.replace(jce.cc, decimation=1, torque_mode=True,
                               implicit_d=imp)
    for jcc, tcc in ((jce.cc, tce.cc), (jsea, tce.cc_sea)):
        for f in ("dt_inner", "substeps", "decimation", "gravity",
                  "mu_terrain", "plane_per_step", "warm_start",
                  "anchor_release_depth", "torque_mode", "wall_thresh"):
            assert getattr(jcc, f) == getattr(tcc, f), f
        jcv = jax_chain_step.const_values(jcc, env_nd=1)
        tcv = chain_step.const_values(tcc)
        for k in tcv:
            rtol = 1e-4 if k.rstrip("0123456789") in PROBED else 1e-5
            np.testing.assert_allclose(jcv[k], tcv[k], rtol=rtol, atol=0,
                                       err_msg=k)
    cc = tce.cc_sea
    assert (cc.substeps, cc.decimation, cc.torque_mode, cc.warm_start) \
        == (4, 1, True, True)
    assert chain_step.variant(cc, anchored=True) == "K3"
    assert tce.cc_sea is cc                      # built once
    # the torque-drive probe differs from the PD one: lighter apparent mass
    for name in ("cp_m_eff", "cp_m_eff_t", "cp_vmax", "cp_k_static"):
        np.testing.assert_allclose(getattr(jenv.engine, name),
                                   getattr(tenv.engine, name), rtol=1e-4,
                                   err_msg=name)
    pd = type(tenv.engine)(tenv.model, tenv.engine.sim, kp=tenv.p_gains,
                           kd=tenv.d_gains)
    pd.calibrate_contact_mass(
        tenv.default_dof_pos,
        lambda n: broadcast_nominal(tenv.model, n, torch.float32))
    assert (pd.cp_m_eff > 1.05 * tenv.engine.cp_m_eff).any()
    with pytest.raises(ValueError):
        pd.calibrate_contact_mass(tenv.default_dof_pos, None, drive="sea")


def test_anymal_c_layout_and_constants(flat, rough):
    _check_constants(*flat, (3, 4, 2, (0, 2, 3), 17))
    jenv, tenv = rough
    assert chain_kernel.model_layout(tenv.chain_engine.cm) \
        == _jax_layout(jenv.chain_engine.cm) == (3, 4, 2, (0, 2, 3), 17)
    assert tenv.chain_engine.cc.wall_thresh == pytest.approx(0.075)
    assert flat[1].chain_engine.cc.wall_thresh == 0.0


def test_anymal_b_layout_and_constants():
    _check_constants(*_pair("anymal_b"), (3, 4, 8, (0, 2, 3), 17))


def test_anymal_c_flat_as_registered_needs_the_general_engine():
    assert torch_registry.task_names() == jax_registry.task_names()
    with pytest.raises(NotImplementedError, match="self-collision"):
        torch_registry.make_env("anymal_c_flat", device="cpu")


# ---------------------------------------------------------- the plain K3

def _sea_args(tenv, state_t, seed=0):
    """Kernel arguments of one SEA segment: the state's, with torques of
    the SEA net's order as targets (some beyond the effort limit)."""
    args = kernel_args(tenv, state_t)
    rng = np.random.default_rng(seed)
    args[3] = torch.as_tensor(rng.normal(0.0, 40.0, tuple(args[3].shape))
                              .astype(np.float32))
    return args


def _jax_groups(cm, packed):
    return [jnp.asarray(a.numpy()) for a in chain_step.split_anchors(
        cm, packed)]


def test_plain_k3_matches_jax_and_pallas_interpret(rough, rough_settled):
    """anymal_c on trimesh, one sim dt (4 substeps) of held torques with
    live anchors from a settled state: the port's plain version against the
    JAX plain version and the Pallas kernel in interpret mode, atol 5e-3 on
    the six outputs; anchors within 5e-3 where live, same live pattern;
    the host build of the kernel source against the plain version."""
    jenv, tenv = rough
    state_t = rough_settled
    tcc = tenv.chain_engine.cc_sea
    jcc = dataclasses.replace(
        jenv.chain_engine.cc, decimation=1, torque_mode=True,
        implicit_d=np.asarray(tcc.implicit_d))
    args = _sea_args(tenv, state_t)
    anchors = state_t.contact_ws
    assert (anchors < LIVE).float().mean() > 0.9
    jargs = [jnp.asarray(a.numpy()) for a in args]
    janc = _jax_groups(tcc.cm, anchors)
    ref = jax_chain_step.run_decimation_chain(jcc, *jargs, anchors=janc)
    out = chain_step.run_decimation_chain(tcc, *args, anchors=anchors)
    pal = run_decimation_pallas(jcc, *jargs, anchors=janc, interpret=True)
    for other in (ref, pal):
        for i, name in enumerate(("pos", "quat", "vel", "q", "qd", "tau")):
            np.testing.assert_allclose(np.asarray(other[i]), out[i].numpy(),
                                       atol=5e-3, err_msg=name)
        anc = anchors_from_jax(_np_tree(other[7])).numpy()
        np.testing.assert_array_equal(anc < LIVE, out[7].numpy() < LIVE)
        live = anc < LIVE
        np.testing.assert_allclose(anc[live], out[7].numpy()[live],
                                   atol=5e-3)
    # tau out is the torque clipped to the effort limit, and it did clip
    lim = torch.as_tensor(tcc.effort, dtype=torch.float32)[..., None]
    assert torch.equal(out[5], torch.clamp(args[3], -lim, lim))
    assert (args[3].abs() > lim).any()
    assert float(out[6][2].sum()) > 500.0            # standing: ~4 x 510 N
    if HAS_CXX:
        host = chain_kernel.run_decimation_host(tcc, *args, anchors=anchors)
        errs = {k: float(v.max())
                for k, v in per_env_errors(out[:7], host[:7]).items()}
        tol = tolerances(settled=True)
        assert all(errs[k] <= tol[k] for k in errs), errs
        assert errs["q"] < 1e-4, errs
        err, n_live, n_diff = anchor_errors(out[7], host[7])
        assert n_diff == 0 and err < 1e-4 and n_live > 0


@pytest.mark.skipif(not HAS_CXX, reason="no host C++ compiler")
@pytest.mark.parametrize("anchored", [False, True], ids=["K3", "K3+K4"])
def test_host_build_of_k3_matches_plain(flat, flat_settled, anchored):
    """The kernel source in torque mode on anymal's layout, with and
    without anchors, on a fresh reset and on a settled state: four
    launches in a row as the SEA path makes them, each launch's state and
    anchors out being the next one's in (never the same buffer). Every
    launch is compared on the plain version's inputs: under random 40 N*m
    torques a rounding-level difference would otherwise grow from launch
    to launch (measured: body_f 0.06 N per launch, up to 18 N chained)."""
    tenv = flat[1]
    cc = tenv.chain_engine.cc_sea
    if not anchored:
        cc = dataclasses.replace(cc, warm_start=False)
    for settled in (False, True):
        state = flat_settled if settled else tenv.initial_state()
        args = _sea_args(tenv, state, seed=int(settled))
        anchors = state.contact_ws if anchored else None
        state5 = args[7:]
        tol = tolerances(settled)
        for _ in range(4):
            ref = chain_step.run_decimation_chain(
                cc, *args[:7], *state5, anchors=anchors)
            out = chain_kernel.run_decimation_host(
                cc, *args[:7], *state5, anchors=anchors)
            errs = {k: float(v.max())
                    for k, v in per_env_errors(ref[:7], out[:7]).items()}
            assert all(errs[k] <= tol[k] for k in errs), errs
            assert errs["q"] < 1e-4, errs
            state5 = ref[:5]
            if anchored:
                assert out[7].data_ptr() != anchors.data_ptr()
                err, _, n_diff = anchor_errors(ref[7], out[7])
                assert n_diff == 0 and err < 1e-4
                anchors = ref[7]
    assert float(ref[6][2].sum()) > 500.0
    lay = chain_kernel.library_layout(chain_kernel.load_library(
        "host", layout=chain_kernel.model_layout(cc.cm)))
    assert (lay["L"], lay["K"], lay["S"], lay["NPTS"]) == (3, 4, (2, 0, 2, 3),
                                                           22)


def test_torque_wrapper_contract(flat):
    tenv = flat[1]
    cc = tenv.chain_engine.cc_sea
    state = tenv.initial_state()
    args = _sea_args(tenv, state)
    assert chain_step.variant(cc, anchored=True) == "K3"
    assert chain_step.variant(tenv.chain_engine.cc, anchored=True) == "K4"
    before = dict(chain_kernel.launches)
    out = chain_kernel.run_decimation(cc, *args, anchors=state.contact_ws)
    ref = chain_step.run_decimation_chain(cc, *args,
                                          anchors=state.contact_ws)
    assert chain_kernel.launches == before  # CPU tensors: the plain version
    for r, o in zip(ref, out):
        torch.testing.assert_close(o, r, rtol=0, atol=0)
    with pytest.raises(ValueError):
        chain_kernel.run_decimation(cc, *args,
                                    anchors=state.contact_ws.to("meta"))
    with pytest.raises(ValueError):     # anchors without warm start
        chain_kernel.run_decimation(
            dataclasses.replace(cc, warm_start=False), *args,
            anchors=state.contact_ws)


# --------------------------------------------------------------- the envs

def _compare_env_step(s_j, tr_j, s_t, tr_t):
    """obs / reward 5e-3, done equal, q 1e-4, anchors 1e-4; the LSTM state
    2e-4 (on the plane, tests/test_torch_sea_env.py, it holds 1e-4; on
    trimesh one entry of 768 reaches 1.04e-4: the net's velocity input is
    qd, which the contact law moves at the 1e-3 level)."""
    assert not np.asarray(tr_j.done).any()
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
        assert tuple(s_t.actuator_state[k].shape) == (2, 8, 12, N)
        np.testing.assert_allclose(np.asarray(s_j.actuator_state[k]),
                                   s_t.actuator_state[k].numpy(), atol=2e-4)
    assert float(s_t.actuator_state["h"].abs().max()) > 0.0
    np.testing.assert_allclose(
        anchors_from_jax(_np_tree(s_j.contact_ws)).numpy(),
        s_t.contact_ws.numpy(), atol=1e-4)


def test_anymal_rough_env_one_step_from_settled_state(rough, rough_settled):
    """anymal_c_rough on trimesh (K3 + K4 + the wall rule, four segments
    with the LSTM between): one zero-action step of each env from the
    shared settled state; the state crosses over and back unchanged."""
    jenv, tenv = rough
    assert tenv.grid.wall_thresh > 0 and tenv.obs_dim == jenv.obs_dim == 235
    state_j = _jax_state_from_torch(jenv, tenv, rough_settled)
    back = env_state_from_jax(_np_tree(state_j))
    assert torch.equal(back.contact_ws, rough_settled.contact_ws)
    assert torch.equal(back.actuator_state["c"],
                       rough_settled.actuator_state["c"])
    s_j, tr_j = jenv.step(state_j, jnp.zeros((N, jenv.num_actions)))
    s_t, tr_t = tenv.step(back, torch.zeros((N, tenv.num_actions)))
    _compare_env_step(s_j, tr_j, s_t, tr_t)


def test_finished_envs_get_zero_lstm_state_and_sentinel_anchors(flat):
    tenv = flat[1]
    state, _ = tenv.reset()
    zeros = torch.zeros((N, tenv.num_actions))
    for _ in range(3):
        state, _ = tenv.step(state, zeros)
    assert all(float(v.abs().amax(dim=(0, 1, 2)).min()) > 0.0
               for v in state.actuator_state.values())
    ep = state.episode_length.clone()
    ep[[1, 3]] = tenv.max_episode_length          # time out on this step
    state = dataclasses.replace(state, episode_length=ep)
    state, tr = tenv.step(state, zeros)
    done = tr.done.numpy()
    assert done[[1, 3]].all() and tr.time_out[[1, 3]].all()
    for v in state.actuator_state.values():
        assert tuple(v.shape) == (2, 8, 12, N)
        assert (v.numpy()[..., done] == 0.0).all()
        assert (np.abs(v.numpy()[..., ~done]).max(axis=(0, 1, 2)) > 0).all()
    ws = state.contact_ws.numpy()
    assert (ws[..., done] == torch_contact.ANCHOR_SENTINEL).all()
    assert (ws[..., ~done] < LIVE).all()


def test_sea_targets_are_not_clipped_to_the_soft_limits(flat):
    """The SEA path feeds the net (target - q) with the raw target
    (anymal.py:71-78); the position drive clips it to the soft limits."""
    tenv = flat[1]
    state, _ = tenv.reset()
    big = torch.full((N, tenv.num_actions), 100.0)      # clipped to +-100
    seen = {}
    net = tenv._sea.forward

    def spy(pos_err, vel, st):
        seen.setdefault("pos_err", pos_err.clone())
        return net(pos_err, vel, st)

    tenv._sea.forward = spy
    try:
        tenv.step(state, big)
    finally:
        del tenv._sea.forward
    want = (100.0 * tenv.cfg.control.action_scale + tenv._dflt
            - state.physics.q).reshape(-1)
    torch.testing.assert_close(seen["pos_err"], want)
    assert float(seen["pos_err"].min()) > 40.0          # far past any limit


def test_one_ppo_iteration_on_anymal_c_rough(tmp_path):
    """registry.make_runner on anymal_c_rough at 8 envs on the CPU: the
    actuator carry survives the rollout buffer and the resets."""
    cfg = _cfg(torch_registry, "anymal_c_rough", n=8)
    env, _ = torch_registry.make_env(cfg=cfg, device="cpu")
    _, tcfg = torch_registry.get_cfgs("anymal_c_rough")
    tcfg.policy.actor_hidden_dims = [32, 16]
    tcfg.policy.critic_hidden_dims = [32, 16]
    tcfg.runner.num_steps_per_env = 6
    runner, _ = torch_registry.make_runner(env, train_cfg=tcfg,
                                           log_root=None)
    runner.learn(1, init_at_random_ep_len=True)
    m = runner.last_metrics
    flat_vals = [v for v in m.values() if isinstance(v, float)]
    flat_vals += list(m["episode"].values())
    assert flat_vals and all(np.isfinite(v) for v in flat_vals), m
    st = runner.env_state
    assert tuple(st.actuator_state["h"].shape) == (2, 8, 12, 8)
    assert torch.isfinite(st.actuator_state["h"]).all()
    assert float(st.actuator_state["c"].abs().max()) > 0.0
    assert tuple(st.contact_ws.shape) == (3, 22, 8)
    assert runner.current_iteration == 1
