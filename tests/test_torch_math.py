"""The PyTorch port's math, state, general-tree dynamics and network
against the JAX package, on the CPU, with random inputs made once by numpy
and handed to both. Tolerance atol 1e-6 unless stated (float32 both sides,
same formulas and summation order). Also the port's Chrome trace
(utils/profiling.trace; its spans: test_torch_tracing.py)."""
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import legged_gym_tpu_torch
from legged_gym_tpu import assets as jax_assets
from legged_gym_tpu.config import PolicyCfg
from legged_gym_tpu.model.robot import compile_model as jax_compile_model
from legged_gym_tpu.ops import lin as jlin
from legged_gym_tpu.ops import quat as jquat
from legged_gym_tpu.physics import aba as jaba
from legged_gym_tpu.physics import contact as jcontact
from legged_gym_tpu.physics import integrator as jintegrator
from legged_gym_tpu.physics import kinematics as jkin
from legged_gym_tpu.physics import params as jparams
from legged_gym_tpu.physics.state import PhysicsState as JState
from legged_gym_tpu.rl import networks as jnet
from legged_gym_tpu_torch import assets
from legged_gym_tpu_torch.interop import actor_critic_from_jax
from legged_gym_tpu_torch.model.robot import compile_model
from legged_gym_tpu_torch.ops import lin, quat
from legged_gym_tpu_torch.physics import aba, contact, integrator, kinematics
from legged_gym_tpu_torch.physics import params
from legged_gym_tpu_torch.physics.state import PhysicsState
from legged_gym_tpu_torch.rl import networks

# one intra-op thread: the tensors are a few envs wide and the test
# workers share the cores (more threads only spin and slow them)
torch.set_num_threads(1)

N = 8
RNG = np.random.default_rng(1234)
PKG_DIR = os.path.dirname(legged_gym_tpu_torch.__file__)


def _r(*shape, scale=1.0):
    return (RNG.normal(size=shape) * scale).astype(np.float32)


def _close(j, t, atol=1e-6, rtol=1e-6):
    np.testing.assert_allclose(np.asarray(j), t.detach().numpy(), atol=atol,
                               rtol=rtol)


def test_package_imports_without_jax():
    code = (
        "import sys, importlib, pkgutil\n"
        "sys.modules['jax'] = None\n"
        "import legged_gym_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, 'legged_gym_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'legged_gym_tpu'\n"
        "       or m.startswith('legged_gym_tpu.')]\n"
        "assert not bad, bad\n"
        "for m in ('parallel', 'parallel.sharding', 'utils.profiling',\n"
        "          'scripts.bench_scaling'):\n"
        "    assert 'legged_gym_tpu_torch.' + m in sys.modules, m\n"
        "print('ok')\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.dirname(PKG_DIR) + os.pathsep + env.get(
        "PYTHONPATH", "")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    # and no source file names the JAX package as a module
    for root, _, files in os.walk(PKG_DIR):
        for f in files:
            if f.endswith((".py", ".cu")):
                src = open(os.path.join(root, f)).read()
                assert "legged_gym_tpu." not in src, f
                assert "import jax" not in src and "from jax" not in src, f


def test_quat_ops():
    q = _r(4, N)
    q /= np.linalg.norm(q, axis=0, keepdims=True)
    b = _r(4, N)
    v = _r(3, N)
    w = _r(3, N)
    tq, tb, tv, tw = map(torch.as_tensor, (q, b, v, w))
    jq, jb, jv, jw = map(jnp.asarray, (q, b, v, w))
    _close(jquat.mul(jq, jb), quat.mul(tq, tb))
    _close(jquat.conj(jq), quat.conj(tq))
    _close(jquat.normalize(jb), quat.normalize(tb))
    _close(jquat.cross(jv, jw), quat.cross(tv, tw))
    _close(jquat.rotate(jq, jv), quat.rotate(tq, tv))
    _close(jquat.rotate_inverse(jq, jv), quat.rotate_inverse(tq, tv))
    _close(jquat.to_matrix(jq), quat.to_matrix(tq))
    _close(jquat.integrate(jq, jw, 0.005), quat.integrate(tq, tw, 0.005))
    _close(jquat.yaw_rotate(jq, jv), quat.yaw_rotate(tq, tv))
    ang = _r(N, scale=10.0)
    _close(jquat.wrap_to_pi(jnp.asarray(ang)),
           quat.wrap_to_pi(torch.as_tensor(ang)), atol=2e-6)


def test_lin_ops():
    A, B = _r(3, 3, N), _r(3, 3, N)
    v, w = _r(3, N), _r(3, N)
    s = np.abs(_r(N)) + 0.5
    tA, tB, tv, tw, ts = map(torch.as_tensor, (A, B, v, w, s))
    jA, jB, jv, jw, js = map(jnp.asarray, (A, B, v, w, s))
    for name in ("mv", "mtv"):
        _close(getattr(jlin, name)(jA, jv), getattr(lin, name)(tA, tv))
    for name in ("mm", "mmt"):
        _close(getattr(jlin, name)(jA, jB), getattr(lin, name)(tA, tB))
    _close(jlin.transpose(jA), lin.transpose(tA))
    _close(jlin.outer(jv, jw), lin.outer(tv, tw))
    _close(jlin.skew(jv), lin.skew(tv))
    _close(jlin.skew_mm(jv, jA), lin.skew_mm(tv, tA))
    _close(jlin.mm_skew(jA, jv), lin.mm_skew(tA, tv))
    Sym = A + np.swapaxes(A, 0, 1)
    _close(jlin.congruence_sym(jB, jnp.asarray(Sym)),
           lin.congruence_sym(tB, torch.as_tensor(Sym)), atol=2e-6)
    _close(jlin.outer_sym(jv, js), lin.outer_sym(tv, ts))
    # well-conditioned 3x3 systems for the adjugate solves
    M = (A + 4.0 * np.eye(3, dtype=np.float32)[:, :, None]).astype(np.float32)
    _close(jlin.inv33(jnp.asarray(M)), lin.inv33(torch.as_tensor(M)),
           atol=1e-6, rtol=1e-5)
    _close(jlin.solve33(jnp.asarray(M), jv),
           lin.solve33(torch.as_tensor(M), tv), atol=1e-6, rtol=1e-5)
    _close(jlin.eye((N,)), lin.eye((N,)))


def test_solve66_sym():
    """The floating-base solve: rtol 1e-4 (f32 cancellation in the Schur
    complement)."""
    X = _r(6, 6, N)
    M = np.einsum("ikn,jkn->ijn", X, X) + 6.0 * np.eye(6)[:, :, None]
    M = M.astype(np.float32)
    AA, AB, BB = M[:3, :3], M[:3, 3:], M[3:, 3:]
    bt, bb = _r(3, N), _r(3, N)
    jt = jlin.solve66_sym(*map(jnp.asarray, (AA, AB, BB, bt, bb)))
    tt = lin.solve66_sym(*map(torch.as_tensor, (AA, AB, BB, bt, bb)))
    for a, b in zip(jt, tt):
        _close(a, b, atol=1e-6, rtol=1e-4)
    # and it solves the system
    x = np.concatenate([tt[0].numpy(), tt[1].numpy()])
    np.testing.assert_allclose(np.einsum("ijn,jn->in", M, x),
                               np.concatenate([bt, bb]), atol=1e-4)


@pytest.fixture(scope="module")
def go1():
    path = "{ASSETS}/robots/go1/urdf/go1.urdf"
    return (jax_compile_model(jax_assets.resolve(path)),
            compile_model(assets.resolve(path)))


def _random_state(m):
    q = _r(4, N)
    q /= np.linalg.norm(q, axis=0, keepdims=True)
    return dict(pos=_r(3, N), quat=q, vel=_r(6, N), q=_r(m.nq, N, scale=0.5),
                qd=_r(m.nq, N))


def test_state_and_params(go1):
    jm, tm = go1
    st = _random_state(tm)
    lw, aw = _r(3, N), _r(3, N)
    js = JState.from_world_vel(jnp.asarray(st["pos"]), jnp.asarray(st["quat"]),
                               jnp.asarray(lw), jnp.asarray(aw),
                               jnp.asarray(st["q"]), jnp.asarray(st["qd"]))
    ts = PhysicsState.from_world_vel(*map(torch.as_tensor, (
        st["pos"], st["quat"], lw, aw, st["q"], st["qd"])))
    _close(js.vel, ts.vel)
    _close(js.world_lin_vel(), ts.world_lin_vel())
    _close(jparams.broadcast_nominal(jm, N), params.broadcast_nominal(tm, N))
    scales = np.abs(_r(tm.n_orig, N)) + 0.5
    _close(jparams.link_params_from_scales(jm, jnp.asarray(scales)),
           params.link_params_from_scales(tm, torch.as_tensor(scales)))


def test_general_tree_dynamics(go1):
    """forward_kinematics, contact_point_kinematics,
    accumulate_link_wrenches, aba and integrate: the apparent-mass probe's
    building blocks."""
    jm, tm = go1
    st = _random_state(tm)
    js = JState(**{k: jnp.asarray(v) for k, v in st.items()})
    ts = PhysicsState(**{k: torch.as_tensor(v) for k, v in st.items()})
    jfk = jkin.forward_kinematics(jm, js)
    tfk = kinematics.forward_kinematics(tm, ts)
    for f in ("R_w", "p_w", "v_ang", "v_lin", "R_loc", "p_loc"):
        _close(getattr(jfk, f), getattr(tfk, f), atol=2e-6)
    jp, jv = jkin.contact_point_kinematics(jm, jfk)
    tp, tv = kinematics.contact_point_kinematics(tm, tfk)
    _close(jp, tp, atol=2e-6)
    _close(jv, tv, atol=1e-5)
    f_pts = _r(3, len(tm.cp_link), N, scale=10.0)
    jf, jn = jcontact.accumulate_link_wrenches(jm, jfk, jp, jnp.asarray(f_pts))
    tf, tn = contact.accumulate_link_wrenches(tm, tfk, tp,
                                              torch.as_tensor(f_pts))
    _close(jf, tf, atol=1e-4, rtol=1e-5)
    _close(jn, tn, atol=1e-4, rtol=1e-5)
    lp = params.broadcast_nominal(tm, N)
    tau = _r(tm.nq, N)
    imp = np.full(tm.nq, 0.01, np.float32)
    ja0, jqdd = jaba.aba(jm, jnp.asarray(lp.numpy()), jfk, js.qd,
                         jnp.asarray(tau), f_ext_w=jf, n_ext_w=jn,
                         implicit_d=imp)
    ta0, tqdd = aba.aba(tm, lp, tfk, ts.qd, torch.as_tensor(tau),
                        f_ext_w=tf, n_ext_w=tn,
                        gravity=torch.tensor([0.0, 0.0, -9.81]).view(3, 1, 1),
                        implicit_d=torch.as_tensor(imp)[:, None])
    _close(ja0, ta0, atol=1e-3, rtol=1e-4)
    _close(jqdd, tqdd, atol=1e-3, rtol=1e-4)
    jn_ = jintegrator.integrate(js, ja0, jqdd, 0.005)
    tn_ = integrator.integrate(ts, ta0, tqdd, 0.005)
    for f in ("pos", "quat", "vel", "q", "qd"):
        _close(getattr(jn_, f), getattr(tn_, f), atol=1e-5, rtol=1e-5)


def test_actor_critic_parity():
    """Carried weights: actor mean, value and log-prob at atol 1e-5."""
    import jax
    obs_dim, na = 235, 12
    pcfg = PolicyCfg()
    jparams_ = jnet.init_actor_critic(jax.random.PRNGKey(0), obs_dim, na,
                                      pcfg)
    jparams_["std"] = jnp.asarray(np.abs(_r(na)) + 0.3)
    model = actor_critic_from_jax(jax.tree.map(np.asarray, jparams_))
    obs = _r(N, obs_dim)
    act = jax.nn.elu
    with torch.no_grad():
        tobs = torch.as_tensor(obs)
        mean_t = networks.actor_mean(model, tobs)
        _close(jnet.actor_mean(jparams_, jnp.asarray(obs), act), mean_t,
               atol=1e-5, rtol=1e-5)
        _close(jnet.critic_value(jparams_, jnp.asarray(obs), act),
               networks.critic_value(model, tobs), atol=1e-5, rtol=1e-5)
        x = _r(N, na)
        std_t = model.std.expand(N, na)
        _close(jnet.gaussian_log_prob(jnp.asarray(x), jnp.asarray(
            mean_t.numpy()), jnp.broadcast_to(jparams_["std"], (N, na))),
            networks.gaussian_log_prob(torch.as_tensor(x), mean_t, std_t),
            atol=1e-5, rtol=1e-6)
        g = torch.Generator().manual_seed(0)
        a, logp, mean, std = networks.sample_action(model, tobs, g)
        assert a.shape == (N, na) and logp.shape == (N,)
        _close(networks.gaussian_log_prob(a, mean, std), logp)


def test_actor_critic_init():
    """Orthogonal init: sqrt(2) gain on hidden layers, 1.0 on the output
    layer, zero biases, std = init_noise_std (rl/networks.py:33-44)."""
    model = networks.ActorCritic.from_cfg(235, 12, PolicyCfg(),
                                          generator=torch.Generator()
                                          .manual_seed(0))
    linears = [m for m in model.actor if isinstance(m, torch.nn.Linear)]
    assert [l.out_features for l in linears] == [512, 256, 128, 12]
    assert isinstance(model.actor[1], torch.nn.ELU)
    for i, l in enumerate(linears):
        W = l.weight.detach().double()
        gain = 1.0 if i == len(linears) - 1 else np.sqrt(2.0)
        small = W @ W.T if W.shape[0] <= W.shape[1] else W.T @ W
        np.testing.assert_allclose(small.numpy(),
                                   gain ** 2 * np.eye(small.shape[0]),
                                   atol=1e-5)
        assert not l.bias.detach().any()
    assert torch.all(model.std == 1.0)


def test_actor_critic_init_is_the_same_at_any_thread_count():
    """One seed gives the same weights to the bit on one CPU thread (a
    torchrun rank's default) and on several (a single process)."""
    threads = torch.get_num_threads()
    weights = []
    try:
        for n in (1, 3):
            torch.set_num_threads(n)
            model = networks.ActorCritic.from_cfg(
                235, 12, PolicyCfg(),
                generator=torch.Generator().manual_seed(5))
            weights.append([p.detach().clone()
                            for p in model.parameters()])
            assert torch.get_num_threads() == n
    finally:
        torch.set_num_threads(threads)
    assert all(torch.equal(a, b) for a, b in zip(*weights))


# ------------------------------------------------------------ profiling

def test_trace_writes_a_chrome_trace(tmp_path):
    """trace() around a few ops on the CPU writes a Chrome trace that
    names them."""
    from legged_gym_tpu_torch.utils.profiling import trace

    with trace(str(tmp_path / "tr")) as prof:
        x = torch.ones(64, 64)
        (x @ x).sum()
    files = list((tmp_path / "tr").glob("trace_*.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any("aten::mm" in e.get("name", "") for e in events)
    assert any(e.key == "aten::mm" for e in prof.key_averages())
