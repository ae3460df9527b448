"""The general stacked engine of the PyTorch port at the env level against
the JAX package, on the CPU: ``anymal_c_flat`` as registered (self-collision
on, SEA LSTM drive, friction anchors on the plane) and go1 with the V and T
drives and an applied UniNet. Noise, pushes and domain randomisation are
off; one env step from a shared state, handed to both packages leaf by
leaf (the anchors as one stacked (3, P, N) array, the actuator carry as it
is).

anymal's JAX step is compiled once (16 substeps with the LSTM between,
about a minute here); the three go1 steps run the JAX env with jit off, op
by op, so that they compile no env step.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from legged_gym_tpu import registry as jax_registry
from legged_gym_tpu.physics import contact as jax_contact
from legged_gym_tpu_torch import registry as torch_registry
from legged_gym_tpu_torch.interop import env_state_from_jax
from legged_gym_tpu_torch.physics.contact import ANCHOR_SENTINEL

# one intra-op thread: the tensors are a few envs wide and the test
# workers share the cores (more threads only spin and slow them)
torch.set_num_threads(1)

N = 4
LIVE = 1e5      # anchors below this are live, at 1e6 they are the sentinel


def _cfg(reg, task, **over):
    cfg, _ = reg.get_cfgs(task)
    cfg.env.num_envs = N
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


def _pair(task, **over):
    jenv, _ = jax_registry.make_env(cfg=_cfg(jax_registry, task, **over))
    tenv, _ = torch_registry.make_env(cfg=_cfg(torch_registry, task, **over),
                                      device="cpu")
    return jenv, tenv


def _np_tree(x):
    return jax.tree.map(np.asarray, x)


def _jax_state_from_torch(jenv, state_t):
    """The port's EnvState as the JAX package's (the reverse of
    interop.env_state_from_jax) on the general engine's layouts."""
    def j(t):
        return jnp.asarray(t.numpy())

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
        contact_ws=(None if state_t.contact_ws is None
                    else j(state_t.contact_ws)),
        **fields)


def _settle(tenv, steps):
    state = tenv.initial_state()
    zeros = torch.zeros((N, tenv.num_actions))
    for _ in range(steps):
        state, tr = tenv.step(state, zeros)
        assert not tr.done.any()
    return state


def _compare(s_j, tr_j, s_t, tr_t, carry_atol=1e-4):
    """obs / reward 5e-3, done equal, q 1e-4, torques 5e-3 + 1e-3 rel,
    the actuator carry and the anchors 1e-4 (the LSTM carry's velocity
    input is qd, which the contact law moves at the 1e-3 level)."""
    assert not np.asarray(tr_j.done).any()
    np.testing.assert_allclose(np.asarray(tr_j.obs), tr_t.obs.numpy(),
                               atol=5e-3)
    np.testing.assert_allclose(np.asarray(tr_j.reward), tr_t.reward.numpy(),
                               atol=5e-3)
    np.testing.assert_array_equal(np.asarray(tr_j.done), tr_t.done.numpy())
    np.testing.assert_allclose(np.asarray(s_j.physics.q),
                               s_t.physics.q.numpy(), atol=1e-4)
    np.testing.assert_allclose(np.asarray(tr_j.torques),
                               tr_t.torques.numpy(), atol=5e-3, rtol=1e-3)
    np.testing.assert_allclose(np.asarray(tr_j.feet_contact_z),
                               tr_t.feet_contact_z.numpy(), atol=2e-2,
                               rtol=5e-3)
    assert set(s_j.actuator_state) == set(s_t.actuator_state)
    for k, v in s_t.actuator_state.items():
        np.testing.assert_allclose(np.asarray(s_j.actuator_state[k]),
                                   v.numpy(), atol=carry_atol, err_msg=k)
    if s_t.contact_ws is not None:
        np.testing.assert_allclose(np.asarray(s_j.contact_ws),
                                   s_t.contact_ws.numpy(), atol=1e-4)


# ------------------------------------------------------------ anymal_c_flat

@pytest.fixture(scope="module")
def flat():
    return _pair("anymal_c_flat")


def test_anymal_c_flat_env_step_matches_jax(flat):
    """anymal_c_flat as registered (150 self-collision pairs, SEA LSTM
    between the general engine's sim dts, stacked anchors): one
    zero-action step of each env from the state the port's env reached
    after 25 steps; the state crosses over and back unchanged."""
    jenv, tenv = flat
    assert jenv.chain_engine is None and not jenv._chain_path
    assert tenv.chain_engine is None
    assert tenv.general_reasons == ["self-collision"]
    np.testing.assert_array_equal(tenv.engine.sc_pairs, jenv.engine.sc_pairs)
    assert len(tenv.engine.sc_pairs) == 150
    settled = _settle(tenv, 25)
    assert tuple(settled.contact_ws.shape) == (3, 22, N)
    assert float((settled.contact_ws < LIVE).float().mean()) > 0.15
    state_j = _jax_state_from_torch(jenv, settled)
    back = env_state_from_jax(_np_tree(state_j))
    assert torch.equal(back.contact_ws, settled.contact_ws)
    assert torch.equal(back.actuator_state["h"],
                       settled.actuator_state["h"])
    s_j, tr_j = jax.jit(jenv.step)(state_j, jnp.zeros((N, jenv.num_actions)))
    s_t, tr_t = tenv.step(back, torch.zeros((N, tenv.num_actions)))
    _compare(s_j, tr_j, s_t, tr_t)
    assert float(s_t.actuator_state["h"].abs().max()) > 0.0
    assert float(tr_t.feet_contact_z.sum()) > 1000.0      # standing, 52 kg


def test_anymal_c_flat_resets_stacked_anchors_to_the_sentinel(flat):
    """Finished envs get sentinel anchors and a zero LSTM state; the
    others keep theirs."""
    tenv = flat[1]
    state = _settle(tenv, 3)
    ep = state.episode_length.clone()
    ep[[0, 2]] = tenv.max_episode_length          # time out on this step
    state = dataclasses.replace(state, episode_length=ep)
    state, tr = tenv.step(state, torch.zeros((N, tenv.num_actions)))
    done = tr.done.numpy()
    assert done[[0, 2]].all() and not done[[1, 3]].any()
    ws = state.contact_ws.numpy()
    assert (ws[..., done] == ANCHOR_SENTINEL).all()
    assert (ws[..., ~done] < LIVE).any()
    assert (state.actuator_state["c"].numpy()[..., done] == 0.0).all()
    assert jax_contact.ANCHOR_SENTINEL == ANCHOR_SENTINEL


# ------------------------------------------------------- go1 V, T, UniNet

DRIVES = {
    "V": {"control.control_type": "V"},
    "T": {"control.control_type": "T"},
    "uninet": {"control.actuator_net_discard_output": False},
}


@pytest.fixture(scope="module")
def go1_settled():
    """go1 on the plane after 20 zero-action steps of the port's default
    (chain, P drive) env: the state the three drives start from."""
    tenv, _ = torch_registry.make_env(cfg=_cfg(torch_registry, "go1"),
                                      device="cpu")
    return _settle(tenv, 20)


@pytest.mark.parametrize("drive", list(DRIVES))
def test_go1_drive_env_step_matches_jax(drive, go1_settled):
    """One env step of go1 with the V drive, the T drive or an applied
    UniNet (all on the general engine, the torque-drive probe for V / T)
    from the shared settled state under seeded random actions, against
    the JAX env stepped op by op (jit off); the UniNet history crosses
    over and back unchanged."""
    jenv, tenv = _pair("go1", **DRIVES[drive])
    assert tenv.chain_engine is None and not jenv._chain_path
    for name in ("cp_m_eff", "cp_m_eff_t"):
        np.testing.assert_allclose(getattr(tenv.engine, name),
                                   getattr(jenv.engine, name), rtol=1e-4)
    state = dataclasses.replace(
        go1_settled, actuator_state=tenv._init_actuator_state(N))
    if drive == "uninet":
        # a history of three earlier sim dts, the same in both packages
        rng = np.random.default_rng(7)
        state = dataclasses.replace(state, actuator_state={
            k: torch.as_tensor(rng.normal(0.0, 1.0, tuple(v.shape))
                               .astype(np.float32))
            for k, v in state.actuator_state.items()})
    actions = np.random.default_rng(6).normal(
        0.0, 0.5, (N, tenv.num_actions)).astype(np.float32)
    state_j = _jax_state_from_torch(jenv, state)
    back = env_state_from_jax(_np_tree(state_j))
    for k, v in state.actuator_state.items():
        assert torch.equal(back.actuator_state[k], v), k
    with jax.disable_jit():
        s_j, tr_j = jenv.step(state_j, jnp.asarray(actions))
    s_t, tr_t = tenv.step(state, torch.as_tensor(actions))
    _compare(s_j, tr_j, s_t, tr_t)
    assert float(tr_t.torques.abs().max()) > 0.0
