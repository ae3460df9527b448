"""The PyTorch port's MPC rollout cost against the JAX package's on two
full robots, on the CPU: go1 on heightfield (the chain plain step with the
shared contact window, multi-chain gathers) and aliengo on its plane with
friction anchors (the packed anchor groups at aliengo's own layout, tiled
over the candidates).

Both packages get the same start state (the port's, settled with zero
actions and carried over as numpy) and the same action sequences; K = 4
candidates over one policy step (H = 1), the JAX side op by op
(``jax.disable_jit``), as the port's other tests run the JAX chain step.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from legged_gym_tpu import registry as jax_registry
from legged_gym_tpu.mpc import sampling as jax_mpc
from legged_gym_tpu.physics.state import PhysicsState as JaxPhysicsState
from legged_gym_tpu_torch import registry
from legged_gym_tpu_torch.mpc import MPCConfig, SamplingMPC
from legged_gym_tpu_torch.physics import chain_kernel, chain_step

# one intra-op thread: the tensors are a few envs wide and the test
# workers share the cores
torch.set_num_threads(1)

K, H = 4, 1
SETTLE = 10             # zero-action steps: feet down, anchors live
COST_ATOL = 1e-4        # the (K,) rollout costs, port vs JAX


def _cfg(reg, task, mesh):
    """``task`` at 2 envs, noise and pushes off; on ``mesh`` (a 2 x 2
    terrain without curriculum) or the task's own plane."""
    cfg, _ = reg.get_cfgs(task)
    cfg.env.num_envs = 2
    cfg.noise.add_noise = False
    cfg.domain_rand.push_robots = False
    if mesh is not None:
        cfg.terrain.mesh_type = mesh
        cfg.terrain.curriculum = False
        cfg.terrain.num_rows = cfg.terrain.num_cols = 2
    return cfg


@pytest.mark.parametrize("task,mesh", [("go1", "heightfield"),
                                       ("aliengo", None)])
def test_rollout_cost_matches_jax_on_robots(task, mesh):
    """(K,) costs at atol 1e-4, the tiled contact window and anchors equal
    to the JAX package's; the CPU runs the plain step (no launch)."""
    tenv, _ = registry.make_env(cfg=_cfg(registry, task, mesh),
                                device="cpu")
    jenv, _ = jax_registry.make_env(cfg=_cfg(jax_registry, task, mesh))
    ce = tenv.chain_engine
    assert ce is not None and jenv.chain_engine is not None
    assert (tenv.grid is not None) == (mesh is not None)
    assert ce.cc.warm_start == (task == "aliengo")
    state = tenv.initial_state()
    zeros = torch.zeros((tenv.num_envs, tenv.num_actions))
    with torch.no_grad():
        for _ in range(SETTLE):
            state, tr = tenv.step(state, zeros)
            assert not tr.done.any()
    p = state.physics
    phys = type(p)(*(t[..., :1].contiguous() for t in (
        p.pos, p.quat, p.vel, p.q, p.qd)))
    lp = state.link_params[..., :1].contiguous()
    fr = state.friction[:1].contiguous()
    anchors = None
    if ce.cc.warm_start:
        anchors = state.contact_ws[..., :1].contiguous()

    def j(t):
        return jnp.asarray(t.numpy())
    phys_j = JaxPhysicsState(pos=j(phys.pos), quat=j(phys.quat),
                             vel=j(phys.vel), q=j(phys.q), qd=j(phys.qd))
    anchors_j = None
    if anchors is not None:
        anchors_j = [j(a.contiguous())
                     for a in chain_step.split_anchors(ce.cm, anchors)]

    cfg = MPCConfig(horizon=H, num_samples=K)
    tm = SamplingMPC(tenv, cfg)
    jm = jax_mpc.SamplingMPC(jenv, cfg)
    commands = np.array([0.5, 0.0, 0.2], np.float32)
    seqs = np.random.default_rng(7).normal(
        0.0, 0.3, (H, tenv.num_actions, K)).astype(np.float32)
    phys_k, lp_k, fr_k, cpatch, anc_k = tm._tiled(phys, lp, fr, anchors, K)
    assert (cpatch is not None) == (mesh is not None)
    assert (anc_k is not None) == ce.cc.warm_start
    launched = dict(chain_kernel.launches)
    with torch.no_grad():
        cost_t = tm.rollout_cost(phys_k, lp_k, fr_k,
                                 torch.as_tensor(commands),
                                 torch.as_tensor(seqs),
                                 contact_patch=cpatch, anchors=anc_k)
    assert chain_kernel.launches == launched

    with jax.disable_jit():
        jcp = jm._shared_patch(phys_j, K)
        if cpatch is not None:
            for a, b in zip(jcp, cpatch):
                np.testing.assert_array_equal(np.asarray(a), b.numpy())
        anc_j = jm._anchors_k(anchors_j, K)
        if anc_k is not None:
            assert int((anc_k < 1e5).sum()) > 0    # the stance's anchors
            for a, b in zip(anc_j, chain_step.split_anchors(ce.cm, anc_k)):
                np.testing.assert_array_equal(np.asarray(a), b.numpy())
        cost_j = jm.rollout_cost(
            jax_mpc._tile_state(phys_j, K),
            jnp.broadcast_to(j(lp), lp.shape[:-1] + (K,)),
            jnp.broadcast_to(j(fr), (K,)), jnp.asarray(commands),
            jnp.asarray(seqs), contact_patch=jcp, anchors=anc_j)
    assert cost_t.shape == (K,) and torch.isfinite(cost_t).all()
    np.testing.assert_allclose(cost_t.numpy(), np.asarray(cost_j),
                               atol=COST_ATOL)
    # the candidates are distinct rollouts
    assert float(cost_t.max() - cost_t.min()) > 1e-6
