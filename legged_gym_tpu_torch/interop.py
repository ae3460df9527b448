"""Weights and state carried over from the JAX package, as numpy arrays.

The parity tests make inputs once and hand the same arrays to both
packages (their random streams cannot match); these functions map the
JAX package's containers onto the port's. Nothing here imports JAX: the
caller converts leaves to numpy first (``jax.tree.map(np.asarray, x)``).
"""
from __future__ import annotations

import numpy as np
import torch

from legged_gym_tpu_torch.envs.legged_env import EnvState
from legged_gym_tpu_torch.physics.state import PhysicsState
from legged_gym_tpu_torch.rl.networks import ActorCritic
from legged_gym_tpu_torch.rl.ppo import AdamState, TrainState


def actor_critic_from_jax(params_np, activation="elu", device="cpu"):
    """``{"actor": [{"w", "b"}, ...], "critic": [...], "std"}`` (JAX
    layout: w is (in, out)) -> ActorCritic with the same weights."""
    actor, critic = params_np["actor"], params_np["critic"]
    obs_dim = np.shape(actor[0]["w"])[0]
    num_actions = np.shape(actor[-1]["w"])[1]
    model = ActorCritic(
        obs_dim, num_actions,
        actor_hidden_dims=[np.shape(l["w"])[1] for l in actor[:-1]],
        critic_hidden_dims=[np.shape(l["w"])[1] for l in critic[:-1]],
        activation=activation,
        critic_obs_dim=np.shape(critic[0]["w"])[0])
    with torch.no_grad():
        for seq, layers in ((model.actor, actor), (model.critic, critic)):
            linears = [m for m in seq if isinstance(m, torch.nn.Linear)]
            for lin, p in zip(linears, layers):
                lin.weight.copy_(torch.as_tensor(np.array(p["w"]).T))
                lin.bias.copy_(torch.as_tensor(np.array(p["b"])))
        model.std.copy_(torch.as_tensor(np.array(params_np["std"])))
    return model.to(device)


def _linears(seq):
    return [m for m in seq if isinstance(m, torch.nn.Linear)]


def param_list_from_jax(model, tree_np):
    """A JAX-layout tree shaped like the params (weights, Adam moments,
    gradients) -> tensors in ``model.parameters()`` order, transposed to
    the ``nn.Linear`` layout, on the model's device."""
    by_id = {}
    for seq, layers in ((model.actor, tree_np["actor"]),
                        (model.critic, tree_np["critic"])):
        for lin, p in zip(_linears(seq), layers):
            by_id[id(lin.weight)] = np.array(p["w"]).T
            by_id[id(lin.bias)] = np.array(p["b"])
    by_id[id(model.std)] = np.array(tree_np["std"])
    return [torch.as_tensor(by_id[id(p)], dtype=p.dtype, device=p.device)
            .contiguous() for p in model.parameters()]


def train_state_from_jax(params_np, opt_state_np, lr, activation="elu",
                         device="cpu", seed=0):
    """The JAX package's ``TrainState`` pieces as numpy -> the port's
    TrainState: weights, the Adam moments and step count out of the optax
    state ``(clip state, ScaleByAdamState(count, mu, nu))``, and the
    learning rate. The generators are fresh, seeded with ``seed`` (the JAX
    key has no counterpart)."""
    model = actor_critic_from_jax(params_np, activation, device)
    adam = next(s for s in opt_state_np if hasattr(s, "mu"))
    device = torch.device(device)
    return TrainState(
        model=model,
        opt_state=AdamState(count=int(np.asarray(adam.count)),
                            mu=param_list_from_jax(model, adam.mu),
                            nu=param_list_from_jax(model, adam.nu)),
        lr=torch.tensor(float(np.asarray(lr)), dtype=torch.float32,
                        device=device),
        noise_generator=torch.Generator(device=device).manual_seed(seed + 1),
        perm_generator=torch.Generator(device=device).manual_seed(seed + 2))


def env_state_from_jax(state_np, device="cpu"):
    """A JAX ``EnvState`` whose leaves are numpy arrays -> the port's
    EnvState on ``device``. The JAX PRNG key has no counterpart (the port's
    env holds a torch.Generator). The actuator carry (the SEA LSTM's
    ``{"h", "c"}``, or ``{}``) has the same layout in both. The
    warm-start anchors (a list of (3, S, K, N) arrays per point group, or
    None) become the port's packed (3, n_points, N) tensor."""
    def t(a):
        a = np.asarray(a)
        return torch.as_tensor(a.copy(), device=device)

    p = state_np.physics
    return EnvState(
        physics=PhysicsState(pos=t(p.pos), quat=t(p.quat), vel=t(p.vel),
                             q=t(p.q), qd=t(p.qd)),
        episode_length=t(state_np.episode_length),
        common_step=int(np.asarray(state_np.common_step)),
        patch=t(state_np.patch), patch_T=t(state_np.patch_T),
        patch_r0=t(state_np.patch_r0), patch_c0=t(state_np.patch_c0),
        commands=t(state_np.commands), actions=t(state_np.actions),
        last_actions=t(state_np.last_actions),
        last_dof_vel=t(state_np.last_dof_vel),
        feet_air_time=t(state_np.feet_air_time),
        terrain_level=t(state_np.terrain_level),
        env_origin=t(state_np.env_origin), friction=t(state_np.friction),
        mass_scales=t(state_np.mass_scales),
        link_params=t(state_np.link_params),
        lin_vel_x_range=t(state_np.lin_vel_x_range),
        episode_sums={k: t(v) for k, v in state_np.episode_sums.items()},
        contact_ws=anchors_from_jax(state_np.contact_ws, device),
        actuator_state={k: t(v) for k, v in
                        (state_np.actuator_state or {}).items()})


def anchors_from_jax(groups_np, device="cpu"):
    """The JAX package's anchor carry (per point group (3, S, K, N), or
    None) -> packed (3, n_points, N) in the kernel's point order."""
    if groups_np is None:
        return None
    return torch.cat([
        torch.as_tensor(np.array(a), device=device).reshape(
            3, -1, np.shape(a)[-1]) for a in groups_np], dim=1).contiguous()
