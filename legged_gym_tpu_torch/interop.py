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


def env_state_from_jax(state_np, device="cpu"):
    """A JAX ``EnvState`` whose leaves are numpy arrays -> the port's
    EnvState on ``device``. The JAX PRNG key has no counterpart (the port's
    env holds a torch.Generator); actuator and warm-start carries are not
    ported."""
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
        episode_sums={k: t(v) for k, v in state_np.episode_sums.items()})
