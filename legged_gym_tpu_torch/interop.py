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
from legged_gym_tpu_torch.rl.networks import (ActorCritic,
                                              ActorCriticRecurrent)
from legged_gym_tpu_torch.rl.ppo import AdamState, TrainState


def actor_critic_from_jax(params_np, activation="elu", device="cpu"):
    """``{"actor": [{"w", "b"}, ...], "critic": [...], "std"}`` (JAX
    layout: w is (in, out)) -> ActorCritic with the same weights; with
    ``"mem_a"`` / ``"mem_c"`` (LSTM layers ``{"w" (in+h, 4h), "b"}``) an
    ActorCriticRecurrent, the critic's LSTM as wide as its input (the
    privileged observations of an asymmetric critic)."""
    actor, critic = params_np["actor"], params_np["critic"]
    num_actions = np.shape(actor[-1]["w"])[1]
    widths = dict(
        actor_hidden_dims=[np.shape(l["w"])[1] for l in actor[:-1]],
        critic_hidden_dims=[np.shape(l["w"])[1] for l in critic[:-1]],
        activation=activation)
    if "mem_a" in params_np:
        mem_a, mem_c = params_np["mem_a"], params_np["mem_c"]
        hidden = np.shape(mem_a[0]["b"])[0] // 4
        model = ActorCriticRecurrent(
            np.shape(mem_a[0]["w"])[0] - hidden, num_actions,
            critic_obs_dim=np.shape(mem_c[0]["w"])[0] - hidden,
            rnn_hidden_size=hidden, rnn_num_layers=len(mem_a), **widths)
    else:
        model = ActorCritic(np.shape(actor[0]["w"])[0], num_actions,
                            critic_obs_dim=np.shape(critic[0]["w"])[0],
                            **widths)
    with torch.no_grad():
        for p, w in zip(model.parameters(),
                        param_list_from_jax(model, params_np)):
            p.copy_(w)
    return model.to(device)


def _linears(seq):
    return [m for m in seq if isinstance(m, torch.nn.Linear)]


def param_list_from_jax(model, tree_np):
    """A JAX-layout tree shaped like the params (weights, Adam moments,
    gradients) -> tensors in ``model.parameters()`` order, transposed to
    the ``nn.Linear`` layout (the LSTM layers keep the JAX layout), on the
    model's device."""
    by_id = {}
    for seq, layers in ((model.actor, tree_np["actor"]),
                        (model.critic, tree_np["critic"])):
        for lin, p in zip(_linears(seq), layers):
            by_id[id(lin.weight)] = np.array(p["w"]).T
            by_id[id(lin.bias)] = np.array(p["b"])
    for name, key in (("memory_a", "mem_a"), ("memory_c", "mem_c")):
        if hasattr(model, name):
            lstm = getattr(model, name)
            for w, b, p in zip(lstm.w, lstm.b, tree_np[key]):
                by_id[id(w)] = np.array(p["w"])
                by_id[id(b)] = np.array(p["b"])
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
    ``{"h", "c"}``, the UniNet history ``{"pos_err", "vel"}``, or ``{}``)
    has the same layout in both. The warm-start anchors become the port's
    layout (``anchors_from_jax``)."""
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
    """The JAX package's anchor carry -> the port's: the chain path's list
    of per-point-group (3, S, K, N) arrays becomes the packed
    (3, n_points, N) tensor in the kernel's point order; the general
    engine's stacked (3, P, N) array is taken as it is; None stays None."""
    if groups_np is None:
        return None
    if not isinstance(groups_np, (list, tuple)):
        return torch.as_tensor(np.array(groups_np), device=device)
    return torch.cat([
        torch.as_tensor(np.array(a), device=device).reshape(
            3, -1, np.shape(a)[-1]) for a in groups_np], dim=1).contiguous()
