"""Actor-critic network (rsl_rl's ``ActorCritic``,
legged_robot_config.py:213-224): ELU MLPs [512, 256, 128] for actor and
critic, plus a state-independent per-dim action std parameter held as std
(not log-std), initialized to ``init_noise_std``; and the Gaussian
log-prob / entropy / KL the PPO update (rl/ppo.py) needs.

Weights are laid out as ``nn.Linear`` (out, in); the JAX package keeps
(in, out) — interop.actor_critic_from_jax transposes. The recurrent
(LSTM) variant is not ported.
"""
from __future__ import annotations

import math

import torch
from torch import nn

_ACTIVATIONS = {
    "elu": nn.ELU,
    "relu": nn.ReLU,
    "selu": nn.SELU,
    "lrelu": nn.LeakyReLU,
    "tanh": nn.Tanh,
    "sigmoid": nn.Sigmoid,
}


def _mlp(dims, activation, generator=None):
    """dims = [in, h1, ..., out]. Orthogonal init, sqrt(2) gain on hidden
    layers, 1.0 on the output layer, zero biases."""
    layers = []
    for i in range(len(dims) - 1):
        lin = nn.Linear(dims[i], dims[i + 1])
        gain = 1.0 if i == len(dims) - 2 else math.sqrt(2.0)
        with torch.no_grad():
            nn.init.orthogonal_(lin.weight, gain, generator=generator)
            lin.bias.zero_()
        layers.append(lin)
        if i < len(dims) - 2:
            layers.append(_ACTIVATIONS[activation]())
    return nn.Sequential(*layers)


class ActorCritic(nn.Module):
    def __init__(self, obs_dim, num_actions, actor_hidden_dims=(512, 256, 128),
                 critic_hidden_dims=(512, 256, 128), activation="elu",
                 init_noise_std=1.0, critic_obs_dim=None, generator=None):
        super().__init__()
        self.actor = _mlp([obs_dim, *actor_hidden_dims, num_actions],
                          activation, generator)
        self.critic = _mlp([critic_obs_dim or obs_dim, *critic_hidden_dims,
                            1], activation, generator)
        self.std = nn.Parameter(torch.full((num_actions,),
                                           float(init_noise_std)))

    @classmethod
    def from_cfg(cls, obs_dim, num_actions, policy_cfg, generator=None,
                 critic_obs_dim=None):
        """Freshly initialized from a PolicyCfg (the JAX package's
        ``init_actor_critic``): orthogonal weights drawn from
        ``generator``, zero biases, std = init_noise_std."""
        if is_recurrent(policy_cfg):
            raise NotImplementedError(
                "the recurrent policy (ActorCriticRecurrent) is not ported "
                "yet (see ROADMAP.md Queue 1)")
        return cls(obs_dim, num_actions, policy_cfg.actor_hidden_dims,
                   policy_cfg.critic_hidden_dims, policy_cfg.activation,
                   policy_cfg.init_noise_std, critic_obs_dim=critic_obs_dim,
                   generator=generator)


def is_recurrent(policy_cfg):
    return getattr(policy_cfg, "rnn_type", None) is not None


def actor_mean(model, obs):
    return model.actor(obs)


def critic_value(model, obs):
    return model.critic(obs)[..., 0]


def gaussian_log_prob(x, mean, std):
    var = std * std
    return torch.sum(-0.5 * torch.square(x - mean) / var - torch.log(std)
                     - 0.5 * math.log(2.0 * math.pi), dim=-1)


def gaussian_entropy(std):
    return torch.sum(0.5 + 0.5 * math.log(2.0 * math.pi) + torch.log(std),
                     dim=-1)


def gaussian_kl(mu_old, std_old, mu_new, std_new):
    """Per-sample KL(old || new), rsl_rl's adaptive-LR formula (the 1e-5
    sits inside the log)."""
    return torch.sum(
        torch.log(std_new / std_old + 1e-5)
        + (torch.square(std_old) + torch.square(mu_old - mu_new))
        / (2.0 * torch.square(std_new)) - 0.5, dim=-1)


def sample_action(model, obs, generator=None, eps=None):
    """Returns (action, log_prob, mean, std). ``eps``: the standard-normal
    draw to use instead of one from ``generator`` (parity tests)."""
    mean = actor_mean(model, obs)
    std = model.std.expand_as(mean)
    if eps is None:
        eps = torch.randn(mean.shape, generator=generator, dtype=mean.dtype,
                          device=mean.device)
    action = mean + std * eps
    return action, gaussian_log_prob(action, mean, std), mean, std
