"""Actor-critic network (rsl_rl's ``ActorCritic``,
legged_robot_config.py:213-224): ELU MLPs [512, 256, 128] for actor and
critic, plus a state-independent per-dim action std parameter held as std
(not log-std), initialized to ``init_noise_std``; and the Gaussian
log-prob / entropy / KL the PPO update (rl/ppo.py) needs.

Weights are laid out as ``nn.Linear`` (out, in); the JAX package keeps
(in, out) — interop.actor_critic_from_jax transposes.

The ``ActorCriticRecurrent`` option (legged_robot_config.py:221-224,
runner policy_class_name): an LSTM memory (rnn_hidden_size,
rnn_num_layers) in front of each MLP head. Each LSTM layer keeps the JAX
package's parameter layout, one ``w`` (in + h, 4h) and one ``b`` (4h,)
with torch's gate order (i, f, g, o), so weights cross without a
reshuffle; the (h, c) carry is held batch-FIRST, (N, layers, 2, hidden).
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
        ``generator``, zero biases, std = init_noise_std; an
        ActorCriticRecurrent when ``policy_cfg.rnn_type`` is set."""
        if is_recurrent(policy_cfg):
            return ActorCriticRecurrent.from_cfg(
                obs_dim, num_actions, policy_cfg, generator=generator,
                critic_obs_dim=critic_obs_dim)
        return cls(obs_dim, num_actions, policy_cfg.actor_hidden_dims,
                   policy_cfg.critic_hidden_dims, policy_cfg.activation,
                   policy_cfg.init_noise_std, critic_obs_dim=critic_obs_dim,
                   generator=generator)


class LSTM(nn.Module):
    """Stacked LSTM cell stepped once per call. Per layer a ``w``
    (in + h, 4h) and ``b`` (4h,) in the JAX package's layout; init
    U(-1/sqrt(h), 1/sqrt(h)) for w, zero b (the JAX ``init_lstm``)."""

    def __init__(self, in_dim, hidden, num_layers, generator=None):
        super().__init__()
        self.hidden, self.num_layers = hidden, num_layers
        scale = 1.0 / math.sqrt(hidden)
        self.w = nn.ParameterList()
        self.b = nn.ParameterList()
        d = in_dim
        for _ in range(num_layers):
            w = torch.rand((d + hidden, 4 * hidden), generator=generator)
            self.w.append(nn.Parameter(scale * (2.0 * w - 1.0)))
            self.b.append(nn.Parameter(torch.zeros(4 * hidden)))
            d = hidden

    def forward(self, x, carry):
        """x (N, in); carry (N, L, 2, h) -> (out (N, h), new carry)."""
        layers = []
        for w, b, state in zip(self.w, self.b, carry.unbind(1)):
            h, c = state.unbind(1)
            gates = torch.cat([x, h], dim=-1) @ w + b
            i, f, g, o = gates.chunk(4, dim=-1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h = torch.sigmoid(o) * torch.tanh(c)
            layers.append(torch.stack([h, c], dim=1))       # (N, 2, h)
            x = h
        return x, torch.stack(layers, dim=1)                # (N, L, 2, h)


class ActorCriticRecurrent(ActorCritic):
    """rsl_rl's ActorCriticRecurrent: ``memory_a`` in front of the actor
    MLP, ``memory_c`` in front of the critic MLP (the critic's LSTM reads
    the privileged observations when there are any)."""

    def __init__(self, obs_dim, num_actions, actor_hidden_dims=(512, 256, 128),
                 critic_hidden_dims=(512, 256, 128), activation="elu",
                 init_noise_std=1.0, critic_obs_dim=None, rnn_hidden_size=512,
                 rnn_num_layers=1, generator=None):
        # the heads read the LSTM output; the JAX package draws the MLP
        # weights before the LSTM weights of each half
        super().__init__(rnn_hidden_size, num_actions, actor_hidden_dims,
                         critic_hidden_dims, activation, init_noise_std,
                         generator=generator)
        self.memory_a = LSTM(obs_dim, rnn_hidden_size, rnn_num_layers,
                             generator)
        self.memory_c = LSTM(critic_obs_dim or obs_dim, rnn_hidden_size,
                             rnn_num_layers, generator)

    @classmethod
    def from_cfg(cls, obs_dim, num_actions, policy_cfg, generator=None,
                 critic_obs_dim=None):
        if policy_cfg.rnn_type != "lstm":
            raise NotImplementedError(
                f"rnn_type {policy_cfg.rnn_type} (the reference supports "
                "lstm; helpers.py:181 'TODO add GRU')")
        return cls(obs_dim, num_actions, policy_cfg.actor_hidden_dims,
                   policy_cfg.critic_hidden_dims, policy_cfg.activation,
                   policy_cfg.init_noise_std, critic_obs_dim=critic_obs_dim,
                   rnn_hidden_size=policy_cfg.rnn_hidden_size,
                   rnn_num_layers=policy_cfg.rnn_num_layers,
                   generator=generator)


def is_recurrent(policy_cfg):
    return getattr(policy_cfg, "rnn_type", None) is not None


def init_memory(n, policy_cfg, dtype=torch.float32, device=None):
    """Zeroed LSTM carries for actor and critic: {"a": (N, L, 2, h), "c":
    ...} (rsl_rl's memory_a / memory_c hidden states)."""
    shape = (n, policy_cfg.rnn_num_layers, 2, policy_cfg.rnn_hidden_size)
    return {"a": torch.zeros(shape, dtype=dtype, device=device),
            "c": torch.zeros(shape, dtype=dtype, device=device)}


def actor_mean(model, obs):
    return model.actor(obs)


def critic_value(model, obs):
    return model.critic(obs)[..., 0]


def actor_mean_rnn(model, obs, carry):
    """Recurrent actor: (mean, new carry)."""
    out, carry = model.memory_a(obs, carry)
    return model.actor(out), carry


def critic_value_rnn(model, obs, carry):
    out, carry = model.memory_c(obs, carry)
    return model.critic(out)[..., 0], carry


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
    action, logp = sample_around(model, mean, generator, eps)
    return action, logp, mean, model.std.expand_as(mean)


def sample_around(model, mean, generator=None, eps=None):
    """(action, log_prob): a Gaussian draw around ``mean`` with the
    model's std (``eps`` as in sample_action)."""
    std = model.std.expand_as(mean)
    if eps is None:
        eps = torch.randn(mean.shape, generator=generator, dtype=mean.dtype,
                          device=mean.device)
    action = mean + std * eps
    return action, gaussian_log_prob(action, mean, std)
