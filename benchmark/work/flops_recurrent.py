"""Counted float operations of a recurrent policy's training iteration,
from the configuration's widths only (2 per multiply-add): per sample an
LSTM's gate products, [x, h] (in + hidden) by the (in + hidden, 4 hidden)
gate weights, in front of each head, and the heads reading the LSTM's
output. The gates' sigmoid / tanh and the carries' products are not
counted. A configuration without ``policy.rnn_type`` counts its MLP
heads alone, as ``flops.policy_flops`` does."""
from __future__ import annotations

from benchmark.work import flops


def lstm_flops(in_dim, hidden, layers):
    """Gate products of one sample through a stacked LSTM."""
    ops = 0
    for _ in range(layers):
        ops += 2 * (in_dim + hidden) * 4 * hidden
        in_dim = hidden
    return ops


def policy_flops(config):
    """(actor, critic) operations per sample, forward only: each LSTM and
    the head behind it."""
    env, pol = config["env"], config["policy"]
    if not pol.get("rnn_type"):
        return flops.policy_flops(config)
    obs = env["num_observations"]
    critic_obs = env.get("num_privileged_obs") or obs
    h, layers = pol["rnn_hidden_size"], pol["rnn_num_layers"]
    actor = (lstm_flops(obs, h, layers)
             + flops.mlp_flops([h, *pol["actor_hidden_dims"],
                                env["num_actions"]]))
    critic = (lstm_flops(critic_obs, h, layers)
              + flops.mlp_flops([h, *pol["critic_hidden_dims"], 1]))
    return actor, critic


def update_flops(config, num_envs):
    """The update of one iteration: every epoch's minibatches through
    actor and critic forward and backward (3x the forward) over the
    ``num_steps_per_env`` x ``num_envs`` samples (BPTT re-runs each
    window's steps once per epoch; its minibatches split the envs, an
    MLP's the samples)."""
    actor, critic = policy_flops(config)
    alg, steps = config["algorithm"], config["runner"]["num_steps_per_env"]
    n_mb = alg["num_mini_batches"]
    if config["policy"].get("rnn_type"):
        rows = steps * (num_envs - num_envs % n_mb)
    else:
        rows = steps * num_envs - steps * num_envs % n_mb
    return alg["num_learning_epochs"] * rows * 3 * (actor + critic)


def train_iteration_flops(config, work, num_envs):
    """One PPO iteration: ``num_steps_per_env`` env steps with the actor
    and critic forward per env, the last value, and the update."""
    steps = config["runner"]["num_steps_per_env"]
    actor, critic = policy_flops(config)
    rollout = steps * (num_envs * (actor + critic)
                       + flops.env_step_flops(config, work, num_envs))
    return rollout + num_envs * critic + update_flops(config, num_envs)
