"""Counted float operations of a cell's work, from the configuration's
widths and the kernel's frozen work table (never from the port's code):
what ``step_mfu`` divides by the window's time and the card's peak."""
from __future__ import annotations


def mlp_flops(dims):
    """Operations of one sample through dense layers ``dims`` (2 per
    multiply-add)."""
    return sum(2 * a * b for a, b in zip(dims[:-1], dims[1:]))


def policy_flops(config):
    """(actor, critic) operations per sample, forward only."""
    env, pol = config["env"], config["policy"]
    obs = env["num_observations"]
    critic_obs = env.get("num_privileged_obs") or obs
    return (mlp_flops([obs, *pol["actor_hidden_dims"], env["num_actions"]]),
            mlp_flops([critic_obs, *pol["critic_hidden_dims"], 1]))


def actuator_flops(config):
    """Operations of one joint's actuator net per sim dt (a stacked LSTM
    and a linear head), 0 without an applied net."""
    net = config.get("actuator_net")
    if not net:
        return 0
    ops, width = 0, net["inputs"]
    for _ in range(net["layers"]):
        ops += 2 * (width + net["hidden"]) * 4 * net["hidden"]
        width = net["hidden"]
    return ops + 2 * width * net["outputs"]


def env_step_flops(config, work, num_envs):
    """Physics and actuator operations of one policy step of every env."""
    physics = work["launches_per_policy_step"] * (
        work["ops_per_env"] * num_envs + work["ops_fixed"])
    actuator = (actuator_flops(config) * config["control"]["decimation"]
                * config["env"]["num_actions"] * num_envs)
    return physics + actuator


def train_iteration_flops(config, work, num_envs):
    """One PPO iteration: ``num_steps_per_env`` env steps with the actor
    and critic forward per env, the last value, and every epoch's
    minibatches through actor and critic forward and backward (3x the
    forward)."""
    steps = config["runner"]["num_steps_per_env"]
    actor, critic = policy_flops(config)
    alg = config["algorithm"]
    rows = steps * num_envs
    rows -= rows % alg["num_mini_batches"]
    rollout = steps * (num_envs * (actor + critic)
                       + env_step_flops(config, work, num_envs))
    return (rollout + num_envs * critic
            + alg["num_learning_epochs"] * rows * 3 * (actor + critic))
