"""PPO layer (rl/ppo.py): host ms per env step in the rollout's policy
(the ``ppo.act`` span: forward pass, action draw, value). Moves
train_steps_per_s."""
from benchmark.metrics.env_step_host_ms import per_env_step


def read(bundle):
    return per_env_step(bundle, "ppo.act")
