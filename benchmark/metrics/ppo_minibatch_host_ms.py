"""PPO layer (rl/ppo.py): host ms per minibatch step of the update (the
``ppo.minibatch`` span: loss, gradients, their sum over ranks, Adam).
Moves train_steps_per_s."""
from benchmark.metrics.env_step_host_ms import per_call


def read(bundle):
    return per_call(bundle, "ppo.minibatch")
