"""PPO layer (rl/ppo.py): host ms per minibatch step in the recurrent
loss's unroll (the ``ppo.bptt`` span, inside ``ppo.minibatch``: both
LSTMs and heads over the window's steps from the window-start carries,
the carries zeroed at dones; the backward pass and Adam are outside it).
None where the span never opened (an MLP policy, or a program without
the span). Split by the end-to-end metric it moves: ``.train``
(train_steps_per_s)."""
from benchmark.metrics.env_step_host_ms import per_call


def read(bundle):
    return per_call(bundle, "ppo.bptt")
