"""Env step layer (envs/legged_env.py): host ms per env step in the
physics call of ``LeggedEnv.step`` (the ``env.physics`` span: the chain
or general physics, with the SEA net and the kernel wrapper inside).
Split by the end-to-end metric it moves: ``.train``
(train_steps_per_s)."""
from benchmark.metrics.env_step_host_ms import per_env_step


def read(bundle):
    return per_env_step(bundle, "env.physics")
