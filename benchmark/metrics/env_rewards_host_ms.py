"""Env step layer (envs/legged_env.py): host ms per env step in the
post-physics bookkeeping of ``LeggedEnv.step`` (the ``env.rewards``
span: base velocities, commands, height scan, pushes, termination and
the reward terms). Split by the end-to-end metric it moves: ``.train``
(train_steps_per_s)."""
from benchmark.metrics.env_step_host_ms import per_env_step


def read(bundle):
    return per_env_step(bundle, "env.rewards")
