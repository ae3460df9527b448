"""Env step layer (envs/legged_env.py): host ms per env step in the
masked reset of ``LeggedEnv.step`` (the ``env.reset`` span: curricula,
the finished envs' statistics, reset draws, the window swap, zeroing).
Split by the end-to-end metric it moves: ``.train``
(train_steps_per_s)."""
from benchmark.metrics.env_step_host_ms import per_env_step


def read(bundle):
    return per_env_step(bundle, "env.reset")
