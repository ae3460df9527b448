"""Env step layer (envs/legged_env.py): host ms per env step in the
terrain window block of ``LeggedEnv.step`` (the ``env.terrain`` span:
the cached window, re-extracted every ``patch_refresh`` steps under
``terrain.refresh``, and the physics's crop). Split by the end-to-end
metric it moves: ``.train`` (train_steps_per_s)."""
from benchmark.metrics.env_step_host_ms import per_env_step


def read(bundle):
    return per_env_step(bundle, "env.terrain")
