"""Actuator layer (actuators/sea_lstm.py): host ms per env step in the SEA
actuator net, evaluated once per sim dt between kernel launches (the
``actuator.sea`` span). None where the env has no SEA net (go1). Split
by the end-to-end metric it moves: ``.train`` (train_steps_per_s)."""
from benchmark.metrics.env_step_host_ms import per_env_step


def read(bundle):
    return per_env_step(bundle, "actuator.sea")
