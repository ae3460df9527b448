"""Env step layer (envs/legged_env.py): the share of the window's env
steps whose physics replayed its CUDA graph (the SEA torque drive: the
actuator LSTM and one kernel launch per sim dt), in %: the count of the
program's ``physics.graph`` span, opened inside ``env.physics`` once per
such step, over the count of ``env.physics``, x 100. None where the
record holds no span summaries or the span never opened (a program
without the graph, or a drive that does not take it). Split by the
end-to-end metric it moves: ``.train`` (train_steps_per_s)."""
from benchmark.metrics.env_step_host_ms import _sums


def read(bundle):
    graphed = _sums(bundle, "physics.graph")
    steps = _sums(bundle, "env.physics")
    if graphed is None or not graphed[0] or not steps[0]:
        return None
    return 100.0 * graphed[0] / steps[0]
