"""Env step layer (envs/legged_env.py): the share of the window's env
steps whose post-physics tail (rewards, masked reset, observations)
replayed its CUDA graphs, in %: the count of the program's ``env.graph``
span, opened once per such step, over the count of ``env.step``, x 100.
None where the record holds no span summaries or the span never opened
(a program without the graphs). Split by the end-to-end metric it moves:
``.train`` (train_steps_per_s)."""
from benchmark.metrics.env_step_host_ms import _sums


def read(bundle):
    graphed, steps = _sums(bundle, "env.graph"), _sums(bundle, "env.step")
    if graphed is None or not graphed[0] or not steps[0]:
        return None
    return 100.0 * graphed[0] / steps[0]
