"""PPO layer (rl/ppo.py): the share of the window's minibatch steps that
replayed the update's CUDA graph, in %: the count of the program's
``ppo.graph`` span, opened once per such step, over the count of
``ppo.minibatch``, x 100. None where the record holds no span summaries
or the span never opened (a program without the graph, or a policy whose
step does not replay it). Split by the end-to-end metric it moves:
``.train`` (train_steps_per_s)."""
from benchmark.metrics.env_step_host_ms import _sums


def read(bundle):
    graphed = _sums(bundle, "ppo.graph")
    steps = _sums(bundle, "ppo.minibatch")
    if graphed is None or not graphed[0] or not steps[0]:
        return None
    return 100.0 * graphed[0] / steps[0]
