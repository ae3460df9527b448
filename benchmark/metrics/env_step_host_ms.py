"""Env step layer (envs/legged_env.py): host ms per env step inside
``LeggedEnv.step`` (the program's ``env.step`` span), its total over the
window's iterations over their summed env steps. Split by the end-to-end
metric it moves: ``.train`` (train_steps_per_s).

The program's span summaries ride in the window's record, one per
iteration (``learn_iteration.times[i]["spans"]``: per span name its
count ``n``, ``total_s`` and ``self_s``). ``per_env_step`` and
``per_call`` here are the readers of every span metric: each gives None
where the record holds no summaries (tracing off, or a program without
spans) or where its span never opened."""


def _sums(bundle, name):
    """(count, total seconds) of the span ``name`` over the window's
    iterations, or None without summaries."""
    times = bundle["record"].get("spans")
    if not times or any("spans" not in t for t in times):
        return None
    found = [t["spans"][name] for t in times if name in t["spans"]]
    return (sum(s["n"] for s in found), sum(s["total_s"] for s in found))


def per_env_step(bundle, name, scale=1e3):
    """The span's total per env step, in seconds x ``scale``."""
    got, steps = _sums(bundle, name), _sums(bundle, "env.step")
    if got is None or not got[0] or not steps[0]:
        return None
    return scale * got[1] / steps[0]


def per_call(bundle, name, scale=1e3):
    """The span's total over its own count, in seconds x ``scale``."""
    got = _sums(bundle, name)
    if got is None or not got[0]:
        return None
    return scale * got[1] / got[0]


def read(bundle):
    return per_env_step(bundle, "env.step")
