"""Env step layer (envs/legged_env.py): kernels the device ran per env
step in the traced stretch's ``rollout`` range, the policy's inference
and action draw included (the range ends with a sync). Split
by the end-to-end metric it moves: ``.train`` (train_steps_per_s)."""


def read(bundle):
    trace = bundle.get("trace")
    if not trace or "rollout" not in trace["ranges"]:
        return None
    return len(trace["ranges"]["rollout"]["kernels"]) / bundle["units"][
        "rollout"]
