"""PPO layer (rl/ppo.py): kernels the device ran per minibatch step in
the traced stretch's ``update`` range (GAE and the advantages' statistics
included; the range ends with a sync). None where the kind's traced
iteration does not count the update's minibatch steps. Split by the
end-to-end metric it moves: ``.train`` (train_steps_per_s)."""


def read(bundle):
    trace, units = bundle.get("trace"), bundle.get("units") or {}
    if not trace or "update" not in trace["ranges"] or not units.get(
            "update"):
        return None
    return len(trace["ranges"]["update"]["kernels"]) / units["update"]
