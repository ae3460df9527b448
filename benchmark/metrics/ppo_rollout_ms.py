"""PPO layer (rl/ppo.py): the synced rollout half of an iteration, ms,
the mean over the window's iterations (``learn_iteration.profile``'s
``rollout_s``). Moves train_steps_per_s."""


def read(bundle):
    spans = bundle["record"].get("spans")
    if not spans:
        return None
    return 1e3 * sum(s["rollout_s"] for s in spans) / len(spans)
