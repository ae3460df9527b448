"""PPO layer (rl/ppo.py): the synced update half of an iteration (GAE and
the epochs' minibatch steps), ms, the mean over the window's iterations
(``learn_iteration.profile``'s ``update_s``). Moves train_steps_per_s."""


def read(bundle):
    spans = bundle["record"].get("spans")
    if not spans:
        return None
    return 1e3 * sum(s["update_s"] for s in spans) / len(spans)
