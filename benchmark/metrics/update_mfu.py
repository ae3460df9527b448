"""PPO layer (rl/ppo.py): the update's share of the card's float32 peak,
%: its counted operations (work/flops_recurrent.py: actor and critic,
LSTMs included, forward and backward over every epoch's minibatches,
from the configuration's widths) over the synced update half's mean time
in the window (``learn_iteration.profile``'s ``update_s``: GAE and the
epochs' minibatch steps) and 67 TFLOP/s. Split by the end-to-end metric
it moves: ``.train`` (train_steps_per_s)."""
from benchmark.work import flops_recurrent


def read(bundle):
    spans, cell = bundle["record"].get("spans"), bundle.get("cell")
    if not spans or cell is None:
        return None
    update_s = sum(s["update_s"] for s in spans) / len(spans)
    if update_s <= 0:
        return None
    ops = flops_recurrent.update_flops(cell.config, cell.num_envs)
    return 100.0 * ops / update_s / bundle["peaks"]["fp32_flops_per_s"]
