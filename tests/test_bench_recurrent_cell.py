"""The cell ``go1_rough_lstm.train`` rehearsed on the CPU through
``benchmark.run.run_cell`` (8 envs, 2 checked iterations, the port's
plain physics step in place of the kernel, so program and reference
agree to the bit): correct as it is; not correct with half of each
rollout's envs left out of the update, nor with each minibatch's unroll
started from zero carries in place of the window-start carries. Then the
readers of the cell's three new per-layer metrics on a traced rehearsal
of the program, and with nothing to read."""
from __future__ import annotations

import copy

import pytest
import torch

from benchmark import run, seeds as bench_seeds, spec
from benchmark.kinds import train_recurrent
from benchmark.trace import Profile

CELL = "go1_rough_lstm.train"
ENVS, CHECKED = 8, 2
NEW_METRICS = ("ppo_bptt_host_ms.train", "update_launches.train",
               "update_mfu.train")


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _run():
    return run.run_cell(CELL, 2 ** 31 + 4242, 0.5, False, device="cpu",
                        num_envs=ENVS, checked=CHECKED)


def _half_batch(monkeypatch):
    """The runner's iterations update on the first half of the envs."""
    from legged_gym_tpu_torch.rl import ppo, runner

    def make(env, policy_cfg, alg_cfg, num_steps):
        whole = ppo.make_learn_fn(env, policy_cfg, alg_cfg, num_steps)

        def learn_iteration(ts, env_state, obs, noise=None, perm=None):
            env_state, obs, batch = whole.rollout(ts, env_state, obs)
            half = ppo.batch_envs(batch, slice(0, env.num_envs // 2))
            return ts, env_state, obs, whole.update(ts, half)

        for name in ("rollout", "update", "profile", "times"):
            setattr(learn_iteration, name, getattr(whole, name))
        return learn_iteration

    monkeypatch.setattr(runner, "make_learn_fn", make)


def _zero_carries(monkeypatch):
    """Each minibatch's unroll starts from zero carries."""
    from legged_gym_tpu_torch.rl import ppo

    real = ppo.ppo_loss

    def ppo_loss(model, mb, *args, **kw):
        if "mem_a0" in mb:
            mb = {**mb, "mem_a0": torch.zeros_like(mb["mem_a0"]),
                  "mem_c0": torch.zeros_like(mb["mem_c0"])}
        return real(model, mb, *args, **kw)

    monkeypatch.setattr(ppo, "ppo_loss", ppo_loss)


@pytest.mark.parametrize("fault", [None, "half_batch", "zero_carries"])
def test_the_rehearsal_is_correct_and_a_broken_update_is_not(monkeypatch,
                                                             fault):
    if fault == "half_batch":
        _half_batch(monkeypatch)
    elif fault == "zero_carries":
        _zero_carries(monkeypatch)
    result = _run()
    checks = result["checks"]
    assert {"priv_gap", "carry_gap"} <= set(checks)
    if fault is None:
        assert result["correct"] is True
        assert result["attempted"] >= 1 and result["failed"] == 0
        assert {k: c["value"] for k, c in checks.items()} == {
            k: 0.0 for k in checks}
        return
    assert result["correct"] is False
    over = {k for k, c in checks.items() if c["value"] > c["limit"]}
    # the env steps and the rollout are the program's own: only the
    # update's numbers move
    assert over and over <= {"loss_gap", "grad_gap", "change_gap"}, checks
    assert checks["carry_gap"]["value"] == 0.0


def test_the_new_readers_on_a_traced_rehearsal():
    # a shorter iteration than the cell's (8 steps, 2 epochs) for time
    cell = spec.load_cell(CELL)
    cell.mix = {**cell.mix, "num_envs": ENVS}
    cell.config = copy.deepcopy(cell.config)
    cell.config["runner"]["num_steps_per_env"] = 8
    cell.config["algorithm"]["num_learning_epochs"] = 2
    device = torch.device("cpu")
    program = train_recurrent.Program(cell, bench_seeds.from_seed(7),
                                      device, 1)
    record = program.window(0.5, spans=True)
    profile = Profile(device)
    units = program.trace(profile)
    assert units == {"rollout": 8, "update": 8}
    bundle = {"cell": cell, "record": record, "peaks": spec.peaks(),
              "work": cell.work(), "kernel_envs": ENVS,
              "flops_per_unit": program.flops_per_unit(),
              "trace": profile.result, "units": units}
    read = {name: spec.metric_reader(name) for name in NEW_METRICS}
    spans = record["spans"]
    bptt = sum(s["spans"]["ppo.bptt"]["total_s"] for s in spans)
    steps = sum(s["spans"]["ppo.bptt"]["n"] for s in spans)
    assert steps == 8 * len(spans)
    assert read["ppo_bptt_host_ms.train"](bundle) == pytest.approx(
        1e3 * bptt / steps)
    # a CPU trace has no device kernels: 0 launches per minibatch step
    assert read["update_launches.train"](bundle) == 0.0
    update_s = sum(s["update_s"] for s in spans) / len(spans)
    ops = 2 * 8 * ENVS * 3 * 7_884_032
    assert read["update_mfu.train"](bundle) == pytest.approx(
        100 * ops / update_s / 67e12)
    assert program.flops_per_unit() > ops
    # nothing to read: no trace, no span summaries, an MLP's traced units
    for empty in ({**bundle, "trace": None, "record": {"spans": []}},
                  {**bundle, "trace": None, "record": {}},
                  {**bundle, "units": {"rollout": 8}, "record": {
                      "spans": [{"rollout_s": 0.1, "update_s": 0.1,
                                 "spans": {"ppo.minibatch": {
                                     "n": 8, "total_s": 0.1,
                                     "self_s": 0.1}}}]}}):
        assert read["ppo_bptt_host_ms.train"](empty) is None
        assert read["update_launches.train"](empty) is None
    assert read["update_mfu.train"]({**bundle, "record": {}}) is None
