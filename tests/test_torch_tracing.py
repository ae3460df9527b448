"""The port's spans (utils/profiling.py) on the CPU: nesting, counts, total
and self times on a scripted clock; nothing recorded and no profiler range
when off; the env step's spans as ranges of a Chrome trace around the ops
they dispatched; one PPO iteration of a tiny go1 trimesh env and a tiny
anymal SEA env recording each span as often as the step runs it."""
from __future__ import annotations

import json

import pytest
import torch

from legged_gym_tpu_torch import registry
from legged_gym_tpu_torch.rl.runner import PPORunner
from legged_gym_tpu_torch.utils import profiling

STEPS = 4          # rollout steps: one terrain refresh in every 4 steps
ENV_SECTIONS = ("env.terrain", "env.physics", "env.rewards", "env.reset",
                "env.obs")


def _runner(task):
    """A PPO runner on a tiny rough-trimesh env: go1 (K2's path, position
    drive) or anymal_c_rough (the SEA net between 4 kernel calls)."""
    cfg, tcfg = registry.get_cfgs(task)
    cfg.env.num_envs = 4
    cfg.terrain.mesh_type = "trimesh"
    cfg.terrain.measure_heights = True
    cfg.terrain.curriculum = True
    cfg.terrain.num_rows = 2
    cfg.terrain.num_cols = 2
    if task == "go1":
        cfg.env.num_observations = 235
    tcfg.runner.num_steps_per_env = STEPS
    tcfg.algorithm.num_learning_epochs = 2
    tcfg.algorithm.num_mini_batches = 2
    env, _ = registry.make_env(cfg=cfg, device="cpu")
    runner = PPORunner(env, tcfg, seed=0)
    runner._ensure_env_state(init_at_random_ep_len=True)
    return runner


@pytest.fixture(scope="module")
def go1_runner():
    return _runner("go1")


def _iterate(runner):
    _, runner.env_state, runner.obs, _ = runner.learn_fn(
        runner.train_state, runner.env_state, runner.obs)


def test_nesting_counts_and_self_time_on_a_scripted_clock(monkeypatch):
    # the clock as the spans read it: each enter, then each exit
    ticks = iter([0, 10, 13, 18, 20, 24, 30, 100, 105, 107])
    monkeypatch.setattr(profiling.time, "perf_counter_ns",
                        lambda: next(ticks))
    with profiling.recording() as rec:
        with profiling.span("a"):
            with profiling.span("b"):
                with profiling.span("c"):
                    pass
            with profiling.span("b"):
                pass
        with profiling.span("c"):
            pass
    assert next(ticks, None) is None
    assert rec.spans == [("a", 0, 100, None), ("b", 10, 20, 0),
                         ("c", 13, 18, 1), ("b", 24, 30, 0),
                         ("c", 105, 107, None)]
    got = rec.summary()
    assert {k: v["n"] for k, v in got.items()} == {"a": 1, "b": 2, "c": 2}
    # self: a less its two b's, b less its c, c has no child
    assert got["a"]["total_s"] == pytest.approx(100e-9)
    assert got["a"]["self_s"] == pytest.approx(84e-9)
    assert got["b"]["total_s"] == pytest.approx(16e-9)
    assert got["b"]["self_s"] == pytest.approx(11e-9)
    assert got["c"]["total_s"] == pytest.approx(7e-9)
    assert got["c"]["self_s"] == pytest.approx(7e-9)


def test_off_records_nothing_and_opens_no_profiler_range():
    from torch.profiler import ProfilerActivity, profile

    # the shared no-op, whatever the name
    assert profiling.span("env.step") is profiling.span("ppo.act")
    x = torch.ones(8, 8)
    with profiling.span("env.step"):
        with profiling.recording() as rec, \
                profile(activities=[ProfilerActivity.CPU]) as prof:
            (x @ x).sum()
    assert rec.spans == []
    names = {e.name for e in prof.events()}
    assert "aten::mm" in names and "env.step" not in names


def test_env_spans_enclose_their_ops_in_a_chrome_trace(go1_runner,
                                                       tmp_path):
    env = go1_runner.env
    actions = torch.zeros((env.num_envs, env.num_actions))
    with profiling.trace(str(tmp_path)):
        env.step(go1_runner.env_state, actions)
    (path,) = tmp_path.glob("trace_*.json")
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X"]
    ranges = {}
    for e in events:
        if e.get("cat") == "user_annotation":
            ranges.setdefault(e["name"], []).append(
                (e["ts"], e["ts"] + e["dur"]))
    assert sorted(ranges) == sorted(("env.step", "kernel.chain_step")
                                    + ENV_SECTIONS)
    assert all(len(r) == 1 for r in ranges.values())

    def inside(name, outer):
        (a, b), (c, d) = ranges[name][0], ranges[outer][0]
        return c <= a and b <= d

    assert all(inside(name, "env.step") for name in ENV_SECTIONS)
    assert inside("kernel.chain_step", "env.physics")
    ops = [e["ts"] for e in events if e.get("cat") == "cpu_op"
           and e["name"].startswith("aten::")]
    for name in ENV_SECTIONS:
        (a, b), = ranges[name]
        assert any(a <= t <= b for t in ops), name


def _span_counts(runner, task):
    """One iteration with ``profile`` on; returns the iteration's times
    entry and the span counts the step should give."""
    env, lf = runner.env, runner.learn_fn
    step0 = int(runner.env_state.common_step)
    lf.profile = True
    lf.times.clear()
    try:
        _iterate(runner)
    finally:
        lf.profile = False
    launches = 4 if task == "anymal_c_rough" else 1
    expected = {"env.step": STEPS, "ppo.act": STEPS,
                "kernel.chain_step": launches * STEPS,
                "ppo.minibatch": 2 * 2,
                **{name: STEPS for name in ENV_SECTIONS}}
    if task == "anymal_c_rough":
        expected["actuator.sea"] = 4 * STEPS
    refreshes = sum((step0 + i) % env.patch_refresh == 0
                    for i in range(STEPS))
    if refreshes:
        expected["terrain.refresh"] = refreshes
    (entry,) = lf.times
    return entry, expected


@pytest.mark.parametrize("task", ["go1", "anymal_c_rough"])
def test_one_iteration_records_each_span(task, go1_runner):
    runner = go1_runner if task == "go1" else _runner(task)
    entry, expected = _span_counts(runner, task)
    spans = entry["spans"]
    assert {name: s["n"] for name, s in spans.items()} == expected
    assert entry["rollout_s"] > 0 and entry["update_s"] > 0
    step = spans["env.step"]
    sections = sum(spans[name]["total_s"] for name in ENV_SECTIONS)
    assert step["self_s"] == pytest.approx(step["total_s"] - sections)
    assert step["total_s"] + spans["ppo.act"]["total_s"] < entry["rollout_s"]
    physics = spans["env.physics"]
    inner = spans["kernel.chain_step"]["total_s"] + spans.get(
        "actuator.sea", {"total_s": 0.0})["total_s"]
    assert physics["self_s"] == pytest.approx(physics["total_s"] - inner)


def test_profile_off_records_no_times(go1_runner):
    go1_runner.learn_fn.times.clear()
    _iterate(go1_runner)
    assert go1_runner.learn_fn.times == []


def test_profile_step_span_table():
    from legged_gym_tpu_torch.scripts.profile_step import span_table

    def s(n, total, own):
        return {"n": n, "total_s": total, "self_s": own}

    times = [{"spans": {"env.step": s(24, 0.48, 0.024),
                        "kernel.chain_step": s(24, 0.0024, 0.0024),
                        "ppo.minibatch": s(20, 0.1, 0.1)}}] * 2
    lines = span_table(times)
    assert lines[0] == "spans over 48 env steps (profiler off):"
    rows = {line.split()[0]: line.split()[1:] for line in lines[2:]}
    assert rows["env.step"] == ["1.00", "20.000", "1.000"]
    assert rows["kernel.chain_step"] == ["1.00", "0.100", "0.100", "100.0",
                                         "us"]
    assert rows["ppo.minibatch"] == ["0.83", "4.167", "4.167", "5.0", "ms"]
    assert span_table([]) == ["no env step was recorded"]
