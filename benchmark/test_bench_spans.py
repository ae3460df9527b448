"""The readers of the program's span metrics over hand-made window
records: per env step, per launch and per minibatch step from the
iterations' span summaries; nothing where a record has no summaries or
the span never opened."""
from __future__ import annotations

import pytest

from benchmark import spec

SPAN_METRICS = ["env_step_host_ms.train", "env_terrain_host_ms.train",
                "env_physics_host_ms.train", "env_rewards_host_ms.train",
                "env_reset_host_ms.train", "env_obs_host_ms.train",
                "sea_actuator_host_ms.train", "chain_launch_host_us.train",
                "ppo_act_host_ms", "ppo_minibatch_host_ms"]


def _summary(steps, launches_per_step, sea, scale):
    """One iteration's span summary: ``steps`` env steps whose spans take
    fixed times x ``scale``."""
    def s(n, total):
        return {"n": n, "total_s": total * scale, "self_s": 0.0}

    out = {"env.step": s(steps, 0.020 * steps),
           "env.terrain": s(steps, 0.001 * steps),
           "terrain.refresh": s(steps // 4, 0.0005 * (steps // 4)),
           "env.physics": s(steps, 0.008 * steps),
           "kernel.chain_step": s(launches_per_step * steps,
                                  50e-6 * launches_per_step * steps),
           "env.rewards": s(steps, 0.004 * steps),
           "env.reset": s(steps, 0.005 * steps),
           "env.obs": s(steps, 0.0015 * steps),
           "ppo.act": s(steps, 0.0012 * steps),
           "ppo.minibatch": s(20, 0.005 * 20)}
    if sea:
        out["actuator.sea"] = s(4 * steps, 0.0007 * 4 * steps)
    return out


def _bundle(sea, summaries=True):
    # two iterations, the second's spans twice as long
    times = [{"rollout_s": 0.5, "update_s": 0.1}, {"rollout_s": 0.7,
                                                   "update_s": 0.3}]
    if summaries:
        for t, scale in zip(times, (1.0, 2.0)):
            t["spans"] = _summary(24, 4 if sea else 1, sea, scale)
    return {"record": {"seconds": 10.0, "units": 2, "spans": times}}


def _read(name, bundle):
    return spec.metric_reader(name)(bundle)


def test_span_readers_on_made_up_iterations():
    go1, anymal = _bundle(sea=False), _bundle(sea=True)
    # per env step: each span's time summed over both iterations (x1, x2)
    # over 48 env steps, so 1.5 x its time per step
    for name, per_step_ms in [("env_step_host_ms.train", 20.0),
                              ("env_terrain_host_ms.train", 1.0),
                              ("env_physics_host_ms.train", 8.0),
                              ("env_rewards_host_ms.train", 4.0),
                              ("env_reset_host_ms.train", 5.0),
                              ("env_obs_host_ms.train", 1.5),
                              ("ppo_act_host_ms", 1.2)]:
        assert _read(name, go1) == pytest.approx(1.5 * per_step_ms), name
        assert _read(name, anymal) == pytest.approx(1.5 * per_step_ms), name
    assert _read("sea_actuator_host_ms.train", anymal) == pytest.approx(
        1.5 * 4 * 0.7)
    # per call: the launches' and minibatch steps' own counts
    assert _read("chain_launch_host_us.train", go1) == pytest.approx(75.0)
    assert _read("chain_launch_host_us.train", anymal) == pytest.approx(75.0)
    assert _read("ppo_minibatch_host_ms", go1) == pytest.approx(7.5)


def test_span_readers_read_nothing_without_their_span():
    assert _read("sea_actuator_host_ms.train", _bundle(sea=False)) is None
    for bundle in (_bundle(sea=True, summaries=False),
                   {"record": {"spans": []}}, {"record": {}}):
        for name in SPAN_METRICS:
            assert _read(name, bundle) is None, name


def test_every_span_metric_is_in_the_benchmark():
    per_layer = {m["name"]: m for m in spec.benchmark_file()["per_layer"]}
    for name in SPAN_METRICS:
        m = per_layer[name]
        assert (m["source"], m["better"], m["moves"]) == (
            "program_span", "lower", "train_steps_per_s")
    assert per_layer["sea_actuator_host_ms.train"]["workloads"] == [
        "anymal_c_rough.train"]
