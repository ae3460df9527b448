"""The frozen work table: a recount on the reference's plain chain step
at a few envs gives the table's operations, bytes and launches per env;
the trace reader and the per-layer readers on a made-up stretch."""
from __future__ import annotations

import pytest
import torch

from benchmark import spec, trace
from benchmark.work import flops, make_table


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", ["go1_K2", "anymal_c_K3"])
@pytest.mark.parametrize("num_envs", [2, 3])
def test_recount_equals_the_table(name, num_envs):
    table = spec.load_json(spec.HERE, "work", name + ".json")
    config = spec.load_json(spec.HERE, "configs", table["config"] + ".json")
    got = make_table.count(config, num_envs)
    assert got["ops"] == make_table.launch_ops(table, num_envs)
    assert got["bytes"] == table["bytes_per_env"] * num_envs
    assert got["variant"] == table["variant"]
    assert (got["launches_per_policy_step"]
            == table["launches_per_policy_step"])


def test_train_iteration_flops_of_go1_rough():
    config = spec.load_json(spec.HERE, "configs", "go1_rough.json")
    work = spec.load_json(spec.HERE, "work", "go1_K2.json")
    actor, critic = flops.policy_flops(config)
    assert actor == 2 * (235 * 512 + 512 * 256 + 256 * 128 + 128 * 12)
    assert critic == 2 * (235 * 512 + 512 * 256 + 256 * 128 + 128)
    n = 4096
    expect = (24 * (n * (actor + critic) + make_table.launch_ops(work, n))
              + n * critic + 5 * 24 * n * 3 * (actor + critic))
    assert flops.train_iteration_flops(config, work, n) == expect


def _events():
    def x(name, cat, ts, dur):
        return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}
    return [
        x("bench.stretch", "user_annotation", 0, 100),
        x("bench.rollout", "user_annotation", 0, 60),
        x("bench.update", "user_annotation", 60, 40),
        x("aten::mul", "cpu_op", 0, 30),
        x("aten::add", "cpu_op", 30, 30),
        x("chain_step_kernel", "kernel", 10, 10),
        x("mul_kernel", "kernel", 15, 10),
        x("add_kernel", "kernel", 40, 5),
        x("gemm", "kernel", 70, 20),
        x("Memcpy HtoD", "gpu_memcpy", 95, 1),
    ]


def test_trace_reads_ranges_busy_and_gaps():
    t = trace.parse(_events())
    assert t["busy_s"] == pytest.approx((15 + 5 + 20 + 1) * 1e-6)
    assert t["window_s"] == pytest.approx(100e-6)
    assert [n for n, _ in t["ranges"]["rollout"]["kernels"]] == [
        "chain_step_kernel", "mul_kernel", "add_kernel"]
    assert [n for n, _ in t["ranges"]["update"]["kernels"]] == ["gemm"]
    gaps = dict(t["breakdown"]["idle_gaps"])
    # idle 0-10 and 25-40 under aten::mul / aten::add, 45-70 under add,
    # 90-95 and 96-100 outside any host op
    assert gaps["aten::mul"] == pytest.approx(10e-6)
    assert gaps["aten::add"] == pytest.approx((15 + 25) * 1e-6)
    assert gaps["python, between ops"] == pytest.approx(9e-6)
    assert t["breakdown"]["device_ops"][0] == ["gemm", pytest.approx(20e-6)]


def test_readers_on_a_made_up_stretch():
    cell = spec.load_cell("go1_rough.train")
    bundle = {"cell": cell, "trace": trace.parse(_events()),
              "units": {"rollout": 3}, "work": cell.work(),
              "kernel_envs": 4096, "peaks": spec.peaks(),
              "flops_per_unit": 1e12,
              "record": {"seconds": 10.0, "units": 2,
                         "spans": [{"rollout_s": 0.5, "update_s": 0.1},
                                   {"rollout_s": 0.7, "update_s": 0.3}]}}

    def read(name):
        return spec.metric_reader(name)(bundle)

    assert read("ppo_rollout_ms") == pytest.approx(600.0)
    assert read("ppo_update_ms") == pytest.approx(200.0)
    assert read("env_step_launches.train") == pytest.approx(1.0)
    least = make_table.launch_ops(cell.work(), 4096) / 67e12
    assert read("chain_kernel_roofline.train") == pytest.approx(
        100 * least / 10e-6)
    assert read("step_mfu.train") == pytest.approx(100 * 2e12 / 10 / 67e12)
    assert read("device_idle_share.train") == pytest.approx(59.0)
    bundle["trace"] = None
    bundle["record"]["spans"] = []
    for name in ("ppo_rollout_ms", "env_step_launches.train",
                 "chain_kernel_roofline.train", "device_idle_share.train"):
        assert read(name) is None
