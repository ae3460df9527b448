"""Each cell rehearsed end to end on the CPU at a few envs: every stage
of a run, with the port's plain physics step in place of the kernel, so
the program and the reference agree to the bit; no device metric is
reported. Then the check caught: the same run with the timed path broken
underneath comes out not correct, once for each fault a training cell
can have. A control test on the card: the reference in TF32 fails the
check at a size a test run holds."""
from __future__ import annotations

import importlib

import pytest
import torch

from benchmark import run, spec, seeds as bench_seeds

ENVS = 8
STEPS = 2
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _run(workload, trace=False, seed=2 ** 31 + 12345):
    return run.run_cell(workload, seed, 0.5, trace, device="cpu",
                        num_envs=ENVS, checked=STEPS)


@pytest.mark.parametrize("workload", [
    w["name"] for w in spec.benchmark_file()["workloads"]])
def test_each_cell_runs_on_the_cpu_and_agrees_with_the_reference(workload):
    # the profiled stretch once: it is the same code for every cell
    result = _run(workload, trace=workload == "go1_rough.train")
    assert list(result)[:5] == KEYS
    assert set(result) <= set(KEYS) | {"breakdown", "checks"}
    assert ("breakdown" in result) == (workload == "go1_rough.train")
    assert list(result)[-1] == "checks"
    assert result["metrics"] == {}
    assert result["device"]["platform"] == "cpu"
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert {k: c["value"] for k, c in result["checks"].items()} == {
        k: 0.0 for k in result["checks"]}
    assert result["correct"] is True


def _broken_learn(kind):
    """A make_learn_fn for the port's runner whose iterations carry the
    fault ``kind``."""
    from legged_gym_tpu_torch.rl import ppo

    def make(env, policy_cfg, alg_cfg, num_steps):
        whole = ppo.make_learn_fn(env, policy_cfg, alg_cfg, num_steps)

        def learn_iteration(ts, env_state, obs, noise=None, perm=None):
            if kind == "unchanged":
                params = [p.detach().clone() for p in ts.model.parameters()]
                out = whole(ts, env_state, obs)
                with torch.no_grad():
                    for p, p0 in zip(ts.model.parameters(), params):
                        p.copy_(p0)
                return out
            env_state, obs, batch = whole.rollout(ts, env_state, obs)
            half = ppo.batch_envs(batch, slice(0, env.num_envs // 2))
            return ts, env_state, obs, whole.update(ts, half)

        for name in ("rollout", "update", "profile", "times"):
            setattr(learn_iteration, name, getattr(whole, name))
        return learn_iteration
    return make


@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
def test_a_broken_training_step_is_not_correct(monkeypatch, fault):
    from legged_gym_tpu_torch.rl import runner
    monkeypatch.setattr(runner, "make_learn_fn", _broken_learn(fault))
    result = _run("go1_rough.train")
    assert result["correct"] is False
    over = [k for k, c in result["checks"].items() if c["value"] > c["limit"]]
    assert over, result["checks"]


@pytest.mark.parametrize("workload", ["go1_rough.train"])
def test_a_physics_step_that_returns_its_state_is_not_correct(monkeypatch,
                                                             workload):
    from legged_gym_tpu_torch.physics import chain_kernel

    def unchanged(cc, lp_base, lp_lvl, mu, targets, ph, r0, c0, pos, quat,
                  vel, q, qd, anchors=None, **kw):
        out = chain_kernel.chain_step.run_decimation_chain(
            cc, lp_base, lp_lvl, mu, targets, ph, r0, c0, pos, quat, vel, q,
            qd, anchors=anchors, cv=kw.get("cv"))
        return (pos, quat, vel, q, qd) + tuple(out[5:])

    monkeypatch.setattr(chain_kernel, "run_decimation", unchanged)
    result = _run(workload)
    assert result["correct"] is False
    over = [k for k, c in result["checks"].items() if c["value"] > c["limit"]]
    assert any(k.startswith("env_gap") for k in over), result["checks"]


def test_an_env_step_with_half_its_batch_left_out_is_not_correct(
        monkeypatch):
    """The env step's batch: the second half of the envs' observations
    come back as the first half's."""
    import dataclasses

    from legged_gym_tpu_torch.envs.legged_env import LeggedEnv

    step = LeggedEnv.step

    def halved(self, state, actions):
        out, tr = step(self, state, actions)
        obs = tr.obs.clone()
        half = obs.shape[0] // 2
        obs[half:2 * half] = obs[:half]
        return out, dataclasses.replace(tr, obs=obs)

    monkeypatch.setattr(LeggedEnv, "step", halved)
    result = _run("go1_rough.train")
    assert result["correct"] is False
    over = [k for k, c in result["checks"].items() if c["value"] > c["limit"]]
    assert "env_miss_share" in over, result["checks"]


def test_the_env_numbers_read_a_fault_in_a_few_envs_and_in_resets():
    """A fault in a few envs reads their share, where the mean over the
    envs stays low; a fault in the envs a step resets reads on
    ``reset_gap`` alone."""
    from benchmark import follow

    n = 400
    obs = torch.zeros((n, 48))
    done = torch.zeros(n)
    done[:8] = 1.0
    ref = {3: (obs, torch.zeros(n), done)}
    few = obs.clone()
    few[100:112] = 0.5                      # 3% of the envs off by 0.5
    got = follow.env_numbers({3: (few, torch.zeros(n), done)}, ref)
    assert got["env_miss_share"] == pytest.approx(12 / n)
    assert got["env_gap"] == pytest.approx(0.5 * 12 / n)
    assert got["reset_gap"] == 0.0
    stale = obs.clone()
    stale[:8, 12:24] = 2.0                  # the reset envs' joint angles
    got = follow.env_numbers({3: (stale, torch.zeros(n), done)}, ref)
    assert got["reset_gap"] == 2.0
    assert got["env_miss_share"] == pytest.approx(8 / n)
    moved = obs.clone()
    moved[:8, :9] = 2.0                     # their pre-reset base motion
    got = follow.env_numbers({3: (moved, torch.zeros(n), done)}, ref)
    assert got["reset_gap"] == 0.0
    assert follow.env_numbers(ref, ref) == {
        "env_gap": 0.0, "env_miss_share": 0.0, "reset_gap": 0.0}


@pytest.mark.cuda
@pytest.mark.parametrize("workload", [
    w["name"] for w in spec.benchmark_file()["workloads"]])
def test_the_tf32_control_fails_the_check_on_the_card(workload):
    """On the card at the cell's own env count (the env numbers are
    shares of it), three seeds: the program within every limit, the
    reference in TF32 over one at least."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    run.use_checkout_caches()
    cell = spec.load_cell(workload)
    kind = importlib.import_module("benchmark.kinds." + cell.kind)
    steps = int(cell.limits["checked_steps"])
    device = torch.device("cuda")
    limits = {k: v["limit"] for k, v in cell.limits["numbers"].items()}
    for seed in (2 ** 31 + 1, 2 ** 31 + 2, 2 ** 31 + 3):
        seeds = bench_seeds.from_seed(seed)
        program = kind.Program(cell, seeds, device, steps)
        readings, weights = program.readings, program.weights
        program.free()
        ref = kind.reference(cell, seeds, device, steps, weights, readings)
        control = kind.reference(cell, seeds, device, steps, weights,
                                 readings, precision="tf32")
        sound = kind.compare(kind.program_side(readings), ref)
        assert all(sound[k] <= limits[k] for k in limits), sound
        low = kind.compare(control, ref)
        assert any(low[k] > limits[k] for k in limits), low
