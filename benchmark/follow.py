"""Following the program step by step: what a cell's set-up records at
the env's ``step`` and how the reference takes each recorded state and
computes the same step.

The env is chaotic (rounding that flips one contact in thousands of envs
moves a whole rollout), so the reference does not run a trajectory of its
own: it starts from the program's recorded state of each sampled step,
with the env generator the program had there."""
from __future__ import annotations

import dataclasses
import math
import random

import torch

SAMPLED_ENV_STEPS = 8
# an env whose step differs by more than this from the reference's is a
# miss (rounding reads 1e-6 to 1e-4; a contact resolved apart ~0.1 to 1)
MISS = 1e-2
# the share of the envs that the "few_envs" fault leaves out
FEW_SHARE = 0.03
FAULTS = (None, "half_batch", "few_envs", "reset_skipped")
# the observations a reset env gets from the reset's own draws in
# legged_gym's layout: the commands, the joint positions and velocities
# (its base velocities, gravity and height scan are the pre-reset ones,
# legged_robot.py:122-136, and move with a contact resolved apart)
RESET_OBS = slice(9, 36)


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def tree(fn, x):
    """``fn`` on every tensor of a tree of dataclasses, dicts, lists and
    tuples."""
    if isinstance(x, torch.Tensor):
        return fn(x)
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return dataclasses.replace(x, **{
            f.name: tree(fn, getattr(x, f.name))
            for f in dataclasses.fields(x) if f.init})
    if isinstance(x, dict):
        return {k: tree(fn, v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(tree(fn, v) for v in x)
    return x


def host(x):
    """A copy of every tensor of ``x`` on the host."""
    return tree(lambda t: t.detach().to("cpu", copy=True), x)


def on(device, x):
    """A copy of every tensor of ``x`` on ``device``."""
    return tree(lambda t: t.to(device, copy=True), x)


def sampled_calls(seed, calls):
    """The env step calls the check follows: the first (the reset's) and
    a draw from the seed among the rest."""
    rest = random.Random(seed).sample(range(1, calls),
                                      min(SAMPLED_ENV_STEPS - 1, calls - 1))
    return [0] + sorted(rest)


def device_copy(x):
    """A copy of every tensor of ``x`` where it lies: queued on the card
    behind the work that makes it, with no wait for it."""
    return tree(lambda t: t.detach().clone(), x)


class Recorder:
    """Over ``env.step`` (an instance attribute, removed on exit): every
    call's actions and transition, and for the calls in ``sample`` also
    the state going in and the env's generator. The copies stay on the
    device, so recording adds no wait for the card to the schedule it
    records; ``host()`` brings them over once the recorded calls are
    done. ``calls`` maps a call's number (from 0, the first step through
    the env) to what was kept of it."""

    def __init__(self, env, sample):
        self.env, self.sample = env, set(sample)
        self.calls, self.count = {}, 0

    def __enter__(self):
        real_step = self.env.step

        def step(state, actions):
            i = self.count
            self.count += 1
            entry = {"actions": device_copy(actions)}
            if i in self.sample:
                entry["state"] = device_copy(state)
                entry["generator"] = self.env.generator.get_state()
            out, tr = real_step(state, actions)
            entry["tr"] = device_copy(tr)
            self.calls[i] = entry
            return out, tr

        self.env.step = step
        return self

    def __exit__(self, *exc):
        del self.env.step
        return False

    def host(self):
        """What was recorded, on the host (the device copies dropped)."""
        calls = {i: host(c) for i, c in sorted(self.calls.items())}
        self.calls = {}
        return calls


def ref_state(state, device):
    """A recorded EnvState of the program as the reference's, on
    ``device``."""
    from benchmark.reference.envs.legged_env import EnvState
    from benchmark.reference.physics.state import PhysicsState

    fields = {f.name: on(device, getattr(state, f.name))
              for f in dataclasses.fields(state) if f.name != "physics"}
    physics = PhysicsState(**{f.name: on(device, getattr(state.physics,
                                                         f.name))
                              for f in dataclasses.fields(state.physics)})
    return EnvState(physics=physics, **fields)


def outputs(tr):
    """What the env gap compares of a transition, on the host."""
    return host((tr.obs, tr.reward, tr.done.float()))


def env_steps(env, calls, device, act=None, fault=None):
    """The reference's outputs of the start (its own initial state and the
    reset's step) and of each sampled call from the program's state, with
    the actions ``act(i)`` (default: the program's). ``fault``, planted
    in the reference put in the program's place: envs that keep the
    observations they came in with, "half_batch" the second half of them,
    "few_envs" the first ``FEW_SHARE`` of them, "reset_skipped" those the
    step resets. Returns {call: outputs}."""
    if fault not in FAULTS:
        raise ValueError(f"fault {fault!r}")
    act = act or (lambda i: calls[i]["actions"].to(device))
    n = env.num_envs
    left_out = {"half_batch": slice(n // 2, n),
                "few_envs": slice(0, math.ceil(FEW_SHARE * n))}
    out = {}
    with torch.no_grad():
        _, tr = env.step(env.initial_state(), calls[0]["actions"].to(device))
        out[0] = outputs(tr)
        for i, entry in calls.items():
            if i == 0 or "state" not in entry:
                continue
            env.generator.set_state(entry["generator"])
            _, tr = env.step(ref_state(entry["state"], device), act(i))
            if fault is not None:
                came_in = calls[i - 1]["tr"].obs.to(device)
                envs = left_out.get(fault, tr.done)
                obs = tr.obs.clone()
                obs[envs] = came_in[envs]
                tr = dataclasses.replace(tr, obs=obs)
            out[i] = outputs(tr)
    return out


def program_env_steps(calls):
    """The program's side of ``env_steps``."""
    return {i: outputs(c["tr"]) for i, c in calls.items()
            if i == 0 or "state" in c}


def per_env_gap(a, b):
    """Per env the largest difference of observations, reward and
    done."""
    (obs_a, r_a, d_a), (obs_b, r_b, d_b) = a, b
    diff = (obs_a - obs_b).abs().amax(dim=1)
    diff = torch.maximum(diff, (r_a - r_b).abs())
    return torch.maximum(diff, (d_a - d_b).abs())


def env_numbers(side, ref):
    """The env steps' numbers, each the worst of the steps followed:
    ``env_gap``, per env the largest difference of observations, reward
    and done, the mean over the envs; ``env_miss_share``, the share of the
    envs whose difference passes ``MISS`` (a fault in a few envs reads
    their share, where a mean would hide it); ``reset_gap``, the largest
    difference of the observations ``RESET_OBS`` over the envs both
    sides reset in the step (they come from the reset's draws, with no
    contact to resolve apart)."""
    if side.keys() != ref.keys():
        raise ValueError("the two sides followed different steps")
    gap = miss = reset = 0.0
    for i in ref:
        per_env = per_env_gap(side[i], ref[i])
        gap = max(gap, float(per_env.mean()))
        miss = max(miss, float((per_env > MISS).float().mean()))
        both = (side[i][2] > 0) & (ref[i][2] > 0)
        if bool(both.any()):
            cols = (side[i][0][both][:, RESET_OBS]
                    - ref[i][0][both][:, RESET_OBS])
            reset = max(reset, float(cols.abs().max()))
    return {"env_gap": gap, "env_miss_share": miss, "reset_gap": reset}


def action_gap(a, b):
    """The largest difference of an action over the calls both sides
    hold."""
    if a.keys() != b.keys():
        raise ValueError("the two sides followed different steps")
    return max(float((a[i] - b[i]).abs().max()) for i in b)
