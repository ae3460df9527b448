"""Where a policy step's time goes on the card: go1 rough at 1800 envs
(the bench.py cell), random normal actions, ``torch.profiler`` over a
window of steady steps.

    python -m legged_gym_tpu_torch.scripts.profile_step [--steps 20]
    python -m legged_gym_tpu_torch.scripts.profile_step --train \
        [--task go1|aliengo|cassie|anymal_c_rough|...] [--iterations 2]

Prints the wall time per step, the device busy time per step (sum of
kernel times), the idle share, the number of kernel launches per step and
the top kernels by device time. Writes a Chrome trace under chiprun_out/.
With ``--train`` the unit is one PPO iteration (24-step rollout, GAE, 20
minibatch steps) through ``registry.make_runner``: go1 on rough terrain at
1800 envs, or any other task as registered (aliengo, cassie, anymal_c_rough,
anymal_c_flat on the general engine, ... at their own 4096 envs); the
rollout / update split comes from a second, unprofiled window; the profiled
window records device activity only; no trace is written unless asked.
"""
from __future__ import annotations

import argparse
import os
import time

import torch
from torch.profiler import ProfilerActivity, profile

from legged_gym_tpu_torch import registry
from legged_gym_tpu_torch.scripts.kernel_numerics import rough_cfg


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--num_envs", type=int, default=1800)
    ap.add_argument("--trace", default=None,
                    help="Chrome trace path (default: "
                         "chiprun_out/profile_step.json, none with --train)")
    ap.add_argument("--train", action="store_true",
                    help="profile PPO iterations instead of env steps")
    ap.add_argument("--task", default="go1",
                    help="go1 (rough variant at --num_envs) or any "
                         "registered task as it is")
    ap.add_argument("--iterations", type=int, default=2)
    args = ap.parse_args(argv)
    if args.train:
        return profile_train(args)
    if args.trace is None:
        args.trace = "chiprun_out/profile_step.json"
    env, _ = registry.make_env(cfg=rough_cfg(args.num_envs), device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    n = env.num_envs

    def actions():
        return torch.randn((n, env.num_actions), generator=gen,
                           device="cuda")

    with torch.inference_mode():
        state, _ = env.reset()
        for _ in range(10):                        # warm up
            state, _ = env.step(state, actions())
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(args.steps):
                state, _ = env.step(state, actions())
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    _report(prof, wall, args.steps, "step", f"{n} envs")
    _export(prof, args.trace)


def _report(prof, wall, units, unit, what):
    """Device-side events (kernels, copies) of the profile, per ``unit``:
    their time ranges are on the card's timeline."""
    kernels = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            k = kernels.setdefault(e.name, [0, 0.0])
            k[0] += 1
            k[1] += e.time_range.elapsed_us()
    dev_us = sum(t for _, t in kernels.values())
    launches = sum(c for c, _ in kernels.values())
    unit_ms = 1e3 * wall / units
    busy_ms = 1e-3 * dev_us / units
    print(f"{what}: {unit_ms:.3f} ms/{unit} wall, {busy_ms:.3f} ms/{unit} "
          f"device busy, idle share {1 - busy_ms / unit_ms:.3f}, "
          f"{launches / units:.0f} kernel launches/{unit} "
          f"({torch.cuda.get_device_name(0)}; profiler on)")
    for name, (c, t) in sorted(kernels.items(), key=lambda kv: -kv[1][1])[:12]:
        print(f"  {t / units:9.1f} us/{unit} {c / units:7.1f}x  {name[:90]}")


def _export(prof, trace):
    if trace:
        os.makedirs(os.path.dirname(trace) or ".", exist_ok=True)
        prof.export_chrome_trace(trace)


def profile_train(args):
    if args.task == "go1":
        env, _ = registry.make_env(cfg=rough_cfg(args.num_envs),
                                   device="cuda")
    else:
        env, _ = registry.make_env(args.task, device="cuda")
    runner, tcfg = registry.make_runner(env, name=args.task, log_root=None)
    horizon = tcfg.runner.num_steps_per_env
    runner.learn(2, init_at_random_ep_len=True)            # warm up
    # unprofiled window: wall time and the rollout / update split
    runner.learn_fn.profile = True
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    runner.learn(args.iterations)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    times = runner.learn_fn.times
    it = args.iterations
    print(f"{args.task}, {env.num_envs} envs (profiler off): "
          f"{1e3 * wall / it:.1f} ms/iteration wall = "
          f"{horizon * env.num_envs * it / wall:.0f} policy-steps/s; "
          f"rollout {1e3 * sum(t['rollout_s'] for t in times) / it:.1f} ms, "
          f"update {1e3 * sum(t['update_s'] for t in times) / it:.1f} ms "
          f"({torch.cuda.get_device_name(0)})")
    runner.learn_fn.profile = False
    # device activity only: an iteration of the general engine issues
    # millions of host ops, whose CPU events would dwarf the device's
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        runner.learn(args.iterations)
        torch.cuda.synchronize()
        wall_on = time.perf_counter() - t0
    _report(prof, wall_on, it, "iteration",
            f"{args.task}, {env.num_envs} envs")
    print(f"idle share against the profiler-off wall time: "
          f"{1 - _busy_s(prof) / wall:.3f}")
    _export(prof, args.trace)


def _busy_s(prof):
    return 1e-6 * sum(e.time_range.elapsed_us() for e in prof.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA)


if __name__ == "__main__":
    main()
