"""Where a policy step's time goes on the card: go1 rough at 1800 envs
(the bench.py cell), random normal actions, ``torch.profiler`` over a
window of steady steps.

    python -m legged_gym_tpu_torch.scripts.profile_step [--steps 20]

Prints the wall time per step, the device busy time per step (sum of
kernel times), the idle share, the number of kernel launches per step and
the top kernels by device time. Writes a Chrome trace under chiprun_out/.
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
    ap.add_argument("--trace", default="chiprun_out/profile_step.json")
    args = ap.parse_args(argv)
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
    # device-side events (kernels, copies): their time ranges are on the
    # card's timeline
    kernels = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            k = kernels.setdefault(e.name, [0, 0.0])
            k[0] += 1
            k[1] += e.time_range.elapsed_us()
    dev_us = sum(t for _, t in kernels.values())
    launches = sum(c for c, _ in kernels.values())
    step_ms = 1e3 * wall / args.steps
    busy_ms = 1e-3 * dev_us / args.steps
    print(f"{n} envs: {step_ms:.3f} ms/step wall, {busy_ms:.3f} ms/step "
          f"device busy, idle share {1 - busy_ms / step_ms:.3f}, "
          f"{launches / args.steps:.0f} kernel launches/step "
          f"({torch.cuda.get_device_name(0)}; profiler on)")
    for name, (c, t) in sorted(kernels.items(), key=lambda kv: -kv[1][1])[:12]:
        print(f"  {t / args.steps:9.1f} us/step {c / args.steps:6.1f}x  "
              f"{name[:90]}")
    if args.trace:
        os.makedirs(os.path.dirname(args.trace) or ".", exist_ok=True)
        prof.export_chrome_trace(args.trace)


if __name__ == "__main__":
    main()
