"""Env smoke harness (reference scripts/test_env.py): a zero-action settle
then a sinusoidal thigh sweep with a PD-tracking printout, on the card
unless ``--device cpu`` is given.

    python -m legged_gym_tpu_torch.scripts.test_env --task go1 --num_envs 10
"""
import argparse
import math

import torch

from legged_gym_tpu_torch import registry


def smoke(task="go1", num_envs=10, device="cuda", steps=200):
    cfg, _ = registry.get_cfgs(task)
    cfg.env.num_envs = num_envs
    env, _ = registry.make_env(cfg=cfg, device=device)
    n = cfg.env.num_envs
    state, _ = env.reset()
    zeros = torch.zeros((n, env.num_actions), device=env.device)

    # phase 1: zero actions
    for _ in range(steps):
        state, tr = env.step(state, zeros)
    z = state.physics.pos[2].cpu()
    print(f"zero-action: base z mean {z.mean():.3f} "
          f"(min {z.min():.3f} max {z.max():.3f}), "
          f"nan-free={bool(torch.isfinite(tr.obs).all())}")

    # phase 2: sinusoidal thigh action, PD tracking of env 0
    joint = 1
    worst = 0.0
    for i in range(steps):
        a = torch.zeros((n, env.num_actions), device=env.device)
        a[:, joint] = 0.75 * math.sin(2 * math.pi * i / 100.0)
        state, tr = env.step(state, a)
        target = (float(a[0, joint]) * env.cfg.control.action_scale
                  + env.default_dof_pos[joint])
        worst = max(worst, abs(float(state.physics.q[joint, 0]) - target))
    print(f"sinusoid PD tracking: worst |err| {worst:.3f} rad")
    print("Done")
    return worst


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--task", default="go1")
    ap.add_argument("--num_envs", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=200)
    args = ap.parse_args(argv)
    smoke(args.task, args.num_envs, args.device, args.steps)


if __name__ == "__main__":
    main()
