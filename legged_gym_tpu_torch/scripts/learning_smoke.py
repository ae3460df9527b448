"""Learning check on the card: the locomotion reward must IMPROVE, not
merely compute.

    python -m legged_gym_tpu_torch.scripts.learning_smoke [--iterations 400]

Trains go1 on flat terrain (the task's own config) at 1800 envs through
``registry.make_env`` / ``registry.make_runner``, as
tests/test_learning_smoke.py does for the JAX package at 64 envs, and
prints the ``episode/tracking_lin_vel`` curve beside the JAX package's
recorded run (docs/runs/go1_flat_1800/metrics.jsonl). The run directory
(metrics.jsonl, config.json, checkpoints) and ``curve.json`` go to
``chiprun_out/learning_smoke/``. Exits non-zero unless the mean of the
last tenth of the curve is above twice the mean of the first tenth.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from legged_gym_tpu_torch import registry
from legged_gym_tpu_torch.utils import helpers

JAX_RUN = os.path.join(helpers.ROOT_DIR, "docs", "runs", "go1_flat_1800",
                       "metrics.jsonl")
OUT_DIR = os.path.join(helpers.ROOT_DIR, "chiprun_out", "learning_smoke")


def _curve(path, key="tracking_lin_vel"):
    with open(path) as fh:
        return [json.loads(line)["episode"][key] for line in fh]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iterations", type=int, default=400)
    ap.add_argument("--num_envs", type=int, default=1800)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)

    card = "cpu"
    if torch.device(args.device).type == "cuda":
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
    helpers.set_seed(args.seed)
    cfg, tcfg = registry.get_cfgs("go1")
    cfg.env.num_envs = args.num_envs
    tcfg.seed = args.seed
    tcfg.runner.run_name = "learning_smoke"
    tcfg.runner.save_interval = max(args.iterations, 1)
    env, _ = registry.make_env(cfg=cfg, seed=args.seed, device=args.device)
    runner, _ = registry.make_runner(env, train_cfg=tcfg, log_root=OUT_DIR)
    t0 = time.perf_counter()
    runner.learn(args.iterations, init_at_random_ep_len=True)
    wall = time.perf_counter() - t0

    track = _curve(os.path.join(runner.log_dir, "metrics.jsonl"))
    ref = _curve(JAX_RUN) if os.path.isfile(JAX_RUN) else []
    if not np.isfinite(track).all():
        print("non-finite tracking_lin_vel", file=sys.stderr)
        return 1
    w = max(len(track) // 10, 1)
    first, last = float(np.mean(track[:w])), float(np.mean(track[-w:]))
    print(f"go1 flat, {args.num_envs} envs, {args.iterations} iterations in "
          f"{wall:.1f} s ({24 * args.num_envs * args.iterations / wall:.0f} "
          f"policy-steps/s) [{card}]")
    print("iteration | tracking_lin_vel (port) | (JAX run)")
    marks = sorted({0, 10, 25, 50, 100, 150, 200, 250, 300, 350,
                    args.iterations - 1})
    rows = []
    for it in marks:
        if it < len(track):
            r = ref[it] if it < len(ref) else None
            rows.append({"iteration": it, "port": track[it], "jax": r})
            print(f"{it:9d} | {track[it]:.4f} | "
                  + ("-" if r is None else f"{r:.4f}"))
    print(f"first {w} iterations mean {first:.4f}, last {w} mean {last:.4f} "
          f"(x{last / max(first, 1e-9):.1f}) [{card}]")
    with open(os.path.join(OUT_DIR, "curve.json"), "w") as fh:
        json.dump({"card": card, "num_envs": args.num_envs,
                   "iterations": args.iterations, "wall_s": wall,
                   "tracking_lin_vel": track, "marks": rows,
                   "first_mean": first, "last_mean": last}, fh)
    if not last > 2.0 * first:
        print(f"tracking_lin_vel did not improve: first {first:.5f}, last "
              f"{last:.5f}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
