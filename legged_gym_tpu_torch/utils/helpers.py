"""CLI args, seeding, and checkpoint path discovery.

Mirrors the reference's utils/helpers.py surface: the same flag names
(--task --resume --experiment_name --run_name --load_run --checkpoint
--headless --num_envs --seed --max_iterations, helpers.py:152-178), the
same precedence (CLI > robot cfg > base cfg, update_cfg_from_args:127-150),
and the same last-run / last-checkpoint resolution (get_load_path:103-125).
``--device`` (default ``cuda``) picks where the env and the trainer run.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import random

import numpy as np
import torch

ROOT_DIR = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
LOG_ROOT = os.path.join(ROOT_DIR, "logs")


def set_seed(seed):
    if seed == -1:
        seed = np.random.randint(0, 10000)
    print(f"Setting seed: {seed}")
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return seed


def snapshot_configs(log_dir, env_cfg, train_cfg):
    """Dump the exact env/train configs into the run dir as JSON so a run
    is reproducible from its logs (reference: task_registry.py:148-155
    pickles env_cfg+train_cfg next to the checkpoints)."""

    def to_jsonable(obj):
        if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
            return {f.name: to_jsonable(getattr(obj, f.name))
                    for f in dataclasses.fields(obj)}
        if isinstance(obj, (list, tuple)):
            return [to_jsonable(v) for v in obj]
        if isinstance(obj, dict):
            return {k: to_jsonable(v) for k, v in obj.items()}
        if isinstance(obj, np.ndarray):
            return obj.tolist()
        if isinstance(obj, (np.floating, np.integer)):
            return obj.item()
        return obj

    os.makedirs(log_dir, exist_ok=True)
    snap = {}
    if env_cfg is not None:
        snap["env_cfg"] = to_jsonable(env_cfg)
    snap["train_cfg"] = to_jsonable(train_cfg)
    with open(os.path.join(log_dir, "config.json"), "w") as fh:
        json.dump(snap, fh, indent=1, default=str)


def get_args(argv=None):
    p = argparse.ArgumentParser("legged_gym_tpu_torch")
    p.add_argument("--task", type=str, default="go1",
                   help="task name from the registry")
    p.add_argument("--resume", action="store_true",
                   help="resume training from a checkpoint")
    p.add_argument("--experiment_name", type=str, default=None)
    p.add_argument("--run_name", type=str, default=None)
    p.add_argument("--load_run", type=str, default=None,
                   help="run dir to load when resume; -1 = last run")
    p.add_argument("--checkpoint", type=int, default=None,
                   help="checkpoint iteration; -1 = last")
    p.add_argument("--headless", action="store_true")
    p.add_argument("--record", action="store_true",
                   help="play: dump a rollout and render it to GIF + PNG "
                        "strip (offline viewer)")
    p.add_argument("--record_steps", type=int, default=None)
    p.add_argument("--num_envs", type=int, default=None)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--max_iterations", type=int, default=None)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device of the env and the trainer "
                        "(cuda, cuda:1, cpu)")
    return p.parse_args(argv)


def update_cfg_from_args(env_cfg, train_cfg, args):
    """CLI overrides (reference update_cfg_from_args, helpers.py:127-150)."""
    if env_cfg is not None:
        if getattr(args, "num_envs", None) is not None:
            env_cfg.env.num_envs = args.num_envs
    if train_cfg is not None:
        if getattr(args, "seed", None) is not None:
            train_cfg.seed = args.seed
        if getattr(args, "max_iterations", None) is not None:
            train_cfg.runner.max_iterations = args.max_iterations
        if getattr(args, "resume", False):
            train_cfg.runner.resume = True
        if getattr(args, "experiment_name", None) is not None:
            train_cfg.runner.experiment_name = args.experiment_name
        if getattr(args, "run_name", None) is not None:
            train_cfg.runner.run_name = args.run_name
        if getattr(args, "load_run", None) is not None:
            train_cfg.runner.load_run = args.load_run
        if getattr(args, "checkpoint", None) is not None:
            train_cfg.runner.checkpoint = args.checkpoint
    return env_cfg, train_cfg


def get_load_path(root, load_run=-1, checkpoint=-1):
    """Resolve run dir + checkpoint file (reference get_load_path,
    helpers.py:103-125; ckpt naming model_<it>.ckpt)."""
    try:
        runs = sorted(os.listdir(root))
        if "exported" in runs:
            runs.remove("exported")
        # ignore run dirs that contain no checkpoints (e.g. the dir a
        # concurrent/aborted run just created)
        runs = [r for r in runs
                if any("model" in f
                       for f in os.listdir(os.path.join(root, r)))]
        last_run = os.path.join(root, runs[-1])
    except (IndexError, FileNotFoundError):
        raise ValueError(f"No runs in this directory: {root}")
    if load_run in (-1, "-1", None):
        load_run = last_run
    else:
        load_run = os.path.join(root, str(load_run))

    if checkpoint in (-1, None):
        models = [f for f in os.listdir(load_run) if "model" in f]
        models.sort(key=lambda m: f"{m:0>15}")
        model = models[-1]
    else:
        model = f"model_{checkpoint}.ckpt"
    return os.path.join(load_run, model)
