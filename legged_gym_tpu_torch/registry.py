"""Task registry: name -> config factory; env + runner construction (the
analog of the reference's ``task_registry``, task_registry.py:30-170):
``make_env`` builds the environment, ``make_runner`` the PPO runner with
run-dir / resume handling. Registration order matches the reference's
envs/__init__.py:52-59. Every task builds; the env picks its physics path
(the fused chain step, or the general stacked engine for
``anymal_c_flat``'s self-collision and the other cases in
envs/legged_env.py)."""
from __future__ import annotations

import os

from legged_gym_tpu_torch import robots, set_full_fp32
from legged_gym_tpu_torch.envs.legged_env import LeggedEnv

_REGISTRY = {}


def register(name, factory):
    _REGISTRY[name] = factory


def get_cfgs(name):
    if name not in _REGISTRY:
        raise KeyError(f"Task not registered: {name} "
                       f"(available: {', '.join(_REGISTRY)})")
    return _REGISTRY[name]()


def task_names():
    return list(_REGISTRY)


def make_env(name=None, args=None, cfg=None, seed=None, device="cuda",
             mesh=None):
    """Build (LeggedEnv, env_cfg) on ``device`` (the card unless the caller
    asks for the CPU). CLI args override config fields (reference
    make_env, task_registry.py:67-104). Keeps float32 matmuls in full
    precision (no TF32). ``mesh``: an EnvMesh (parallel/sharding.py); the
    env then simulates this rank's share of the envs on ``mesh.device``."""
    if cfg is None:
        cfg, _ = get_cfgs(name)
    if args is not None:
        from legged_gym_tpu_torch.utils.helpers import update_cfg_from_args
        cfg, _ = update_cfg_from_args(cfg, None, args)
    set_full_fp32()
    if mesh is not None:
        device = mesh.device
    env = LeggedEnv(cfg, seed=0 if seed is None else seed, device=device,
                    mesh=mesh)
    return env, cfg


def make_runner(env, name=None, args=None, train_cfg=None,
                log_root="default"):
    """Build (PPORunner, train_cfg) with the reference's run-dir layout
    logs/<experiment_name>/<date>_<run_name> (task_registry.py:106-160).
    The runner trains on the env's device; with the env split over ranks
    (its ``mesh``) on every rank of the split, where only rank 0 writes
    the run dir."""
    from datetime import datetime

    from legged_gym_tpu_torch.rl.runner import PPORunner
    from legged_gym_tpu_torch.utils import helpers

    if train_cfg is None:
        if name is None:
            raise ValueError("either name or train_cfg must be given")
        _, train_cfg = get_cfgs(name)
    if args is not None:
        _, train_cfg = helpers.update_cfg_from_args(None, train_cfg, args)

    if log_root == "default":
        log_root = os.path.join(helpers.LOG_ROOT,
                                train_cfg.runner.experiment_name)
    mesh = getattr(env, "mesh", None)
    if log_root is None or (mesh is not None and mesh.rank != 0):
        log_dir = None
    else:
        stamp = datetime.now().strftime("%b%d_%H-%M-%S")
        log_dir = os.path.join(
            log_root, stamp + "_" + train_cfg.runner.run_name)

    # resolve the resume checkpoint BEFORE the runner creates its new run
    # dir — otherwise the fresh (model-less) dir is itself the "last run"
    load_path = None
    if train_cfg.runner.resume:
        load_path = helpers.get_load_path(
            log_root, load_run=train_cfg.runner.load_run,
            checkpoint=train_cfg.runner.checkpoint)

    runner = PPORunner(env, train_cfg, log_dir=log_dir)
    if log_dir is not None:
        # snapshot the exact configs next to the checkpoints so any run
        # is reproducible from its log dir
        helpers.snapshot_configs(log_dir, getattr(env, "cfg", None),
                                 train_cfg)
    if load_path is not None:
        print(f"Loading model from: {load_path}")
        runner.load(load_path)
    return runner, train_cfg


register("anymal_c_rough", robots.anymal_c_rough)
register("anymal_c_flat", robots.anymal_c_flat)
register("anymal_b", robots.anymal_b)
register("a1", robots.a1)
register("cassie", robots.cassie)
register("a1_src", robots.a1_src)
register("go1", robots.go1)
register("aliengo", robots.aliengo)
