"""Task registry: name -> config factory; env construction (the analog of
the reference's ``task_registry``, task_registry.py:30-170). The port
registers go1, the robot of its main path."""
from __future__ import annotations

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


def make_env(name=None, cfg=None, seed=None, device="cuda"):
    """Build (LeggedEnv, env_cfg) on ``device`` (the card unless the caller
    asks for the CPU). Keeps float32 matmuls in full precision (no TF32)."""
    if cfg is None:
        cfg, _ = get_cfgs(name)
    set_full_fp32()
    env = LeggedEnv(cfg, seed=0 if seed is None else seed, device=device)
    return env, cfg


register("go1", robots.go1)
