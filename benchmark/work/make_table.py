"""Make the frozen work table of a kernel launch: the float operations
and the bytes one launch of the physics step needs per env, counted on
the reference's plain chain step (reference/physics/chain_step.py), never
on the port's code. A kernel's roofline and a step's MFU read these
files, so the yardstick stays the same whatever implements the step.

    python3 -m benchmark.work.make_table go1_rough go1_K2
    python3 -m benchmark.work.make_table anymal_c_rough anymal_c_K3

builds the configuration's env on the CPU at 4 and at 8 envs, records the
arguments of the first launch of one env step and the launches per step,
counts the operations by aten op (``count_flops``: per env, and the few
on the step's constants that do not grow with the envs) and the bytes by
the rule of ``launch_bytes``, and writes work/<name>.json.
"""
from __future__ import annotations

import argparse
import json
import os

import torch

from benchmark import spec

HERE = os.path.dirname(os.path.abspath(__file__))
COUNT_ENVS = 4
# the name the port gives the physics step's kernel on the device
KERNEL = "chain_step_kernel"

# elementwise aten ops that count one operation per output element
ARITH = {"add", "sub", "mul", "div", "neg", "sqrt", "rsqrt", "sin", "cos",
         "reciprocal", "clamp", "clamp_min", "clamp_max", "minimum",
         "maximum", "floor", "where", "atan2", "exp"}


def count_flops(fn):
    """Floating-point operations of ``fn`` by aten op: one per output
    element of each elementwise arithmetic op (sqrt, division and
    sin / cos count as one), n - 1 per n-element sum. Indexing, stacking,
    copies and comparisons count nothing."""
    from torch.utils._python_dispatch import TorchDispatchMode

    total = [0]

    class Counter(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            name = func.overloadpacket.__name__.rstrip("_")
            if name in ARITH and isinstance(out, torch.Tensor) \
                    and out.is_floating_point():
                total[0] += out.numel()
            elif name == "sum" and isinstance(args[0], torch.Tensor):
                total[0] += args[0].numel() - out.numel()
            return out

    with Counter():
        fn()
    return total[0]


def launch_bytes(cc, tensors, n_points, n):
    """Bytes one launch must move: each tensor of ``tensors`` (inputs
    without the contact patch, outputs, anchors both ways) once, and of
    each env's contact patch only the cells a launch can read: the four
    corners of the query cell of each contact point, once per plane
    sampling (one, or one per sim dt). The kernel's constant table, a
    few KB whatever the env count, is left out."""
    n_bytes = sum(t.numel() * t.element_size() for t in tensors)
    samplings = 1 if cc.plane_per_step else cc.decimation
    cells = min(cc.patch_S ** 2, 4 * n_points * samplings)
    return n_bytes + 4 * cells * n


def reference_env(config, num_envs, seed=0):
    """The reference's env of a configuration file on the CPU."""
    from benchmark.reference import config as ref_config
    from benchmark.reference.envs.legged_env import LeggedEnv

    env_cfg, _ = spec.build_cfgs(ref_config, config, num_envs)
    return LeggedEnv(env_cfg, seed=seed, device="cpu")


def launches_of_one_step(env):
    """[(cc, args, anchors)] of every physics launch of one zero-action
    env step from the reset state."""
    from benchmark.reference.physics import chain_kernel

    seen = []
    run = chain_kernel.run_decimation

    def record(cc, *args, anchors=None, cv=None, consts=None):
        seen.append((cc, [a.clone() for a in args],
                     None if anchors is None else anchors.clone()))
        return run(cc, *args, anchors=anchors, cv=cv, consts=consts)

    state, _ = env.reset()
    chain_kernel.run_decimation = record
    try:
        with torch.no_grad():
            env.step(state, torch.zeros((env.num_envs, env.num_actions)))
    finally:
        chain_kernel.run_decimation = run
    return seen


def count(config, num_envs):
    """The first launch of a step of a configuration's env at ``num_envs``
    envs: its operations and bytes, the launches per step, the variant."""
    from benchmark.reference.physics import chain_step

    env = reference_env(config, num_envs)
    seen = launches_of_one_step(env)
    cc, args, anchors = seen[0]
    cv = chain_step.const_tensors(cc, "cpu")

    def plain():
        return chain_step.run_decimation_chain(cc, *args, cv=cv,
                                               anchors=anchors)

    ops = count_flops(plain)
    outs = list(plain())
    moved = [a for i, a in enumerate(args) if i != 4] + outs
    if anchors is not None:
        moved.append(anchors)
    return {"variant": chain_step.variant(cc), "ops": ops,
            "bytes": launch_bytes(cc, moved, chain_step.n_points(cc.cm),
                                  num_envs),
            "launches_per_policy_step": len(seen)}


def entry(config, num_envs=COUNT_ENVS):
    """The work table's entry: operations per env and the few that do not
    grow with the env count (the plain step's work on its constants),
    from counts at ``num_envs`` and twice as many; bytes per env."""
    one, two = count(config, num_envs), count(config, 2 * num_envs)
    per_env = (two["ops"] - one["ops"]) // num_envs
    if (two["ops"] - one["ops"]) % num_envs or one["bytes"] % num_envs:
        raise ValueError("work does not divide by the env count")
    return {"kernel": KERNEL, "variant": one["variant"],
            "ops_per_env": per_env,
            "ops_fixed": one["ops"] - per_env * num_envs,
            "bytes_per_env": one["bytes"] // num_envs,
            "launches_per_policy_step": one["launches_per_policy_step"]}


def launch_ops(work, num_envs):
    """Operations of one launch at ``num_envs`` envs by the table."""
    return work["ops_per_env"] * num_envs + work["ops_fixed"]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("config")
    ap.add_argument("name")
    a = ap.parse_args()
    torch.set_num_threads(1)
    config = spec.load_json(spec.HERE, "configs", a.config + ".json")
    work = {"config": a.config, **entry(config)}
    with open(os.path.join(HERE, a.name + ".json"), "w") as fh:
        json.dump(work, fh, indent=1)
        fh.write("\n")
    print(json.dumps(work))


if __name__ == "__main__":
    main()
