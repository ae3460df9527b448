"""Training entry point (reference scripts/train.py:33-47).

    python -m legged_gym_tpu_torch.scripts.train --task go1 --num_envs 1800

Trains on the card; ``--device cpu`` asks for the CPU. One rank per card,
the env axis split over them:

    python -m torch.distributed.run --nproc_per_node=<cards> \\
        -m legged_gym_tpu_torch.scripts.train --task go1 --shard

``--multihost`` with ``--coordinator_address``, ``--num_processes`` and
``--process_id`` joins a multi-node group without torchrun.
"""
import os

import torch.distributed as dist

from legged_gym_tpu_torch import registry
from legged_gym_tpu_torch.utils import helpers


def _join(args):
    """The EnvMesh of a --shard / --multihost run, after joining the
    process group (NCCL for cards, gloo for CPU ranks)."""
    from legged_gym_tpu_torch.parallel import env_mesh, init_multihost

    backend = "gloo" if args.device == "cpu" else "nccl"
    if args.multihost:
        init_multihost(args.coordinator_address, args.num_processes,
                       args.process_id, backend=backend)
    elif not dist.is_initialized():
        if not all(k in os.environ for k in ("RANK", "WORLD_SIZE",
                                             "MASTER_ADDR", "MASTER_PORT")):
            raise RuntimeError(
                "--shard needs the ranks of a process group: launch with "
                "torchrun (python -m torch.distributed.run "
                "--nproc_per_node=<cards> -m "
                "legged_gym_tpu_torch.scripts.train --shard ...), or pass "
                "--multihost with --coordinator_address, --num_processes "
                "and --process_id")
        init_multihost(backend=backend)
    mesh = env_mesh(device=args.device)
    print(f"rank {mesh.rank} of {mesh.world_size} on {mesh.device}")
    return mesh


def train(args):
    mesh = None
    joined = False
    try:
        if getattr(args, "shard", False) or getattr(args, "multihost", False):
            joined = not dist.is_initialized()
            mesh = _join(args)
        helpers.set_seed(args.seed if args.seed is not None else 1)
        env, env_cfg = registry.make_env(name=args.task, args=args,
                                         device=args.device, mesh=mesh)
        runner, train_cfg = registry.make_runner(env, name=args.task,
                                                 args=args)
        runner.learn(train_cfg.runner.max_iterations,
                     init_at_random_ep_len=True)
        return runner
    finally:
        if joined and dist.is_initialized():
            dist.destroy_process_group()


def main():
    """Console-script entry (pyproject.toml lgt-torch-train)."""
    train(helpers.get_args())


if __name__ == "__main__":
    main()
