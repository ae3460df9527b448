"""Training entry point (reference scripts/train.py:33-47).

    python -m legged_gym_tpu_torch.scripts.train --task go1 --num_envs 1800

Trains on the card; ``--device cpu`` asks for the CPU.
"""
from legged_gym_tpu_torch import registry
from legged_gym_tpu_torch.utils import helpers


def train(args):
    helpers.set_seed(args.seed if args.seed is not None else 1)
    env, env_cfg = registry.make_env(name=args.task, args=args,
                                     device=args.device)
    runner, train_cfg = registry.make_runner(env, name=args.task, args=args)
    runner.learn(train_cfg.runner.max_iterations,
                 init_at_random_ep_len=True)
    return runner


def main():
    """Console-script entry (pyproject.toml lgt-torch-train)."""
    train(helpers.get_args())


if __name__ == "__main__":
    main()
