"""Interactive teleop: drive a trained policy with the keyboard (the JAX
package's scripts/teleop.py, the ROS-free analog of the reference's
play_joy.py:15-217 — /joy messages become WASD/QE keys; the ~50 ROS debug
topics become a live status line; commands flow through
env.set_commands, the _change_cmds equivalent).

    python -m legged_gym_tpu_torch.scripts.teleop --task go1

Keys: w/s = +/- vx, a/d = +/- vy, q/e = +/- yaw rate, space = stop,
x = quit. Requires a TTY. Runs on the card; ``--device cpu`` asks for the
CPU.
"""
import select
import sys
import termios
import tty

import torch

from legged_gym_tpu_torch import registry
from legged_gym_tpu_torch.utils import helpers

VX_STEP, VY_STEP, WZ_STEP = 0.1, 0.1, 0.1


def _read_key(timeout=0.0):
    if select.select([sys.stdin], [], [], timeout)[0]:
        return sys.stdin.read(1)
    return None


def teleop_cfg(task):
    """(env_cfg, train_cfg) of ``task`` for one manually commanded robot:
    no noise, no pushes, no heading command, commands never resampled."""
    env_cfg, train_cfg = registry.get_cfgs(task)
    env_cfg.env.num_envs = 1
    env_cfg.noise.add_noise = False
    env_cfg.domain_rand.push_robots = False
    env_cfg.commands.heading_command = False
    env_cfg.commands.resampling_time = 1e9   # manual commands only
    return env_cfg, train_cfg


def teleop(args):
    env_cfg, train_cfg = teleop_cfg(args.task)
    env, _ = registry.make_env(cfg=env_cfg, device=args.device)

    train_cfg.runner.resume = True
    runner, _ = registry.make_runner(env, train_cfg=train_cfg, args=args)
    policy = runner.get_inference_policy()

    with torch.no_grad():
        state, obs = env.reset()
    vx = vy = wz = 0.0
    keys = {"w": (VX_STEP, 0, 0), "s": (-VX_STEP, 0, 0),
            "a": (0, VY_STEP, 0), "d": (0, -VY_STEP, 0),
            "q": (0, 0, WZ_STEP), "e": (0, 0, -WZ_STEP)}

    old = termios.tcgetattr(sys.stdin)
    tty.setcbreak(sys.stdin.fileno())
    try:
        while True:
            k = _read_key()
            if k == "x":
                break
            if k == " ":
                vx = vy = wz = 0.0
            elif k in keys:
                dx, dy, dz = keys[k]
                vx, vy, wz = vx + dx, vy + dy, wz + dz
            with torch.no_grad():
                state = env.set_commands(state, vx, vy, wz)
                state, tr = env.step(state, policy(obs))
            obs = tr.obs
            blv = state.physics.base_lin_vel()[:, 0].tolist()
            z = float(state.physics.pos[2, 0])
            print(f"\rcmd ({vx:+.1f} {vy:+.1f} {wz:+.1f}) "
                  f"vel ({blv[0]:+.2f} {blv[1]:+.2f}) z {z:.2f}  ",
                  end="", flush=True)
    finally:
        termios.tcsetattr(sys.stdin, termios.TCSADRAIN, old)
        print()


def main():
    teleop(helpers.get_args())


if __name__ == "__main__":
    main()
