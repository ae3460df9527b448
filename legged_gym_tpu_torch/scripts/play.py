"""Policy evaluation and deployment export (reference scripts/play.py:33-128;
the JAX package's scripts/play.py): a small env count, a flat 5 x 5 terrain
without curriculum, domain randomization, noise and pushes off; loads the
last checkpoint, exports the actor as ``.npz``, rolls out and logs states.

    python -m legged_gym_tpu_torch.scripts.play --task go1 [--record]

Plays on the card; ``--device cpu`` asks for the CPU. ``--record`` renders
the first ``--record_steps`` (250) steps to a GIF and a PNG strip next to
the export.
"""
import os

import numpy as np
import torch

from legged_gym_tpu_torch import registry
from legged_gym_tpu_torch.utils import helpers
from legged_gym_tpu_torch.utils.logger import Logger

EXPORT_POLICY = True


def play(args, num_steps=1000, log_root="default"):
    """Roll out the last checkpoint of ``args.task`` for ``num_steps``.
    ``log_root``: the experiment's log dir (default
    logs/<experiment_name>), where the checkpoint is looked up and the
    export is written. Returns {"runner", "env", "state", "obs",
    "policy", "export"} of the rollout's end."""
    env_cfg, train_cfg = registry.get_cfgs(args.task)
    # override for evaluation (play.py:45-58)
    env_cfg.env.num_envs = min(env_cfg.env.num_envs, args.num_envs or 25)
    env_cfg.terrain.num_rows = 5
    env_cfg.terrain.num_cols = 5
    env_cfg.terrain.curriculum = False
    env_cfg.noise.add_noise = False
    env_cfg.domain_rand.randomize_friction = False
    env_cfg.domain_rand.push_robots = False
    env_cfg.domain_rand.randomize_base_mass = False
    env_cfg.domain_rand.randomize_limb_mass = False

    args.num_envs = env_cfg.env.num_envs
    env, _ = registry.make_env(cfg=env_cfg, device=args.device)

    train_cfg.runner.resume = True
    runner, train_cfg = registry.make_runner(env, train_cfg=train_cfg,
                                             args=args, log_root=log_root)
    policy = runner.get_inference_policy()
    if log_root == "default":
        log_root = os.path.join(helpers.LOG_ROOT,
                                train_cfg.runner.experiment_name)
    exported = os.path.join(log_root, "exported")

    path = None
    if EXPORT_POLICY:
        path = runner.export_policy(os.path.join(exported, "policies",
                                                 "policy.npz"))
        print("Exported policy to:", path)

    logger = Logger(env.dt)
    robot_index = 0
    joint_index = 1
    stop_state_log = 100
    stop_rew_log = env.max_episode_length + 1

    record = bool(getattr(args, "record", False))
    rec_frames = []
    rec_steps = int(getattr(args, "record_steps", None) or 250)

    def host(t):
        return t.detach().cpu().numpy()

    with torch.no_grad():
        state, obs = env.reset()
        for i in range(num_steps):
            actions = policy(obs)
            state, tr = env.step(state, actions)
            obs = tr.obs
            if record and i < rec_steps:
                rec_frames.append((host(state.physics.pos),
                                   host(state.physics.quat),
                                   host(state.physics.q)))
                if i == min(rec_steps, num_steps) - 1:
                    render(env, rec_frames, exported, robot_index)
            if i < stop_state_log:
                q = host(state.physics.q)
                qd = host(state.physics.qd)
                cmds = host(state.commands)
                blv = host(state.physics.base_lin_vel())
                bav = host(state.physics.base_ang_vel())
                taus = host(tr.torques)
                fz = host(tr.feet_contact_z)
                logger.log_states({
                    "dof_torque": taus[joint_index, robot_index],
                    "contact_forces_z": (fz[:, robot_index].sum()
                                         if fz.size else 0.0),
                    "power": float(
                        (taus[:, robot_index] * qd[:, robot_index]).sum()),
                    "dof_pos_target": float(
                        host(actions)[robot_index, joint_index]
                        * env.cfg.control.action_scale),
                    "dof_pos": q[joint_index, robot_index],
                    "dof_vel": qd[joint_index, robot_index],
                    "command_x": cmds[0, robot_index],
                    "command_y": cmds[1, robot_index],
                    "command_yaw": cmds[2, robot_index],
                    "base_vel_x": blv[0, robot_index],
                    "base_vel_y": blv[1, robot_index],
                    "base_vel_z": blv[2, robot_index],
                    "base_vel_yaw": bav[2, robot_index],
                })
            elif i == stop_state_log:
                logger.plot_states()
            if i < stop_rew_log:
                done_count = int(tr.episode_count)
                if done_count > 0:
                    logger.log_rewards(
                        {k: float(v) for k, v in tr.episode_sums.items()},
                        done_count)
            elif i == stop_rew_log:
                logger.print_rewards()
    return {"runner": runner, "env": env, "state": state, "obs": obs,
            "policy": policy, "export": path}


def render(env, frames, out_dir, env_index):
    """The recorded frames as exported/rollout.gif and a PNG strip."""
    from legged_gym_tpu_torch.utils.render import render_trajectory

    os.makedirs(out_dir, exist_ok=True)
    files = render_trajectory(env, frames, os.path.join(out_dir,
                                                        "rollout.gif"),
                              env_index=env_index, strip_every=10)
    print("Recorded rollout:", ", ".join(files))
    return files


def exported_policy(path):
    """The actor of an exported ``policy.npz`` as a plain numpy function,
    obs (N, D) -> actions (N, na), holding the LSTM carry between calls
    for a recurrent export (the deployment side of export_policy)."""
    def sigmoid(x):
        return 1.0 / (1.0 + np.exp(-x))

    def elu(x):
        return np.where(x > 0, x, np.expm1(np.minimum(x, 0.0)))

    with np.load(path) as f:
        z = dict(f)
    act = {"elu": elu,
           "selu": lambda x: 1.0507009873554805 * elu(x) * np.where(
               x > 0, 1.0, 1.6732632423543772),
           "relu": lambda x: np.maximum(x, 0.0),
           "lrelu": lambda x: np.where(x > 0, x, 0.01 * x),
           "tanh": np.tanh, "sigmoid": sigmoid}[str(z["activation"])]
    n_layers = len([k for k in z if k.startswith("w")])
    n_lstm = len([k for k in z if k.startswith("lstm_w")])
    carry = {}

    def policy(obs):
        x = np.asarray(obs, np.float32)
        for i in range(n_lstm):
            w, b = z[f"lstm_w{i}"], z[f"lstm_b{i}"]
            zero = np.zeros((x.shape[0], b.shape[0] // 4), np.float32)
            h, c = carry.get(i, (zero, zero))
            gi, gf, gg, go = np.split(np.concatenate([x, h], -1) @ w + b, 4,
                                      axis=-1)
            c = sigmoid(gf) * c + sigmoid(gi) * np.tanh(gg)
            h = sigmoid(go) * np.tanh(c)
            carry[i] = (h, c)
            x = h
        for i in range(n_layers):
            x = x @ z[f"w{i}"] + z[f"b{i}"]
            if i < n_layers - 1:
                x = act(x)
        return x

    policy.reset_memory = carry.clear
    return policy


def main():
    """Console-script entry (pyproject.toml lgt-torch-play)."""
    play(helpers.get_args())


if __name__ == "__main__":
    main()
