"""Offline trajectory rendering in place of the reference's interactive
Isaac viewer (base_task.py:92-99,120-144); the JAX package's
utils/render.py.

The rollout dumps (base pose, joint angles) per frame, and this module
renders them host-side with matplotlib (imported inside
render_trajectory only): a 3D stick-figure skeleton (links as segments)
over the terrain heightfield, with the height-scan points. Output:
animated GIF (and a PNG strip) — ``scripts.play --record`` produces a
watchable gait. Forward kinematics and the height scan run with the
port's torch functions on the CPU.
"""
from __future__ import annotations

import dataclasses

import numpy as np


def stack_frames(frames):
    """frames: list of (pos (3,N), quat (4,N), q (nq,N)) numpy triples ->
    batch-last stacked arrays with the frame axis as the batch."""
    pos = np.stack([f[0] for f in frames], axis=-1)    # (3, N, T) -> pick env
    quat = np.stack([f[1] for f in frames], axis=-1)
    q = np.stack([f[2] for f in frames], axis=-1)
    return pos, quat, q


def _host_state(pos, quat, q):
    """A PhysicsState on the CPU for ONE env's stacked trajectory (frame
    axis as the batch), zero velocities."""
    import torch

    from legged_gym_tpu_torch.physics.state import PhysicsState

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32))

    pos, quat, q = t(pos), t(quat), t(q)
    return PhysicsState(pos=pos, quat=quat,
                        vel=torch.zeros((6, pos.shape[-1])), q=q,
                        qd=torch.zeros_like(q))


def link_positions(model, pos, quat, q):
    """World link origins (3, nl, T) for a stacked trajectory of ONE env:
    pos (3, T), quat (4, T), q (nq, T). Runs FK on the host CPU."""
    import torch

    from legged_gym_tpu_torch.physics.kinematics import forward_kinematics

    with torch.no_grad():
        fk = forward_kinematics(model, _host_state(pos, quat, q))
    return fk.p_w.numpy()


def scan_points_world(env, pos, quat):
    """Height-scan debug points for ONE env's stacked trajectory
    (reference _draw_debug_vis, legged_robot.py:781-800: the viewer
    draws the measured heights as spheres). pos (3, T), quat (4, T) ->
    (3, P, T) world points: xy = yaw-rotated scan grid + base xy,
    z = the measured (min-of-3-cells) terrain height — what the
    policy's height observation sees, so a mis-tracking scan is visible
    against the terrain wireframe. Runs on the host CPU. None if the env
    has no height scan."""
    if not getattr(env, "measure_heights", False) or env.grid is None:
        return None
    import torch

    from legged_gym_tpu_torch.ops import quat as quat_ops
    from legged_gym_tpu_torch.terrain.heightfield import sample_min3

    T = np.shape(pos)[-1]
    st = _host_state(pos, quat, np.zeros((env.model.nq, T), np.float32))
    grid = dataclasses.replace(env.grid, height=env.grid.height.cpu())
    pts = torch.as_tensor(env.height_points, dtype=torch.float32)  # (2, P)
    p3 = torch.cat([pts, torch.zeros_like(pts[:1])])
    with torch.no_grad():
        rot = quat_ops.yaw_rotate(st.quat[:, None, :], p3[:, :, None])
        x = rot[0] + st.pos[0][None, :]
        y = rot[1] + st.pos[1][None, :]
        measured = sample_min3(grid, x, y)                  # (P, T)
    return np.stack([x.numpy(), y.numpy(), measured.numpy()])


def _terrain_window(grid, xy_min, xy_max, max_cells=60):
    """Static heightfield wireframe around the trajectory."""
    if grid is None:
        xs = np.linspace(xy_min[0] - 0.5, xy_max[0] + 0.5, 2)
        ys = np.linspace(xy_min[1] - 0.5, xy_max[1] + 0.5, 2)
        X, Y = np.meshgrid(xs, ys, indexing="ij")
        return X, Y, np.zeros_like(X)
    hs = grid.horizontal_scale
    H = grid.height.cpu().numpy()
    r0 = max(int((xy_min[0] - 0.5 + grid.border_size) / hs), 0)
    r1 = min(int((xy_max[0] + 0.5 + grid.border_size) / hs) + 2, H.shape[0])
    c0 = max(int((xy_min[1] - 0.5 + grid.border_size) / hs), 0)
    c1 = min(int((xy_max[1] + 0.5 + grid.border_size) / hs) + 2, H.shape[1])
    step = max(1, (r1 - r0) // max_cells, (c1 - c0) // max_cells)
    rr = np.arange(r0, r1, step)
    cc = np.arange(c0, c1, step)
    X = rr[:, None] * hs - grid.border_size + 0 * cc[None, :]
    Y = 0 * rr[:, None] + cc[None, :] * hs - grid.border_size
    return X, Y, H[np.ix_(rr, cc)]


def render_trajectory(env, frames, path, env_index=0, stride=2, fps=25,
                      strip_every=0):
    """Render a recorded rollout to an animated GIF.

    frames: list of (pos, quat, q) numpy triples (batch-last, all envs);
    env_index picks the robot. stride subsamples frames. strip_every > 0
    additionally writes a PNG contact-sheet every that-many rendered
    frames. Returns the list of files written."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    model = env.model
    pos, quat, q = stack_frames(frames)
    e = env_index
    pw = link_positions(model, pos[:, e], quat[:, e], q[:, e])  # (3,nl,T)
    pw = pw[..., ::stride]
    T = pw.shape[-1]
    parent = np.asarray(model.link_parent)
    scan = scan_points_world(env, pos[:, e], quat[:, e])   # (3, P, T)|None
    if scan is not None:
        scan = scan[..., ::stride]

    xy_min = pw[:2].reshape(2, -1).min(axis=1)
    xy_max = pw[:2].reshape(2, -1).max(axis=1)
    X, Y, Z = _terrain_window(getattr(env, "grid", None), xy_min, xy_max)

    fig = plt.figure(figsize=(6, 5))
    ax = fig.add_subplot(projection="3d")

    def draw(t):
        ax.cla()
        ax.plot_wireframe(X, Y, Z, color="0.75", linewidth=0.5,
                          rstride=1, cstride=1)
        for li in range(1, model.nl):
            pi = parent[li]
            ax.plot([pw[0, pi, t], pw[0, li, t]],
                    [pw[1, pi, t], pw[1, li, t]],
                    [pw[2, pi, t], pw[2, li, t]], "-o",
                    color="C0", markersize=2, linewidth=1.5)
        b = pw[:, 0, t]
        ax.scatter(*b, color="C3", s=40)
        if scan is not None:
            # measured height-scan points (debug-vis spheres analog)
            ax.scatter(scan[0, :, t], scan[1, :, t], scan[2, :, t],
                       color="C2", s=3, alpha=0.6, depthshade=False)
        ax.set_xlim(b[0] - 0.8, b[0] + 0.8)
        ax.set_ylim(b[1] - 0.8, b[1] + 0.8)
        ax.set_zlim(b[2] - 0.6, b[2] + 0.6)
        ax.set_box_aspect((1, 1, 0.75))
        ax.set_title(f"frame {t * stride}")

    written = []
    from matplotlib.animation import FuncAnimation, PillowWriter
    anim = FuncAnimation(fig, draw, frames=T, interval=1000 / fps)
    gif = path if path.endswith(".gif") else path + ".gif"
    anim.save(gif, writer=PillowWriter(fps=fps))
    written.append(gif)

    if strip_every > 0:
        cols = min(8, max(1, T // strip_every))
        figs, axs = plt.subplots(1, cols, figsize=(2.2 * cols, 2.4),
                                 subplot_kw={"projection": "3d"})
        axs = np.atleast_1d(axs)
        for k, axk in enumerate(axs):
            t = min(k * strip_every, T - 1)
            axk.plot_wireframe(X, Y, Z, color="0.8", linewidth=0.4)
            for li in range(1, model.nl):
                pi = parent[li]
                axk.plot([pw[0, pi, t], pw[0, li, t]],
                         [pw[1, pi, t], pw[1, li, t]],
                         [pw[2, pi, t], pw[2, li, t]], "-o",
                         color="C0", markersize=1.5, linewidth=1.0)
            b = pw[:, 0, t]
            axk.set_xlim(b[0] - 0.7, b[0] + 0.7)
            axk.set_ylim(b[1] - 0.7, b[1] + 0.7)
            axk.set_zlim(b[2] - 0.5, b[2] + 0.5)
            axk.set_axis_off()
        strip = gif.rsplit(".", 1)[0] + "_strip.png"
        figs.savefig(strip, dpi=110, bbox_inches="tight")
        written.append(strip)
        plt.close(figs)
    plt.close(fig)
    return written
