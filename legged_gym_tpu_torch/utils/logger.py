"""Per-step state/reward logger with the 3x3 matplotlib dashboard
(reference utils/logger.py:36-136; the JAX package's utils/logger.py).
Plotting runs in a child process so the rollout keeps stepping, and
imports matplotlib there only; headless environments fall back to saving
the figure to a file. The values it logs are host floats.
"""
from __future__ import annotations

from collections import defaultdict
from multiprocessing import Process


class Logger:
    def __init__(self, dt):
        self.state_log = defaultdict(list)
        self.rew_log = defaultdict(float)
        self.dt = dt
        self.num_episodes = 0
        self.plot_process = None

    def log_state(self, key, value):
        self.state_log[key].append(value)

    def log_states(self, state_dict):
        for key, value in state_dict.items():
            self.log_state(key, value)

    def log_rewards(self, sums_dict, num_episodes):
        """sums_dict: per-term reward SUMS over episodes finished this
        step (already normalized by episode seconds in the env)."""
        for key, value in sums_dict.items():
            self.rew_log["rew_" + key] += value * num_episodes
        self.num_episodes += num_episodes

    def reset(self):
        self.state_log.clear()
        self.rew_log.clear()

    def plot_states(self):
        self.plot_process = Process(target=self._plot)
        self.plot_process.start()

    def _plot(self):
        import matplotlib
        import matplotlib.pyplot as plt
        log = self.state_log
        nb_rows, nb_cols = 3, 3
        fig, axs = plt.subplots(nb_rows, nb_cols, figsize=(14, 9))
        time = [i * self.dt for i in range(
            max((len(v) for v in log.values()), default=0))]

        def plot(ax, keys, title, ylabel):
            for k, lbl in keys:
                if log.get(k):
                    ax.plot(time[: len(log[k])], log[k], label=lbl)
            ax.set(xlabel="time [s]", ylabel=ylabel, title=title)
            ax.legend()

        plot(axs[0, 0], [("base_vel_x", "measured"),
                         ("command_x", "commanded")],
             "Base velocity x", "[m/s]")
        plot(axs[0, 1], [("base_vel_y", "measured"),
                         ("command_y", "commanded")],
             "Base velocity y", "[m/s]")
        plot(axs[0, 2], [("base_vel_yaw", "measured"),
                         ("command_yaw", "commanded")],
             "Base velocity yaw", "[rad/s]")
        plot(axs[1, 0], [("base_vel_z", "measured")],
             "Base velocity z", "[m/s]")
        plot(axs[1, 1], [("dof_pos", "measured"),
                         ("dof_pos_target", "target")],
             "DOF Position", "[rad]")
        plot(axs[1, 2], [("dof_vel", "measured")],
             "Joint Velocity", "[rad/s]")
        plot(axs[2, 0], [("dof_torque", "measured")],
             "Joint Torque", "[Nm]")
        plot(axs[2, 1], [("contact_forces_z", "forces z")],
             "Vertical Contact forces", "[N]")
        plot(axs[2, 2], [("power", "power")], "Power", "[W]")
        try:
            plt.show()
        except Exception:
            pass
        if matplotlib.get_backend().lower() == "agg":
            fig.savefig("play_states.png", dpi=100)
            print("Saved state plots to play_states.png")

    def print_rewards(self):
        print("Average rewards per second:")
        for key, values in self.rew_log.items():
            mean = values / max(self.num_episodes, 1)
            print(f" - {key}: {mean:.4f}")
        print(f"Total number of episodes: {self.num_episodes}")

    def __del__(self):
        if self.plot_process is not None:
            self.plot_process.kill()
