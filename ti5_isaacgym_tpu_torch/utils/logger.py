"""Evaluation state logger and plots (port of ``ti5_isaacgym_tpu/utils/logger.py``).

Collects per-step eval-time state (commanded against measured base
velocity, joint position, velocity and torque, foot contact forces) and the
per-episode reward terms, and renders the reference's diagnostic panels to
a PNG file.  Values are stored as numpy arrays on the host.
"""
from __future__ import annotations

import os
from collections import defaultdict
from typing import Dict, List

import numpy as np


def _host(value) -> np.ndarray:
    """A tensor (on any device), array or number as a numpy array."""
    if hasattr(value, "detach"):
        value = value.detach().cpu().numpy()
    return np.asarray(value)


class Logger:
    def __init__(self, dt: float):
        self.dt = dt
        self.state_log: Dict[str, List[np.ndarray]] = defaultdict(list)
        self.rew_log: Dict[str, List[float]] = defaultdict(list)
        self.num_episodes = 0

    def log_state(self, key: str, value):
        self.state_log[key].append(_host(value))

    def log_states(self, d: Dict):
        for k, v in d.items():
            self.log_state(k, v)

    def log_rewards(self, d: Dict, num_episodes: int):
        for k, v in d.items():
            if "rew" in k:
                self.rew_log[k].append(float(v) * num_episodes)
        self.num_episodes += num_episodes

    def reset(self):
        self.state_log.clear()
        self.rew_log.clear()

    def print_rewards(self):
        print("Average rewards per second:")
        for k, values in self.rew_log.items():
            mean = np.sum(np.array(values)) / max(self.num_episodes, 1)
            print(f" - {k}: {mean:.4f}")
        print(f"Total number of episodes: {self.num_episodes}")

    def plot_states(self, out_dir: str):
        """Render the reference's diagnostic panels to ``out_dir/eval_states.png``;
        prints a line and returns when matplotlib is not installed."""
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except ImportError as e:
            print(f"matplotlib unavailable ({e}); skipping plots")
            return
        os.makedirs(out_dir, exist_ok=True)
        log = {k: np.stack(v) for k, v in self.state_log.items() if v}
        if not log:
            return
        t = np.arange(len(next(iter(log.values())))) * self.dt

        fig, axs = plt.subplots(3, 3, figsize=(16, 10))

        def plot(ax, keys, title, ylabel):
            for k in keys:
                if k in log:
                    ax.plot(t[: len(log[k])], log[k], label=k)
            ax.set(title=title, xlabel="time [s]", ylabel=ylabel)
            ax.legend(fontsize=6)

        plot(axs[0, 0], ["base_vel_x", "command_x"], "Base velocity x", "m/s")
        plot(axs[0, 1], ["base_vel_y", "command_y"], "Base velocity y", "m/s")
        plot(axs[0, 2], ["base_vel_yaw", "command_yaw"], "Base velocity yaw", "rad/s")
        plot(axs[1, 0], ["base_vel_z"], "Base velocity z", "m/s")
        plot(axs[1, 1], ["contact_forces_z_l", "contact_forces_z_r"],
             "Feet contact forces", "N")
        plot(axs[1, 2], ["base_height"], "Base height", "m")
        plot(axs[2, 0], ["dof_pos", "dof_pos_target"], "Joint position", "rad")
        plot(axs[2, 1], ["dof_vel"], "Joint velocity", "rad/s")
        plot(axs[2, 2], ["dof_torque"], "Joint torque", "Nm")
        fig.tight_layout()
        path = os.path.join(out_dir, "eval_states.png")
        fig.savefig(path, dpi=110)
        plt.close(fig)
        print(f"wrote {path}")
