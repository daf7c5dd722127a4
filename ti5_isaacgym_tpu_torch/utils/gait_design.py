"""Offline gait-curve and reward-shape design tools (port of
``ti5_isaacgym_tpu/utils/gait_design.py``, a numpy copy; reference C25:
``humanoid/utils/calculate_gait.py``, ``scripts/plot_cdes.py``,
``scripts/plot_gck.py``).

Designer utilities, not training-path code: a quintic swing-foot height
profile solved from boundary conditions, the phase-indicator C_des curve
(smoothed double-support windows), and the Gaussian / Cauchy reward shaping
kernels.  :func:`plot_design` writes the three figures to PNG headlessly
(matplotlib's Agg backend, imported inside it):

    python -m ti5_isaacgym_tpu_torch.utils.gait_design <out_dir>
"""
from __future__ import annotations

import math
import os
from typing import Tuple

import numpy as np


def quintic_swing_coefficients(h0: float, h_end: float, v0: float, v_end: float,
                               h_max: float, swing_time: float) -> np.ndarray:
    """Solve a quintic h(t) = sum a_k t^k with the reference's six boundary
    conditions (start/end heights & velocities, apex height at mid-swing,
    and the coefficients-sum regularizer).  Linear in the coefficients, so a
    direct solve replaces the reference's fsolve."""
    T = swing_time

    def pow_row(t, d=0):
        # d-th derivative of [t^5 ... t^0]
        row = []
        for k in range(5, -1, -1):
            if d == 0:
                row.append(t ** k)
            elif d == 1:
                row.append(k * t ** (k - 1) if k >= 1 else 0.0)
        return row

    A = np.array([
        [0, 0, 0, 0, 0, 1],                 # h(0)   = h0
        pow_row(T),                          # h(T)   = h_end
        [0, 0, 0, 0, 1, 0],                 # v(0)   = v0
        pow_row(T, d=1),                     # v(T)   = v_end
        pow_row(T / 2.0),                    # h(T/2) = h_max
        [1, 1, 1, 1, 1, 1],                 # sum(a) = 0 (regularizer)
    ], dtype=float)
    b = np.array([h0, h_end, v0, v_end, h_max, 0.0])
    return np.linalg.solve(A, b)


def quintic_eval(coeffs: np.ndarray, t: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    a5, a4, a3, a2, a1, a0 = coeffs
    h = a5 * t**5 + a4 * t**4 + a3 * t**3 + a2 * t**2 + a1 * t + a0
    v = 5 * a5 * t**4 + 4 * a4 * t**3 + 3 * a3 * t**2 + 2 * a2 * t + a1
    a = 20 * a5 * t**3 + 12 * a4 * t**2 + 6 * a3 * t + 2 * a2
    return h, v, a


def normal_cdf(x: np.ndarray, std: float) -> np.ndarray:
    return 0.5 * (1.0 + np.vectorize(math.erf)(x / (std * math.sqrt(2.0))))


def c_des(phi: np.ndarray, phi_stance: float = 0.5, sigma: float = 0.02) -> np.ndarray:
    """Desired-contact indicator over normalized phase (plot_cdes.py)."""
    phi_bar = np.where(
        phi <= phi_stance,
        0.5 * phi / phi_stance,
        0.5 + 0.5 * (phi - phi_stance) / (1 - phi_stance))
    return (normal_cdf(phi_bar, sigma) * (1 - normal_cdf(phi_bar - 0.5, sigma))
            + normal_cdf(phi_bar - 1, sigma) * (1 - normal_cdf(phi_bar - 1.5, sigma)))


def gaussian_kernel(x, alpha: float = 1.0, sigma: float = 1.0):
    """G_{alpha,sigma}(x) = alpha exp(-(x/sigma)^2) (plot_gck.py)."""
    return alpha * np.exp(-np.square(x / sigma))


def cauchy_kernel(x, alpha: float = 1.0, beta: float = 1.0, sigma: float = 1.0):
    """C_{alpha,beta,sigma}(x) = alpha / ((x/sigma)^{2 beta} + 1)."""
    return alpha / (np.power(x / sigma, 2 * beta) + 1.0)


def plot_design(out_dir: str, swing_time: float = 0.4, h_max: float = 0.08):
    """Render the reference's three design figures to PNG."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(out_dir, exist_ok=True)
    coeffs = quintic_swing_coefficients(0.0, 0.0, 0.0, 0.0, h_max, swing_time)
    t = np.linspace(0, swing_time, 500)
    h, v, a = quintic_eval(coeffs, t)
    fig, axs = plt.subplots(1, 3, figsize=(14, 4))
    for ax, y, name in zip(axs, (h, v, a), ("height [m]", "velocity [m/s]", "accel [m/s^2]")):
        ax.plot(t, y)
        ax.set(xlabel="t [s]", ylabel=name)
        ax.grid(True)
    fig.suptitle("quintic swing-foot profile")
    fig.tight_layout()
    fig.savefig(os.path.join(out_dir, "gait_quintic.png"), dpi=110)
    plt.close(fig)

    phi = np.linspace(0, 1, 500)
    fig, ax = plt.subplots()
    ax.plot(phi, c_des(phi))
    ax.set(xlabel="phi", ylabel="C_des")
    ax.grid(True)
    fig.savefig(os.path.join(out_dir, "gait_cdes.png"), dpi=110)
    plt.close(fig)

    x = np.linspace(-1, 1, 400) * 0.6 * 5
    fig, axs = plt.subplots(1, 2, figsize=(10, 4))
    axs[0].plot(x, gaussian_kernel(x, 1, 0.6))
    axs[0].set_title("Gaussian kernel")
    for beta in (1, 20):
        axs[1].plot(x, cauchy_kernel(x, 1, beta, 0.6), label=f"beta={beta}")
    axs[1].set_title("Cauchy kernel")
    axs[1].legend()
    for ax in axs:
        ax.grid(True)
    fig.tight_layout()
    fig.savefig(os.path.join(out_dir, "gait_kernels.png"), dpi=110)
    plt.close(fig)
    return out_dir


if __name__ == "__main__":
    import sys

    plot_design(sys.argv[1] if len(sys.argv) > 1 else "gait_design_out")
