"""Plotting utilities on the host (the port's own copy of
mpc_tpu/viz/plots.py, the reference's visualization layer).

Every function takes numpy arrays or tensors, on the card or the CPU;
tensors are copied to the host. matplotlib is imported when a plot is
drawn, never when the module is imported.
"""

from __future__ import annotations

import numpy as np
import torch


def _host(a) -> np.ndarray:
    """A numpy array of ``a``, a tensor (anywhere) or an array-like."""
    if torch.is_tensor(a):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _plt():
    import matplotlib
    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt
    return plt


def rotate_point(px, py, ox, oy, angle):
    """Rotate a point about an origin (reference: simulation.py:60-64)."""
    c, s = np.cos(angle), np.sin(angle)
    return [c * (px - ox) - s * (py - oy) + ox,
            s * (px - ox) + c * (py - oy) + oy]


def car_corners(params, x, y, phi):
    """Rotated car-box outline (reference: simulation.py:67-83)."""
    lf, lr, w = params.axis_front, params.axis_rear, params.width
    xl, xr = x - lr, x + lf
    yl, yu = y - w / 2, y + w / 2
    return np.array([
        rotate_point(xl, yl, x, y, phi),
        rotate_point(xl, yu, x, y, phi),
        rotate_point(xr, yu, x, y, phi),
        rotate_point(xr, yl, x, y, phi),
        rotate_point(xl, yl, x, y, phi),
    ])


def plot_results(t, x, y, phi, vx, vy, omega, u, title, save_path=None):
    """6-panel state/input/speed/quiver figure (reference: simulation.py:5-45)."""
    plt = _plt()
    t, x, y, phi, vx, vy, omega = map(_host, (t, x, y, phi, vx, vy, omega))
    u = _host(u)
    fig = plt.figure(figsize=(12, 8))
    fig.suptitle(title)

    ax = plt.subplot(321)
    ax.plot(t, x); ax.plot(t, y); ax.plot(t, phi)
    ax.legend(["$x$", "$y$", r"$\phi$"])

    ax = plt.subplot(322)
    ax.plot(t, vx); ax.plot(t, vy); ax.plot(t, omega)
    ax.legend(["$v_x$", "$v_y$", r"$\omega$"])

    ax = plt.subplot(323)
    ax.plot(t, u[0, :]); ax.plot(t, u[1, :])
    ax.legend(["$d$", r"$\delta$"])

    ax = plt.subplot(324)
    ax.plot(t, np.sqrt(vx * vx + vy * vy))
    ax.legend(["$|v|$"])

    delta = u[1, :]
    ax = plt.subplot(313)
    ax.quiver(x, y, np.cos(phi), np.sin(phi), scale=100, color="r",
              width=0.002)
    ax.quiver(x, y, np.cos(phi + delta), np.sin(phi + delta), scale=100,
              color="y", width=0.002)
    ax.plot(x, y, "r")
    if save_path:
        fig.savefig(save_path, dpi=100)
        plt.close(fig)
        return save_path
    return fig


def plot_trajectory(x, y, phi, u, title, save_path=None):
    """Trajectory + heading/steering quivers (reference: simulation.py:48-57)."""
    plt = _plt()
    x, y, phi = map(_host, (x, y, phi))
    delta = _host(u)[1, :]
    fig = plt.figure(figsize=(10, 6))
    plt.title(title)
    plt.quiver(x, y, np.cos(phi), np.sin(phi), scale=100, color="r",
               width=0.002)
    plt.quiver(x, y, np.cos(phi + delta), np.sin(phi + delta), scale=100,
               color="y", width=0.002)
    plt.plot(x, y, "r")
    if save_path:
        fig.savefig(save_path, dpi=100)
        plt.close(fig)
        return save_path
    return fig


def plot_closed_loop(centerline, ys, title="closed loop", save_path=None):
    """Centerline vs achieved trajectory (reference: main.py:158-167)."""
    plt = _plt()
    cl = _host(centerline)
    ys = _host(ys)
    fig = plt.figure(figsize=(10, 6))
    plt.title(title)
    plt.plot(cl[:, 0], cl[:, 1], label="centerline")
    plt.plot(ys[:, 0], ys[:, 1], label="trajectory")
    plt.legend()
    if save_path:
        fig.savefig(save_path, dpi=100)
        plt.close(fig)
        return save_path
    return fig


def animate_motion(params, x, y, phi, u, t, title, save_path=None,
                   max_frames=200):
    """Car-box animation (reference: simulation.py:86-114, pyglet_sim.py:7-46
    — rendered via matplotlib FuncAnimation instead of a GUI loop)."""
    plt = _plt()
    from matplotlib import animation

    x, y, phi, t = map(_host, (x, y, phi, t))
    delta = _host(u)[1, :]
    stride = max(1, len(x) // max_frames)
    idx = np.arange(0, len(x), stride)

    fig, ax = plt.subplots(figsize=(8, 6))
    ax.set_title(title)
    off = 0.5
    ax.set_xlim(x.min() - off, x.max() + off)
    ax.set_ylim(y.min() - off, y.max() + off)
    (box_line,) = ax.plot([], [])
    (trail,) = ax.plot([], [], "k")

    def frame(k):
        i = idx[k]
        corners = car_corners(params, x[i], y[i], phi[i])
        box_line.set_data(corners[:, 0], corners[:, 1])
        trail.set_data(x[:i], y[:i])
        return box_line, trail

    ani = animation.FuncAnimation(fig, frame, frames=len(idx), blit=True,
                                  interval=50)
    if save_path:
        ani.save(save_path, writer="pillow", fps=20)
        plt.close(fig)
        return save_path
    return ani
