"""Visualization (``vitvs_tpu/harness/viz.py``): the reference's per-frame
image topics as functions on numpy images.

``draw_points`` is the processed frame with the matched points (the
benchmark's live channel and ``ServoLoop``'s viz hook use it); the
correspondence figure and the trajectory plot need matplotlib, imported
inside each of them (the card's machine has none: they raise ImportError
saying so), never on the servo path.
"""

from __future__ import annotations

import numpy as np


def draw_points(image: np.ndarray, current_points: np.ndarray,
                goal_points: np.ndarray, radius: int = 2) -> np.ndarray:
    """Current (green) and goal (red) feature points as squares of
    ``radius`` on a copy of the image (H, W, 3), uint8 or float; points
    (k, 2) pixel (u, v), those outside the image skipped."""
    img = np.array(image, copy=True)
    h, w = img.shape[:2]
    green = np.array([0, 255, 0], img.dtype) if img.dtype == np.uint8 else np.array([0, 1.0, 0])
    red = np.array([255, 0, 0], img.dtype) if img.dtype == np.uint8 else np.array([1.0, 0, 0])

    def blot(pts, color):
        for u, v in np.asarray(pts, int):
            if 0 <= u < w and 0 <= v < h:
                img[max(0, v - radius):min(h, v + radius + 1),
                    max(0, u - radius):min(w, u + radius + 1)] = color

    blot(current_points, green)
    blot(goal_points, red)
    return img


def _pyplot():
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError("the figure functions of harness/viz.py need matplotlib, which is "
                          "not installed (draw_points does not)") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def correspondence_figure(goal_image: np.ndarray, current_image: np.ndarray,
                          points1: np.ndarray, points2: np.ndarray,
                          valid: np.ndarray | None = None,
                          save_path: str | None = None):
    """Side-by-side correspondence plot with rainbow connection lines;
    points (k, 2) in (row, col) order, as the reference's patch-scaled
    points.  Returns the matplotlib figure."""
    plt = _pyplot()
    from matplotlib.patches import ConnectionPatch

    p1 = np.asarray(points1, float)
    p2 = np.asarray(points2, float)
    if valid is not None:
        p1, p2 = p1[np.asarray(valid, bool)], p2[np.asarray(valid, bool)]

    fig = plt.figure(figsize=(12, 6))
    ax1 = fig.add_subplot(121)
    ax2 = fig.add_subplot(122)
    ax1.imshow(np.asarray(goal_image))
    ax2.imshow(np.asarray(current_image))
    colors = plt.cm.rainbow(np.linspace(0, 1, max(len(p1), 1)))
    for i, ((y1, x1), (y2, x2), color) in enumerate(zip(p1, p2, colors)):
        ax1.plot(x1, y1, "o", color=color, markersize=8)
        ax1.text(x1 + 5, y1 + 5, str(i), color=color, fontsize=8)
        ax2.plot(x2, y2, "o", color=color, markersize=8)
        ax2.text(x2 + 5, y2 + 5, str(i), color=color, fontsize=8)
        fig.add_artist(ConnectionPatch(xyA=(x1, y1), xyB=(x2, y2), coordsA="data",
                                       coordsB="data", axesA=ax1, axesB=ax2, color=color,
                                       alpha=0.5))
    ax1.axis("off")
    ax2.axis("off")
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path)
    return fig


def figure_to_image(fig) -> np.ndarray:
    """A matplotlib figure rasterized to (H, W, 3) uint8."""
    _pyplot()
    fig.canvas.draw()
    w, h = fig.canvas.get_width_height()
    buf = np.frombuffer(fig.canvas.buffer_rgba(), dtype=np.uint8).reshape(h, w, 4)
    return buf[..., :3].copy()


def plot_trajectory(npz_or_dict, sample_idx: int, save_path: str | None = None):
    """3D trajectory of one episode of a results npz (a path or its arrays)
    against the straight line to the goal."""
    plt = _pyplot()
    if isinstance(npz_or_dict, (str, bytes)):
        d = np.load(npz_or_dict, allow_pickle=True)
    else:
        d = npz_or_dict
    n = int(np.asarray(d["all_iteration_histories"])[sample_idx])
    p = np.asarray(d["all_position_histories"][sample_idx], dtype=float)[:n]
    fig = plt.figure(figsize=(6, 6))
    ax = fig.add_subplot(111, projection="3d")
    ax.plot(p[:, 0], p[:, 1], p[:, 2], label="actual")
    goal = np.array([0.0, 0.0, 0.61])
    ax.plot([p[0, 0], goal[0]], [p[0, 1], goal[1]], [p[0, 2], goal[2]], "--", label="geodesic")
    ax.scatter(*goal, marker="*", s=80, label="goal")
    ax.legend()
    if save_path:
        fig.savefig(save_path)
    return fig
