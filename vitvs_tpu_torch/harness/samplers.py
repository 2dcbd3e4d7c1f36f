"""Start-pose sampling for the 500-episode benchmark, a numpy mirror of
``vitvs_tpu/harness/samplers.py``.

Reproduces the reference's sampling chain (vitvs_v2.py:959-1342,1397-1418)
exactly, including the legacy `np.random.seed(41)` stream, so the port
evaluates on the identical 500 start poses:

    np.random.seed(41)
    positions   = uniform box 1.2 x 1.2 x 0.3 m around the goal   (:959-978)
    focal pts   = concentric circles radius 0.08*(c+1) on z=0.01  (:981-1010)
    orientation = look-at(focal) then optical-axis spin linspace(-120,120)
                  per circle                                      (:1253-1342)

Host-side numpy: sampling happens once per benchmark, not in the hot loop.
"""

from __future__ import annotations

import numpy as np
from scipy.spatial.transform import Rotation as R

from vitvs_tpu_torch.io_bridge.config import VSConfig

DESIRED_POSITION = np.array([0.0, 0.0, 0.61])           # vitvs_v2.py:1391
DESIRED_ORIENTATION = np.array([0.0, 0.7071068, 0.0, 0.7071068])  # :1392
BOX_SAMPLE_SIZE = np.array([1.2, 1.2, 0.3])             # :1393
REFERENCE_POINT = np.array([0.0, 0.0, 0.01])            # :1394


def sample_camera_positions(volume_dimensions, num_samples, desired_position, rng) -> np.ndarray:
    half = np.asarray(volume_dimensions) / 2
    lo = np.asarray(desired_position) - half
    hi = np.asarray(desired_position) + half
    return rng.uniform(lo, hi, size=(num_samples, 3))


def sample_focal_points(num_samples, reference_point, num_circles, circle_radius_aug, rng) -> np.ndarray:
    per = num_samples // num_circles
    out = np.empty((num_samples, 3))
    for cn in range(num_circles):
        radius = circle_radius_aug * (cn + 1)
        theta = rng.uniform(-np.pi, np.pi, size=per)
        pts = np.column_stack([
            np.cos(theta) * radius + reference_point[0],
            np.sin(theta) * radius + reference_point[1],
            np.repeat(reference_point[2], per),
        ])
        out[cn * per:(cn + 1) * per] = pts
    return out


def look_at_matrices(camera_positions: np.ndarray, focal_points: np.ndarray) -> np.ndarray:
    """Rotation matrices with body +x toward the focal point
    (vitvs_v2.py:1270-1290)."""
    forward = focal_points - camera_positions
    forward = forward / np.linalg.norm(forward, axis=-1, keepdims=True)
    world_up = np.array([-1.0, 0.0, 0.0])
    right = -np.cross(forward, np.broadcast_to(world_up, forward.shape))
    right = right / np.linalg.norm(right, axis=-1, keepdims=True)
    up = np.cross(right, forward)
    return np.stack([forward, -right, up], axis=-1)


def apply_optical_axis_rotation(matrices: np.ndarray, num_circles: int,
                                samples_per_circle: int,
                                rz_max: float = np.radians(120)) -> np.ndarray:
    """Deterministic linspace(-rz_max, rz_max) spin about the optical (body x)
    axis per circle (vitvs_v2.py:1295-1342) -> quaternions xyzw."""
    n = len(matrices)
    quats = []
    for cn in range(num_circles):
        rz_values = np.linspace(-rz_max, rz_max, num=samples_per_circle)
        for i in range(samples_per_circle):
            idx = cn * samples_per_circle + i
            if idx >= n:
                break
            rz = rz_values[i]
            c, s = np.cos(rz), np.sin(rz)
            rx = np.array([[1, 0, 0], [0, c, -s], [0, s, c]])
            quats.append(R.from_matrix(matrices[idx] @ rx).as_quat())
    return np.array(quats)


def generate_episode_starts(cfg: VSConfig, seed: int = 41):
    """The full benchmark sampling chain with the reference's seed/stream
    (vitvs_v2.py:1383-1418).  Returns (positions (n,3), quats (n,4), n)."""
    per = cfg.num_samples // cfg.num_circles
    n = cfg.num_circles * per
    if n == 0:
        raise ValueError(
            f"num_samples={cfg.num_samples} < num_circles={cfg.num_circles} "
            "yields an empty sweep (the reference distributes samples evenly "
            "over the focal circles, vitvs_v2.py:988-1008); raise num_samples "
            "or lower num_circles")
    rng = np.random.RandomState(seed)  # legacy stream == np.random.seed(seed)
    positions = sample_camera_positions(BOX_SAMPLE_SIZE, n, DESIRED_POSITION, rng)
    focal = sample_focal_points(n, REFERENCE_POINT, cfg.num_circles,
                                cfg.circle_radius_aug, rng)
    mats = look_at_matrices(positions, focal)
    quats = apply_optical_axis_rotation(mats, cfg.num_circles, per,
                                        rz_max=np.radians(cfg.rz_max_deg))
    return positions, quats, n


def pose_error_stats(positions, desired_position):
    """Mean/std position error in cm (vitvs_v2.py:1013-1027)."""
    err = np.linalg.norm(positions - desired_position, axis=1)
    return float(np.mean(err) * 100), float(np.std(err) * 100)


def orientation_error_stats(quats, desired_orientation):
    """Mean/std orientation error in degrees (vitvs_v2.py:1030-1060)."""
    desired = R.from_quat(desired_orientation)
    errs = np.degrees([(R.from_quat(q).inv() * desired).magnitude() for q in quats])
    return float(np.mean(errs)), float(np.std(errs))
