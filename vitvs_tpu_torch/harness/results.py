"""Benchmark results writer, a numpy mirror of ``vitvs_tpu/harness/results.py``:
npz schema-compatible with the reference.

Produces the same 22-array archive as the reference's `np.savez`
(vitvs_v2.py:1493-1516; filename pattern
`results_{config}_{method}_{standard|perturbed}.npz`), so the reference's
eval scripts (and ours in harness/evals.py) read either's output.
"""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np


def _trim(history: np.ndarray, n: int) -> np.ndarray:
    return np.asarray(history[:n])


def episode_summaries(results: Sequence, initial_positions, initial_orientations,
                      best_poses=None):
    """Batched EpisodeResult (numpy pytrees, one per episode) -> dict of the
    reference npz arrays."""
    out = {
        "initial_positions": np.asarray(initial_positions),
        "initial_orientations": np.asarray(initial_orientations),
        "final_positions": [],
        "final_quaternions": [],
        "convergence_flags": [],
        "position_errors": [],
        "orientation_errors": [],
        "best_poses": [],
        "all_position_histories": [],
        "all_orientation_histories": [],
        "all_iteration_histories": [],
        "lowest_position_errors": [],
        "lowest_orientation_errors": [],
        "all_average_velocities": [],
        "all_velocity_mean_100": [],
        "all_velocity_mean_10": [],
        "all_applied_velocity_x": [],
        "all_applied_velocity_y": [],
        "all_applied_velocity_z": [],
        "all_applied_velocity_roll": [],
        "all_applied_velocity_pitch": [],
        "all_applied_velocity_yaw": [],
    }
    for i, r in enumerate(results):
        n = int(r.iterations)
        out["final_positions"].append(np.asarray(r.final_position))
        out["final_quaternions"].append(np.asarray(r.final_quat))
        out["convergence_flags"].append(bool(r.converged))
        out["position_errors"].append(float(r.position_error))
        out["orientation_errors"].append(float(r.orientation_error))
        bp = (best_poses[i] if best_poses is not None
              else (np.asarray(initial_positions[i]), np.asarray(initial_orientations[i])))
        out["best_poses"].append(bp)
        out["all_position_histories"].append(_trim(np.asarray(r.position_history), n))
        out["all_orientation_histories"].append(_trim(np.asarray(r.orientation_history), n))
        out["all_iteration_histories"].append(n)
        out["lowest_position_errors"].append(float(r.lowest_position_error))
        out["lowest_orientation_errors"].append(float(r.lowest_orientation_error))

        v = _trim(np.asarray(r.v_c_history), n)
        avg = np.abs(v).mean(axis=1) if n else np.array([])
        out["all_average_velocities"].append(avg)
        # running window means (reference run(), vitvs_v2.py:766-775)
        m100 = np.array([avg[max(0, j - 99):j + 1].mean() for j in range(n)]) if n else np.array([])
        m10 = np.array([avg[max(0, j - 9):j + 1].mean() for j in range(n)]) if n else np.array([])
        out["all_velocity_mean_100"].append(m100)
        out["all_velocity_mean_10"].append(m10)

        tw = _trim(np.asarray(r.applied_twist_history), n)
        for k, axis in enumerate(["x", "y", "z", "roll", "pitch", "yaw"]):
            out[f"all_applied_velocity_{axis}"].append(tw[:, k] if n else np.array([]))
    return out


def save_results(
    path_or_dir: str,
    summaries: dict,
    total_execution_time: float,
    config_name: str = "config",
    method: str = "dino",
    perturbed: bool = False,
) -> str:
    """Write the reference-format npz (vitvs_v2.py:1487-1516)."""
    if os.path.isdir(path_or_dir) or not path_or_dir.endswith(".npz"):
        fname = f"results_{config_name}_{method}_{'perturbed' if perturbed else 'standard'}.npz"
        path = os.path.join(path_or_dir, fname)
    else:
        path = path_or_dir
    # a sweep can run for hours before reaching this save — never let a
    # missing --out directory discard it
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)

    arrays = {}
    for k, v in summaries.items():
        if k in ("initial_positions", "initial_orientations"):
            arrays[k] = np.asarray(v)
        elif k in ("convergence_flags", "position_errors", "orientation_errors",
                   "all_iteration_histories", "lowest_position_errors",
                   "lowest_orientation_errors"):
            arrays[k] = np.asarray(v)
        else:
            arrays[k] = np.array(v, dtype=object)
    np.savez(path, total_execution_time=total_execution_time, **arrays)
    return path
