"""Offline evaluation of benchmark npz archives, a numpy/scipy mirror of
``vitvs_tpu/harness/evals.py``.

Ports the three reference analyses (all operating on the reference-format
npz, so they read either implementation's results):

* convergence / pose statistics  (`eval/eval_conv_pose.py:5-97`)
* APE vs geodesic                (`eval/eval_ape_calc.py:5-139`)
* trajectory length ratio        (`eval/eval_lenght_ratio.py:4-93`)
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
from scipy.spatial.transform import Rotation as R

DESIRED_POSITION = np.array([0.0, 0.0, 0.61])
DESIRED_ORIENTATION = np.array([0.0, 0.7071068, 0.0, 0.7071068])


def _load(npz_or_dict):
    if isinstance(npz_or_dict, (str, bytes)):
        return np.load(npz_or_dict, allow_pickle=True)
    return npz_or_dict


@dataclass
class ConvergenceStats:
    num_samples: int
    num_converged: int
    convergence_rate: float          # percent
    mean_lowest_position_error: float
    std_lowest_position_error: float
    mean_lowest_orientation_error: float
    std_lowest_orientation_error: float
    mean_iterations: float
    total_execution_time: float


def convergence_stats(npz_or_dict) -> ConvergenceStats:
    """Headline task metrics (eval_conv_pose.py semantics)."""
    d = _load(npz_or_dict)
    flags = np.asarray(d["convergence_flags"]).astype(bool)
    low_p = np.asarray(d["lowest_position_errors"], dtype=float)
    low_o = np.asarray(d["lowest_orientation_errors"], dtype=float)
    iters = np.asarray(d["all_iteration_histories"], dtype=float)
    conv = flags.sum()
    sel = flags if conv else np.zeros_like(flags)
    return ConvergenceStats(
        num_samples=len(flags),
        num_converged=int(conv),
        convergence_rate=float(100.0 * conv / max(len(flags), 1)),
        mean_lowest_position_error=float(low_p[sel].mean()) if conv else float("nan"),
        std_lowest_position_error=float(low_p[sel].std()) if conv else float("nan"),
        mean_lowest_orientation_error=float(low_o[sel].mean()) if conv else float("nan"),
        std_lowest_orientation_error=float(low_o[sel].std()) if conv else float("nan"),
        mean_iterations=float(iters.mean()) if len(iters) else float("nan"),
        total_execution_time=float(np.asarray(d["total_execution_time"])) if "total_execution_time" in d else float("nan"),
    )


def _orientation_geodesic(q0: np.ndarray, q1: np.ndarray, num_steps: int) -> np.ndarray:
    """Normalized-lerp shortest-path quaternion interpolation
    (eval_ape_calc.py:33-54)."""
    if np.dot(q0, q1) < 0:
        q1 = -q1
    t = np.linspace(0, 1, num_steps)[:, None]
    q = (1 - t) * q0[None] + t * q1[None]
    return q / np.linalg.norm(q, axis=1, keepdims=True)


def ape(npz_or_dict, desired_position=DESIRED_POSITION,
        desired_orientation=DESIRED_ORIENTATION):
    """Mean per-step deviation from the straight-line / nlerp geodesic over
    converged samples (eval_ape_calc.py:63-139).

    Returns ((pos_mean_cm, pos_std_cm), (rot_mean_deg, rot_std_deg))."""
    d = _load(npz_or_dict)
    flags = np.asarray(d["convergence_flags"]).astype(bool)
    pos_h = d["all_position_histories"]
    ori_h = d["all_orientation_histories"]
    iters = np.asarray(d["all_iteration_histories"]).astype(int)

    pos_apes, rot_apes = [], []
    for idx in np.nonzero(flags)[0]:
        n = iters[idx]
        if n < 2:
            continue
        # npz object arrays come back with dtype=object; force float
        actual_p = np.asarray(pos_h[idx], dtype=float)[:n]
        actual_q = np.asarray(ori_h[idx], dtype=float)[:n]
        t = np.linspace(0, 1, n)[:, None]
        geo_p = actual_p[0] * (1 - t) + desired_position[None] * t
        geo_q = _orientation_geodesic(actual_q[0], desired_orientation, n)
        perr = np.linalg.norm(actual_p - geo_p, axis=1) * 100.0
        rerr = np.array([
            np.degrees((R.from_quat(a).inv() * R.from_quat(g)).magnitude())
            for a, g in zip(actual_q, geo_q)
        ])
        pos_apes.append(perr.mean())
        rot_apes.append(rerr.mean())
    pos_apes = np.asarray(pos_apes)
    rot_apes = np.asarray(rot_apes)
    if not len(pos_apes):
        nan = float("nan")
        return (nan, nan), (nan, nan)
    return ((float(pos_apes.mean()), float(pos_apes.std())),
            (float(rot_apes.mean()), float(rot_apes.std())))


def print_report(npz_or_dict) -> None:
    """All three analyses on one archive — the combined equivalent of the
    reference's eval_conv_pose.py / eval_ape_calc.py / eval_lenght_ratio.py
    CLIs."""
    s = convergence_stats(npz_or_dict)
    print(f"samples:              {s.num_samples}")
    print(f"converged:            {s.num_converged}  ({s.convergence_rate:.1f}%)")
    print(f"lowest pos error:     {s.mean_lowest_position_error:.2f} ± "
          f"{s.std_lowest_position_error:.2f} cm")
    print(f"lowest orient error:  {s.mean_lowest_orientation_error:.2f} ± "
          f"{s.std_lowest_orientation_error:.2f} deg")
    print(f"mean iterations:      {s.mean_iterations:.1f}")
    print(f"total exec time:      {s.total_execution_time:.1f} s")
    (pm, ps), (rm, rs) = ape(npz_or_dict)
    print(f"position APE:         {pm:.2f} ± {ps:.2f} cm")
    print(f"orientation APE:      {rm:.2f} ± {rs:.2f} deg")
    lm, ls = length_ratio(npz_or_dict)
    print(f"length ratio:         {lm:.3f} ± {ls:.3f}")


def length_ratio(npz_or_dict, desired_position=DESIRED_POSITION):
    """Actual trajectory length / straight-line length over converged samples
    (eval_lenght_ratio.py:15-93).  Returns (mean, std)."""
    d = _load(npz_or_dict)
    flags = np.asarray(d["convergence_flags"]).astype(bool)
    pos_h = d["all_position_histories"]
    iters = np.asarray(d["all_iteration_histories"]).astype(int)
    ratios = []
    for idx in np.nonzero(flags)[0]:
        n = iters[idx]
        p = np.asarray(pos_h[idx], dtype=float)[:n]
        if len(p) < 2:
            continue
        actual = np.linalg.norm(p[1:] - p[:-1], axis=1).sum()
        geo = np.linalg.norm(desired_position - p[0])
        if geo > 1e-9:
            ratios.append(actual / geo)
    if not ratios:
        return float("nan"), float("nan")
    r = np.asarray(ratios)
    return float(r.mean()), float(r.std())


if __name__ == "__main__":
    import sys

    if len(sys.argv) != 2:
        print("usage: python -m vitvs_tpu_torch.harness.evals results_*.npz")
        raise SystemExit(1)
    print_report(sys.argv[1])
