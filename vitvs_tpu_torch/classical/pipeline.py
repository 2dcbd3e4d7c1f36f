"""The classical per-frame servo step, the reference's ``ibvs_standard``
controller (``vitvs_tpu/classical/pipeline.py``), for one frame or a chunk
of B.

Full-resolution grayscale frames; keypoints and descriptors of the goal
once an episode and of every current frame; mutual-NN matching; the same
IBVS control law as the ViT path.  Kept from the reference:

* on a feature failure (fewer than 4 pairs) the previous command is reused
  and the EMA holds (``StepResult.feature_ok``);
* matched pixel coordinates are rounded half to even, as ``jnp.round``;
* the divergence abort is 5x the initial error, checked every step
  (``VSConfig.divergence_multiplier``, ``early_divergence_abort``, set by
  ``classical/benchmark.py`` and the command line).

No ViT runs here: the model supplies the configuration, the camera and the
device.  The step draws no random numbers (matching is deterministic).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from vitvs_tpu_torch.classical.features import (detect_corners, grayscale, match_descriptors,
                                                sift_like_descriptors)
from vitvs_tpu_torch.control.ibvs import (EmaState, body_twist_from_optical, depth_at_points,
                                          ema_update, ibvs_velocity)
from vitvs_tpu_torch.core.batch import item
from vitvs_tpu_torch.harness.pipeline import ServoModel, StepResult


class GoalFeatures(NamedTuple):
    uv: torch.Tensor      # (K, 2), or (..., K, 2) for a batch of frames
    desc: torch.Tensor    # (K, D)
    valid: torch.Tensor   # (K,)


# method -> BFMatcher norm, the reference's dispatch: SIFT NORM_L2, ORB and
# AKAZE NORM_HAMMING
METHOD_NORMS = {"sift": "l2", "orb": "hamming", "akaze": "hamming", "harris": "l2"}

# Lowe's ambiguity ratio per method (features.match_descriptors): Lowe's
# 0.7 for the float descriptors, 0.8 for the binary ones
METHOD_RATIOS = {"sift": 0.7, "orb": 0.8, "akaze": 0.8, "harris": 0.7}

# the benchmark's keypoint budget per method when none is given: ORB's
# cv2.ORB_create(nfeatures=1000); SIFT enough DoG slots for the two views'
# keypoint sets to overlap; 512 for the others
DEFAULT_MAX_CORNERS = {"sift": 1152, "orb": 1000, "akaze": 512, "harris": 512}


def extract_features(gray: torch.Tensor, max_corners: int = 512,
                     method: str = "sift") -> GoalFeatures:
    """detectAndCompute of grayscale frames (..., H, W), per method:

    'sift'   - DoG scale-space keypoints + 128-d gradient descriptors;
    'orb'    - Harris pyramid corners + steered BRIEF (256 bits);
    'akaze'  - nonlinear scale space + M-LDB (486 bits);
    'harris' - single-scale Harris + SIFT-like descriptors.
    """
    if method == "sift":
        from vitvs_tpu_torch.classical.scalespace import sift_features

        f = sift_features(gray, max_corners)
        return GoalFeatures(uv=f.uv, desc=f.desc, valid=f.valid)
    if method == "orb":
        from vitvs_tpu_torch.classical.binary import orb_features

        f = orb_features(gray, nfeatures=max_corners)
        return GoalFeatures(uv=f.uv, desc=f.desc, valid=f.valid)
    if method == "akaze":
        from vitvs_tpu_torch.classical.binary import akaze_features

        f = akaze_features(gray, max_keypoints=max_corners)
        return GoalFeatures(uv=f.uv, desc=f.desc, valid=f.valid)
    if method == "harris":
        c = detect_corners(gray, max_corners)
        return GoalFeatures(uv=c.uv, desc=sift_like_descriptors(gray, c.uv), valid=c.valid)
    raise ValueError(f"unknown classical method {method!r}")


def _gray(model: ServoModel, rgb) -> torch.Tensor:
    if isinstance(rgb, np.ndarray):
        rgb = torch.from_numpy(np.ascontiguousarray(rgb))
    return grayscale(rgb.to(model.device, torch.float32))


@torch.inference_mode()
def extract_goal_features(model: ServoModel, goal_rgb, max_corners: int = 512,
                          method: str = "sift") -> GoalFeatures:
    """The goal frame's (H, W, 3) features, once an episode."""
    return extract_features(_gray(model, goal_rgb), max_corners, method)


@torch.inference_mode()
def classical_servo_step(model: ServoModel, goal_feats: GoalFeatures, frame_rgb, frame_depth_m,
                         ema: EmaState, prev_v_c: torch.Tensor, max_corners: int = 512,
                         method: str = "sift") -> StepResult:
    """One classical servo iteration, of one frame (H, W, 3) or of a chunk
    of B (B, H, W, 3), against the goal's features; ``ema``, ``prev_v_c``
    and the depth maps with the frames' leading axis.  One frame runs as
    the chunk of one and its result has no batch axis."""
    if torch.as_tensor(frame_rgb).dim() == 3:
        depth = torch.as_tensor(frame_depth_m)[None]
        step = classical_servo_step(model, goal_feats, torch.as_tensor(frame_rgb)[None], depth,
                                    item(ema, None), prev_v_c[None], max_corners, method)
        return item(step, 0)
    cfg, cam = model.cfg, model.camera
    feats = extract_features(_gray(model, frame_rgb), max_corners, method)
    m = match_descriptors(goal_feats.desc, feats.desc, goal_feats.valid, feats.valid,
                          cfg.num_pairs, norm=METHOD_NORMS[method], ratio=METHOD_RATIOS[method])
    s_uv_star = torch.round(goal_feats.uv[m.idx1])                        # goal points
    s_uv = torch.round(feats.uv.gather(-2, m.idx2[..., None].expand(*m.idx2.shape, 2)))

    feature_ok = m.num_valid >= 4                                          # (B,)
    depth = torch.as_tensor(frame_depth_m).to(model.device, torch.float32)
    v_raw = ibvs_velocity(cam.pixel_to_normalized(s_uv), cam.pixel_to_normalized(s_uv_star),
                          depth_at_points(depth, s_uv), cfg.lambda_, valid=m.valid,
                          mode=cfg.pinv_mode, damping=cfg.pinv_damping)
    ema_new, v_smoothed = ema_update(ema, v_raw, cfg.ema_alpha)
    ok = feature_ok[:, None]
    v_c = torch.where(ok, v_smoothed, prev_v_c)
    ema_out = EmaState(value=torch.where(ok, ema_new.value, ema.value),
                       initialized=torch.where(feature_ok, ema_new.initialized, ema.initialized))
    # the diagnostic "similarity": the inverse of the normalized match distance
    sim = torch.where(m.valid, 1.0 / (1.0 + m.distance), 0.0)
    mean_sim = sim.sum(-1) / torch.clamp(m.num_valid, min=1)
    return StepResult(
        v_c=v_c, body_twist=body_twist_from_optical(v_c, cfg.max_velocity), ema=ema_out,
        feature_ok=feature_ok, num_valid=m.num_valid,
        mean_sim=torch.where(m.num_valid > 0, mean_sim, -math.inf),
        s_uv=s_uv, s_uv_star=s_uv_star, valid=m.valid)
