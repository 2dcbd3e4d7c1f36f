"""DoG scale-space keypoints with subpixel refinement, the SIFT detector
(``vitvs_tpu/classical/scalespace.py``), for a batch of frames.

* per-octave Gaussian stacks built by incremental separable blurs;
* DoG extrema as 3x3x3 max / min pools over (level, y, x), a static top-K
  per octave with masks;
* quadratic subpixel offsets from the 2x2 spatial Hessian (closed form);
* Lowe's edge rejection (Hessian trace^2 / det, r = 10);
* descriptors sampled from the octave's base image with the keypoint's
  scale multiplying the sampling window.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from vitvs_tpu_torch.classical.features import (_blur, inside_border, shift_clamped,
                                                sift_like_descriptors, top_k_scores)

SIGMA0 = 1.6


class MultiScaleFeatures(NamedTuple):
    uv: torch.Tensor        # (..., K, 2) float (u, v) base-resolution, subpixel
    scale: torch.Tensor     # (..., K) descriptor window multiplier (base pixels)
    response: torch.Tensor  # (..., K) |DoG| at the refined extremum
    valid: torch.Tensor     # (..., K) bool
    desc: torch.Tensor      # (..., K, 128) SIFT-style descriptors


def _downsample2(img: torch.Tensor) -> torch.Tensor:
    """2x2 average-pool downsample of (..., H, W)."""
    h, w = img.shape[-2:]
    x = img[..., : h - h % 2, : w - w % 2]
    return x.reshape(*x.shape[:-2], h // 2, 2, w // 2, 2).mean((-3, -1))


def _gauss_stack(img: torch.Tensor, intervals: int) -> tuple[torch.Tensor, list[float]]:
    """Incremental Gaussian stack (..., S + 3, H, W): sigmas SIGMA0 *
    2^(i / intervals), i = 0 .. intervals + 2 (SIFT's s + 3 images)."""
    sigmas = [SIGMA0 * (2.0 ** (i / intervals)) for i in range(intervals + 3)]
    levels = [_blur(img, sigmas[0])]
    for i in range(1, len(sigmas)):
        levels.append(_blur(levels[-1], math.sqrt(sigmas[i] ** 2 - sigmas[i - 1] ** 2)))
    return torch.stack(levels, dim=-3), sigmas


def _octave_extrema(dog: torch.Tensor, contrast_thresh: float, edge_ratio: float,
                    border: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(..., S + 2, H, W) DoG -> (score, off_y, off_x), each (..., S, H, W)
    for levels 1 .. S.

    score is |refined response| where a 26-neighbour extremum passes the
    contrast and edge tests, else -inf; offsets are the clamped subpixel
    corrections."""
    L, H, W = dog.shape[-3:]
    inner = dog[..., 1:-1, :, :]
    d5 = dog.reshape(-1, 1, L, H, W)
    mx = F.max_pool3d(d5, 3, stride=1, padding=1).reshape(dog.shape)[..., 1:-1, :, :]
    mn = -F.max_pool3d(-d5, 3, stride=1, padding=1).reshape(dog.shape)[..., 1:-1, :, :]
    is_ext = (((inner >= mx) & (inner > contrast_thresh))
              | ((inner <= mn) & (inner < -contrast_thresh)))

    # spatial finite differences on each level, edge-clamped neighbours
    sh = shift_clamped
    dx = 0.5 * (sh(inner, 0, -1) - sh(inner, 0, 1))
    dy = 0.5 * (sh(inner, -1, 0) - sh(inner, 1, 0))
    dxx = sh(inner, 0, -1) + sh(inner, 0, 1) - 2 * inner
    dyy = sh(inner, -1, 0) + sh(inner, 1, 0) - 2 * inner
    dxy = 0.25 * (sh(inner, -1, -1) + sh(inner, 1, 1) - sh(inner, -1, 1) - sh(inner, 1, -1))

    # Lowe's edge rejection: tr^2 / det < (r + 1)^2 / r with det > 0
    tr = dxx + dyy
    det = dxx * dyy - dxy * dxy
    edge_ok = (det > 0) & (tr * tr * edge_ratio < (edge_ratio + 1) ** 2 * det)

    # subpixel: solve [dxx dxy; dxy dyy] [ox; oy] = -[dx; dy]
    denom = torch.where(torch.abs(det) > 1e-12, det, 1e-12)
    ox = torch.clamp(-(dyy * dx - dxy * dy) / denom, -0.5, 0.5)
    oy = torch.clamp(-(dxx * dy - dxy * dx) / denom, -0.5, 0.5)
    refined = inner + 0.5 * (dx * ox + dy * oy)

    keep = is_ext & edge_ok & inside_border(H, W, border, dog.device)
    return torch.where(keep, torch.abs(refined), -math.inf), oy, ox


def sift_features(img: torch.Tensor, max_keypoints: int = 512, octaves: int = 3,
                  intervals: int = 3, contrast_thresh: float = 0.008,
                  edge_ratio: float = 10.0, border: int = 8) -> MultiScaleFeatures:
    """The SIFT-role pipeline on grayscale (..., H, W) in [0, 1]: DoG
    keypoints over ``octaves`` octaves + scale-adapted 128-d descriptors.

    Fixed shape: exactly ``max_keypoints`` slots (max_keypoints // octaves
    an octave), invalid slots masked.  Descriptors are sampled from the
    octave's base image (before its blurs), the keypoint's within-octave
    sigma scaling the window."""
    per_oct = max_keypoints // octaves
    assert per_oct > 0
    lead = img.shape[:-2]
    parts = []
    img_o = img
    for o in range(octaves):
        stride = float(2 ** o)
        gauss, sigmas = _gauss_stack(img_o, intervals)
        dog = gauss[..., 1:, :, :] - gauss[..., :-1, :, :]
        score, oy, ox = _octave_extrema(dog, contrast_thresh, edge_ratio, border)
        S, h, w = score.shape[-3:]
        top, idx = top_k_scores(score.flatten(-3), per_oct)
        lvl = idx // (h * w)
        yy = (idx % (h * w)) // w
        xx = idx % w
        off_y = oy.flatten(-3).gather(-1, idx)
        off_x = ox.flatten(-3).gather(-1, idx)
        k_rel = torch.tensor([sigmas[i + 1] / SIGMA0 for i in range(S)],
                             dtype=torch.float32, device=img.device)[lvl]
        uv_o = torch.stack([xx.to(torch.float32) + off_x, yy.to(torch.float32) + off_y], -1)
        desc = sift_like_descriptors(img_o, uv_o, scale=k_rel)
        parts.append(MultiScaleFeatures(uv_o * stride + (stride - 1.0) / 2.0, k_rel * stride,
                                        top, torch.isfinite(top), desc))
        if o + 1 < octaves:
            img_o = _downsample2(img_o)
    out = MultiScaleFeatures(*(torch.cat(f, dim=len(lead)) for f in zip(*parts)))
    pad = max_keypoints - per_oct * octaves
    if pad:
        def padded(x, value):
            fill = x.new_full((*lead, pad, *x.shape[len(lead) + 1:]), value)
            return torch.cat([x, fill], dim=len(lead))

        out = MultiScaleFeatures(padded(out.uv, 0.0), padded(out.scale, 1.0),
                                 padded(out.response, -math.inf), padded(out.valid, False),
                                 padded(out.desc, 0.0))
    return out
