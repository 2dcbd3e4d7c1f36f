"""The binary-descriptor families, the ORB and AKAZE equivalents
(``vitvs_tpu/classical/binary.py``), for a batch of frames.  Hamming
matching is an exact int8 product (``features.match_descriptors(norm=
'hamming')``).

ORB equivalent (:func:`orb_features`): a 4-level pyramid (factor 4/3) of
antialiased bilinear resizes of the frame; Harris corners a level;
orientation by the intensity centroid over a radius-15 disc; steered BRIEF,
256 fixed Gaussian test pairs rotated by the keypoint's orientation on a
sigma-2 smoothed level -> (256,) {0, 1} int8.

AKAZE equivalent (:func:`akaze_features`): a Perona-Malik (g2) nonlinear
diffusion scale space in fixed explicit steps; the scale-normalized
determinant of the Hessian as detector; SURF-style dominant-gradient
orientation; M-LDB, 2x2 / 3x3 / 4x4 grids of cell means of (intensity, gx,
gy) in the keypoint's frame, compared pairwise -> 486 bits.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from vitvs_tpu_torch.classical.features import (_bilinear, _blur, binned_sum,
                                                corners_from_response, detect_corners, gradients,
                                                sample_packed, shift_clamped)
from vitvs_tpu_torch.core.image import pack_quad


class BinaryFeatures(NamedTuple):
    uv: torch.Tensor     # (..., K, 2) float (u, v) base-resolution coords
    desc: torch.Tensor   # (..., K, bits) {0, 1} int8
    valid: torch.Tensor  # (..., K) bool


# ---------------------------------------------------------------- ORB ----

def _brief_pattern(n_bits: int = 256, radius: float = 13.0, seed: int = 7) -> np.ndarray:
    """The static BRIEF test pattern: (n_bits, 2, 2) of (x, y) offsets,
    Gaussian around the keypoint (BRIEF's G(0, S^2 / 25)), clipped to the
    disc (the reference's numpy recipe, so the same bits)."""
    rng = np.random.default_rng(seed)
    pts = rng.normal(0.0, radius / 2.0, (n_bits, 2, 2))
    norm = np.linalg.norm(pts, axis=-1, keepdims=True)
    pts = np.where(norm > radius, pts * (radius / np.maximum(norm, 1e-9)), pts)
    return pts.astype(np.float32)


@functools.lru_cache(maxsize=8)
def _brief_on(n_bits: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_brief_pattern(n_bits)).to(device)


def _offsets(lo: int, hi: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(oy, ox): the integer offsets lo .. hi of a square window, as f32."""
    off = torch.arange(lo, hi + 1, dtype=torch.float32, device=device)
    oy, ox = torch.meshgrid(off, off, indexing="ij")
    return oy, ox


def orientation_centroid(img: torch.Tensor, uv: torch.Tensor, radius: int = 15) -> torch.Tensor:
    """ORB's intensity-centroid orientation theta = atan2(m01, m10) over a
    disc of ``radius`` (Rublee et al. 2011, sec. 3.2) -> (..., K)."""
    oy, ox = _offsets(-radius, radius, img.device)
    disc = (ox ** 2 + oy ** 2 <= radius ** 2).to(torch.float32)
    patch = _bilinear(img, uv[..., 1, None, None] + oy, uv[..., 0, None, None] + ox) * disc
    return torch.atan2((patch * oy).sum((-2, -1)), (patch * ox).sum((-2, -1)))


def steered_brief(img_smooth: torch.Tensor, uv: torch.Tensor, theta: torch.Tensor,
                  scale=1.0, n_bits: int = 256) -> torch.Tensor:
    """(..., K, n_bits) {0, 1} int8: BRIEF tests on the pattern rotated by
    theta and scaled per keypoint."""
    pat = _brief_on(n_bits, img_smooth.device)                 # (n, 2, 2) (x, y)
    sc = torch.broadcast_to(torch.as_tensor(scale, dtype=torch.float32,
                                            device=uv.device), uv.shape[:-1])[..., None, None]
    c, s = torch.cos(theta)[..., None, None], torch.sin(theta)[..., None, None]
    rx = (c * pat[..., 0] - s * pat[..., 1]) * sc              # (..., K, n, 2)
    ry = (s * pat[..., 0] + c * pat[..., 1]) * sc
    vals = _bilinear(img_smooth, uv[..., 1, None, None] + ry, uv[..., 0, None, None] + rx)
    return (vals[..., 0] < vals[..., 1]).to(torch.int8)


def pyramid_level(img: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """(..., H, W) resized to ``size`` as ``jax.image.resize(img, size,
    'linear')`` (antialiased triangle weights, half-pixel centres)."""
    out = F.interpolate(img.reshape(-1, 1, *img.shape[-2:]), size=size, mode="bilinear",
                        antialias=True, align_corners=False)
    return out.reshape(*img.shape[:-2], *size)


def orb_features(img: torch.Tensor, nfeatures: int = 1000, levels: int = 4,
                 scale_factor: float = 4.0 / 3.0, border: int = 16,
                 quality: float = 0.01) -> BinaryFeatures:
    """ORB-role features of grayscale (..., H, W) in [0, 1];
    nfeatures = 1000 as ``cv2.ORB_create(nfeatures=1000)``.  Fixed shape:
    nfeatures // levels slots a pyramid level, concatenated."""
    per = nfeatures // levels
    assert per > 0
    H, W = img.shape[-2:]
    ax = img.dim() - 2
    parts = []
    level = img
    for lv in range(levels):
        stride = scale_factor ** lv
        smooth = _blur(level, 2.0)
        c = detect_corners(level, per, quality=quality, border=border)
        theta = orientation_centroid(smooth, c.uv)
        # uv * stride + (stride - 1) / 2 in one rounding, as XLA fuses it
        uv = torch.addcmul(torch.full_like(c.uv, (stride - 1.0) / 2.0), c.uv,
                           torch.full_like(c.uv, stride))
        parts.append(BinaryFeatures(uv, steered_brief(smooth, c.uv, theta), c.valid))
        if lv + 1 < levels:
            nh = max(int(round(H / scale_factor ** (lv + 1))), 32)
            nw = max(int(round(W / scale_factor ** (lv + 1))), 32)
            level = pyramid_level(img, (nh, nw))
    return BinaryFeatures(*(torch.cat(f, dim=ax) for f in zip(*parts)))


def orientation_dominant_gradient(img: torch.Tensor, uv: torch.Tensor, radius: int = 8,
                                  n_bins: int = 36, window_bins: int = 6) -> torch.Tensor:
    """SURF/AKAZE-style dominant orientation (Compute_Main_Orientation):
    Gaussian-weighted gradient samples over a disc, binned by angle; the
    densest sliding window of ``window_bins`` bins gives theta -> (..., K)."""
    gx_img, gy_img = gradients(img)
    quad = pack_quad(img, gx_img, gy_img)
    oy, ox = _offsets(-radius, radius, img.device)
    disc = ox ** 2 + oy ** 2 <= radius ** 2
    w = torch.where(disc, torch.exp(-(ox ** 2 + oy ** 2) / (2 * (radius / 2.0) ** 2)),
                    0.0).flatten()
    vals = sample_packed(quad, img.shape[-2:], uv[..., 1, None, None] + oy,
                         uv[..., 0, None, None] + ox)
    gx = vals[..., 1].flatten(-2) * w
    gy = vals[..., 2].flatten(-2) * w
    ang = torch.atan2(gy, gx)
    b = ((ang + math.pi) * float(np.float32(n_bins / (2 * np.pi)))).to(torch.int64)
    b = b.clamp(0, n_bins - 1)
    sx = binned_sum(b, gx, n_bins)
    sy = binned_sum(b, gy, n_bins)
    # circular sliding-window sums of `window_bins` adjacent bins
    wx = sum(torch.roll(sx, -i, dims=-1) for i in range(window_bins))
    wy = sum(torch.roll(sy, -i, dims=-1) for i in range(window_bins))
    best = (wx * wx + wy * wy).argmax(-1, keepdim=True)
    return torch.atan2(wy.gather(-1, best), wx.gather(-1, best))[..., 0]


# -------------------------------------------------------------- AKAZE ----

def _diffuse(img: torch.Tensor, steps: int, dt: float = 0.15, k: float = 0.03) -> torch.Tensor:
    """Perona-Malik g2 nonlinear diffusion, explicit scheme: g = 1 / (1 +
    |grad L|^2 / k^2); L += dt div(g grad L), with edge-clamped neighbours
    (reflecting boundaries)."""
    inv_k2 = float(np.float32(1) / np.float32(k * k))   # XLA's reciprocal of the constant
    L = img
    for _ in range(steps):
        gx, gy = gradients(L)
        g = 1.0 / (1.0 + (gx * gx + gy * gy) * inv_k2)
        fx = g * gx
        fy = g * gy
        div = (0.5 * (shift_clamped(fx, 0, -1) - shift_clamped(fx, 0, 1))
               + 0.5 * (shift_clamped(fy, -1, 0) - shift_clamped(fy, 1, 0)))
        L = L + dt * div
    return L


def _hessian_det(img: torch.Tensor, sigma: float) -> torch.Tensor:
    """Scale-normalized determinant of the Hessian."""
    s = _blur(img, sigma)
    sh = shift_clamped
    lxx = sh(s, 0, -1) + sh(s, 0, 1) - 2 * s
    lyy = sh(s, -1, 0) + sh(s, 1, 0) - 2 * s
    lxy = 0.25 * (sh(s, -1, -1) + sh(s, 1, 1) - sh(s, -1, 1) - sh(s, 1, -1))
    return (sigma ** 2) * (lxx * lyy - lxy * lxy)


MLDB_GRIDS = (2, 3, 4)


@functools.lru_cache(maxsize=8)
def _mldb_tables(samples: int, device: torch.device):
    """Per grid: the (samples^2, g^2) cell membership of the samples, its
    counts, and the cell pairs (a < b) each bit compares."""
    out = []
    for g in MLDB_GRIDS:
        cell = (np.arange(samples) * g) // samples
        cid = (cell[:, None] * g + cell[None, :]).reshape(-1)
        onehot = (cid[:, None] == np.arange(g * g)[None, :]).astype(np.float32)
        a, b = np.meshgrid(np.arange(g * g), np.arange(g * g), indexing="ij")
        sel = a < b
        out.append(tuple(torch.from_numpy(x).to(device) for x in
                         (onehot, onehot.sum(0), a[sel], b[sel])))
    return out


def mldb_descriptor(img: torch.Tensor, uv: torch.Tensor, theta: torch.Tensor, scale=1.0,
                    patch: float = 20.0, samples: int = 12) -> torch.Tensor:
    """M-LDB: the oriented patch -> 2x2 / 3x3 / 4x4 grids of cell means of
    (intensity, gx, gy); bits = all pairwise comparisons a grid a channel
    -> 6 * 3 + 36 * 3 + 120 * 3 = 486 bits, (..., K, 486) int8."""
    dev = img.device
    gx, gy = gradients(img)
    quad = pack_quad(img, gx, gy)
    off = (torch.arange(samples, dtype=torch.float32, device=dev) + 0.5) / samples - 0.5
    oy, ox = torch.meshgrid(off, off, indexing="ij")
    sc = torch.broadcast_to(torch.as_tensor(scale, dtype=torch.float32, device=dev),
                            uv.shape[:-1])[..., None, None]
    c, s = torch.cos(theta)[..., None, None], torch.sin(theta)[..., None, None]
    ext = patch * sc
    rx = (c * ox - s * oy) * ext
    ry = (s * ox + c * oy) * ext
    vals = sample_packed(quad, img.shape[-2:], uv[..., 1, None, None] + ry,
                         uv[..., 0, None, None] + rx)             # (..., K, n, n, 3)
    # the derivative channels rotated into the keypoint's frame (AKAZE's
    # MLDB_Fill_Values): without it the gradient bits decorrelate under spin
    gxr = c * vals[..., 1] + s * vals[..., 2]
    gyr = -s * vals[..., 1] + c * vals[..., 2]
    flat = torch.stack([vals[..., 0], gxr, gyr], dim=-1).flatten(-3, -2)   # (..., K, n^2, 3)
    bits = []
    for onehot, counts, ia, ib in _mldb_tables(samples, dev):
        sums = (flat.transpose(-1, -2) @ onehot).transpose(-1, -2)         # (..., K, g^2, 3)
        means = sums / torch.clamp(counts, min=1.0)[:, None]
        bits.append((means[..., ia, :] > means[..., ib, :]).to(torch.int8).flatten(-2))
    return torch.cat(bits, dim=-1)


def akaze_features(img: torch.Tensor, max_keypoints: int = 512, levels: int = 4,
                   border: int = 16, quality: float = 0.001) -> BinaryFeatures:
    """AKAZE-role features of grayscale (..., H, W): nonlinear scale space +
    Hessian-determinant keypoints + M-LDB binary descriptors."""
    per = max_keypoints // levels
    assert per > 0
    ax = img.dim() - 2
    parts = []
    L = img
    sigma = 1.6
    for lv in range(levels):
        if lv:
            L = _diffuse(L, steps=6)
            sigma *= 1.6
        c = corners_from_response(_hessian_det(L, 1.0), per, quality, border)
        theta = orientation_dominant_gradient(L, c.uv, radius=8)
        parts.append(BinaryFeatures(c.uv, mldb_descriptor(L, c.uv, theta, scale=sigma / 1.6),
                                    c.valid))
    return BinaryFeatures(*(torch.cat(f, dim=ax) for f in zip(*parts)))
