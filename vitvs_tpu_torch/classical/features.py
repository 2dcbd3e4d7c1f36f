"""The classical feature pipeline (``vitvs_tpu/classical/features.py``) in
PyTorch: fixed-shape, mask-based corner detection, rotation-aware gradient
descriptors and brute-force mutual-NN matching, the non-learned comparison
baseline of the paper.

* Harris response + 3x3 non-max suppression, top-K corners (a static K with
  a validity mask instead of a dynamic keypoint list);
* SIFT-style descriptors: dominant gradient orientation, then a 4x4 grid of
  8-bin orientation histograms sampled on the rotated frame (128-d,
  normalized, clipped at 0.2, renormalized);
* mutual-NN (cross-check) matching sorted by distance, the top
  ``num_pairs`` kept, with Lowe's ratio test on top.

Every function takes a leading batch of frames, (..., H, W) images and
(..., K, 2) keypoints, one frame being the batch of none: a chunk's frames
go through each operation once (one gather, one product).  f32
throughout; the card runs the products with TF32 off
(``core/image.set_f32_matmul_precision``).  The filters are sums of shifted
maps, not library convolutions, so every frame of a batch, and every
device, computes the same arithmetic: a chunk equals its frames alone.

Boundary rules follow the reference: blurs and Sobel gradients pad with
zeros (XLA's "SAME" convolution), stencil neighbours (:func:`shift_clamped`)
replicate the edge.  Selections follow ``lax.top_k``: sorted descending, the
lower index first among equal values (:func:`top_k_scores`), on the CPU
and the card alike.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from vitvs_tpu_torch.core.image import bilinear_packed, pack_quad
from vitvs_tpu_torch.ops.int_mm import int8_matmul_nt

BIG = 3e38                # the distance of an unmatched slot
_HIST_ELEMS = 1 << 26     # elements of one histogram one-hot chunk (256 MB of f32)


def grayscale(rgb: torch.Tensor) -> torch.Tensor:
    """(..., H, W, 3) in [0, 1] -> (..., H, W), OpenCV's RGB2GRAY weights."""
    return rgb @ torch.tensor([0.299, 0.587, 0.114], dtype=rgb.dtype, device=rgb.device)


def _gaussian_kernel1d(sigma: float, radius: int) -> np.ndarray:
    x = np.arange(-radius, radius + 1)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


@functools.lru_cache(maxsize=64)
def _blur_taps(sigma: float, radius: int, device: torch.device) -> torch.Tensor:
    """The separable gaussian's taps as a constant tensor on ``device``."""
    return torch.from_numpy(_gaussian_kernel1d(sigma, radius)).to(device)


def _as_nchw(img: torch.Tensor) -> torch.Tensor:
    return img.reshape(-1, 1, *img.shape[-2:])


def _blur(img: torch.Tensor, sigma: float) -> torch.Tensor:
    """Separable gaussian blur of (..., H, W), zero-padded: along W, then H.
    Each pass weighs the unfolded taps and sums them, the same arithmetic
    for every frame of a batch and on every device (a convolution library
    picks its algorithm by the batch's size)."""
    radius = max(1, int(3 * sigma))
    k = _blur_taps(float(sigma), radius, img.device)
    taps = 2 * radius + 1
    x = (F.pad(img, (radius, radius)).unfold(-1, taps, 1) * k).sum(-1)
    return (F.pad(x, (0, 0, radius, radius)).unfold(-2, taps, 1) * k).sum(-1)


def shift_clamped(a: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """Shift the last two dims by (dy, dx) with edge-clamped (replicate)
    boundaries: out[i, j] = a[clamp(i - dy), clamp(j - dx)], the
    non-periodic stencil neighbour (a roll would wrap opposite edges)."""
    h, w = a.shape[-2:]
    iy = (torch.arange(h, device=a.device) - dy).clamp(0, h - 1)
    ix = (torch.arange(w, device=a.device) - dx).clamp(0, w - 1)
    return a.index_select(-2, iy).index_select(-1, ix)


def gradients(img: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Sobel gradients (gx, gy) of (..., H, W), zero-padded, as separable
    sums and one difference each.  Where the two sides of a stencil cancel
    exactly the difference is +0, as XLA's convolution gives it; a
    convolution library may give -0 there, and the gradient angle
    (atan2(+-0, +-0)) of a flat pixel then jumps by pi."""
    p = F.pad(img, (1, 1, 1, 1))
    rows = p[..., :-2, :] + 2 * p[..., 1:-1, :] + p[..., 2:, :]    # (H, W + 2): down the columns
    cols = p[..., :, :-2] + 2 * p[..., :, 1:-1] + p[..., :, 2:]    # (H + 2, W): along the rows
    return rows[..., 2:] - rows[..., :-2], cols[..., 2:, :] - cols[..., :-2, :]


def harris_response(img: torch.Tensor, sigma: float = 1.5, k: float = 0.04) -> torch.Tensor:
    gx, gy = gradients(img)
    ixx, iyy, ixy = _blur(torch.stack([gx * gx, gy * gy, gx * gy]), sigma)
    det = ixx * iyy - ixy * ixy
    tr = ixx + iyy
    return det - k * tr * tr


class Corners(NamedTuple):
    uv: torch.Tensor        # (..., K, 2) float pixel coords (u, v)
    response: torch.Tensor  # (..., K)
    valid: torch.Tensor     # (..., K) bool


def top_k_scores(flat: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the k best scores along the last axis, exactly
    as ``lax.top_k``: sorted descending, the lower index first among equal
    values.  The scores' f32 bits, made order-preserving, and the reversed
    index form one int64 key each, so the keys are distinct and
    ``torch.topk``'s order is the reference's on any device (the order of
    equal values it leaves open)."""
    n = flat.shape[-1]
    bits = flat.contiguous().view(torch.int32)
    bits = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits).to(torch.int64)
    rev = torch.arange(n - 1, -1, -1, device=flat.device)
    _, idx = torch.topk((bits << 32) | rev, k, dim=-1)
    return flat.gather(-1, idx), idx


def local_max3(r: torch.Tensor) -> torch.Tensor:
    """3x3 maximum of (..., H, W) with -inf beyond the border (XLA's "SAME"
    ``reduce_window`` max)."""
    return F.max_pool2d(_as_nchw(r), 3, stride=1, padding=1).reshape(r.shape)


def inside_border(h: int, w: int, border: int, device) -> torch.Tensor:
    """(H, W) bool: pixels at least ``border`` from every edge."""
    rows = torch.arange(h, device=device)[:, None]
    cols = torch.arange(w, device=device)[None, :]
    return (rows >= border) & (rows < h - border) & (cols >= border) & (cols < w - border)


def corners_from_response(r: torch.Tensor, max_corners: int, quality: float,
                          border: int) -> Corners:
    """The top ``max_corners`` 3x3 peaks of response maps (..., H, W) above
    ``quality`` times each map's maximum and ``border`` pixels inside."""
    h, w = r.shape[-2:]
    is_peak = (r >= local_max3(r)) & (r > quality * r.amax((-2, -1), keepdim=True))
    score = torch.where(is_peak & inside_border(h, w, border, r.device), r, -math.inf)
    top, idx = top_k_scores(score.flatten(-2), max_corners)
    uv = torch.stack([idx % w, idx // w], dim=-1).to(torch.float32)
    return Corners(uv=uv, response=top, valid=torch.isfinite(top))


def detect_corners(img: torch.Tensor, max_corners: int = 512, quality: float = 0.01,
                   border: int = 8) -> Corners:
    """Harris + 3x3 NMS + top-K (a fixed-shape ``goodFeaturesToTrack``)."""
    return corners_from_response(harris_response(img), max_corners, quality, border)


def sample_packed(quad: torch.Tensor, hw: tuple[int, int], ys: torch.Tensor,
                  xs: torch.Tensor) -> torch.Tensor:
    """Bilinear samples of a batch of :func:`pack_quad` images (..., H * W,
    4C) at coordinates (..., *S), each image at its own -> (..., *S, C):
    one gather for the batch."""
    lead = quad.shape[:-2]
    nb = math.prod(lead)
    npix = hw[0] * hw[1]
    off = (torch.arange(nb, device=quad.device) * npix).view(nb, *[1] * (ys.dim() - len(lead)))
    out = bilinear_packed(quad.reshape(nb * npix, quad.shape[-1]), hw,
                          ys.reshape(nb, *ys.shape[len(lead):]),
                          xs.reshape(nb, *xs.shape[len(lead):]), off)
    return out.reshape(*ys.shape, out.shape[-1])


def _bilinear(img: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """Samples of (..., H, W) images at (..., *S) coordinates."""
    return sample_packed(pack_quad(img[..., None]), img.shape[-2:], ys, xs)[..., 0]


def binned_sum(idx: torch.Tensor, w: torch.Tensor, n_bins: int) -> torch.Tensor:
    """Histograms (..., n_bins) of weights (..., S) by bin (..., S), as the
    reference's one-hot weighted sums over the samples (a reduction, so two
    runs on the card sum in the same order, which atomic adds would not),
    in chunks of rows that bound the one-hot's memory."""
    lead, s = idx.shape[:-1], idx.shape[-1]
    idx, w = idx.reshape(-1, s), w.reshape(-1, s)
    bins = torch.arange(n_bins, device=idx.device)
    rows = max(1, _HIST_ELEMS // (s * n_bins))
    out = [torch.where(idx[lo:lo + rows, :, None] == bins, w[lo:lo + rows, :, None], 0.0).sum(1)
           for lo in range(0, idx.shape[0], rows)]
    return torch.cat(out).reshape(*lead, n_bins)


def _unit(desc: torch.Tensor) -> torch.Tensor:
    return desc / torch.clamp(torch.linalg.vector_norm(desc, dim=-1, keepdim=True), min=1e-12)


def sift_like_descriptors(img: torch.Tensor, uv: torch.Tensor, scale=1.0,
                          num_angle_bins: int = 36, grid: int = 4, bins: int = 8,
                          window: int = 16) -> torch.Tensor:
    """(..., K, grid * grid * bins) rotation-aware gradient-histogram
    descriptors of keypoints (..., K, 2) in images (..., H, W).

    ``scale`` (a number or (..., K)) multiplies the sampling offsets, so a
    keypoint detected at DoG scale s is described over ``window * s``
    pixels."""
    dev = img.device
    gx, gy = gradients(img)
    mag = torch.sqrt(gx * gx + gy * gy + 1e-12)
    ang = torch.atan2(gy, gx)
    quad = pack_quad(mag, ang)        # (mag, ang): one gather a sample
    hw = img.shape[-2:]

    half = window / 2.0
    off = torch.arange(window, dtype=torch.float32, device=dev) - half + 0.5
    oy, ox = torch.meshgrid(off, off, indexing="ij")
    gauss = torch.exp(-(ox ** 2 + oy ** 2) / (2 * (half ** 2)))
    sc = torch.broadcast_to(torch.as_tensor(scale, dtype=torch.float32, device=dev),
                            uv.shape[:-1])[..., None, None]
    u, v = uv[..., 0, None, None], uv[..., 1, None, None]

    # dominant orientation from an axis-aligned window
    ma = sample_packed(quad, hw, v + oy * sc, u + ox * sc)         # (..., K, win, win, 2)
    m, a = ma[..., 0], ma[..., 1]
    tau = np.float32(2 * np.pi)
    # XLA folds "/ (2 pi) * n" into one multiply by f32(f32(1 / f32(2 pi)) * n)
    hist_idx = torch.floor((a + math.pi) * float(np.float32(1) / tau
                                                 * np.float32(num_angle_bins)))
    hist_idx = hist_idx.clamp(0, num_angle_bins - 1).to(torch.int64)
    ohist = binned_sum(hist_idx.flatten(-2), (m * gauss).flatten(-2), num_angle_bins)
    theta = (ohist.argmax(-1).to(torch.float32) + 0.5) * float(np.float32(1 / num_angle_bins))
    theta = (theta * 2 * math.pi - math.pi)[..., None, None]

    # rotated resampling
    c, s = torch.cos(theta), torch.sin(theta)
    rx = (c * ox - s * oy) * sc
    ry = (s * ox + c * oy) * sc
    ma = sample_packed(quad, hw, v + ry, u + rx)
    m = ma[..., 0]
    a = ma[..., 1] - theta            # gradient angles re-referenced

    # grid x grid cells x `bins` orientation bins, soft (linear) binning
    bpos = torch.remainder(a + math.pi, float(tau)) * float(np.float32(1) / tau
                                                            * np.float32(bins)) - 0.5
    b0 = torch.floor(bpos)
    frac = bpos - b0
    b0i = torch.remainder(b0.to(torch.int64), bins)
    b1i = torch.remainder(b0i + 1, bins)
    wgt = m * gauss
    # each cell's samples only reach that cell's bins: histogram per cell
    cell = window // grid

    def cells(x):                     # (..., win, win) -> (..., grid * grid, cell * cell)
        x = x.reshape(*x.shape[:-2], grid, cell, grid, cell).transpose(-3, -2)
        return x.reshape(*x.shape[:-4], grid * grid, cell * cell)

    desc = (binned_sum(cells(b0i), cells(wgt * (1 - frac)), bins)
            + binned_sum(cells(b1i), cells(wgt * frac), bins))
    desc = desc.flatten(-2)
    # SIFT normalization: L2, clip 0.2, L2
    return _unit(torch.clamp(_unit(desc), max=0.2))


class Matches(NamedTuple):
    idx1: torch.Tensor       # (..., P) indices into the first set (the goal's)
    idx2: torch.Tensor       # (..., P) indices into the second set
    distance: torch.Tensor   # (..., P)
    valid: torch.Tensor      # (..., P) bool
    num_valid: torch.Tensor  # (...) int32


def _hamming_d2(desc1: torch.Tensor, desc2: torch.Tensor) -> torch.Tensor:
    """Hamming distances of {0, 1} rows: goal (K1, d) against frames (...,
    K2, d) -> (..., K1, K2) f32, as |a| + |b| - 2 a.b with a.b ONE exact
    int8 product (B K2, d) x (d, K1) for the batch."""
    a, b = desc1.to(torch.int8), desc2.to(torch.int8)
    lead, k2, d = b.shape[:-2], b.shape[-2], b.shape[-1]
    dot = int8_matmul_nt(b.reshape(-1, d), a).reshape(*lead, k2, -1).transpose(-1, -2)
    s1 = a.to(torch.int32).sum(-1)
    s2 = b.to(torch.int32).sum(-1)
    return (s1[:, None] + s2[..., None, :] - 2 * dot).to(torch.float32)


def match_descriptors(desc1: torch.Tensor, desc2: torch.Tensor, valid1: torch.Tensor,
                      valid2: torch.Tensor, num_pairs: int, norm: str = "l2",
                      ratio: float | None = None) -> Matches:
    """Brute-force mutual-NN (cross-check) matching, sorted by distance, the
    top ``num_pairs`` kept: BFMatcher(norm, crossCheck=True).match + sort.
    ``desc1``/``valid1`` are one set (the goal's, (K1, d)), ``desc2``/
    ``valid2`` one or a batch of sets (..., K2, d).

    norm='l2' for float descriptors (SIFT), f32 products with TF32 off;
    norm='hamming' for {0, 1} int8 descriptors (ORB, AKAZE), an exact int8
    product.  ``ratio`` adds Lowe's ambiguity test: a match survives only if
    best < ratio * second best (squared for l2's squared distances)."""
    if norm == "hamming":
        d2 = _hamming_d2(desc1, desc2)
    else:
        d2 = ((desc1 ** 2).sum(-1)[:, None] + (desc2 ** 2).sum(-1)[..., None, :]
              - 2.0 * (desc1 @ desc2.transpose(-1, -2)))
    both = valid1[:, None] & valid2[..., None, :]
    d2 = torch.where(both, torch.clamp(d2, min=0.0), BIG)
    k1 = desc1.shape[0]
    if ratio is not None:
        neg2, top2 = top_k_scores(-d2, 2)
        best, second = -neg2[..., 0], -neg2[..., 1]
        nn12 = top2[..., 0]
        thresh = (ratio * ratio if norm != "hamming" else ratio) * second
        unambiguous = best < thresh
    else:
        nn12 = d2.argmin(-1)
        best = d2.amin(-1)
        unambiguous = torch.ones_like(best, dtype=torch.bool)
    nn21 = d2.argmin(-2)                                                   # (..., K2)
    ar1 = torch.arange(k1, device=d2.device)
    mutual = (nn21.gather(-1, nn12) == ar1) & valid1 & (best < BIG) & unambiguous
    dist = torch.where(mutual, best if norm == "hamming" else torch.sqrt(best), BIG)
    neg, order = top_k_scores(-dist, min(num_pairs, k1))
    sel_dist = -neg
    sel_valid = sel_dist < BIG
    if order.shape[-1] < num_pairs:
        fill = order.new_zeros(*order.shape[:-1], num_pairs - order.shape[-1])
        order = torch.cat([order, fill], -1)
        sel_dist = torch.cat([sel_dist, torch.full_like(fill, BIG, dtype=torch.float32)], -1)
        sel_valid = torch.cat([sel_valid, fill.bool()], -1)
    zero = torch.zeros_like(order)
    return Matches(idx1=torch.where(sel_valid, order, zero),
                   idx2=torch.where(sel_valid, nn12.gather(-1, order), zero),
                   distance=sel_dist, valid=sel_valid,
                   num_valid=sel_valid.sum(-1, dtype=torch.int32))
