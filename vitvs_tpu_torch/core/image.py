"""Image preprocessing as two dense resampling matmuls
(``vitvs_tpu/core/image.py``): out = W_h @ img @ W_w^T, with the weights
computed once per shape in numpy.

``resize`` takes the reference's ``precision``.  'highest' (the default)
and 'high' are full f32 matmuls; on the card that needs TF32 off for
matmuls and for cuDNN, which :func:`set_f32_matmul_precision` sets and the
servo pipeline calls.  'default' (the int8 serving setting) is one reduced
precision pass: on the card the two resize products run in TF32, as XLA
lowers ``DEFAULT`` f32 dots on Ampere and later, with TF32 allowed for
those two products only; on the CPU it is f32, as XLA computes it there.

Parity notes (as in the JAX package):
  * ``method='bicubic'`` reproduces torch's cubic convolution (A = -0.75,
    half-pixel, ``align_corners=False``, replicate edges); with
    ``antialias=True`` the PIL cubic (A = -0.5) with a widened support.
  * ``scale=`` overrides the coordinate scale, reproducing
    ``F.interpolate(scale_factor=..., recompute_scale_factor=False)``, which
    the DINO pos-embed "+0.1" resample depends on.
"""

from __future__ import annotations

import contextlib
import functools

import numpy as np
import torch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
HALF_MEAN = (0.5, 0.5, 0.5)
HALF_STD = (0.5, 0.5, 0.5)
PRECISIONS = ("highest", "high", "default")


def set_f32_matmul_precision() -> None:
    """Full-f32 matmuls and convolutions on the card (no TF32), the
    ``precision='highest'`` semantics the preprocess and the f32 parity
    runs rely on.  Process-wide PyTorch settings."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@contextlib.contextmanager
def _tf32_matmuls():
    """TF32 cuBLAS matmuls inside the block, the setting restored after."""
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


def _cubic_kernel(x: np.ndarray, a: float = -0.75) -> np.ndarray:
    """Cubic convolution kernel, torch's A = -0.75 variant."""
    ax = np.abs(x)
    ax2 = ax * ax
    ax3 = ax2 * ax
    return np.where(
        ax <= 1.0,
        (a + 2.0) * ax3 - (a + 3.0) * ax2 + 1.0,
        np.where(ax < 2.0, a * ax3 - 5.0 * a * ax2 + 8.0 * a * ax - 4.0 * a, 0.0),
    )


def _linear_kernel(x: np.ndarray) -> np.ndarray:
    return np.maximum(0.0, 1.0 - np.abs(x))


@functools.lru_cache(maxsize=256)
def resize_weights(
    in_size: int,
    out_size: int,
    method: str = "bilinear",
    antialias: bool = False,
    scale: float | None = None,
) -> np.ndarray:
    """(out_size, in_size) resampling matrix, half-pixel / align_corners=False.

    ``scale`` is the out/in coordinate scale; None means out_size / in_size.
    """
    if method == "bilinear":
        kernel, support = _linear_kernel, 1.0
    elif method == "bicubic":
        a = -0.5 if antialias else -0.75
        kernel, support = (lambda x: _cubic_kernel(x, a=a)), 2.0
    elif method == "nearest":
        kernel, support = None, 0.5
    else:
        raise ValueError(f"unknown resize method {method!r}")

    s = (out_size / in_size) if scale is None else scale
    inv = 1.0 / s

    dst = np.arange(out_size, dtype=np.float64)
    src = (dst + 0.5) * inv - 0.5

    if method == "nearest":
        idx = np.clip(np.floor(dst * inv).astype(np.int64), 0, in_size - 1)
        w = np.zeros((out_size, in_size), dtype=np.float32)
        w[np.arange(out_size), idx] = 1.0
        return w

    filt_scale = max(inv, 1.0) if antialias else 1.0
    sup = support * filt_scale

    if antialias:
        # PIL tap window [int(center - sup + 0.5), int(center + sup + 0.5)),
        # clipped to bounds and renormalized over the window
        center = src + 0.5
        xmin = np.maximum(0, (center - sup + 0.5).astype(np.int64))
        xmax = np.minimum(in_size, (center + sup + 0.5).astype(np.int64))
        ntaps = int((xmax - xmin).max())
        taps = xmin[:, None] + np.arange(ntaps)[None, :]
        x = (src[:, None] - taps) / filt_scale
        w = kernel(x)
        w = np.where(taps < xmax[:, None], w, 0.0)
    else:
        lo = np.floor(src - sup + 1.0).astype(np.int64)
        ntaps = int(np.ceil(2.0 * sup)) + 2
        taps = lo[:, None] + np.arange(ntaps)[None, :]
        x = (src[:, None] - taps) / filt_scale
        w = kernel(x)
    w = w / np.maximum(w.sum(axis=1, keepdims=True), 1e-12)
    # replicate-pad edges: clamped taps accumulate onto the edge sample
    taps_c = np.clip(taps, 0, in_size - 1)
    dense = np.zeros((out_size, in_size), dtype=np.float64)
    np.add.at(dense, (np.repeat(np.arange(out_size), ntaps), taps_c.ravel()), w.ravel())
    return dense.astype(np.float32)


@functools.lru_cache(maxsize=64)
@torch.inference_mode(False)
def _weights_on(in_size: int, out_size: int, method: str, antialias: bool,
                scale: float | None, device: torch.device) -> torch.Tensor:
    """resize_weights as a constant tensor on ``device`` (built once, and
    never as an inference tensor: a training forward may take it after a
    serving call under inference_mode built it)."""
    return torch.from_numpy(
        resize_weights(in_size, out_size, method, antialias, scale)).to(device)


def resize(
    img: torch.Tensor,
    out_hw: tuple[int, int],
    method: str = "bilinear",
    antialias: bool = False,
    precision: str = "highest",
) -> torch.Tensor:
    """Resize (..., H, W, C) f32 images to (..., H', W', C) via two matmuls,
    at ``precision`` (see the module docstring)."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")
    h, w = img.shape[-3], img.shape[-2]
    oh, ow = out_hw
    wh = _weights_on(h, oh, method, antialias, None, img.device)
    ww = _weights_on(w, ow, method, antialias, None, img.device)
    tf32 = precision == "default" and img.device.type == "cuda"
    with _tf32_matmuls() if tf32 else contextlib.nullcontext():
        out = torch.einsum("Oh,...hwc->...Owc", wh, img)
        return torch.einsum("Ow,...hwc->...hOc", ww, out)


def interpolate_bicubic_scale_factor(
    grid: torch.Tensor, scale_h: float, scale_w: float
) -> torch.Tensor:
    """Bicubic resample of an (H, W, D) f32 grid with explicit scale factors:
    output floor(in * scale), coordinates mapped with the given scale."""
    h, w, _ = grid.shape
    oh = int(np.floor(h * scale_h))
    ow = int(np.floor(w * scale_w))
    wh = _weights_on(h, oh, "bicubic", False, scale_h, grid.device)
    ww = _weights_on(w, ow, "bicubic", False, scale_w, grid.device)
    out = torch.einsum("Oh,hwd->Owd", wh, grid)
    return torch.einsum("Ow,hwd->hOd", ww, out)


def normalize(img: torch.Tensor, mean=IMAGENET_MEAN, std=IMAGENET_STD) -> torch.Tensor:
    """Channel-wise normalization of a float image in [0, 1], (..., H, W, C)."""
    mean = torch.tensor(mean, dtype=img.dtype, device=img.device)
    std = torch.tensor(std, dtype=img.dtype, device=img.device)
    return (img - mean) / std


def preprocess_frame(
    rgb: torch.Tensor,
    input_size: int,
    mean=IMAGENET_MEAN,
    std=IMAGENET_STD,
    method: str = "bicubic",
    antialias: bool = True,
    precision: str = "highest",
) -> torch.Tensor:
    """Resize to (input_size, input_size) at ``precision``, scale uint8 to
    [0, 1], normalize.

    Accepts (..., H, W, 3) uint8 or float; returns float32 (..., S, S, 3).
    """
    img = rgb.to(torch.float32)
    if rgb.dtype == torch.uint8:
        img = img / 255.0
    img = resize(img, (input_size, input_size), method=method, antialias=antialias,
                 precision=precision)
    return normalize(img, mean, std)


def pack_quad(*maps: torch.Tensor) -> torch.Tensor:
    """(..., H, W, C) images -> (..., H * W, 4C): each pixel's 2x2 bilinear
    neighbourhood (edge-padded) packed into channels [v00, v01, v10, v11],
    so that one gather per sample fetches all four corners.  Built once per
    texture.  Several maps (..., H, W) sampled at the same coordinates are
    packed as the C channels of one image, in the order given; one map
    alone is passed with its channel axis, (..., H, W, 1)."""
    img = maps[0] if len(maps) == 1 else torch.stack(maps, dim=-1)
    h, w, c = img.shape[-3:]
    tp = torch.cat([img, img[..., -1:, :, :]], dim=-3)
    tp = torch.cat([tp, tp[..., :, -1:, :]], dim=-2)
    quad = torch.cat([tp[..., :-1, :-1, :], tp[..., :-1, 1:, :], tp[..., 1:, :-1, :],
                      tp[..., 1:, 1:, :]], dim=-1)
    return quad.reshape(*img.shape[:-3], h * w, 4 * c)


def bilinear_packed(quad: torch.Tensor, hw: tuple[int, int], ys: torch.Tensor,
                    xs: torch.Tensor, offset: torch.Tensor | int = 0) -> torch.Tensor:
    """Sample a :func:`pack_quad` image at continuous coords -> (..., C),
    the corner indices clamped to the image:
    ((v00 (1 - fx) + v01 fx) (1 - fy) + (v10 (1 - fx) + v11 fx) fy).
    ``offset`` is added to each flat texel index: ``b * H * W`` picks image
    b of a stack of packed images flattened to (B * H * W, 4C)."""
    h, w = hw
    y0, x0 = torch.floor(ys), torch.floor(xs)
    fy, fx = (ys - y0)[..., None], (xs - x0)[..., None]
    y0 = y0.to(torch.int32).clamp(0, h - 1)
    x0 = x0.to(torch.int32).clamp(0, w - 1)
    q = quad[(y0 * w + x0).long() + offset]
    v00, v01, v10, v11 = q.chunk(4, dim=-1)
    return (v00 * (1 - fx) + v01 * fx) * (1 - fy) + (v10 * (1 - fx) + v11 * fx) * fy
