"""Scene perturbation (``vitvs_tpu/sim/perturb.py``): the reference's
RandomErasing(p=0.5) + ColorJitter(0.6, 0.4) + Gaussian noise (sigma 0.05)
poster corruption, applied to the scene texture on its device.

The random draws are split from the arithmetic: :func:`draw_perturbation`
takes them from an explicit ``torch.Generator`` (torch cannot reproduce
``jax.random``), :func:`apply_perturbation` is a pure function of the
texture and the draws, so a test can feed it the draws JAX's keys give.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch


# the reference's corruption (generate_perturbed_models.py): RandomErasing p,
# area fraction and aspect ranges, ColorJitter brightness and contrast, noise sigma
ERASE_P = 0.5
ERASE_SCALE = (0.02, 0.33)
ERASE_RATIO = (0.3, 3.3)
BRIGHTNESS = 0.6
CONTRAST = 0.4
NOISE_SIGMA = 0.05


class PerturbDraws(NamedTuple):
    erase: torch.Tensor             # () bool: erase a rectangle
    erase_hw: torch.Tensor          # (2,) int32 rectangle height and width
    erase_origin: torch.Tensor      # (2,) int32 top, left (the far edge reachable)
    brightness: torch.Tensor        # () brightness factor
    contrast: torch.Tensor          # () contrast factor
    brightness_first: torch.Tensor  # () bool: brightness before contrast
    noise: torch.Tensor             # (H, W, 3) standard normal


def _uniform(generator: torch.Generator, lo: float, hi: float) -> torch.Tensor:
    return lo + (hi - lo) * torch.rand((), generator=generator, device=generator.device)


def draw_perturbation(generator: torch.Generator, shape) -> PerturbDraws:
    """The draws of one perturbation of an (H, W, 3) texture, on the
    generator's device, without a host sync: the erased area is a fraction
    U[scale] of the texture with aspect exp(U[log ratio]), its origin uniform
    over the positions that keep it inside (edge included)."""
    h, w, _ = shape
    area = _uniform(generator, *ERASE_SCALE) * h * w
    aspect = torch.exp(_uniform(generator, math.log(ERASE_RATIO[0]), math.log(ERASE_RATIO[1])))
    eh = torch.sqrt(area * aspect).clamp(1, h).to(torch.int32)
    ew = torch.sqrt(area / aspect).clamp(1, w).to(torch.int32)
    u = torch.rand(2, generator=generator, device=generator.device)
    span = torch.stack([h - eh + 1, w - ew + 1]).clamp(min=1)
    origin = torch.minimum((u * span).to(torch.int32), span - 1)
    return PerturbDraws(
        erase=torch.rand((), generator=generator, device=generator.device) < ERASE_P,
        erase_hw=torch.stack([eh, ew]),
        erase_origin=origin,
        brightness=_uniform(generator, max(0.0, 1 - BRIGHTNESS), 1 + BRIGHTNESS),
        contrast=_uniform(generator, 1 - CONTRAST, 1 + CONTRAST),
        brightness_first=torch.rand((), generator=generator, device=generator.device) < 0.5,
        noise=torch.randn(tuple(shape), generator=generator, device=generator.device),
    )


def apply_perturbation(texture: torch.Tensor, draws: PerturbDraws) -> torch.Tensor:
    """Erase (value 0), then brightness and contrast in the drawn order, then
    noise, then clip to [0, 1]."""
    h, w, _ = texture.shape
    dev = texture.device
    rows = torch.arange(h, device=dev)[:, None]
    cols = torch.arange(w, device=dev)[None, :]
    (top, left), (eh, ew) = draws.erase_origin, draws.erase_hw
    inside = (rows >= top) & (rows < top + eh) & (cols >= left) & (cols < left + ew)
    img = torch.where((inside & draws.erase)[..., None], torch.zeros_like(texture), texture)

    def apply_brightness(x):
        return torch.clamp(x * draws.brightness, 0.0, 1.0)

    def apply_contrast(x):
        mean = (0.299 * x[..., 0] + 0.587 * x[..., 1] + 0.114 * x[..., 2]).mean()
        return torch.clamp((x - mean) * draws.contrast + mean, 0.0, 1.0)

    img = torch.where(draws.brightness_first, apply_contrast(apply_brightness(img)),
                      apply_brightness(apply_contrast(img)))
    return torch.clamp(img + draws.noise * NOISE_SIGMA, 0.0, 1.0)


def perturb_texture(generator: torch.Generator, texture: torch.Tensor) -> torch.Tensor:
    """The full chain on a texture with fresh draws from ``generator``."""
    return apply_perturbation(texture, draw_perturbation(generator, texture.shape))
