"""Classic IBVS control law (``vitvs_tpu/control/ibvs.py``): interaction
matrix, pseudo-inverse velocity solve ('svd' = ``np.linalg.pinv`` parity,
'dls' = damped least squares through a 6x6 Cholesky), per-axis EMA, the
optical -> body remap with clipping, and the depth lookup with its 100 m
missing-depth sentinel.  Invalid correspondence slots are dropped by zeroing
their rows of L and e.  Every function takes leading batch dims, one solve,
EMA and depth map per episode of a chunk."""

from __future__ import annotations

from typing import NamedTuple

import torch

from vitvs_tpu_torch.core import se3


def interaction_matrix(s_xy: torch.Tensor, Z: torch.Tensor) -> torch.Tensor:
    """Feature Jacobian L (..., 2k, 6) of points (..., k, 2) at depths
    (..., k), interleaved x/y rows per point:
        [-1/z,   0,  x/z,  x*y, -(1+x^2),  y]
        [  0, -1/z,  y/z, 1+y^2,  -x*y,   -x]
    """
    x, y, z = s_xy[..., 0], s_xy[..., 1], Z
    zero = torch.zeros_like(x)
    row_x = torch.stack([-1.0 / z, zero, x / z, x * y, -(1.0 + x * x), y], dim=-1)
    row_y = torch.stack([zero, -1.0 / z, y / z, 1.0 + y * y, -x * y, -x], dim=-1)
    L = torch.stack([row_x, row_y], dim=-2)     # (..., k, 2, 6)
    return L.reshape(*L.shape[:-3], -1, 6)


def ibvs_velocity(
    s_xy: torch.Tensor,
    s_star_xy: torch.Tensor,
    Z: torch.Tensor,
    lambda_: float,
    valid: torch.Tensor | None = None,
    mode: str = "svd",
    damping: float = 1e-9,
) -> torch.Tensor:
    """v_c = -lambda * pinv(L) @ e, the 6-DoF OPTICAL-frame velocity (..., 6).

    s_xy, s_star_xy: (..., k, 2) current / goal normalized features; Z:
    (..., k) depths; valid: (..., k) mask of real correspondence slots.  Each
    leading index is its own solve."""
    e = (s_xy - s_star_xy).reshape(*s_xy.shape[:-2], -1, 1)     # (..., 2k, 1)
    L = interaction_matrix(s_xy, Z)
    if valid is not None:
        m = valid.to(L.dtype).repeat_interleave(2, dim=-1)[..., None]
        L = L * m
        e = e * m
    if mode == "svd":
        # jnp.linalg.pinv's default cutoff: 10 * max(M, N) * eps
        rtol = 10.0 * max(L.shape[-2:]) * torch.finfo(L.dtype).eps
        return -lambda_ * (torch.linalg.pinv(L, rtol=rtol) @ e)[..., 0]
    if mode == "dls":
        LtL = L.mT @ L + damping * torch.eye(6, dtype=L.dtype, device=L.device)
        # fewer than 3 live pairs leave L^T L singular in f32; as the
        # reference's cho_factor, give non-finite values (the step's
        # feature-failure select discards them) instead of raising, and
        # without a host sync on the factorization's status; per solve, so
        # one singular episode leaves the chunk's others alone
        chol, info = torch.linalg.cholesky_ex(LtL)
        v = -lambda_ * torch.cholesky_solve(L.mT @ e, chol)[..., 0]
        return torch.where(info[..., None] == 0, v, torch.full_like(v, torch.nan))
    raise ValueError(f"unknown pinv mode {mode!r}")


class EmaState(NamedTuple):
    """Per-axis EMA of the velocity command: the first sample initializes,
    then ema = a * new + (1 - a) * ema.  A chunk's has a leading B."""

    value: torch.Tensor        # (6,), or (B, 6)
    initialized: torch.Tensor  # () bool, or (B,)

    @staticmethod
    def init(device="cuda", batch: tuple[int, ...] = ()) -> "EmaState":
        return EmaState(torch.zeros(*batch, 6, device=device),
                        torch.zeros(batch, dtype=torch.bool, device=device))


def ema_update(state: EmaState, new_value: torch.Tensor,
               alpha: float) -> tuple[EmaState, torch.Tensor]:
    smoothed = torch.where(state.initialized[..., None],
                           alpha * new_value + (1.0 - alpha) * state.value, new_value)
    return EmaState(smoothed, torch.ones_like(state.initialized)), smoothed


def body_twist_from_optical(v_c: torch.Tensor, max_velocity: float) -> torch.Tensor:
    """Optical-frame velocity -> body-frame twist clipped to +-max_velocity."""
    return se3.optical_twist_to_body(v_c).clamp(-max_velocity, max_velocity)


def depth_at_points(depth_m: torch.Tensor, uv: torch.Tensor,
                    sentinel: float = 100.0) -> torch.Tensor:
    """Per-point z-depth of (..., H, W) maps at (..., k, 2) pixels (u, v),
    each map read at its own points; out-of-bounds or zero depth reads as
    ``sentinel`` (100 m)."""
    h, w = depth_m.shape[-2:]
    u = uv[..., 0].to(torch.int32)
    v = uv[..., 1].to(torch.int32)
    in_bounds = (u >= 0) & (u < w) & (v >= 0) & (v < h)
    flat = (v.clamp(0, h - 1) * w + u.clamp(0, w - 1)).long()
    z = torch.gather(depth_m.flatten(-2), -1, flat)
    z = torch.where(z != 0.0, z, torch.full_like(z, sentinel))
    return torch.where(in_bounds, z, torch.full_like(z, sentinel))
