"""Pinhole camera intrinsics (``vitvs_tpu/core/camera.py``): the Gazebo
RealSense's 65 deg HFOV at 640x480, principal point at the image centre."""

from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class CameraIntrinsics:
    width: int = 640
    height: int = 480
    fx: float = 502.3016357421875
    fy: float = 502.3016357421875
    cx: float | None = None
    cy: float | None = None

    def __post_init__(self):
        if self.cx is None:
            object.__setattr__(self, "cx", self.width / 2.0)
        if self.cy is None:
            object.__setattr__(self, "cy", self.height / 2.0)

    @staticmethod
    def from_hfov(width: int, height: int, hfov_deg: float) -> "CameraIntrinsics":
        """Intrinsics from a horizontal field of view, as the Gazebo plugin's
        ``f = 0.5 * W / tan(HFOV / 2)``."""
        f = 0.5 * width / math.tan(math.radians(hfov_deg) / 2.0)
        return CameraIntrinsics(width=width, height=height, fx=f, fy=f)

    def pixel_to_normalized(self, uv: torch.Tensor) -> torch.Tensor:
        """Pixel coords (..., 2) [u, v] -> normalized image-plane coords
        (..., 2) [(u - cx) / fx, (v - cy) / fy]."""
        return torch.stack([(uv[..., 0] - self.cx) / self.fx,
                            (uv[..., 1] - self.cy) / self.fy], dim=-1)

    def normalized_to_pixel(self, xy: torch.Tensor) -> torch.Tensor:
        """Inverse of :meth:`pixel_to_normalized`."""
        return torch.stack([xy[..., 0] * self.fx + self.cx,
                            xy[..., 1] * self.fy + self.cy], dim=-1)

    def ray_directions(self, device="cuda") -> torch.Tensor:
        """(H, W, 3) f32 unnormalized ray directions in the OPTICAL frame
        (x right, y down, z forward), one per pixel centre."""
        x = (torch.arange(self.width, dtype=torch.float32, device=device) + 0.5 - self.cx) / self.fx
        y = (torch.arange(self.height, dtype=torch.float32, device=device) + 0.5 - self.cy) / self.fy
        yy, xx = torch.meshgrid(y, x, indexing="ij")
        return torch.stack([xx, yy, torch.ones_like(xx)], dim=-1)
