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


def reproject_via_plane(cam: CameraIntrinsics, uv_a, pos_a: torch.Tensor, quat_a: torch.Tensor,
                        pos_b: torch.Tensor, quat_b: torch.Tensor, plane_z):
    """Ground-truth pixel correspondence view A -> view B through the world
    plane z = ``plane_z`` (the poster): pixels ``uv_a`` (t, 2) of camera A
    (body pose ``pos_a`` (..., 3), ``quat_a`` (..., 4)) are back-projected,
    intersected with the plane and projected into camera B.

    Returns ``(uv_b, world, t_hit, z_b)``, each with the poses' leading
    dims before the pixels': pixel coords in B, the plane hit points, the
    ray parameter in A (<= 0: the plane is behind A) and the depth along
    B's optical axis (<= 0: behind B)."""
    from vitvs_tpu_torch.core import se3

    uv_a = torch.as_tensor(uv_a, dtype=torch.float32, device=pos_a.device)
    xy = cam.pixel_to_normalized(uv_a)
    d_c = torch.cat([xy, torch.ones_like(xy[..., :1])], -1)
    r_wa = se3.matrix_from_quat(quat_a) @ se3.body_from_optical(quat_a)
    d_w = d_c @ r_wa.mT                                          # (..., t, 3)
    dz = d_w[..., 2]
    t_hit = ((plane_z - pos_a[..., 2, None])
             / torch.where(dz.abs() < 1e-9, torch.full_like(dz, 1e-9), dz))
    world = pos_a[..., None, :] + t_hit[..., None] * d_w
    r_wb = se3.matrix_from_quat(quat_b) @ se3.body_from_optical(quat_b)
    p_c = (world - pos_b[..., None, :]) @ r_wb
    z_b = p_c[..., 2]
    uv_b = cam.normalized_to_pixel(p_c[..., :2] / torch.clamp(z_b, min=1e-9)[..., None])
    return uv_b, world, t_hit, z_b
