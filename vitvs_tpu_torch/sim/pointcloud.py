"""Organized XYZRGB point clouds from depth (``vitvs_tpu/sim/pointcloud.py``),
the reference plugin's ``FillPointCloudHelper`` as one vectorized
backprojection (its per-pixel ``depth * tan(atan2(i - c, fl))`` is
``depth * (i - c) / fl``).

As the plugin: one focal length ``fl = W / (2 tan(hfov / 2))`` for both axes,
the principal point at ``(N - 1) / 2`` on each axis (pixel indices, not
centres), points with depth outside ``(near, far)`` NaN in xyz with their
colour kept (ROS ``is_dense=false``); the cloud is (..., H, W, 6): xyz in
metres in the optical frame (x right, y down, z forward), then rgb.
"""

from __future__ import annotations

import math

import torch

# the plugin's pointCloudCutOff_ / pointCloudCutOffMax_ defaults: the visible range
DEFAULT_CUTOFF_M = 0.5
DEFAULT_CUTOFF_MAX_M = 5.0


def organized_point_cloud(depth_m: torch.Tensor, rgb: torch.Tensor | None = None,
                          hfov_deg: float = 65.0, near_m: float = DEFAULT_CUTOFF_M,
                          far_m: float = DEFAULT_CUTOFF_MAX_M) -> torch.Tensor:
    """Depth (..., H, W) metres [+ rgb (..., H, W, 3)] -> the organized cloud
    (..., H, W, 6) f32 on depth's device.  rgb None gives zero colours (the
    plugin's "no image" branch); a mono image (..., H, W) fills all three
    channels (its "mono" branch)."""
    H, W = depth_m.shape[-2:]
    dev = depth_m.device
    fl = W / (2.0 * math.tan(math.radians(hfov_deg) / 2.0))
    i = torch.arange(W, dtype=torch.float32, device=dev) - 0.5 * (W - 1)
    j = torch.arange(H, dtype=torch.float32, device=dev) - 0.5 * (H - 1)
    d = depth_m.float()
    x = d * (i / fl)
    y = d * (j / fl)[:, None]
    bad = ~((d > near_m) & (d < far_m))
    nan = torch.full_like(d, math.nan)
    xyz = torch.stack([torch.where(bad, nan, x), torch.where(bad, nan, y),
                       torch.where(bad, nan, d)], dim=-1)
    if rgb is None:
        color = torch.zeros(d.shape + (3,), dtype=torch.float32, device=dev)
    elif rgb.shape == depth_m.shape:
        color = rgb.float()[..., None].expand(d.shape + (3,))
    else:
        color = rgb.float()
    return torch.cat([xyz, color.to(dev)], dim=-1)
