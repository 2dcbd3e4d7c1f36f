"""Environment observe / step (``vitvs_tpu/sim/env.py``): the renderer
stands in for the RealSense subscriptions, a pose integrator for the ROS
actuation chain (controller -> /camera_vel -> Gazebo)."""

from __future__ import annotations

import torch

from vitvs_tpu_torch.core import se3
from vitvs_tpu_torch.core.camera import CameraIntrinsics
from vitvs_tpu_torch.sim.scene import Scene, render


def observe(scene: Scene, cam: CameraIntrinsics, position: torch.Tensor, quat: torch.Tensor,
            quantize_depth_mm: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """(rgb [0, 1], depth meters) at camera poses (..., 3) / (..., 4): one
    view per pose (``render``)."""
    return render(scene, cam, position, quat, quantize_depth_mm)


def env_step(position: torch.Tensor, quat: torch.Tensor, body_twist: torch.Tensor,
             dt: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Integrate the clipped body-frame twists (..., 6) of poses (..., 3) /
    (..., 4) over one control period (``VSConfig.control_dt``)."""
    return se3.integrate_body_twist(position, quat, body_twist, dt)
