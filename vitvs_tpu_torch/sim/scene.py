"""Textured-plane camera simulator, the Gazebo stand-in
(``vitvs_tpu/sim/scene.py``).

The reference's scene is a textured poster lying on the ground plane,
observed by a simulated RealSense giving 640x480 RGB and depth at HFOV
65 deg.  A pinhole render of the plane with analytic depth reproduces that
observation as tensor arithmetic on the episode's device.

Conventions: world z-up, the plane at z = plane_z; the camera body has +x
forward (the optical axis), mapped to the optical frame by
``se3.R_BODY_FROM_OPTICAL``.  At the goal pose (position (0, 0, 0.61), quat
(0, 0.7071068, 0, 0.7071068)) the camera looks straight down with
image-right = -y_world and image-down = -x_world, and the texture is mapped
so that the poster renders upright there.
"""

from __future__ import annotations

import functools
import os
from typing import NamedTuple

import numpy as np
import torch

from vitvs_tpu_torch.core import se3
from vitvs_tpu_torch.core.camera import CameraIntrinsics
from vitvs_tpu_torch.core.image import bilinear_packed, pack_quad

# the emulated RealSense's depth range: outside it the sensor gives 0 ("no return")
DEPTH_MIN_RANGE_M = 0.1
DEPTH_MAX_RANGE_M = 10.0

# the reference's benchmark scene: the viso poster texture (1500 x 1125) on its
# 0.8 x 0.6 m mesh, top face at z = 0.01, the long side along world y
POSTER_ASSET = os.path.join(os.path.dirname(os.path.dirname(__file__)), "assets",
                            "poster_resized.npz")
POSTER_HALF_SIZE = (0.3, 0.4)   # (world-x, world-y) meters
POSTER_PLANE_Z = 0.01


class Scene(NamedTuple):
    texture: torch.Tensor      # (Ht, Wt, 3) f32 in [0, 1]
    quad: torch.Tensor         # (Ht * Wt, 12): pack_quad(texture)
    half_size: torch.Tensor    # (2,) half-extents in meters: (world-x = texture
    #                            rows / image-down, world-y = texture cols /
    #                            image-right at the goal view)
    plane_z: torch.Tensor      # () poster plane height
    background: torch.Tensor   # (3,) colour outside the poster

    @staticmethod
    def create(texture, half_size=0.42, plane_z: float = 0.005,
               background=(0.5, 0.5, 0.5), device="cuda") -> "Scene":
        """``texture``: an (Ht, Wt, 3) array in [0, 1]; ``half_size``: a scalar
        (square poster) or an (hs_x, hs_y) pair."""
        tex = torch.from_numpy(np.asarray(texture, np.float32)).to(device)
        hs = torch.as_tensor(half_size, dtype=torch.float32).to(device)
        if hs.ndim == 0:
            hs = torch.stack([hs, hs])
        return Scene(tex, pack_quad(tex), hs,
                     torch.tensor(plane_z, dtype=torch.float32, device=device),
                     torch.tensor(background, dtype=torch.float32, device=device))

    def with_texture(self, texture: torch.Tensor) -> "Scene":
        """The same geometry with another texture of the same size."""
        return self._replace(texture=texture, quad=pack_quad(texture))


def load_poster_scene(path: str | None = None, device="cuda") -> Scene:
    """The reference's benchmark scene: its poster texture on the real mesh
    geometry.  ``path`` overrides the packaged copy of the texture."""
    from vitvs_tpu_torch.io_bridge.images import load_image

    return Scene.create(load_image(path or POSTER_ASSET), half_size=POSTER_HALF_SIZE,
                        plane_z=POSTER_PLANE_Z, device=device)


def make_synthetic_poster(size: int = 512, seed: int = 0,
                          octaves: tuple[int, int] = (2, 7)) -> np.ndarray:
    """Synthetic poster (multi-scale value noise + fiducial squares), f32
    (size, size, 3) in [0, 1]; ``octaves=(lo, hi)`` gives noise scales
    2^lo .. 2^(hi-1)."""
    rng = np.random.default_rng(seed)
    img = np.zeros((size, size, 3), np.float32)
    for octave in range(*octaves):
        n = 2 ** octave
        coarse = rng.random((n, n, 3)).astype(np.float32)
        reps = size // n
        up = np.kron(coarse, np.ones((reps, reps, 1), np.float32))
        img += up / (octaves[1] - octave)
    img /= img.max()
    qs = size // 8
    for (r, c), color in [((0, 0), (1, 0, 0)), ((0, 7), (0, 1, 0)),
                          ((7, 0), (0, 0, 1)), ((7, 7), (1, 1, 0)),
                          ((3, 3), (1, 0, 1)), ((4, 5), (0, 1, 1))]:
        img[r * qs:(r + 1) * qs, c * qs:(c + 1) * qs] = color
    return np.clip(img, 0, 1)


@functools.lru_cache(maxsize=8)
def _rays(cam: CameraIntrinsics, device: torch.device) -> torch.Tensor:
    return cam.ray_directions(device)


def render(scene: Scene, cam: CameraIntrinsics, position: torch.Tensor, quat: torch.Tensor,
           quantize_depth_mm: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """(rgb (H, W, 3) f32 in [0, 1], depth (H, W) meters) from a camera pose.

    Depth is z-depth along the optical axis, rounded to millimeters by
    default (the uint16-mm depth images of the reference's sensor plugin);
    rays missing the plane, or hitting it outside the sensor's [0.1, 10] m
    range, get depth 0 ("no return")."""
    d_c = _rays(cam, scene.texture.device)                   # (H, W, 3) optical frame
    r_wb = se3.matrix_from_quat(quat)
    r_wc = r_wb @ se3.body_from_optical(r_wb)
    d_w = d_c @ r_wc.T                                       # (H, W, 3) world
    denom = d_w[..., 2]
    t = (scene.plane_z - position[2]) / torch.where(denom.abs() < 1e-9,
                                                    torch.full_like(denom, 1e-9), denom)
    hit = t > 1e-6                                           # plane in front of the camera
    pt = position + t[..., None] * d_w                       # (H, W, 3) world points

    ht, wt, _ = scene.texture.shape
    hs_x, hs_y = scene.half_size[0], scene.half_size[1]
    # poster upright in the goal view: image-right = -y, image-down = -x
    cols = (hs_y - pt[..., 1]) / (2 * hs_y) * (wt - 1)
    rows = (hs_x - pt[..., 0]) / (2 * hs_x) * (ht - 1)
    on_poster = hit & (pt[..., 0].abs() <= hs_x) & (pt[..., 1].abs() <= hs_y)
    rgb = bilinear_packed(scene.quad, (ht, wt), rows, cols)
    rgb = torch.where(on_poster[..., None], rgb, scene.background)

    in_range = (t >= DEPTH_MIN_RANGE_M) & (t <= DEPTH_MAX_RANGE_M)
    depth = torch.where(hit & in_range, t, torch.zeros_like(t))
    if quantize_depth_mm:
        # times the reciprocal: XLA computes the JAX package's division by the
        # constant 1000 so, and the depths then agree bit for bit
        depth = torch.round(depth * 1000.0) * (1.0 / 1000.0)
    return rgb, depth
