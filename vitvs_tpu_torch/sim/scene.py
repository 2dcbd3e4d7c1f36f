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
    """One textured poster, or a chunk's B textures of one geometry
    (``texture`` (B, Ht, Wt, 3), ``quad`` (B, Ht * Wt, 12)): then render
    draws episode b's views, poses (B, ...), on texture b."""

    texture: torch.Tensor      # (Ht, Wt, 3) f32 in [0, 1], or (B, Ht, Wt, 3)
    quad: torch.Tensor         # (Ht * Wt, 12): pack_quad(texture), or (B, Ht * Wt, 12)
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
        """The same geometry with another texture of the same size, or with
        a stack of B of them (B, Ht, Wt, 3): a chunk's perturbed textures."""
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
    """(rgb (..., H, W, 3) f32 in [0, 1], depth (..., H, W) meters) from
    camera poses (position (..., 3), quat (..., 4)), one view per pose.  A
    scene of B textures takes poses (B, ...): episode b's on texture b, all
    in one gather.

    Depth is z-depth along the optical axis, rounded to millimeters by
    default (the uint16-mm depth images of the reference's sensor plugin);
    rays missing the plane, or hitting it outside the sensor's [0.1, 10] m
    range, get depth 0 ("no return")."""
    d_c = _rays(cam, scene.texture.device)                   # (H, W, 3) optical frame
    r_wb = se3.matrix_from_quat(quat)
    r_wc = r_wb @ se3.body_from_optical(r_wb)                # (..., 3, 3)
    d_w = d_c @ r_wc.mT.unsqueeze(-3)                        # (..., H, W, 3) world
    denom = d_w[..., 2]
    t = ((scene.plane_z - position[..., 2, None, None])
         / torch.where(denom.abs() < 1e-9, torch.full_like(denom, 1e-9), denom))
    hit = t > 1e-6                                           # plane in front of the camera
    pt = position[..., None, None, :] + t[..., None] * d_w   # (..., H, W, 3) world points

    ht, wt = scene.texture.shape[-3:-1]
    hs_x, hs_y = scene.half_size[0], scene.half_size[1]
    # poster upright in the goal view: image-right = -y, image-down = -x
    cols = (hs_y - pt[..., 1]) / (2 * hs_y) * (wt - 1)
    rows = (hs_x - pt[..., 0]) / (2 * hs_x) * (ht - 1)
    on_poster = hit & (pt[..., 0].abs() <= hs_x) & (pt[..., 1].abs() <= hs_y)
    quad, offset = scene.quad, 0
    if quad.ndim == 3:                                       # texture b for episode b
        nb = quad.shape[0]
        if rows.shape[0] != nb:
            raise ValueError(f"a scene of {nb} textures renders poses (B = {nb}, ...), "
                             f"got {tuple(position.shape)}")
        offset = (torch.arange(nb, device=quad.device) * (ht * wt)).reshape(
            (nb,) + (1,) * (rows.ndim - 1))
        quad = quad.reshape(-1, quad.shape[-1])
    rgb = bilinear_packed(quad, (ht, wt), rows, cols, offset)
    rgb = torch.where(on_poster[..., None], rgb, scene.background)

    in_range = (t >= DEPTH_MIN_RANGE_M) & (t <= DEPTH_MAX_RANGE_M)
    depth = torch.where(hit & in_range, t, torch.zeros_like(t))
    if quantize_depth_mm:
        # times the reciprocal: XLA computes the JAX package's division by the
        # constant 1000 so, and the depths then agree bit for bit
        depth = torch.round(depth * 1000.0) * (1.0 / 1000.0)
    return rgb, depth


# D435 stereo-IR extrinsics: the left IR sits at the depth frame, the right IR
# 50 mm to its right (body y is image-left, so the offset is negative)
IR1_OFFSET_Y = 0.0
IR2_OFFSET_Y = -0.050
IR_NOISE_STD = 0.05   # the plugin's IR sensors' Gaussian noise

# ITU-R BT.601 luma: how a colourless renderer greys an RGB scene (as f32)
_LUMA = tuple(float(np.float32(c)) for c in (0.299, 0.587, 0.114))


def _luma(rgb: torch.Tensor) -> torch.Tensor:
    """The f32 luma of (..., 3) as XLA's CPU dot of the JAX package computes
    it, fma(b, .114, fma(g, .587, r * .299)): each fused step is one f64
    product and sum (the product exact) rounded to f32."""
    acc = rgb[..., 0] * _LUMA[0]
    for c in (1, 2):
        acc = (rgb[..., c].double() * _LUMA[c] + acc.double()).float()
    return acc


def render_ir(scene: Scene, cam: CameraIntrinsics, position: torch.Tensor, quat: torch.Tensor,
              generator: torch.Generator | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """The two infrared streams (ir1 left, ir2 right), each (..., H, W) in
    [0, 1] at 8-bit levels, of camera poses (..., 3) / (..., 4)
    (``vitvs_tpu/sim/scene.py:render_ir``).

    The emulated RealSense's IR sensors render the same scene in 8-bit grey
    (BT.601 luma of a pinhole render, no depth rounding) from two poses: the
    left IR at the depth frame, the right one 50 mm along body -y, so the
    pair has the stereo disparity f B / Z.  With ``generator`` the sensors'
    Gaussian noise (std 0.05; ir1's draws, then ir2's, on the generator's
    device) is added before the 8-bit quantization; None renders without
    noise."""
    r_wb = se3.matrix_from_quat(quat)
    outs = []
    for off_y in (IR1_OFFSET_Y, IR2_OFFSET_Y):
        pos = position + r_wb[..., :, 1] * off_y
        rgb, _ = render(scene, cam, pos, quat, quantize_depth_mm=False)
        ir = _luma(rgb)
        if generator is not None:
            noise = torch.randn(ir.shape, generator=generator, device=generator.device)
            ir = ir + IR_NOISE_STD * noise.to(ir.device)
        # the L_INT8 wire format: 8-bit levels (times the reciprocal, as XLA
        # computes the JAX package's division by the constant 255)
        outs.append(torch.round(torch.clamp(ir, 0.0, 1.0) * 255.0) * (1.0 / 255.0))
    return outs[0], outs[1]
