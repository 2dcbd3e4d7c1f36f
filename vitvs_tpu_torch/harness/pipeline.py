"""The per-frame servo step, from camera frame to body twist
(``vitvs_tpu/harness/pipeline.py``), as eager PyTorch on one device.

Behaviour kept from the JAX package:
* goal descriptors are computed once per episode (``goal_descriptors``);
* with fewer than 4 valid matches (feature failure) the previous velocity
  command is kept and the EMA is frozen;
* invalid pairs are masked out of the solve, or, with
  ``VSConfig.reference_pad_bug``, fed as phantom (0, 0) pixels;
* the step is branch-free: nothing waits for the device mid-step.

Pair sampling takes (t,) ``scores``; when none are given they are drawn with
``torch.rand`` on the model's device from the caller's ``generator`` (JAX
draws them with ``jax.random.uniform``, which torch cannot reproduce).

The int8 W8A8 serving step (``ServoModel.quantized``) runs a ``QuantViT``
(``models/quant.py``, made by :func:`quantized_vit`), quantizes the binned
descriptors at the source (``fused_bin_quant``, ``match/binned.py``) and
matches them with an int8 matmul; ``use_kernels`` then selects the
attention kernels or their plain versions, and never a matcher kernel.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from vitvs_tpu_torch.control.ibvs import (EmaState, body_twist_from_optical,
                                          depth_at_points, ema_update, ibvs_velocity)
from vitvs_tpu_torch.core import image as image_ops
from vitvs_tpu_torch.core.camera import CameraIntrinsics
from vitvs_tpu_torch.io_bridge.config import VSConfig
from vitvs_tpu_torch.match.binned import quantize_binned_int8
from vitvs_tpu_torch.match.correspondence import (find_correspondences,
                                                  match_points_to_pixels,
                                                  refine_matches_subpixel)
from vitvs_tpu_torch.models.extractor import extract_descriptors
from vitvs_tpu_torch.models.quant import QuantViT, quantize_vit_params
from vitvs_tpu_torch.models.vit import ViT, ViTConfig, make_config


@dataclasses.dataclass(frozen=True)
class ServoModel:
    """Static bundle: ViT architecture + servo config + run settings.  The
    weights travel separately as a :class:`ViT` module.

    Creating one sets full-f32 matmuls on the card (no TF32), the
    ``precision='highest'`` semantics of the preprocess resize."""

    vit: ViTConfig
    cfg: VSConfig
    compute_dtype: torch.dtype = torch.bfloat16
    # attention and matching launch the CUDA kernels on the card; False runs
    # their plain versions (the reference pass of chip_smoke.py)
    use_kernels: bool = True
    # the reference's flag: float matching in the TPU matcher kernel's
    # arithmetic (rows cast to f32, then normalized) instead of the
    # reference's default (rows normalized in their dtype, product with f32
    # accumulation); ops/matcher.py's f32 and bf16 modes
    use_match_kernel: bool = False
    device: str = "cuda"
    # int8 W8A8 serving path (the ViT must be a QuantViT, from quantized_vit)
    quantized: bool = False
    # int8 serving only: quantize the binned descriptors at the source
    # (match/binned.quantize_binned_int8); they travel as QuantizedBinned
    fused_bin_quant: bool = True

    def __post_init__(self):
        image_ops.set_f32_matmul_precision()

    @property
    def source_quantized_bins(self) -> bool:
        return self.quantized and self.binned and self.fused_bin_quant

    @staticmethod
    def create(cfg: VSConfig, compute_dtype: torch.dtype | None = None,
               gelu_approx: bool = True, use_kernels: bool = True,
               device: str = "cuda", quantized: bool = False,
               fused_bin_quant: bool = True, attn_impl: str = "xla",
               quant_attn: str = "none") -> "ServoModel":
        """gelu_approx=True is the production default (tanh GELU); pass
        False for strict torch-parity numerics.  compute_dtype defaults to
        cfg.compute_dtype (bfloat16).  attn_impl and quant_attn go to the
        ViTConfig (quant_attn matters only with quantized=True)."""
        if cfg.attn_score != "softmax" or cfg.kv_pool != 1:
            raise NotImplementedError("attn_score and kv_pool are not ported "
                                      "(ROADMAP.md queue 1, item 3)")
        if compute_dtype is None:
            compute_dtype = getattr(torch, cfg.compute_dtype)
        vit = dataclasses.replace(make_config(cfg.model_name, cfg.stride),
                                  gelu_approx=gelu_approx, attn_impl=attn_impl,
                                  quant_attn=quant_attn)
        return ServoModel(vit=vit, cfg=cfg, compute_dtype=compute_dtype,
                          use_kernels=use_kernels, device=device, quantized=quantized,
                          fused_bin_quant=fused_bin_quant)

    def load_vit(self, state_dict: dict[str, torch.Tensor]) -> ViT:
        """A ViT with these weights, blocks in the compute dtype, on the device."""
        net = ViT(self.vit)
        net.load_state_dict(state_dict)
        return net.cast_blocks(self.compute_dtype).to(self.device).eval()

    @property
    def binned(self) -> bool:
        return self.cfg.use_feature_binning

    def desc_dim(self) -> int:
        return self.vit.embed_dim * (9 if self.binned else 1)

    @property
    def camera(self) -> CameraIntrinsics:
        c = self.cfg
        return CameraIntrinsics(width=c.u_max, height=c.v_max, fx=c.f_x, fy=c.f_y)

    @property
    def mean(self):
        return image_ops.IMAGENET_MEAN if "dino" in self.cfg.model_name else image_ops.HALF_MEAN

    @property
    def std(self):
        return image_ops.IMAGENET_STD if "dino" in self.cfg.model_name else image_ops.HALF_STD

    def grid(self) -> tuple[int, int]:
        return self.vit.num_patches(self.cfg.dino_input_size, self.cfg.dino_input_size)


class StepResult(NamedTuple):
    v_c: torch.Tensor          # (6,) smoothed optical-frame velocity
    body_twist: torch.Tensor   # (6,) clipped body-frame command
    ema: EmaState
    feature_ok: torch.Tensor   # () bool, >= 4 valid correspondences
    num_valid: torch.Tensor    # () int32
    mean_sim: torch.Tensor     # () mean similarity of the selected matches
    s_uv: torch.Tensor         # (k, 2) current-image pixel features
    s_uv_star: torch.Tensor    # (k, 2) goal-image pixel features
    valid: torch.Tensor        # (k,) bool


def _on_device(model: ServoModel, x) -> torch.Tensor:
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return x.to(model.device)


def _check_net(net: ViT | QuantViT, model: ServoModel) -> None:
    want = QuantViT if model.quantized else ViT
    if not isinstance(net, want):
        raise TypeError(f"a {'quantized' if model.quantized else 'float'} model runs a "
                        f"{want.__name__}, got {type(net).__name__}")
    if net.cfg != model.vit:
        raise ValueError("the ViT was built for another ViTConfig than the model's")
    if net.compute_dtype != model.compute_dtype:
        raise ValueError(f"ViT blocks are {net.compute_dtype}, the model computes "
                         f"in {model.compute_dtype} (ViT.cast_blocks)")


def preprocess(model: ServoModel, rgb) -> torch.Tensor:
    """Camera frame (H, W, 3) -> normalized ViT input (S, S, 3) f32."""
    return image_ops.preprocess_frame(_on_device(model, rgb), model.cfg.dino_input_size,
                                      model.mean, model.std, method="bicubic",
                                      antialias=True)


@torch.no_grad()
def quantized_vit(net: ViT, model: ServoModel, calib_rgb=None,
                  smooth_alpha: float = 0.5) -> QuantViT:
    """The int8 serving ViT of a float ``net``: dynamic activation scales,
    or, given calibration frames (N, H, W, 3) (the goal view and a few start
    views, as ``vitvs_tpu/harness/benchmark.py`` takes them), static scales
    calibrated on their preprocessed images with the SmoothQuant fold."""
    calib = None
    if calib_rgb is not None:
        calib = torch.stack([preprocess(model, f) for f in calib_rgb])
    return quantize_vit_params(net, model.vit, calib, layer=model.cfg.layer,
                               smooth_alpha=smooth_alpha, compute_dtype=model.compute_dtype)


def _descriptors(net: ViT | QuantViT, model: ServoModel, rgb):
    """One frame (H, W, 3) -> (t, d) (a ``QuantizedBinned`` on the
    source-quantized int8 path), or float descriptors of a batch of frames
    (A, H, W, 3) -> (A, t, d) from one forward."""
    _check_net(net, model)
    x = preprocess(model, rgb)
    batched = x.ndim == 4
    src_q = model.source_quantized_bins
    if batched and src_q:
        raise NotImplementedError("batched source-quantized descriptors are not ported "
                                  "(ROADMAP.md queue 1, item 3)")
    desc = extract_descriptors(net, x if batched else x[None], layer=model.cfg.layer,
                               facet=model.cfg.facet, bin=model.binned and not src_q,
                               use_kernels=model.use_kernels, quantized=model.quantized)[:, 0]
    if batched:
        return desc
    return quantize_binned_int8(desc[0], model.grid()) if src_q else desc[0]


@torch.inference_mode()
def goal_descriptors(net: ViT | QuantViT, model: ServoModel, goal_rgb):
    """Per-episode goal descriptor precompute -> (t, d), or a
    ``QuantizedBinned`` on the source-quantized int8 serving path."""
    return _descriptors(net, model, goal_rgb)


@torch.inference_mode()
def batch_descriptors(net: ViT, model: ServoModel, frames) -> torch.Tensor:
    """Float descriptors (A, t, d) of A camera frames (A, H, W, 3), one
    batched ViT forward (the rotation search's four views)."""
    return _descriptors(net, model, frames)


@torch.inference_mode()
def servo_step(
    net: ViT | QuantViT,
    model: ServoModel,
    goal_desc,
    frame_rgb,
    frame_depth_m,
    ema: EmaState,
    prev_v_c: torch.Tensor,
    scores: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
    num_pairs: int | None = None,
) -> StepResult:
    """One servo iteration.

    frame_rgb: (H, W, 3) uint8 or float [0, 1]; frame_depth_m: (H, W)
    z-depth in meters (0 = no return); arrays or tensors.  scores: (t,)
    pair-sampling scores, drawn on the model's device from ``generator``
    (a generator of that device) when None.
    """
    cfg = model.cfg
    k = num_pairs or cfg.num_pairs
    grid = model.grid()
    cur_desc = _descriptors(net, model, frame_rgb)
    if scores is None:
        scores = torch.rand(grid[0] * grid[1], generator=generator, device=model.device)
    # int8 serving matches with an int8 matmul, never a matcher kernel
    match = find_correspondences(goal_desc, cur_desc, grid, k, scores.to(model.device),
                                 distance_threshold=cfg.thresh_filter_keypoints,
                                 use_kernel=model.use_kernels and not model.quantized,
                                 int8=model.quantized, use_match_kernel=model.use_match_kernel)
    if cfg.subpixel_matching:
        match = refine_matches_subpixel(goal_desc, cur_desc, match, grid)

    round_px = not cfg.subpixel_matching
    size_uv = (cfg.u_max, cfg.v_max)
    s_uv_star = match_points_to_pixels(match.points1, grid[0], cfg.dino_input_size,
                                       size_uv, round_px=round_px)
    s_uv = match_points_to_pixels(match.points2, grid[0], cfg.dino_input_size,
                                  size_uv, round_px=round_px)

    feature_ok = match.num_valid >= 4
    cam = model.camera
    if cfg.reference_pad_bug:
        keep = match.valid[:, None]
        s_uv_eff = torch.where(keep, s_uv, torch.zeros_like(s_uv))
        s_uv_star_eff = torch.where(keep, s_uv_star, torch.zeros_like(s_uv_star))
        valid_for_solve = None
    else:
        s_uv_eff, s_uv_star_eff = s_uv, s_uv_star
        valid_for_solve = match.valid

    depth = _on_device(model, frame_depth_m).float()
    v_raw = ibvs_velocity(cam.pixel_to_normalized(s_uv_eff),
                          cam.pixel_to_normalized(s_uv_star_eff),
                          depth_at_points(depth, s_uv_eff), cfg.lambda_,
                          valid=valid_for_solve, mode=cfg.pinv_mode,
                          damping=cfg.pinv_damping)

    ema_new, v_smoothed = ema_update(ema, v_raw, cfg.ema_alpha)
    v_c = torch.where(feature_ok, v_smoothed, prev_v_c)
    ema_out = EmaState(
        value=torch.where(feature_ok, ema_new.value, ema.value),
        initialized=torch.where(feature_ok, ema_new.initialized, ema.initialized),
    )
    sim_sum = torch.where(match.valid, match.sim, torch.zeros_like(match.sim)).sum()
    mean_sim = sim_sum / torch.clamp(match.num_valid, min=1)
    return StepResult(
        v_c=v_c,
        body_twist=body_twist_from_optical(v_c, cfg.max_velocity),
        ema=ema_out,
        feature_ok=feature_ok,
        num_valid=match.num_valid,
        mean_sim=torch.where(match.num_valid > 0, mean_sim, torch.full_like(mean_sim, -torch.inf)),
        s_uv=s_uv,
        s_uv_star=s_uv_star,
        valid=match.valid,
    )
