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

``servo_step`` also takes a chunk of B episodes' frames (B, H, W, 3), the
reference's vmapped step written out as a batch dimension: one ViT forward
over the B frames, one matcher launch against the shared goal, one batched
solve, every reduction per episode.  One frame is the chunk of one.

The int8 W8A8 serving step (``ServoModel.quantized``) runs a ``QuantViT``
(``models/quant.py``, made by :func:`quantized_vit`), quantizes the binned
descriptors at the source (``fused_bin_quant``, ``match/binned.py``) and
matches them with an int8 matmul, a chunk of B frames in one product;
``use_kernels`` then selects the attention kernels or their plain versions,
and never a matcher kernel.

``ServoModel.fast_binned_match`` takes the binned similarity from the
unbinned descriptors (``match/binned.binned_cosine_similarity``: one product
a frame or a chunk, then 9 shifted sums), float or int8; the match reduces
it with plain max / argmax and the refinement fits on it, and no matcher
kernel runs (the reference reduces it in XLA).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from vitvs_tpu_torch.control.ibvs import (EmaState, body_twist_from_optical,
                                          depth_at_points, ema_update, ibvs_velocity)
from vitvs_tpu_torch.core import image as image_ops
from vitvs_tpu_torch.core.batch import item
from vitvs_tpu_torch.core.camera import CameraIntrinsics
from vitvs_tpu_torch.io_bridge.config import VSConfig
from vitvs_tpu_torch.match.binned import binned_cosine_similarity, quantize_binned_int8
from vitvs_tpu_torch.match.correspondence import (MatchResult, find_correspondences,
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
    ``precision='highest'`` semantics of the preprocess resize;
    ``pp_precision='default'`` allows TF32 for the resize's two products
    alone."""

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
    # matmul precision of the preprocess resize (core/image.resize):
    # 'highest' the f32 parity default, 'default' one TF32 pass on the card
    pp_precision: str = "highest"
    # factorized binned matching (match/binned.py): the binned similarity
    # from the UNBINNED descriptors by the shift identity, 9x fewer matmul
    # FLOPs and no 9d descriptor tensors (equal up to float association)
    fast_binned_match: bool = False

    def __post_init__(self):
        image_ops.set_f32_matmul_precision()

    @property
    def source_quantized_bins(self) -> bool:
        return self.quantized and self.materialize_bins and self.fused_bin_quant

    @staticmethod
    def create(cfg: VSConfig, compute_dtype: torch.dtype | None = None,
               gelu_approx: bool = True, use_kernels: bool = True,
               device: str = "cuda", quantized: bool = False,
               fused_bin_quant: bool = True, attn_impl: str = "xla",
               quant_attn: str = "none") -> "ServoModel":
        """gelu_approx=True is the production default (tanh GELU); pass
        False for strict torch-parity numerics.  compute_dtype defaults to
        cfg.compute_dtype (bfloat16).  attn_impl and quant_attn go to the
        ViTConfig (quant_attn matters only with quantized=True), and so do
        cfg's attn_score, kv_pool, kv_pool_impl and kv_pool_where."""
        if compute_dtype is None:
            compute_dtype = getattr(torch, cfg.compute_dtype)
        vit = dataclasses.replace(make_config(cfg.model_name, cfg.stride),
                                  gelu_approx=gelu_approx, attn_impl=attn_impl,
                                  quant_attn=quant_attn, attn_score=cfg.attn_score,
                                  kv_pool=cfg.kv_pool,
                                  kv_pool_impl=cfg.kv_pool_impl,
                                  kv_pool_where=cfg.kv_pool_where)
        return ServoModel(vit=vit, cfg=cfg, compute_dtype=compute_dtype,
                          use_kernels=use_kernels, device=device, quantized=quantized,
                          fused_bin_quant=fused_bin_quant)

    def load_vit(self, state_dict: dict[str, torch.Tensor]) -> ViT:
        """A ViT with these weights, blocks in the compute dtype, on the device."""
        net = ViT.from_state_dict(self.vit, state_dict)
        return net.cast_blocks(self.compute_dtype).to(self.device).eval()

    @property
    def binned(self) -> bool:
        return self.cfg.use_feature_binning

    @property
    def materialize_bins(self) -> bool:
        """The descriptors themselves are binned (not the factorized path)."""
        return self.binned and not self.fast_binned_match

    def desc_dim(self) -> int:
        return self.vit.embed_dim * (9 if self.materialize_bins else 1)

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
    """One step's result; a chunk's has a leading B on every field."""

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
                                      antialias=True, precision=model.pp_precision)


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
    """One frame (H, W, 3) -> (t, d), or a batch of frames (A, H, W, 3) ->
    (A, t, d) from one forward; on the source-quantized int8 path a
    ``QuantizedBinned`` of (t, 9D) or (A, t, 9D)."""
    _check_net(net, model)
    x = preprocess(model, rgb)
    batched = x.ndim == 4
    src_q = model.source_quantized_bins
    desc = extract_descriptors(net, x if batched else x[None], layer=model.cfg.layer,
                               facet=model.cfg.facet, bin=model.materialize_bins and not src_q,
                               use_kernels=model.use_kernels, quantized=model.quantized)[:, 0]
    if src_q:
        desc = quantize_binned_int8(desc, model.grid())
    return desc if batched else item(desc, 0)


@torch.inference_mode()
def goal_descriptors(net: ViT | QuantViT, model: ServoModel, goal_rgb):
    """Per-episode goal descriptor precompute -> (t, d), or a
    ``QuantizedBinned`` on the source-quantized int8 serving path."""
    return _descriptors(net, model, goal_rgb)


@torch.inference_mode()
def batch_descriptors(net: ViT | QuantViT, model: ServoModel, frames):
    """Descriptors (A, t, d) of A camera frames (A, H, W, 3), one batched
    ViT forward (the rotation search's views); a ``QuantizedBinned`` on the
    source-quantized int8 path."""
    return _descriptors(net, model, frames)


def match_frames(model: ServoModel, goal_desc, cur_desc, num_pairs: int, scores: torch.Tensor,
                 distance_threshold: float = 1.0
                 ) -> tuple[MatchResult, torch.Tensor | None]:
    """The goal's descriptors against one frame's (t, d) or a chunk's
    (B, t, d) on the model's matching path: the matcher kernel (float) or
    one int8 product, or under ``fast_binned_match`` the factorized binned
    similarity (float or int8), reduced without a kernel.  Returns the match
    and that similarity (None off the factorized path)."""
    sim = None
    if model.binned and model.fast_binned_match:
        sim = binned_cosine_similarity(goal_desc, cur_desc, model.grid(), int8=model.quantized)
    match = find_correspondences(goal_desc, cur_desc, model.grid(), num_pairs, scores,
                                 distance_threshold=distance_threshold,
                                 use_kernel=model.use_kernels and not model.quantized and sim is None,
                                 int8=model.quantized, use_match_kernel=model.use_match_kernel,
                                 sim_matrix=sim)
    return match, sim


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
    """One servo iteration, of one episode or of a chunk of B.

    frame_rgb: (H, W, 3), or (B, H, W, 3), uint8 or float [0, 1];
    frame_depth_m: (H, W) or (B, H, W) z-depth in meters (0 = no return);
    arrays or tensors.  ema, prev_v_c: one episode's, or with a leading B.
    scores: (t,) or (B, t) pair-sampling scores, drawn on the model's
    device from ``generator`` (a generator of that device) when None.  One
    frame runs as the chunk of one and its result has no batch axis.
    """
    rgb = _on_device(model, frame_rgb)
    single = rgb.dim() == 3
    if single:
        step = servo_step(net, model, goal_desc, rgb[None], _on_device(model, frame_depth_m)[None],
                          item(ema, None), prev_v_c[None],
                          None if scores is None else scores[None], generator, num_pairs)
        return item(step, 0)
    cfg = model.cfg
    k = num_pairs or cfg.num_pairs
    grid = model.grid()
    nb = rgb.shape[0]
    cur_desc = _descriptors(net, model, rgb)                               # (B, t, d)
    if scores is None:
        scores = torch.rand((nb, grid[0] * grid[1]), generator=generator, device=model.device)
    scores = scores.to(model.device)
    match, sim = match_frames(model, goal_desc, cur_desc, k, scores,
                              distance_threshold=cfg.thresh_filter_keypoints)
    if cfg.subpixel_matching:
        match = refine_matches_subpixel(goal_desc, cur_desc, match, grid, sim_matrix=sim)

    round_px = not cfg.subpixel_matching
    size_uv = (cfg.u_max, cfg.v_max)
    s_uv_star = match_points_to_pixels(match.points1, grid[0], cfg.dino_input_size,
                                       size_uv, round_px=round_px)
    s_uv = match_points_to_pixels(match.points2, grid[0], cfg.dino_input_size,
                                  size_uv, round_px=round_px)

    feature_ok = match.num_valid >= 4                                      # (B,)
    cam = model.camera
    if cfg.reference_pad_bug:
        keep = match.valid[..., None]
        s_uv_eff = torch.where(keep, s_uv, torch.zeros_like(s_uv))
        s_uv_star_eff = torch.where(keep, s_uv_star, torch.zeros_like(s_uv_star))
        valid_for_solve = None
    else:
        s_uv_eff, s_uv_star_eff = s_uv, s_uv_star
        valid_for_solve = match.valid

    depth = _on_device(model, frame_depth_m).float()
    if depth.shape[0] != nb:
        raise ValueError(f"{nb} frames take {nb} depth maps, got {tuple(depth.shape)}")
    v_raw = ibvs_velocity(cam.pixel_to_normalized(s_uv_eff),
                          cam.pixel_to_normalized(s_uv_star_eff),
                          depth_at_points(depth, s_uv_eff), cfg.lambda_,
                          valid=valid_for_solve, mode=cfg.pinv_mode,
                          damping=cfg.pinv_damping)

    ema_new, v_smoothed = ema_update(ema, v_raw, cfg.ema_alpha)
    ok = feature_ok[:, None]
    v_c = torch.where(ok, v_smoothed, prev_v_c)
    ema_out = EmaState(
        value=torch.where(ok, ema_new.value, ema.value),
        initialized=torch.where(feature_ok, ema_new.initialized, ema.initialized),
    )
    sim_sum = torch.where(match.valid, match.sim, torch.zeros_like(match.sim)).sum(-1)
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
