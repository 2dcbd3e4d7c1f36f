"""Descriptor fine-tuning in the simulator (``vitvs_tpu/train/finetune.py``).

The scene is a textured plane whose geometry is known, so the patch
correspondence between any two camera views has a closed form (patch
centres projected through the plane).  It supervises an InfoNCE objective
over the dense descriptors:

    two views of the scene -> ViT descriptors -> contrastive loss against
    the geometric correspondence -> AdamW update.

The ViT's parameters stay f32; the forward runs its blocks in the model's
compute dtype on casts made inside the autograd graph
(``vit_features(compute_dtype=...)``), with ``use_kernels=False``: the hand
kernels have no backward.  The optimizer is a ``torch.optim.Optimizer`` with
the arithmetic of ``optax.adamw`` (b1 0.9, b2 0.999, eps 1e-8 outside the
square root, decoupled weight decay 1e-4 on every parameter), its learning
rate set by ``LambdaLR`` from the schedule at the update count *before* the
update, as optax evaluates it: a warm-up from 0 makes the first update with
lr 0.

Random draws come from explicit ``torch.Generator``s on the CPU (torch
cannot reproduce ``jax.random``): poses, Bernoulli choices and pair-sampling
scores are drawn there and moved to the model's device; a perturbed
texture is drawn on the device by a generator seeded from the CPU one.
Rendering and the pair draws run without grad; only the ViT forward
carries it.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import numpy as np
import torch

from vitvs_tpu_torch.core import camera as camera_mod
from vitvs_tpu_torch.core import se3
from vitvs_tpu_torch.harness.pipeline import (ServoModel, batch_descriptors, goal_descriptors,
                                              match_frames, preprocess, quantized_vit)
from vitvs_tpu_torch.harness.samplers import (DESIRED_ORIENTATION, DESIRED_POSITION,
                                              REFERENCE_POINT)
from vitvs_tpu_torch.models.extractor import extract_descriptors
from vitvs_tpu_torch.models.quant import QuantViT
from vitvs_tpu_torch.models.vit import ViT
from vitvs_tpu_torch.sim.env import observe
from vitvs_tpu_torch.sim.perturb import perturb_texture
from vitvs_tpu_torch.sim.scene import Scene

# optax.adamw's defaults
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
WEIGHT_DECAY = 1e-4


class TrainState(NamedTuple):
    net: ViT                                          # f32 master weights
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LambdaLR      # lr of update n = schedule(n)
    step: int


# ---------------------------------------------------------------------------
# Optimizer
# ---------------------------------------------------------------------------


def warmup_cosine_decay_schedule(init_value: float, peak_value: float, warmup_steps: int,
                                 decay_steps: int, end_value: float = 0.0
                                 ) -> Callable[[int], float]:
    """``optax.warmup_cosine_decay_schedule`` in closed form: linear from
    ``init_value`` to ``peak_value`` over ``warmup_steps`` updates, then a
    cosine to ``end_value`` at ``decay_steps`` (warm-up included), constant
    after."""
    alpha = end_value / peak_value if peak_value else 0.0
    span = decay_steps - warmup_steps

    def schedule(count: int) -> float:
        if count < warmup_steps:
            return init_value + (peak_value - init_value) * count / warmup_steps
        t = min(count - warmup_steps, span)
        cos = 0.5 * (1.0 + math.cos(math.pi * t / span))
        return peak_value * ((1.0 - alpha) * cos + alpha)

    return schedule


class AdamW(torch.optim.Optimizer):
    """``optax.adamw``'s arithmetic as a torch optimizer, in the parameters'
    dtype (f32): mu = (1 - b1) g + b1 mu, nu = (1 - b2) g^2 + b2 nu, the
    bias corrections 1 - b^n in f32, and p += -lr (mu_hat / (sqrt(nu_hat) +
    eps) + weight_decay p): the decay joins the update before the one
    rounding onto p.  ``torch.optim.AdamW`` rounds the decayed p first and
    takes the corrections in f64, which drifts from optax by tens of ulps in
    150 updates.  A parameter with no gradient takes a zero one: optax
    decays every leaf and advances its moments.  Multi-tensor (``foreach``)
    ops, one launch each for all parameters."""

    def __init__(self, params, lr: float = 1e-3, b1: float = ADAM_B1, b2: float = ADAM_B2,
                 eps: float = ADAM_EPS, weight_decay: float = WEIGHT_DECAY):
        super().__init__(params, dict(lr=lr, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay))

    @staticmethod
    def _correction(b: float, count: int) -> float:
        """1 - b^count computed in f32 (exact as a Python float)."""
        return float(1.0 - torch.tensor(b, dtype=torch.float32) ** count)

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            params = group["params"]
            for p in params:
                if not self.state[p]:
                    self.state[p].update(step=0, mu=torch.zeros_like(p), nu=torch.zeros_like(p))
                self.state[p]["step"] += 1
            count = self.state[params[0]]["step"]
            grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in params]
            mus = [self.state[p]["mu"] for p in params]
            nus = [self.state[p]["nu"] for p in params]
            b1, b2 = group["b1"], group["b2"]
            torch._foreach_mul_(mus, b1)
            torch._foreach_add_(mus, torch._foreach_mul(grads, 1.0 - b1))
            torch._foreach_mul_(nus, b2)
            torch._foreach_add_(nus, torch._foreach_mul(torch._foreach_mul(grads, grads), 1.0 - b2))
            upd = torch._foreach_div(mus, self._correction(b1, count))
            den = torch._foreach_sqrt(torch._foreach_div(nus, self._correction(b2, count)))
            torch._foreach_add_(den, group["eps"])
            torch._foreach_div_(upd, den)
            torch._foreach_add_(upd, torch._foreach_mul(params, group["weight_decay"]))
            torch._foreach_mul_(upd, -group["lr"])
            torch._foreach_add_(params, upd)


def init_train_state(net: ViT, learning_rate: float | Callable[[int], float],
                     weight_decay: float = WEIGHT_DECAY) -> TrainState:
    """AdamW over every parameter of ``net`` (``optax.adamw``), its learning
    rate a constant or a schedule of the update count."""
    sched = learning_rate if callable(learning_rate) else (lambda count: learning_rate)
    opt = AdamW(net.parameters(), lr=1.0, weight_decay=weight_decay)
    return TrainState(net, opt, torch.optim.lr_scheduler.LambdaLR(opt, sched), 0)


def apply_gradients(state: TrainState, loss: torch.Tensor) -> TrainState:
    """Backward of ``loss`` and one AdamW update."""
    state.optimizer.zero_grad(set_to_none=True)
    loss.backward()
    state.optimizer.step()
    state.scheduler.step()
    return state._replace(step=state.step + 1)


# ---------------------------------------------------------------------------
# Geometric supervision
# ---------------------------------------------------------------------------


def _patch_centers_px(model: ServoModel) -> torch.Tensor:
    """(t, 2) f32 patch-centre pixel coordinates (u, v) in the camera frame:
    (i + 0.5) times one f32 constant per axis, scale * u_max * (1 / s) folded
    in f32, as XLA folds the JAX package's constant chain under jit."""
    gh, gw = model.grid()
    s = model.cfg.dino_input_size
    f32 = np.float32
    scale = f32(s / gh)
    dev = model.device
    cu = float(scale * f32(model.cfg.u_max) * (f32(1) / f32(s)))
    cv = float(scale * f32(model.cfg.v_max) * (f32(1) / f32(s)))
    rows = (torch.arange(gh, dtype=torch.float32, device=dev) + 0.5) * cv
    cols = (torch.arange(gw, dtype=torch.float32, device=dev) + 0.5) * cu
    vv, uu = torch.meshgrid(rows, cols, indexing="ij")
    return torch.stack([uu, vv], -1).reshape(-1, 2)


def geometric_correspondences(model: ServoModel, scene: Scene, pos_a: torch.Tensor,
                              quat_a: torch.Tensor, pos_b: torch.Tensor, quat_b: torch.Tensor
                              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Ground-truth patch map A -> B through the plane, for poses (..., 3) /
    (..., 4) (A and B broadcast).  Returns (idx (..., t) int64, the target
    patch in view B of each patch of view A; valid (..., t) bool, the ray
    hits the poster in front of both cameras and lands inside view B)."""
    gh, gw = model.grid()
    uv_b, world, t_hit, z = camera_mod.reproject_via_plane(
        model.camera, _patch_centers_px(model), pos_a, quat_a, pos_b, quat_b, scene.plane_z)
    on_poster = ((t_hit > 1e-6)
                 & (world[..., 0].abs() <= scene.half_size[0])
                 & (world[..., 1].abs() <= scene.half_size[1]))
    s = model.cfg.dino_input_size
    gu = uv_b[..., 0] * s / model.cfg.u_max / (s / gw)        # patch col in B
    gv = uv_b[..., 1] * s / model.cfg.v_max / (s / gh)        # patch row in B
    col = torch.floor(gu).to(torch.int64)
    row = torch.floor(gv).to(torch.int64)
    inside = (col >= 0) & (col < gw) & (row >= 0) & (row < gh)
    idx = row.clamp(0, gh - 1) * gw + col.clamp(0, gw - 1)
    return idx, on_poster & (z > 1e-6) & inside


def _uniform(generator: torch.Generator, shape, lo, hi) -> torch.Tensor:
    """U[lo, hi) f32 on the generator's device (CPU); lo, hi broadcast."""
    u = torch.rand(shape, generator=generator, dtype=torch.float32)
    lo = torch.as_tensor(lo, dtype=torch.float32)
    hi = torch.as_tensor(hi, dtype=torch.float32)
    return lo + (hi - lo) * u


def _goal_pose(device) -> tuple[torch.Tensor, torch.Tensor]:
    return (torch.tensor(DESIRED_POSITION, dtype=torch.float32, device=device),
            torch.tensor(DESIRED_ORIENTATION, dtype=torch.float32, device=device))


def _texture_seeds(generator: torch.Generator, batch: int) -> list[int]:
    """One seed per item for the device generator of its perturbation."""
    return torch.randint(0, 2 ** 62, (batch,), generator=generator).tolist()


def _perturbed_textures(scene: Scene, seeds: list[int]) -> torch.Tensor:
    """(n, Ht, Wt, 3): one perturbation of the scene's texture per seed,
    drawn on the texture's device."""
    dev = scene.texture.device
    return torch.stack([perturb_texture(torch.Generator(dev).manual_seed(s), scene.texture)
                        for s in seeds])


def _render_views(model: ServoModel, scene: Scene, pos: torch.Tensor, quat: torch.Tensor,
                  perturbed: list[bool], seeds: list[int]) -> torch.Tensor:
    """rgb (B, ..., H, W, 3) of item b's views (poses (B, ..., 3)) on the
    scene's texture, or, where ``perturbed[b]``, on its own perturbation
    (seed ``seeds[b]``): the clean items in one render, the perturbed ones
    in one render of their stacked textures."""
    cam = model.camera
    pert = [b for b, p in enumerate(perturbed) if p]
    if not pert:
        return observe(scene, cam, pos, quat)[0]
    if len(pert) == len(perturbed):
        tex = _perturbed_textures(scene, seeds)
        return observe(scene.with_texture(tex), cam, pos, quat)[0]
    clean = [b for b, p in enumerate(perturbed) if not p]
    ip = torch.tensor(pert, device=pos.device)
    ic = torch.tensor(clean, device=pos.device)
    tex = _perturbed_textures(scene, [seeds[b] for b in pert])
    rgb_p = observe(scene.with_texture(tex), cam, pos[ip], quat[ip])[0]
    rgb_c = observe(scene, cam, pos[ic], quat[ic])[0]
    rgb = torch.empty((len(perturbed),) + rgb_p.shape[1:], dtype=rgb_p.dtype, device=rgb_p.device)
    rgb[ip] = rgb_p
    rgb[ic] = rgb_c
    return rgb


@torch.no_grad()
def make_pair_batch(model: ServoModel, scene: Scene, generator: torch.Generator, batch: int,
                    pos_noise: float = 0.08, rot_noise_deg: float = 10.0,
                    perturb: bool = True) -> dict[str, torch.Tensor]:
    """``batch`` view pairs around the goal pose, with their ground-truth
    correspondence: dict of img_a, img_b (B, S, S, 3) preprocessed, idx,
    valid (B, t).  With ``perturb`` both views of item b show one
    perturbation of the texture, its own."""
    dev = model.device
    goal_p, goal_q = _goal_pose("cpu")
    pos = goal_p + _uniform(generator, (batch, 2, 3), -pos_noise, pos_noise)
    ang = _uniform(generator, (batch, 2), -math.radians(rot_noise_deg),
                   math.radians(rot_noise_deg))
    seeds = _texture_seeds(generator, batch)
    quat = se3.rotate_about_body_x(goal_q, ang)                          # (B, 2, 4)
    pos, quat = pos.to(dev), quat.to(dev)
    rgb = _render_views(model, scene, pos, quat, [perturb] * batch, seeds)   # (B, 2, H, W, 3)
    idx, valid = geometric_correspondences(model, scene, pos[:, 0], quat[:, 0],
                                           pos[:, 1], quat[:, 1])
    return {"img_a": preprocess(model, rgb[:, 0]), "img_b": preprocess(model, rgb[:, 1]),
            "idx": idx, "valid": valid}


class ServoPoses(NamedTuple):
    """The draws of :func:`make_servo_pair_batch`, on the CPU."""

    position: torch.Tensor       # (B, 3)
    quat: torch.Tensor           # (B, 4)
    spin: torch.Tensor           # (B,) optical-axis spin, radians
    perturbed: list[bool]
    seeds: list[int]             # each item's texture-perturbation seed


def draw_servo_poses(generator: torch.Generator, batch: int, box=(1.2, 1.2, 0.3),
                     rot_range_deg: float = 135.0, focal_radius: float = 0.32,
                     perturb_prob: float = 0.5, min_z: float = 0.12) -> ServoPoses:
    """Episode-like start poses: uniform in the box around the goal (z at
    least ``min_z``), looking at a focal point uniform in the square of
    half-side ``focal_radius`` around the poster centre, spun about the
    optical axis uniformly in +-``rot_range_deg``; each item perturbed with
    probability ``perturb_prob``."""
    goal_p, _ = _goal_pose("cpu")
    half = torch.tensor(box, dtype=torch.float32) / 2.0
    pos = goal_p + _uniform(generator, (batch, 3), -half, half)
    pos[:, 2] = torch.clamp(pos[:, 2], min=min_z)
    foc = torch.tensor(REFERENCE_POINT, dtype=torch.float32).expand(batch, 3).clone()
    foc[:, :2] += focal_radius * _uniform(generator, (batch, 2), -1.0, 1.0)
    spin = _uniform(generator, (batch,), -math.radians(rot_range_deg),
                    math.radians(rot_range_deg))
    quat = se3.rotate_about_body_x(se3.look_at_quaternion(pos, foc), spin)
    perturbed = (torch.rand(batch, generator=generator) < perturb_prob).tolist()
    return ServoPoses(pos, quat, spin, perturbed, _texture_seeds(generator, batch))


def _servo_views(model: ServoModel, scene: Scene, generator: torch.Generator, batch: int,
                 **draw_kw):
    """(goal rgb (H, W, 3), episode rgb (B, H, W, 3), the correspondence
    dict idx_ab, valid_ab, idx_ba, valid_ba (B, t))."""
    dev = model.device
    poses = draw_servo_poses(generator, batch, **draw_kw)
    goal_p, goal_q = _goal_pose(dev)
    pb, qb = poses.position.to(dev), poses.quat.to(dev)
    goal_rgb = observe(scene, model.camera, goal_p, goal_q)[0]
    rgb_b = _render_views(model, scene, pb, qb, poses.perturbed, poses.seeds)
    idx_ab, valid_ab = geometric_correspondences(model, scene, goal_p, goal_q, pb, qb)
    idx_ba, valid_ba = geometric_correspondences(model, scene, pb, qb, goal_p, goal_q)
    return goal_rgb, rgb_b, {"idx_ab": idx_ab, "valid_ab": valid_ab,
                             "idx_ba": idx_ba, "valid_ba": valid_ba}


@torch.no_grad()
def make_servo_pair_batch(model: ServoModel, scene: Scene, generator: torch.Generator,
                          batch: int, box=(1.2, 1.2, 0.3), rot_range_deg: float = 135.0,
                          focal_radius: float = 0.32, perturb_prob: float = 0.5,
                          min_z: float = 0.12):
    """Goal-view / episode-view training pairs, the benchmark's matching
    task: view A is the goal pose on the clean texture (the serving goal
    image), view B an episode-like start pose (:func:`draw_servo_poses`),
    on a perturbed texture with probability ``perturb_prob`` (the perturbed
    sweeps swap the poster while the goal image stays clean).

    Returns (goal_img (S, S, 3), dict of (B, ...): img_b, idx_ab, valid_ab,
    idx_ba, valid_ba)."""
    goal_rgb, rgb_b, corr = _servo_views(
        model, scene, generator, batch, box=box, rot_range_deg=rot_range_deg,
        focal_radius=focal_radius, perturb_prob=perturb_prob, min_z=min_z)
    return preprocess(model, goal_rgb), {"img_b": preprocess(model, rgb_b), **corr}


# ---------------------------------------------------------------------------
# Loss + train step
# ---------------------------------------------------------------------------


def info_nce_loss(desc_a: torch.Tensor, desc_b: torch.Tensor, idx: torch.Tensor,
                  valid: torch.Tensor, temperature: float = 0.1) -> torch.Tensor:
    """Contrastive matching loss of view pairs: desc_a, desc_b (..., t, d)
    (broadcasting), idx (..., t) the ground-truth target in B, valid (..., t)
    its mask -> (...) losses."""
    a = desc_a / (torch.linalg.vector_norm(desc_a, dim=-1, keepdim=True) + 1e-8)
    b = desc_b / (torch.linalg.vector_norm(desc_b, dim=-1, keepdim=True) + 1e-8)
    logits = (a @ b.mT) / temperature                                   # (..., t, t)
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, idx[..., None].expand(logp.shape[:-1] + (1,)))[..., 0]
    v = valid.to(nll.dtype)
    return (nll * v).sum(-1) / torch.clamp(v.sum(-1), min=1.0)


def _train_descriptors(net: ViT, model: ServoModel, images: torch.Tensor) -> torch.Tensor:
    """(N, t, D) f32 raw facet descriptors (binning is linear, so training
    skips it) of the training forward: blocks in the compute dtype on casts
    of the f32 parameters, no hand kernel."""
    return extract_descriptors(net, images, layer=model.cfg.layer, facet=model.cfg.facet,
                               bin=False, use_kernels=False,
                               compute_dtype=model.compute_dtype)[:, 0].float()


def _batch_loss(net: ViT, model: ServoModel, batch) -> torch.Tensor:
    """Mean InfoNCE of the pairs (img_a -> img_b), one forward over both views."""
    nb = batch["img_a"].shape[0]
    desc = _train_descriptors(net, model, torch.cat([batch["img_a"], batch["img_b"]]))
    return info_nce_loss(desc[:nb], desc[nb:], batch["idx"], batch["valid"]).mean()


def make_train_step(model: ServoModel):
    """(state, batch) -> (state, loss): one AdamW step on a pair batch."""

    def step(state: TrainState, batch) -> tuple[TrainState, torch.Tensor]:
        loss = _batch_loss(state.net, model, batch)
        return apply_gradients(state, loss), loss.detach()

    return step


def train_descriptor_model(net: ViT, model: ServoModel, scene: Scene, steps: int = 100,
                           batch: int = 4, learning_rate: float = 3e-4, seed: int = 0,
                           verbose: bool = False) -> tuple[TrainState, list[float]]:
    """Fine-tune ``net`` (f32, trained in place) on sim view pairs at a
    constant learning rate."""
    state = init_train_state(net, learning_rate)
    step_fn = make_train_step(model)
    gen = torch.Generator().manual_seed(seed)
    losses = []
    for i in range(steps):
        state, loss = step_fn(state, make_pair_batch(model, scene, gen, batch))
        losses.append(float(loss))
        if verbose and i % 10 == 0:
            print(f"[train] step {i}: loss {losses[-1]:.4f}", flush=True)
    return state, losses


# ---------------------------------------------------------------------------
# Servo-descriptor training (goal view against episode views)
# ---------------------------------------------------------------------------


def _servo_batch_loss(net: ViT, model: ServoModel, goal_img: torch.Tensor, batch) -> torch.Tensor:
    """Symmetric InfoNCE between the shared goal view and B episode views,
    the goal and the views in one forward."""
    desc = _train_descriptors(net, model, torch.cat([goal_img[None], batch["img_b"]]))
    d_goal, d_eps = desc[0], desc[1:]
    losses = 0.5 * (info_nce_loss(d_goal, d_eps, batch["idx_ab"], batch["valid_ab"])
                    + info_nce_loss(d_eps, d_goal, batch["idx_ba"], batch["valid_ba"]))
    return losses.mean()


def make_servo_train_epoch(model: ServoModel, batch: int, steps_per_call: int,
                           perturb_prob: float = 0.5):
    """(state, scene, generator) -> (state, losses (steps_per_call,)):
    ``steps_per_call`` train steps, pair batches included, with no host
    wait on the device; the losses come back as one tensor on the device."""

    def epoch(state: TrainState, scene: Scene, generator: torch.Generator):
        losses = []
        for _ in range(steps_per_call):
            goal_img, data = make_servo_pair_batch(model, scene, generator, batch,
                                                   perturb_prob=perturb_prob)
            loss = _servo_batch_loss(state.net, model, goal_img, data)
            state = apply_gradients(state, loss)
            losses.append(loss.detach())
        return state, torch.stack(losses)

    return epoch


def _serving_net(net: ViT | QuantViT, model: ServoModel) -> ViT | QuantViT:
    """The net the serving path runs: ``net`` itself when it already has
    the model's form, else a copy with the blocks in the compute dtype, or
    its int8 W8A8 form (dynamic scales) for a quantized model."""
    if model.quantized:
        return net if isinstance(net, QuantViT) else quantized_vit(net, model)
    if net.compute_dtype == model.compute_dtype:
        return net
    return model.load_vit(net.state_dict())


@torch.no_grad()
def matching_quality(net: ViT | QuantViT, model: ServoModel, scene: Scene,
                     generator: torch.Generator, num_views: int = 8,
                     num_pairs: int | None = None) -> tuple[float, float]:
    """Serving-path evaluation: the goal view against ``num_views``
    episode-like views (unperturbed) through ``goal_descriptors``,
    ``batch_descriptors`` and the batched match (``match_frames``: the hand
    kernels when ``model.use_kernels``; int8 and source-quantized bins on a
    quantized model; the factorized binned similarity under
    ``fast_binned_match``).  Returns (mean valid-pair fraction, mean share of
    valid pairs within one patch of the geometric ground truth)."""
    k = num_pairs or model.cfg.num_pairs
    gh, gw = model.grid()
    goal_rgb, rgb_b, corr = _servo_views(model, scene, generator, num_views, perturb_prob=0.0)
    serve = _serving_net(net, model)
    gd = goal_descriptors(serve, model, goal_rgb)
    db = batch_descriptors(serve, model, rgb_b)
    scores = torch.rand((num_views, gh * gw), generator=generator).to(model.device)
    m, _ = match_frames(model, gd, db, k, scores,
                        distance_threshold=model.cfg.thresh_filter_keypoints)
    # the ground truth: goal patch p1 lands at idx_ab[p1]; a match counts as
    # correct within one patch of it
    pts1, pts2 = m.points1.long(), m.points2.long()
    p1 = pts1[..., 0] * gw + pts1[..., 1]
    p2 = pts2[..., 0] * gw + pts2[..., 1]
    gt = torch.gather(corr["idx_ab"], 1, p1)
    ok = m.valid & torch.gather(corr["valid_ab"], 1, p1)
    near = ((p2 // gw - gt // gw).abs() <= 1) & ((p2 % gw - gt % gw).abs() <= 1)
    acc = (near & ok).sum(1) / torch.clamp(ok.sum(1), min=1)
    frac = m.num_valid / k
    return float(frac.float().mean()), float(acc.float().mean())
