"""Closed-loop episode rollouts on one device (``vitvs_tpu/harness/rollout.py``).

A step is {render -> servo_step -> integrate -> convergence bookkeeping}
for a chunk of B episodes at once, the reference's vmap over the chunk
written out as a batch dimension: every value a tensor on the model's
device with a leading B, one render, one ViT forward, one matcher launch
and one batched solve a step, and no wait for the device within a segment.
One episode is the chunk of one (its carry and histories without the axis).

Kept from the JAX package:
* per-step ground-truth errors from the sim pose (the reference's
  ``calculate_end_error``);
* an episode's carry freezes once it is done or aborted (a select, so the
  steps still run), its recorded errors are those of the frozen pose, and
  its recorded command and twist are zero;
* the feature-failure counter aborts an episode after
  ``max_feature_failures`` consecutive failures (inf errors in the result);
  ``early_divergence_abort`` adds the classical controller's per-step
  divergence abort;
* ``step_fn`` overrides the per-frame pipeline (the classical path's hook);
* the rotation-compensation search over 4 optical-axis spins, scored by the
  mean similarity of its matches at ``num_pairs`` 48, the chunk's 4B views
  rendered together and matched from one batched ViT forward (on the int8
  serving path source-quantized and matched in one int8 product; under
  ``fast_binned_match`` scored on the factorized binned similarity).

Pair scores are the one random stream torch cannot reproduce: JAX draws
``jax.random.uniform(sub, (t,))`` each step.  Here each episode draws (t,) a
step from its own ``torch.Generator`` of the model's device, so an episode's
stream does not depend on the chunk it runs in; or they are injected (the
tests feed JAX's).
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Sequence

import numpy as np
import torch

from vitvs_tpu_torch.control.convergence import (ConvergenceState, convergence_init,
                                                 convergence_step)
from vitvs_tpu_torch.control.ibvs import EmaState
from vitvs_tpu_torch.core import se3
from vitvs_tpu_torch.core.batch import item, select
from vitvs_tpu_torch.harness.pipeline import (ServoModel, StepResult, batch_descriptors,
                                              match_frames, servo_step)
from vitvs_tpu_torch.harness.samplers import DESIRED_ORIENTATION, DESIRED_POSITION
from vitvs_tpu_torch.sim.env import env_step, observe
from vitvs_tpu_torch.sim.scene import Scene


# the rotation search (the reference's find_and_set_best_pose): the spins tried
# about the optical axis and the pairs each view's matches are scored on
SEARCH_ANGLES_DEG = (0.0, 90.0, 180.0, 270.0)
SEARCH_PAIRS = 48


def goal_pose(device) -> tuple[torch.Tensor, torch.Tensor]:
    """The reference's goal pose as f32 tensors on ``device``."""
    return (torch.tensor(DESIRED_POSITION, dtype=torch.float32, device=device),
            torch.tensor(DESIRED_ORIENTATION, dtype=torch.float32, device=device))


def pose_errors(position, quat, desired_position, desired_quat):
    """(translation error cm, rotation error deg) of poses (..., 3) / (..., 4)."""
    t = torch.linalg.vector_norm(position - desired_position, dim=-1) * 100.0
    r = se3.quat_error_angle(quat, desired_quat) * (180.0 / math.pi)
    return t, r


class EpisodeCarry(NamedTuple):
    """One episode's state between steps; a chunk's has a leading B."""

    position: torch.Tensor
    quat: torch.Tensor
    ema: EmaState
    prev_v_c: torch.Tensor
    conv: ConvergenceState
    fail_count: torch.Tensor
    aborted: torch.Tensor
    lowest_pos_err: torch.Tensor
    lowest_rot_err: torch.Tensor


class EpisodeResult(NamedTuple):
    """The reference ``Controller.run`` tuple as fixed-shape arrays plus an
    ``active`` mask over history steps (a chunk's: a leading B on each)."""

    final_position: torch.Tensor       # (3,)
    final_quat: torch.Tensor           # (4,)
    converged: torch.Tensor            # () bool
    position_error: torch.Tensor       # () cm (inf when aborted)
    orientation_error: torch.Tensor    # () deg
    position_history: torch.Tensor     # (T, 3)
    orientation_history: torch.Tensor  # (T, 4)
    iterations: torch.Tensor           # () int32
    lowest_position_error: torch.Tensor
    lowest_orientation_error: torch.Tensor
    v_c_history: torch.Tensor          # (T, 6) optical-frame smoothed commands
    applied_twist_history: torch.Tensor  # (T, 6) clipped body twists
    error_history: torch.Tensor        # (T, 2) (cm, deg)
    active: torch.Tensor               # (T,) bool: the step was not frozen
    aborted: torch.Tensor              # () bool: persistent feature failure


class StepInputs(NamedTuple):
    """What one rollout step handed the chunk's ``servo_step`` (for
    ``on_step``), each with the chunk's leading B (``scores`` None where the
    rollout draws none)."""

    rgb: torch.Tensor
    depth: torch.Tensor
    ema: EmaState
    prev_v_c: torch.Tensor
    scores: torch.Tensor


def _f32(x, device) -> torch.Tensor:
    """A pose array or tensor as an f32 tensor on ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(device, torch.float32)
    return torch.tensor(np.asarray(x, np.float32), device=device)


def _generators(generator) -> list | None:
    """One episode's generator, or a chunk's sequence of them, as a list."""
    if generator is None:
        return None
    return [generator] if isinstance(generator, torch.Generator) else list(generator)


def episode_init(start_position, start_quat, desired_position: torch.Tensor,
                 desired_quat: torch.Tensor) -> EpisodeCarry:
    """One episode's carry from a start (3,) / (4,), or a chunk's from (B, 3)
    / (B, 4) starts."""
    dev = desired_position.device
    position, quat = _f32(start_position, dev), _f32(start_quat, dev)
    batch = position.shape[:-1]
    e0t, e0r = pose_errors(position, quat, desired_position, desired_quat)
    inf = torch.full(batch, math.inf, device=dev)
    return EpisodeCarry(
        position=position, quat=quat, ema=EmaState.init(device=dev, batch=batch),
        prev_v_c=torch.zeros(*batch, 6, device=dev), conv=convergence_init(e0t, e0r),
        fail_count=torch.zeros(batch, dtype=torch.int32, device=dev),
        aborted=torch.zeros(batch, dtype=torch.bool, device=dev),
        lowest_pos_err=inf, lowest_rot_err=inf.clone())


def _num_tokens(model: ServoModel) -> int:
    gh, gw = model.grid()
    return gh * gw


StepFn = Callable[[torch.Tensor, torch.Tensor, EmaState, torch.Tensor, torch.Tensor], StepResult]


@torch.inference_mode()
def rollout_segment(net, model: ServoModel, scene: Scene, goal_desc, carry0: EpisodeCarry,
                    num_steps: int, desired_position: torch.Tensor,
                    desired_quat: torch.Tensor,
                    generator: torch.Generator | Sequence[torch.Generator] | None = None,
                    scores: torch.Tensor | None = None,
                    on_step: Callable[[StepInputs, StepResult], None] | None = None,
                    step_fn: StepFn | None = None,
                    draw_scores: bool = True,
                    ) -> tuple[EpisodeCarry, dict]:
    """``num_steps`` servo iterations from a carry: one episode's, or a
    chunk's with a leading B (``scene`` one scene, or one of B textures).

    ``generator``: one episode's, or the chunk's B, each drawing (t,) pair
    scores a step on the model's device; ``scores``: injected instead,
    (num_steps, t), or (B, num_steps, t).  ``step_fn(rgb, depth, ema,
    prev_v_c, scores) -> StepResult`` replaces the per-frame pipeline
    (default: ``servo_step`` on ``net`` and ``goal_desc``); it and
    ``on_step(inputs, result)`` see each step's chunk-shaped tensors (B = 1
    for one episode).  ``draw_scores=False`` draws none and hands the step
    ``None`` (a step without pair sampling, the classical path's).  Returns
    the carry and the histories, (num_steps, ...) tensors, (B, num_steps,
    ...) for a chunk."""
    if carry0.position.dim() == 1:
        carry, ys = rollout_segment(
            net, model, scene, goal_desc, item(carry0, None), num_steps, desired_position,
            desired_quat, generator=_generators(generator),
            scores=None if scores is None else scores[None], on_step=on_step, step_fn=step_fn,
            draw_scores=draw_scores)
        return item(carry, 0), {k: v[0] for k, v in ys.items()}
    cfg, cam = model.cfg, model.camera
    nb = carry0.position.shape[0]
    t = _num_tokens(model) if scores is None and draw_scores else 0
    gens = _generators(generator)
    if gens is not None and len(gens) != nb:
        raise ValueError(f"a chunk of {nb} episodes takes {nb} generators, got {len(gens)}")
    if step_fn is None:
        def step_fn(rgb, depth, ema, prev_v_c, s):
            return servo_step(net, model, goal_desc, rgb, depth, ema, prev_v_c, scores=s)
    e0t = carry0.conv.initial_err_trans
    carry, ys = carry0, []
    for i in range(num_steps):
        frozen = carry.conv.done | carry.aborted                           # (B,)
        if scores is not None:
            s = scores[:, i]
        elif not draw_scores:
            s = None
        elif gens is None:
            s = torch.rand((nb, t), device=model.device)
        else:
            s = torch.stack([torch.rand(t, generator=g, device=model.device) for g in gens])
        rgb, depth = observe(scene, cam, carry.position, carry.quat)
        step = step_fn(rgb, depth, carry.ema, carry.prev_v_c, s)
        if on_step is not None:
            on_step(StepInputs(rgb, depth, carry.ema, carry.prev_v_c, s), step)

        fail_count = torch.where(step.feature_ok, torch.zeros_like(carry.fail_count),
                                 carry.fail_count + 1)
        aborted = carry.aborted | (fail_count >= cfg.max_feature_failures)
        if cfg.early_divergence_abort:
            et_now, _ = pose_errors(carry.position, carry.quat, desired_position, desired_quat)
            aborted = aborted | (et_now > cfg.divergence_multiplier * e0t)
        position, quat = env_step(carry.position, carry.quat, step.body_twist, cfg.control_dt)
        et, er = pose_errors(position, quat, desired_position, desired_quat)
        conv = convergence_step(carry.conv, step.v_c, et, er, cfg,
                                update_velocity=step.feature_ok)
        new = EpisodeCarry(position, quat, step.ema, step.v_c, conv, fail_count, aborted,
                           torch.minimum(carry.lowest_pos_err, et),
                           torch.minimum(carry.lowest_rot_err, er))
        carry = select(frozen, carry, new)
        # the recorded errors follow the frozen pose, not the phantom step above
        rec_et, rec_er = pose_errors(carry.position, carry.quat, desired_position, desired_quat)
        still = frozen[:, None]
        ys.append({"position": carry.position, "quat": carry.quat,
                   "v_c": torch.where(still, 0.0, step.v_c),
                   "twist": torch.where(still, 0.0, step.body_twist),
                   "err": torch.stack([rec_et, rec_er], dim=-1), "active": ~frozen})
    return carry, {k: torch.stack([y[k] for y in ys], dim=1) for k in ys[0]}


def finalize_episode(carry: EpisodeCarry, ys: dict, desired_position: torch.Tensor,
                     desired_quat: torch.Tensor) -> EpisodeResult:
    """Package a finished carry and its (possibly concatenated) histories."""
    final_et, final_er = pose_errors(carry.position, carry.quat, desired_position, desired_quat)
    inf = torch.full_like(final_et, math.inf)
    ab = carry.aborted
    return EpisodeResult(
        final_position=carry.position, final_quat=carry.quat,
        converged=carry.conv.converged & ~ab,
        position_error=torch.where(ab, inf, final_et),
        orientation_error=torch.where(ab, inf, final_er),
        position_history=ys["position"], orientation_history=ys["quat"],
        iterations=carry.conv.iteration,
        lowest_position_error=torch.where(ab, inf, carry.lowest_pos_err),
        lowest_orientation_error=torch.where(ab, inf, carry.lowest_rot_err),
        v_c_history=ys["v_c"], applied_twist_history=ys["twist"], error_history=ys["err"],
        active=ys["active"], aborted=ab)


def rollout_episode(net, model: ServoModel, scene: Scene, goal_desc, start_position,
                    start_quat, generator=None, scores: torch.Tensor | None = None,
                    num_steps: int | None = None, step_fn: StepFn | None = None,
                    ) -> EpisodeResult:
    """One episode (or a chunk, from (B, 3) / (B, 4) starts) of
    ``num_steps`` (default ``max_iterations``) steps to the reference's goal
    pose, as one segment; ``step_fn`` as :func:`rollout_segment`'s."""
    desired_p, desired_q = goal_pose(model.device)
    carry0 = episode_init(start_position, start_quat, desired_p, desired_q)
    carry, ys = rollout_segment(net, model, scene, goal_desc, carry0,
                                num_steps or model.cfg.max_iterations, desired_p, desired_q,
                                generator=generator, scores=scores, step_fn=step_fn)
    return finalize_episode(carry, ys, desired_p, desired_q)


@torch.inference_mode()
def find_best_start_pose(net, model: ServoModel, scene: Scene, goal_desc, position, quat,
                         generator: torch.Generator | Sequence[torch.Generator] | None = None,
                         scores: torch.Tensor | None = None,
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Rotation compensation: the optical-axis spin whose matches score the
    highest mean similarity (first on ties), of one start pose (3,) / (4,)
    or of a chunk's (B, 3) / (B, 4) (``scene`` one scene, or one of B
    textures).  The 4B views are rendered in one call, described by one ViT
    forward and matched against the goal in one matcher launch (one int8
    product on the int8 serving path).
    ``scores``: injected pair scores (A, t), or (B, A, t); else each
    episode's generator (``generator``: one, or the chunk's B) draws (A, t)
    on the model's device.  Returns (position, best quat)."""
    dev = model.device
    position, quat = _f32(position, dev), _f32(quat, dev)
    if position.dim() == 1:
        _, best = find_best_start_pose(net, model, scene, goal_desc, position[None], quat[None],
                                       generator=_generators(generator),
                                       scores=None if scores is None else scores[None])
        return position, best[0]
    nb, na = position.shape[0], len(SEARCH_ANGLES_DEG)
    angles = torch.tensor(SEARCH_ANGLES_DEG, dtype=torch.float32, device=dev) * (math.pi / 180.0)
    quats = se3.rotate_about_body_x(quat[:, None], angles)                # (B, A, 4)
    frames, _ = observe(scene, model.camera, position[:, None].expand(nb, na, 3), quats)
    descs = batch_descriptors(net, model, frames.flatten(0, 1))            # (B A, t, d)
    if scores is None:
        gens = _generators(generator) or [None] * nb
        scores = torch.stack([torch.rand((na, _num_tokens(model)), generator=g, device=dev)
                              for g in gens])
    m, _ = match_frames(model, goal_desc, descs, SEARCH_PAIRS, scores.to(dev).flatten(0, 1))
    total = torch.where(m.valid, m.sim, torch.zeros_like(m.sim)).sum(-1)
    mean = total / torch.clamp(m.num_valid, min=1)
    mean_sims = torch.where(m.num_valid > 0, mean, torch.full_like(mean, -math.inf))
    best = mean_sims.reshape(nb, na).argmax(-1)
    return position, quats[torch.arange(nb, device=dev), best]
