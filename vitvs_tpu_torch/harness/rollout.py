"""Closed-loop episode rollouts on one device (``vitvs_tpu/harness/rollout.py``).

A step is {render -> servo_step -> integrate -> convergence bookkeeping},
one episode at a time (B = 1), every value a tensor on the model's device:
a segment of steps queues its work without waiting for the device.

Kept from the JAX package:
* per-step ground-truth errors from the sim pose (the reference's
  ``calculate_end_error``);
* the carry freezes once the episode is done or aborted (a select, so the
  steps still run), its recorded errors are those of the frozen pose, and
  its recorded command and twist are zero;
* the feature-failure counter aborts an episode after
  ``max_feature_failures`` consecutive failures (inf errors in the result);
  ``early_divergence_abort`` adds the classical controller's per-step
  divergence abort;
* the rotation-compensation search over 4 optical-axis spins, scored by the
  mean similarity of its matches at ``num_pairs`` 48, from one batched ViT
  forward over the 4 views.

Pair scores are the one random stream torch cannot reproduce: JAX draws
``jax.random.uniform(sub, (t,))`` each step.  Here they come from a
``torch.Generator`` of the model's device, or are injected (the tests feed
JAX's).
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import numpy as np
import torch

from vitvs_tpu_torch.control.convergence import (ConvergenceState, convergence_init,
                                                 convergence_step)
from vitvs_tpu_torch.control.ibvs import EmaState
from vitvs_tpu_torch.core import se3
from vitvs_tpu_torch.harness.pipeline import ServoModel, StepResult, batch_descriptors, servo_step
from vitvs_tpu_torch.harness.samplers import DESIRED_ORIENTATION, DESIRED_POSITION
from vitvs_tpu_torch.match.correspondence import find_correspondences
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
    """(translation error cm, rotation error deg)."""
    t = torch.linalg.vector_norm(position - desired_position) * 100.0
    r = se3.quat_error_angle(quat, desired_quat) * (180.0 / math.pi)
    return t, r


class EpisodeCarry(NamedTuple):
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
    ``active`` mask over history steps."""

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
    """What one rollout step handed ``servo_step`` (for ``on_step``)."""

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


def _select(cond: torch.Tensor, old, new):
    """torch.where(cond, old, new) over a nest of NamedTuples of tensors."""
    if isinstance(old, tuple):
        return type(old)(*(_select(cond, o, n) for o, n in zip(old, new)))
    return torch.where(cond, old, new)


def episode_init(start_position, start_quat, desired_position: torch.Tensor,
                 desired_quat: torch.Tensor) -> EpisodeCarry:
    dev = desired_position.device
    position, quat = _f32(start_position, dev), _f32(start_quat, dev)
    e0t, e0r = pose_errors(position, quat, desired_position, desired_quat)
    inf = torch.tensor(math.inf, device=dev)
    return EpisodeCarry(
        position=position, quat=quat, ema=EmaState.init(device=dev),
        prev_v_c=torch.zeros(6, device=dev), conv=convergence_init(e0t, e0r),
        fail_count=torch.zeros((), dtype=torch.int32, device=dev),
        aborted=torch.zeros((), dtype=torch.bool, device=dev),
        lowest_pos_err=inf, lowest_rot_err=inf)


def _num_tokens(model: ServoModel) -> int:
    gh, gw = model.grid()
    return gh * gw


@torch.inference_mode()
def rollout_segment(net, model: ServoModel, scene: Scene, goal_desc, carry0: EpisodeCarry,
                    num_steps: int, desired_position: torch.Tensor,
                    desired_quat: torch.Tensor, generator: torch.Generator | None = None,
                    scores: torch.Tensor | None = None,
                    on_step: Callable[[StepInputs, StepResult], None] | None = None,
                    ) -> tuple[EpisodeCarry, dict]:
    """``num_steps`` servo iterations from a carry.  ``scores``: (num_steps,
    t) injected pair scores, else each step draws (t,) from ``generator``
    on the model's device.  ``on_step`` sees each step's inputs and result.
    Returns the carry and the histories, (num_steps, ...) tensors."""
    cfg, cam = model.cfg, model.camera
    e0t = carry0.conv.initial_err_trans
    zeros6 = torch.zeros(6, device=e0t.device)
    carry, ys = carry0, []
    for i in range(num_steps):
        frozen = carry.conv.done | carry.aborted
        s = (scores[i] if scores is not None else
             torch.rand(_num_tokens(model), generator=generator, device=model.device))
        rgb, depth = observe(scene, cam, carry.position, carry.quat)
        step = servo_step(net, model, goal_desc, rgb, depth, carry.ema, carry.prev_v_c, scores=s)
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
        carry = _select(frozen, carry, new)
        # the recorded errors follow the frozen pose, not the phantom step above
        rec_et, rec_er = pose_errors(carry.position, carry.quat, desired_position, desired_quat)
        ys.append({"position": carry.position, "quat": carry.quat,
                   "v_c": torch.where(frozen, zeros6, step.v_c),
                   "twist": torch.where(frozen, zeros6, step.body_twist),
                   "err": torch.stack([rec_et, rec_er]), "active": ~frozen})
    return carry, {k: torch.stack([y[k] for y in ys]) for k in ys[0]}


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
                    start_quat, generator: torch.Generator | None = None,
                    scores: torch.Tensor | None = None, num_steps: int | None = None,
                    ) -> EpisodeResult:
    """One episode of ``num_steps`` (default ``max_iterations``) steps to the
    reference's goal pose, as one segment."""
    desired_p, desired_q = goal_pose(model.device)
    carry0 = episode_init(start_position, start_quat, desired_p, desired_q)
    carry, ys = rollout_segment(net, model, scene, goal_desc, carry0,
                                num_steps or model.cfg.max_iterations, desired_p, desired_q,
                                generator=generator, scores=scores)
    return finalize_episode(carry, ys, desired_p, desired_q)


@torch.inference_mode()
def find_best_start_pose(net, model: ServoModel, scene: Scene, goal_desc, position, quat,
                         generator: torch.Generator | None = None,
                         scores: torch.Tensor | None = None,
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Rotation compensation: the optical-axis spin whose matches score the
    highest mean similarity (first on ties).  ``scores``: (A, t) injected
    pair scores, else drawn from ``generator`` on the model's device.
    Returns (position, best quat)."""
    dev = model.device
    position, quat = _f32(position, dev), _f32(quat, dev)
    angles = torch.tensor(SEARCH_ANGLES_DEG, dtype=torch.float32, device=dev) * (math.pi / 180.0)
    quats = se3.rotate_about_body_x(quat, angles)                          # (A, 4)
    frames = torch.stack([observe(scene, model.camera, position, q)[0] for q in quats])
    descs = batch_descriptors(net, model, frames)                          # (A, t, d)
    if scores is None:
        scores = torch.rand((len(SEARCH_ANGLES_DEG), _num_tokens(model)), generator=generator,
                            device=dev)
    mean_sims = []
    for desc, s in zip(descs, scores.to(dev)):
        m = find_correspondences(goal_desc, desc, model.grid(), SEARCH_PAIRS, s,
                                 use_kernel=model.use_kernels and not model.quantized,
                                 use_match_kernel=model.use_match_kernel)
        total = torch.where(m.valid, m.sim, torch.zeros_like(m.sim)).sum()
        mean = total / torch.clamp(m.num_valid, min=1)
        mean_sims.append(torch.where(m.num_valid > 0, mean, torch.full_like(mean, -math.inf)))
    return position, quats[torch.stack(mean_sims).argmax()]
