"""Convergence / stopping ladder as carried tensor state
(``vitvs_tpu/control/convergence.py``, the reference's
``is_visual_servoing_done``).

* a hard minimum of ``min_iterations``;
* divergence when the translation error exceeds ``divergence_multiplier`` x
  the initial one;
* converged when BOTH errors dropped by 90%; the absolute test compares the
  centimetre error against 0.01, as the reference does, and is kept but
  unused (every stop path returns the 90% test);
* the velocity-trend stop over the last 200 commands, a ring read in
  chronological order and split into two 100-sample windows;
* the max-iteration stop.

Once done the state freezes.  Every value is a tensor on the episode's
device and every decision a select, so a step never waits for the device.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from vitvs_tpu_torch.io_bridge.config import VSConfig

WINDOW = 200  # two 100-sample windows (the reference's literal)


class ConvergenceState(NamedTuple):
    iteration: torch.Tensor          # () int32, count AFTER the current step
    initial_err_trans: torch.Tensor  # () cm
    initial_err_rot: torch.Tensor    # () deg
    vel_buffer: torch.Tensor         # (WINDOW, 6) ring of v_c
    vel_count: torch.Tensor          # () int32 total writes
    done: torch.Tensor               # () bool
    converged: torch.Tensor          # () bool


def convergence_init(initial_err_trans_cm: torch.Tensor,
                     initial_err_rot_deg: torch.Tensor) -> ConvergenceState:
    dev = initial_err_trans_cm.device
    zero_i = torch.zeros((), dtype=torch.int32, device=dev)
    false = torch.zeros((), dtype=torch.bool, device=dev)
    return ConvergenceState(
        iteration=zero_i,
        initial_err_trans=initial_err_trans_cm.to(torch.float32),
        initial_err_rot=initial_err_rot_deg.to(torch.float32),
        vel_buffer=torch.zeros((WINDOW, 6), dtype=torch.float32, device=dev),
        vel_count=zero_i,
        done=false,
        converged=false,
    )


def _window_means(buffer: torch.Tensor, count: torch.Tensor):
    """Means of ||v_trans|| (mm/s) and ||v_rot|| (deg/s) over the two
    chronological 100-sample halves of the ring (oldest sample first)."""
    start = count % WINDOW      # the next write position holds the oldest sample
    chron = buffer[(torch.arange(WINDOW, device=buffer.device) + start) % WINDOW]

    def stats(win):
        trans = torch.linalg.vector_norm(win[:, :3] * 1000.0, dim=1)
        rot = torch.linalg.vector_norm(win[:, 3:] * (180.0 / math.pi), dim=1)
        return trans.mean(), rot.mean()

    return stats(chron[: WINDOW // 2]), stats(chron[WINDOW // 2:])


def convergence_step(state: ConvergenceState, v_c: torch.Tensor, err_trans_cm: torch.Tensor,
                     err_rot_deg: torch.Tensor, cfg: VSConfig,
                     update_velocity: torch.Tensor | bool = True) -> ConvergenceState:
    """One servo iteration's bookkeeping and stop decision, called after the
    smoothed command and the current ground-truth errors.
    ``update_velocity=False`` is a feature-failure iteration: the command is
    not appended to the history, the iteration still counts."""
    update = torch.as_tensor(update_velocity, device=v_c.device)
    slot = torch.arange(WINDOW, device=v_c.device)[:, None] == (state.vel_count % WINDOW)
    vel_buffer = torch.where(slot & update, v_c.to(torch.float32), state.vel_buffer)
    vel_count = state.vel_count + update.to(torch.int32)
    iteration = state.iteration + 1
    e0t, e0r = state.initial_err_trans, state.initial_err_rot

    past_min = iteration >= cfg.min_iterations
    diverged = err_trans_cm > cfg.divergence_multiplier * e0t
    error_reduced_90 = ((err_trans_cm / e0t) < 0.1) & ((err_rot_deg / e0r) < 0.1)
    # the reference's absolute test (cm against 0.01): kept, and on no stop path
    _error_below_abs = (err_trans_cm < 0.01) & (err_rot_deg < 1.0)

    (f_t, f_r), (s_t, s_r) = _window_means(vel_buffer, vel_count)
    trend_stop = ((vel_count >= WINDOW) & (f_t < 1.0) & (f_r < 0.1) & (s_t > f_t)
                  & (s_r > f_r))
    max_iter = iteration >= cfg.max_iterations

    done = past_min & (diverged | trend_stop | max_iter)
    converged = past_min & ~diverged & (trend_stop | max_iter) & error_reduced_90
    new = ConvergenceState(iteration, e0t, e0r, vel_buffer, vel_count, done, converged)
    return ConvergenceState(*(torch.where(state.done, old, nw) for old, nw in zip(state, new)))
