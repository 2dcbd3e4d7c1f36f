"""The host I/O bridge (``vitvs_tpu/io_bridge/host_loop.py``): a camera in,
robot twists out.

The reference's boundary is ROS pub/sub; here the device pipeline stays a
plain function and host I/O enters at two points:

* :func:`make_io_servo_step`: one call pulls the latest (rgb, depth) frame,
  runs the servo step on the model's device and pushes the twist (the JAX
  package does this inside its jitted graph with ``io_callback``);
* :class:`ServoLoop`: grabs a frame, runs the step, forwards the twist,
  keeps the reference controller's feature-failure counter and abort, and
  every ``viz_every`` iterations hands the frame with its matched points
  drawn (``harness/viz.draw_points``) to ``viz_sink``.

Frame sources implement ``get_frame() -> (rgb uint8 (H, W, 3), depth_m f32
(H, W))``, as the native sensor bridge's seqlock'd mailbox does
(``io_bridge/native.py:NativeFrameBuffer``); sinks implement
``send_twist(np.ndarray (6,)) -> None``.
"""

from __future__ import annotations

import time
from typing import Callable, Protocol

import numpy as np
import torch

from vitvs_tpu_torch.control.ibvs import EmaState
from vitvs_tpu_torch.harness.pipeline import ServoModel, goal_descriptors, servo_step
from vitvs_tpu_torch.harness.viz import draw_points


class FrameSource(Protocol):
    def get_frame(self) -> tuple[np.ndarray, np.ndarray]: ...


class TwistSink(Protocol):
    def send_twist(self, twist: np.ndarray) -> None: ...


def make_io_servo_step(net, model: ServoModel,
                       get_frame: Callable[[], tuple[np.ndarray, np.ndarray]],
                       send_twist: Callable[[np.ndarray], None]):
    """One function = {pull frame -> servo step -> push twist}.  The goal
    descriptors, EMA, previous command and the pair scores' generator are
    arguments of each call; it returns the step's result."""
    cfg = model.cfg
    h, w = cfg.v_max, cfg.u_max

    def step(goal_desc, ema: EmaState, prev_v_c: torch.Tensor, generator: torch.Generator):
        rgb, depth = get_frame()
        res = servo_step(net, model, goal_desc,
                         np.asarray(rgb, np.uint8).reshape(h, w, 3),
                         np.asarray(depth, np.float32).reshape(h, w), ema, prev_v_c,
                         generator=generator)
        send_twist(res.body_twist.cpu().numpy())
        return res

    return step


class ServoLoop:
    """The host driver, as the reference controller's ``run`` handles I/O."""

    def __init__(self, net, model: ServoModel, goal_rgb, source: FrameSource,
                 sink: TwistSink, seed: int = 0, viz_every: int = 0,
                 viz_sink: Callable[[np.ndarray], None] | None = None):
        """``viz_every`` N > 0: every N iterations whose features are ok, the
        frame with the step's matched points drawn (current green, goal red)
        goes to ``viz_sink(image)`` (the reference's processed-image topic)."""
        self.net = net
        self.viz_every = viz_every
        self.viz_sink = viz_sink
        self.model = model
        self.source = source
        self.sink = sink
        self.goal_rgb = np.asarray(goal_rgb)
        self.goal_desc = goal_descriptors(net, model, self.goal_rgb)
        self.generator = torch.Generator(device=model.device)
        self.generator.manual_seed(seed)
        self.reset()

    def reset(self):
        dev = self.model.device
        self.ema = EmaState.init(device=dev)
        self.prev_v = torch.zeros(6, device=dev)
        self.fail_count = 0
        self.iteration = 0

    def iterate(self) -> dict:
        rgb, depth = self.source.get_frame()
        t0 = time.perf_counter()
        res = servo_step(self.net, self.model, self.goal_desc, np.asarray(rgb),
                         np.asarray(depth, np.float32), self.ema, self.prev_v,
                         generator=self.generator)
        twist = res.body_twist.cpu().numpy()
        dt = time.perf_counter() - t0

        ok = bool(res.feature_ok)
        self.fail_count = 0 if ok else self.fail_count + 1
        if self.fail_count >= self.model.cfg.max_feature_failures:
            # the reference: RuntimeError('Persistent feature detection failure')
            raise RuntimeError("Persistent feature detection failure")

        self.sink.send_twist(twist)
        if self.viz_every and self.iteration % self.viz_every == 0 and ok:
            valid = res.valid.cpu().numpy()
            img = draw_points(np.asarray(rgb), res.s_uv.cpu().numpy()[valid],
                              res.s_uv_star.cpu().numpy()[valid])
            if self.viz_sink is not None:
                self.viz_sink(img)
        self.ema = res.ema
        self.prev_v = res.v_c
        self.iteration += 1
        return {
            "iteration": self.iteration,
            "v_c": res.v_c.cpu().numpy(),
            "twist": twist,
            "feature_ok": ok,
            "num_valid": int(res.num_valid),
            "mean_sim": float(res.mean_sim),
            "step_time_s": dt,
        }

    def run(self, max_iterations: int | None = None,
            should_stop: Callable[[dict], bool] | None = None):
        max_it = max_iterations or self.model.cfg.max_iterations
        infos = []
        for _ in range(max_it):
            info = self.iterate()
            infos.append(info)
            if should_stop and should_stop(info):
                break
        return infos
