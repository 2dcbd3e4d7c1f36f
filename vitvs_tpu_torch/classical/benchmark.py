"""The classical benchmark driver (``vitvs_tpu/classical/benchmark.py``),
the reference's ``ibvs_standard.py main()``: the seed-41 start poses, no
rotation-compensation search (the classical controller starts from the
sampled pose), the 5x divergence abort checked every step, and the same
22-array npz with the method in its name.

A chunk of episodes runs a step at a time as in ``harness/benchmark.py``:
one render, one feature extraction and one batched match against the goal's
features a step.  No ViT is built and no pair scores are drawn.  Each
episode's perturbed texture comes from its ABSOLUTE index (seed
``(perturb_seed << 32) + i``), so results do not depend on ``chunk``, on
resuming, or on which ``episode_indices`` run.
"""

from __future__ import annotations

import dataclasses
import hashlib
import time
from typing import Callable

import numpy as np
import torch

from vitvs_tpu_torch.classical.pipeline import (DEFAULT_MAX_CORNERS, classical_servo_step,
                                                extract_goal_features)
from vitvs_tpu_torch.harness import chunks, evals, results, samplers
from vitvs_tpu_torch.harness.benchmark import BenchmarkRun, ChunkRow, _run_chunk
from vitvs_tpu_torch.harness.pipeline import ServoModel
from vitvs_tpu_torch.harness.rollout import EpisodeResult, goal_pose
from vitvs_tpu_torch.io_bridge.config import VSConfig
from vitvs_tpu_torch.sim.env import observe
from vitvs_tpu_torch.sim.scene import Scene, load_poster_scene

# steps between the host's checks whether every episode of a chunk is frozen
SEGMENT_STEPS = 64


def classical_model(cfg: VSConfig, device="cuda") -> ServoModel:
    """The classical controller's model: ``cfg`` with the classical abort
    (5x divergence, checked every step), f32, on ``device``.  Its ViT
    configuration is never built into a network."""
    cfg = cfg.replace(divergence_multiplier=5.0, early_divergence_abort=True)
    model = ServoModel.create(cfg.replace(model_name="dinov2_vits14"),
                              compute_dtype=torch.float32, device=device)
    return dataclasses.replace(model, cfg=cfg)


def run_classical_benchmark(
    cfg: VSConfig,
    scene: Scene | None = None,
    out_dir: str = ".",
    config_name: str = "config",
    method: str = "sift",
    perturbation: bool = False,
    chunk: int = 8,
    num_steps: int | None = None,
    max_corners: int | None = None,
    seed: int = 41,
    perturb_seed: int = 489,
    save: bool = True,
    verbose: bool = True,
    checkpoint_path: str | None = None,
    episode_indices=None,
    device="cuda",
    on_step: Callable | None = None,
) -> BenchmarkRun:
    """The classical benchmark of ``method`` ('sift', 'orb', 'akaze' or
    'harris') on ``scene`` (the poster scene when None).

    ``max_corners`` defaults to the method's (1152 SIFT, 1000 ORB, 512
    otherwise).  ``checkpoint_path``: completed episodes are pickled after
    every chunk, and a run with the same path and run identity continues
    from the first missing chunk.  ``episode_indices`` runs episodes by
    their ABSOLUTE index in the seed-41 stream.  ``on_step(abs_ids, inputs,
    result)`` as ``harness/benchmark.run_benchmark``'s (``inputs.scores``
    None).  Returns a ``BenchmarkRun`` without a network."""
    t_start = time.time()
    model = classical_model(cfg, device)
    cfg, dev = model.cfg, model.device
    scene = scene or load_poster_scene(device=dev)
    if max_corners is None:
        max_corners = DEFAULT_MAX_CORNERS[method]

    positions, quats, n = samplers.generate_episode_starts(cfg, seed=seed)
    abs_idx = np.arange(n)
    if episode_indices is not None:
        abs_idx = np.asarray(sorted(set(int(i) for i in episode_indices)))
        if abs_idx.size == 0 or abs_idx[0] < 0 or abs_idx[-1] >= n:
            raise ValueError(f"episode_indices must be within [0, {n})")
        positions, quats = positions[abs_idx], quats[abs_idx]
        n = len(abs_idx)

    goal_rgb, _ = observe(scene, model.camera, *goal_pose(dev))
    goal_feats = extract_goal_features(model, goal_rgb, max_corners, method)
    textures_for = (chunks.make_textures_for(perturb_seed, scene.texture)
                    if perturbation else None)

    def step_fn(rgb, depth, ema, prev_v_c, scores):
        return classical_servo_step(model, goal_feats, rgb, depth, ema, prev_v_c,
                                    max_corners, method)

    # the run's identity: the reference's fields, the episodes and their starts
    T = num_steps or cfg.max_iterations
    starts = hashlib.sha256(np.ascontiguousarray(positions, np.float64).tobytes()
                            + np.ascontiguousarray(quats, np.float64).tobytes()).hexdigest()
    ckpt_meta = dict(kind="classical", impl="vitvs_tpu_torch", method=method, n=int(n),
                     seed=int(seed), perturbation=bool(perturbation),
                     perturb_seed=int(perturb_seed), max_corners=int(max_corners), T=int(T),
                     abs_idx=tuple(int(i) for i in abs_idx), starts=starts)
    episodes, _ = chunks.load_episodes(checkpoint_path, f"bench:{method}", verbose,
                                       meta=ckpt_meta)

    chunk = max(1, min(chunk, n))
    seg = min(SEGMENT_STEPS, T)

    def chunk_of(a: np.ndarray, lo: int, hi: int) -> np.ndarray:
        return chunks.pad_tail(np.asarray(a[lo:hi]), chunk - (hi - lo))

    device_steps = chunk_steps = 0
    for lo in range(len(episodes), n, chunk):
        hi = min(lo + chunk, n)
        ids = chunk_of(abs_idx, lo, hi)
        sc = scene if textures_for is None else scene.with_texture(torch.stack(textures_for(ids)))
        hook = None if on_step is None else (
            lambda inputs, res, ids=ids: on_step(ids, inputs, res))
        res, steps = _run_chunk([ChunkRow(None, model, sc, None, hook)],
                                chunk_of(positions, lo, hi), chunk_of(quats, lo, hi), None, T,
                                seg, step_fn=step_fn)
        episodes.extend(EpisodeResult(*(np.array(a[j]) for a in res)) for j in range(hi - lo))
        device_steps += (hi - lo) * steps
        chunk_steps += steps
        chunks.save_episodes(checkpoint_path, episodes, meta=ckpt_meta)
        if verbose:
            done = sum(bool(e.converged) for e in episodes)
            print(f"[bench:{method}] episodes {hi}/{n}; converged: {done}")

    total_time = time.time() - t_start
    summaries = results.episode_summaries(episodes, positions, quats)
    path = None
    if save:
        path = results.save_results(out_dir, summaries, total_time, config_name=config_name,
                                    method=method, perturbed=perturbation)
    stats = evals.convergence_stats({**{k: np.asarray(v, dtype=object) if isinstance(v, list)
                                        else v for k, v in summaries.items()},
                                     "total_execution_time": total_time})
    return BenchmarkRun(stats, path, summaries, device_steps, chunk_steps, None, model)
