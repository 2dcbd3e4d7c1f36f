"""The 500-episode benchmark (``vitvs_tpu/harness/benchmark.py``), the
reference's ``main()`` and its Gazebo orchestration, on one device.

  1. start poses from the legacy seed-41 stream (identical poses);
  2. the goal view rendered at the goal pose, then its descriptors;
  3. optionally, per-episode perturbed textures (seed 489);
  4. the rotation-compensation search of each episode (a batched 4-view
     forward);
  5. rollouts in segments, to convergence, abort or ``num_steps``;
  6. the reference's 22-array npz and the convergence statistics.

Episodes run one at a time (B = 1 a step).  Each random stream is a
``torch.Generator`` of the model's device seeded from the ABSOLUTE episode
index, as the JAX benchmark derives its keys (the search ``1000 + i``, the
rollout ``i``, the texture ``(perturb_seed << 32) + i``): results do not
depend on ``chunk``, on resuming, or on which ``episode_indices`` run.
"""

from __future__ import annotations

import copy
import hashlib
import time
from typing import Callable, NamedTuple

import numpy as np
import torch

from vitvs_tpu_torch.harness import chunks, evals, results, samplers
from vitvs_tpu_torch.harness.pipeline import ServoModel, goal_descriptors
from vitvs_tpu_torch.harness.rollout import (EpisodeResult, episode_init, finalize_episode,
                                             find_best_start_pose, goal_pose, rollout_segment)
from vitvs_tpu_torch.io_bridge.config import VSConfig
from vitvs_tpu_torch.models.vit import ViT, init_vit
from vitvs_tpu_torch.sim.env import observe
from vitvs_tpu_torch.sim.scene import Scene, load_poster_scene

SEARCH_SEED_BASE = 1000   # the search's generator of episode i is seeded 1000 + i


class BenchmarkRun(NamedTuple):
    stats: evals.ConvergenceStats
    path: str | None                  # the npz written, or None
    summaries: dict                   # the npz's arrays
    device_steps: int                 # servo steps run on the device (all episodes)


def build_model(cfg: VSConfig, net: ViT | None = None, compute_dtype=torch.bfloat16,
                seed: int = 0, device="cuda") -> tuple[ViT, ServoModel]:
    """The servo model of ``cfg`` and a ViT for it: ``net``, or seeded
    random weights (``seed``) with the blocks in the compute dtype.  The
    compute dtype is bf16 whatever ``cfg.compute_dtype`` says, as the
    reference's ``build_model`` builds it; an explicit ``compute_dtype``
    wins."""
    model = ServoModel.create(cfg, compute_dtype=compute_dtype, device=device)
    if net is None:
        net = init_vit(model.vit, torch.Generator().manual_seed(seed), device=device)
        net = net.cast_blocks(model.compute_dtype).eval()
    return net, model


def build_scene(texture: np.ndarray | None = None, half_size=None, device="cuda") -> Scene:
    """The reference's benchmark scene (its poster on its 0.8 x 0.6 m mesh),
    or a custom texture on a square poster of ``half_size`` (default 0.42)."""
    if texture is None:
        if half_size is not None:
            raise ValueError("half_size requires a texture: the poster scene has the "
                             "reference mesh's fixed size")
        return load_poster_scene(device=device)
    return Scene.create(texture, half_size=0.42 if half_size is None else half_size,
                        device=device)


def cast_for_benchmark(net: ViT, dtype: torch.dtype) -> ViT:
    """A copy of ``net`` with EVERY parameter in ``dtype``, the patch
    embedding, cls and pos embeddings included, as the JAX benchmark casts
    its parameters before the rollouts (its bf16 patch matmul); the servo
    step alone keeps the embedding in f32."""
    return copy.deepcopy(net).to(dtype)


def _generator(device, seed: int) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    return gen


def _run_episode(net, model: ServoModel, scene: Scene, goal_desc, start_p, start_q,
                 generator: torch.Generator, T: int, seg: int, on_step=None):
    """One episode in segments of ``seg`` steps (the last one clamped).  At a
    segment's end one host sync asks whether the episode is frozen; if so,
    the rest of its histories are the frozen tail.  Returns (the result as
    numpy arrays, the steps run on the device)."""
    desired_p, desired_q = goal_pose(model.device)
    carry = episode_init(start_p, start_q, desired_p, desired_q)
    parts, done, steps = [], 0, 0
    while done < T:
        nsteps = min(seg, T - done)
        carry, ys = rollout_segment(net, model, scene, goal_desc, carry, nsteps, desired_p,
                                    desired_q, generator=generator, on_step=on_step)
        parts.append(ys)
        done += nsteps
        steps += nsteps
        if done < T and bool(carry.conv.done | carry.aborted):
            parts.append(chunks.frozen_tail(ys, T - done))
            done = T
    full = {k: torch.cat([p[k] for p in parts]) for k in parts[0]}
    res = finalize_episode(carry, full, desired_p, desired_q)
    return EpisodeResult(*(a.cpu().numpy() for a in res)), steps


def run_benchmark(
    cfg: VSConfig,
    net: ViT | None = None,
    model: ServoModel | None = None,
    scene: Scene | None = None,
    out_dir: str = ".",
    config_name: str = "config",
    perturbation: bool = False,
    rotation_search: bool = True,
    chunk: int = 8,
    num_steps: int | None = None,
    segment_steps: int | None = 250,
    seed: int = 41,                      # the reference's seed
    perturb_seed: int = 489,             # the reference's perturbed-model seed
    save: bool = True,
    verbose: bool = True,
    checkpoint_path: str | None = None,
    mesh=None,
    quantized: bool = False,
    episode_indices=None,
    live_dir: str | None = None,
    device="cuda",
    on_step: Callable | None = None,
) -> BenchmarkRun:
    """The benchmark of ``cfg`` on ``net`` (seeded random weights when None)
    and ``scene`` (the poster scene when None).

    ``checkpoint_path``: after every ``chunk`` episodes the completed
    results are pickled there, and a run with the same path and the same
    run identity continues from the first missing episode (the rotation
    search's results are kept too).  ``episode_indices`` replays episodes
    by their ABSOLUTE index in the seed-41 stream, identical to the same
    episodes of the full sweep.  ``on_step(abs_idx, inputs, result)`` sees
    every rollout step (``rollout.StepInputs``, ``StepResult``).

    Not ported: ``quantized`` (the int8 closed loop runs
    ``quant_attn='nomax3'``), ``mesh`` and ``live_dir`` raise."""
    t_start = time.time()
    if quantized or (model is not None and model.quantized):
        raise NotImplementedError("the int8 closed loop needs quant_attn='nomax3' "
                                  "(ROADMAP.md queue 1, item 3)")
    if mesh is not None:
        raise NotImplementedError("sharding the sweep over a mesh is not ported "
                                  "(ROADMAP.md queue 1, item 8)")
    if live_dir is not None:
        raise NotImplementedError("the live channel needs harness/viz.py, not ported "
                                  "(ROADMAP.md queue 1, item 1)")
    if model is None:
        net, model = build_model(cfg, net, device=device)
    if net is None:
        raise ValueError("pass the ViT when supplying a prebuilt model")
    net = cast_for_benchmark(net, model.compute_dtype)
    dev = model.device
    scene = scene or build_scene(device=dev)

    positions, quats, n = samplers.generate_episode_starts(cfg, seed=seed)
    abs_idx = np.arange(n)
    if episode_indices is not None:
        abs_idx = np.asarray(sorted(set(int(i) for i in episode_indices)))
        if abs_idx.size == 0 or abs_idx[0] < 0 or abs_idx[-1] >= n:
            raise ValueError(f"episode_indices must be within [0, {n})")
        positions, quats = positions[abs_idx], quats[abs_idx]
        n = len(abs_idx)
    if verbose:
        ap, sp = samplers.pose_error_stats(positions, samplers.DESIRED_POSITION)
        ao, so = samplers.orientation_error_stats(quats, samplers.DESIRED_ORIENTATION)
        print(f"[bench] {n} episodes; initial pos err {ap:.2f}±{sp:.2f} cm, "
              f"rot err {ao:.2f}±{so:.2f} deg")

    # the goal image: the scene rendered from the goal pose
    goal_rgb, _ = observe(scene, model.camera, *goal_pose(dev))
    goal_desc = goal_descriptors(net, model, goal_rgb)
    textures_for = (chunks.make_textures_for(perturb_seed, scene.texture)
                    if perturbation else None)

    def scenes(lo: int, hi: int):
        if textures_for is None:
            return [scene] * (hi - lo)
        return [scene.with_texture(tx) for tx in textures_for(abs_idx[lo:hi])]

    # the run's identity: a checkpoint written by another run refuses to resume
    # (config_name only names the npz, so it is left out).  The start poses
    # are fingerprinted too: they depend on the stream's length (num_samples,
    # num_circles), which the episode indices do not show
    T = num_steps or cfg.max_iterations
    starts = hashlib.sha256(np.ascontiguousarray(positions, np.float64).tobytes()
                            + np.ascontiguousarray(quats, np.float64).tobytes()).hexdigest()
    ckpt_meta = dict(
        kind="dino", impl="vitvs_tpu_torch", model=cfg.model_name,
        size=int(cfg.dino_input_size), layer=int(cfg.layer),
        dtype=str(model.compute_dtype), abs_idx=tuple(int(i) for i in abs_idx),
        starts=starts, seed=int(seed), perturbation=bool(perturbation),
        perturb_seed=int(perturb_seed), rotation_search=bool(rotation_search), T=int(T))
    episodes, ckpt_extra = chunks.load_episodes(checkpoint_path, "bench", verbose,
                                                meta=ckpt_meta)

    best_quats = np.asarray(quats, np.float32)
    if rotation_search and "best_quats" in ckpt_extra:
        best_quats = np.asarray(ckpt_extra["best_quats"], np.float32)
    elif rotation_search:
        found = []
        for lo in range(0, n, chunk):
            hi = min(lo + chunk, n)
            for j, sc in enumerate(scenes(lo, hi)):
                gen = _generator(dev, SEARCH_SEED_BASE + abs_idx[lo + j])
                found.append(find_best_start_pose(net, model, sc, goal_desc, positions[lo + j],
                                                  best_quats[lo + j], generator=gen)[1])
        best_quats = torch.stack(found).cpu().numpy()
        chunks.save_episodes(checkpoint_path, episodes, meta=ckpt_meta,
                             extra={"best_quats": best_quats})

    seg = max(1, min(segment_steps or T, T))
    device_steps = 0
    for lo in range(len(episodes), n, chunk):
        hi = min(lo + chunk, n)
        for j, sc in enumerate(scenes(lo, hi)):
            i = lo + j
            hook = None if on_step is None else (
                lambda inputs, res, a=int(abs_idx[i]): on_step(a, inputs, res))
            res, steps = _run_episode(net, model, sc, goal_desc, positions[i], best_quats[i],
                                      _generator(dev, abs_idx[i]), T, seg, hook)
            episodes.append(res)
            device_steps += steps
        chunks.save_episodes(checkpoint_path, episodes, meta=ckpt_meta,
                             extra={"best_quats": best_quats})
        if verbose:
            done = sum(bool(e.converged) for e in episodes)
            print(f"[bench] episodes {hi}/{n}; converged so far: {done}")

    total_time = time.time() - t_start
    best_poses = [(positions[i], best_quats[i]) for i in range(n)]
    summaries = results.episode_summaries(episodes, positions, quats, best_poses)
    path = None
    if save:
        path = results.save_results(out_dir, summaries, total_time, config_name=config_name,
                                    method="dino" if rotation_search else "dino_no_rot",
                                    perturbed=perturbation)
    stats = evals.convergence_stats({**{k: np.asarray(v, dtype=object) if isinstance(v, list)
                                        else v for k, v in summaries.items()},
                                     "total_execution_time": total_time})
    if verbose:
        print(f"[bench] convergence {stats.convergence_rate:.1f}% "
              f"({stats.num_converged}/{stats.num_samples}) in {total_time:.1f}s")
    return BenchmarkRun(stats, path, summaries, device_steps)
