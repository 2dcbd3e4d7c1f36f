"""The 500-episode benchmark (``vitvs_tpu/harness/benchmark.py``), the
reference's ``main()`` and its Gazebo orchestration, on one device.

  1. start poses from the legacy seed-41 stream (identical poses);
  2. the goal view rendered at the goal pose, then its descriptors;
  3. optionally, per-episode perturbed textures (seed 489);
  4. the rotation-compensation search, a chunk of episodes at a time (its
     4 x chunk views in one forward and one matcher launch);
  5. rollouts of a chunk at a time in segments, to convergence, abort or
     ``num_steps``;
  6. the reference's 22-array npz and the convergence statistics.

``chunk`` episodes run together, as the reference's vmapped chunk: each
step of a chunk is one render, one ViT forward, one matcher launch (one
int8 product when quantized) and one batched solve; the last chunk is
padded by repeating its last episode.

``quantized=True`` runs the JAX package's int8 serving configuration, the
graph its ``bench.py`` times: W8A8 projections quantized from the float
master weights, 'nomax3' attention, the conv patch embedding, the
'default' (one TF32 pass) preprocess resize and source-quantized bins;
``int8_static`` adds static activation scales calibrated on the port's
renders of the goal view and the first min(7, n) start views of the full
seed-41 stream (so a replayed subset serves the full sweep's scales).
Each random stream is a ``torch.Generator`` of the model's device seeded
from the ABSOLUTE episode index, as the JAX benchmark derives its keys (the
search ``1000 + i``, the rollout ``i``, the texture ``(perturb_seed << 32)
+ i``), and each episode draws its own: results do not depend on
``chunk`` (bit for bit on the CPU; on the card GEMMs of another batch may
round otherwise), on resuming, or on which ``episode_indices`` run.
"""

from __future__ import annotations

import copy
import dataclasses
import hashlib
import time
from typing import Callable, NamedTuple

import numpy as np
import torch

from vitvs_tpu_torch.harness import chunks, evals, results, samplers
from vitvs_tpu_torch.harness.pipeline import ServoModel, goal_descriptors, quantized_vit
from vitvs_tpu_torch.harness.rollout import (EpisodeResult, episode_init, finalize_episode,
                                             find_best_start_pose, goal_pose, rollout_segment)
from vitvs_tpu_torch.io_bridge.config import VSConfig
from vitvs_tpu_torch.models.quant import QuantViT
from vitvs_tpu_torch.models.vit import ViT, init_vit
from vitvs_tpu_torch.sim.env import observe
from vitvs_tpu_torch.sim.scene import Scene, load_poster_scene

SEARCH_SEED_BASE = 1000   # the search's generator of episode i is seeded 1000 + i


class BenchmarkRun(NamedTuple):
    stats: evals.ConvergenceStats
    path: str | None                  # the npz written, or None
    summaries: dict                   # the npz's arrays
    device_steps: int                 # episode-steps of the real episodes run on the device
    chunk_steps: int                  # chunk-steps run on the device (one forward each)
    net: ViT | QuantViT               # the ViT the episodes ran (the cast copy, or the int8 one)
    model: ServoModel                 # and its model


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


def int8_serving(net: ViT, model: ServoModel, scene: Scene, calib_poses=None
                 ) -> tuple[QuantViT, ServoModel]:
    """The int8 serving configuration of ``model`` (the reference
    benchmark's ``quantized=True``): 'nomax3' attention, the conv patch
    embedding, the 'default' preprocess resize, W8A8 weights quantized from
    ``net``'s float weights; with ``calib_poses`` ((N, 3), (N, 4)) static
    activation scales calibrated on the scene's views from those poses."""
    model = dataclasses.replace(
        model, pp_precision="default",
        vit=dataclasses.replace(model.vit, quant_attn="nomax3", patch_embed_impl="conv"))
    calib = None
    if calib_poses is not None:
        p, q = (torch.tensor(np.asarray(a, np.float32), device=model.device)
                for a in calib_poses)
        calib, _ = observe(scene, model.camera, p, q)
    qnet = quantized_vit(net, model, calib)
    return qnet, dataclasses.replace(model, quantized=True)


def _generator(device, seed: int) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    return gen


def _run_chunk(net, model: ServoModel, scene: Scene, goal_desc, start_p, start_q,
               generators: list | None, T: int, seg: int, on_step=None, step_fn=None):
    """A chunk of episodes from starts (B, 3) / (B, 4) in segments of
    ``seg`` steps (the last one clamped).  At a segment's end one host sync
    asks whether every episode of the chunk is frozen (done or aborted); if
    so, the rest of their histories are the frozen tail.  ``step_fn``
    replaces the servo step and draws no pair scores (``generators`` then
    None).  Returns (the chunk's result as numpy arrays with a leading B,
    the chunk-steps run on the device)."""
    desired_p, desired_q = goal_pose(model.device)
    carry = episode_init(start_p, start_q, desired_p, desired_q)
    parts, done, steps = [], 0, 0
    while done < T:
        nsteps = min(seg, T - done)
        carry, ys = rollout_segment(net, model, scene, goal_desc, carry, nsteps, desired_p,
                                    desired_q, generator=generators, on_step=on_step,
                                    step_fn=step_fn, draw_scores=step_fn is None)
        parts.append(ys)
        done += nsteps
        steps += nsteps
        if done < T and bool((carry.conv.done | carry.aborted).all()):
            parts.append(chunks.frozen_tail(ys, T - done))
            done = T
    full = {k: torch.cat([p[k] for p in parts], dim=1) for k in parts[0]}
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
    int8_static: bool = False,
    episode_indices=None,
    live_dir: str | None = None,
    device="cuda",
    on_step: Callable | None = None,
) -> BenchmarkRun:
    """The benchmark of ``cfg`` on ``net`` (seeded random weights when None)
    and ``scene`` (the poster scene when None).

    ``chunk``: episodes run together (at most the number of episodes).
    ``checkpoint_path``: after every chunk the completed results are
    pickled there, and a run with the same path and the same run identity
    continues from the first missing episode (the rotation search's results
    are kept too; ``chunk`` is not part of the identity).
    ``episode_indices`` replays episodes by their ABSOLUTE index in the
    seed-41 stream, identical to the same episodes of the full sweep.
    ``on_step(abs_ids, inputs, result)`` sees every step of a chunk: the
    chunk's absolute episode indices (the padding repeating the last), its
    ``rollout.StepInputs`` and ``StepResult``, each with a leading B.
    ``quantized`` (and ``int8_static``): the int8 serving configuration of
    the module docstring, quantized from ``net``; a model that is already
    quantized runs its ``QuantViT`` ``net`` as given.

    Not ported: ``mesh`` and ``live_dir`` raise."""
    t_start = time.time()
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
    dev = model.device
    scene = scene or build_scene(device=dev)

    positions, quats, n = samplers.generate_episode_starts(cfg, seed=seed)
    if quantized and not model.quantized:
        calib = None
        if int8_static:
            k = min(7, n)
            calib = (np.concatenate([[samplers.DESIRED_POSITION], positions[:k]]),
                     np.concatenate([[samplers.DESIRED_ORIENTATION], quats[:k]]))
        net, model = int8_serving(net, model, scene, calib)
    elif not model.quantized:
        net = cast_for_benchmark(net, model.compute_dtype)
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
        perturb_seed=int(perturb_seed), rotation_search=bool(rotation_search), T=int(T),
        quantized=bool(model.quantized), int8_static=bool(int8_static))
    episodes, ckpt_extra = chunks.load_episodes(checkpoint_path, "bench", verbose,
                                                meta=ckpt_meta)

    chunk = max(1, min(chunk, n))

    def chunk_of(a: np.ndarray, lo: int, hi: int) -> np.ndarray:
        return chunks.pad_tail(np.asarray(a[lo:hi]), chunk - (hi - lo))

    def chunk_scene(ids) -> Scene:
        if textures_for is None:
            return scene
        return scene.with_texture(torch.stack(textures_for(ids)))

    best_quats = np.asarray(quats, np.float32)
    if rotation_search and "best_quats" in ckpt_extra:
        best_quats = np.asarray(ckpt_extra["best_quats"], np.float32)
    elif rotation_search:
        found = []
        for lo in range(0, n, chunk):
            hi = min(lo + chunk, n)
            ids = chunk_of(abs_idx, lo, hi)
            gens = [_generator(dev, SEARCH_SEED_BASE + i) for i in ids]
            _, q = find_best_start_pose(net, model, chunk_scene(ids), goal_desc,
                                        chunk_of(positions, lo, hi), chunk_of(best_quats, lo, hi),
                                        generator=gens)
            found.append(q[: hi - lo])
        best_quats = torch.cat(found).cpu().numpy()
        chunks.save_episodes(checkpoint_path, episodes, meta=ckpt_meta,
                             extra={"best_quats": best_quats})

    seg = max(1, min(segment_steps or T, T))
    device_steps = chunk_steps = 0
    for lo in range(len(episodes), n, chunk):
        hi = min(lo + chunk, n)
        ids = chunk_of(abs_idx, lo, hi)
        hook = None if on_step is None else (
            lambda inputs, res, ids=ids: on_step(ids, inputs, res))
        res, steps = _run_chunk(net, model, chunk_scene(ids), goal_desc,
                                chunk_of(positions, lo, hi), chunk_of(best_quats, lo, hi),
                                [_generator(dev, i) for i in ids], T, seg, hook)
        episodes.extend(EpisodeResult(*(np.array(a[j]) for a in res)) for j in range(hi - lo))
        device_steps += (hi - lo) * steps
        chunk_steps += steps
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
    return BenchmarkRun(stats, path, summaries, device_steps, chunk_steps, net, model)
