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
import os
import time
from typing import Callable, NamedTuple

import numpy as np
import torch

from vitvs_tpu_torch.core.batch import item
from vitvs_tpu_torch.harness import chunks, evals, results, samplers, viz
from vitvs_tpu_torch.harness.pipeline import (ServoModel, goal_descriptors, quantized_vit,
                                              servo_step)
from vitvs_tpu_torch.harness.rollout import (EpisodeResult, episode_init, finalize_episode,
                                             find_best_start_pose, goal_pose, rollout_segment)
from vitvs_tpu_torch.io_bridge.config import VSConfig
from vitvs_tpu_torch.io_bridge.images import save_image
from vitvs_tpu_torch.models.baselines import init_pixel_params, is_pixel_model
from vitvs_tpu_torch.models.quant import QuantViT
from vitvs_tpu_torch.models.vit import ViT, init_vit
from vitvs_tpu_torch.parallel.mesh import row_models, row_slices, shard_vit_params, to_device
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
    random weights (``seed``) with the blocks in the compute dtype (a pixel
    baseline's weights: ``init_pixel_params``).  The compute dtype is bf16
    whatever ``cfg.compute_dtype`` says, as the reference's ``build_model``
    builds it; an explicit ``compute_dtype`` wins."""
    model = ServoModel.create(cfg, compute_dtype=compute_dtype, device=device)
    if net is None:
        gen = torch.Generator().manual_seed(seed)
        net = (init_pixel_params(model.vit, gen, device=device) if is_pixel_model(cfg.model_name)
               else init_vit(model.vit, gen, device=device))
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
    benchmark's ``quantized=True``): 'nomax3' attention (which relu / sqrelu
    scores supersede, calibrated through them), the conv patch embedding,
    the 'default' preprocess resize, W8A8 weights quantized from ``net``'s
    float weights; with ``calib_poses`` ((N, 3), (N, 4)) static activation
    scales calibrated on the scene's views from those poses."""
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


class ChunkRow(NamedTuple):
    """One dp row's share of a chunk (``parallel/mesh.py``): its net, model,
    scene and goal descriptors on its device, and its ``on_step`` hook."""

    net: object
    model: ServoModel
    scene: Scene
    goal_desc: object
    on_step: Callable | None = None


def _run_chunk(rows: list[ChunkRow], start_p, start_q, generators: list | None, T: int,
               seg: int, step_fn=None, after_segment=None):
    """A chunk of episodes from starts (B, 3) / (B, 4) in segments of
    ``seg`` steps (the last one clamped), over ``rows``: one for a device,
    or a mesh's dp rows, each running its consecutive share of the episodes,
    segment by segment in lockstep.  At a segment's end one host sync asks
    whether every episode of the chunk is frozen (done or aborted); if so,
    the rest of their histories are the frozen tail.  ``step_fn`` replaces
    the servo step and draws no pair scores (``generators`` then None).
    ``after_segment(row, carry, steps done)`` sees row 0's carry after each
    segment.  Returns (the chunk's result as numpy arrays with a leading B,
    in episode order, the chunk-steps run on the device)."""
    shares = row_slices(len(start_p), len(rows))
    desired = [goal_pose(row.model.device) for row in rows]
    carries = [episode_init(start_p[sl], start_q[sl], *d) for sl, d in zip(shares, desired)]
    parts = [[] for _ in rows]
    done = steps = 0
    while done < T:
        nsteps = min(seg, T - done)
        for r, (row, sl) in enumerate(zip(rows, shares)):
            carries[r], ys = rollout_segment(
                row.net, row.model, row.scene, row.goal_desc, carries[r], nsteps, *desired[r],
                generator=None if generators is None else generators[sl],
                on_step=row.on_step, step_fn=step_fn, draw_scores=step_fn is None)
            parts[r].append(ys)
        done += nsteps
        steps += nsteps
        if after_segment is not None:
            after_segment(rows[0], carries[0], done)
        if done < T and all(bool((c.conv.done | c.aborted).all()) for c in carries):
            for part in parts:
                part.append(chunks.frozen_tail(part[-1], T - done))
            done = T
    out = []
    for carry, part, d in zip(carries, parts, desired):
        full = {k: torch.cat([p[k] for p in part], dim=1) for k in part[0]}
        out.append([a.cpu().numpy() for a in finalize_episode(carry, full, *d)])
    return EpisodeResult(*(np.concatenate(a) for a in zip(*out))), steps


def _clone(gen: torch.Generator) -> torch.Generator:
    """A generator in ``gen``'s state, so that drawing from it leaves
    ``gen`` where it was."""
    twin = torch.Generator(device=gen.device)
    twin.set_state(gen.get_state())
    return twin


def live_snapshot(row: ChunkRow, carry, generator: torch.Generator | None, live_dir: str,
                  name: str) -> str:
    """The live channel's frame: episode 0 of ``carry`` (a row's, with a
    leading B) rendered at its pose, its servo step (pair scores drawn from a
    clone of its ``generator``, the draws its next step makes, so the
    episode's own stream does not move) and the matched points drawn on the
    frame (current green, goal red), written to ``live_dir/name`` as a PNG,
    with ``latest.png`` a symlink to it."""
    model, scene = row.model, row.scene
    if scene.texture.ndim == 4:                         # the chunk's textures: episode 0's
        scene = scene._replace(texture=scene.texture[0], quad=scene.quad[0])
    rgb, depth = observe(scene, model.camera, carry.position[0], carry.quat[0])
    scores = None
    if generator is not None:
        gh, gw = model.grid()
        scores = torch.rand(gh * gw, generator=_clone(generator), device=model.device)
    res = servo_step(row.net, model, row.goal_desc, rgb, depth, item(carry.ema, 0),
                     carry.prev_v_c[0], scores=scores)
    valid = res.valid.cpu().numpy()
    img = viz.draw_points(np.clip(rgb.float().cpu().numpy(), 0.0, 1.0),
                          res.s_uv.cpu().numpy()[valid], res.s_uv_star.cpu().numpy()[valid])
    os.makedirs(live_dir, exist_ok=True)
    path = os.path.join(live_dir, name)
    save_image(path, img)
    tmp = os.path.join(live_dir, ".latest.tmp")
    if os.path.lexists(tmp):
        os.unlink(tmp)
    os.symlink(name, tmp)
    os.replace(tmp, os.path.join(live_dir, "latest.png"))
    return path


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
    live_every: int = 1,
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
    ``rollout.StepInputs`` and ``StepResult``, each with a leading B (under
    a mesh, each dp row's share).
    ``quantized`` (and ``int8_static``): the int8 serving configuration of
    the module docstring, quantized from ``net``; a model that is already
    quantized runs its ``QuantViT`` ``net`` as given.

    ``mesh`` (``parallel.make_mesh``): ``chunk`` is rounded to a multiple of
    dp, each chunk's episodes split into dp consecutive shares run on their
    rows' devices (the ViT split over each row's tp devices when tp > 1,
    the int8 serving ViT too, quantized and calibrated unsplit first), the
    goal descriptors computed on row 0 and copied to every row; the results
    gathered in episode order.  Each episode's generators live on its row's
    device and are seeded from its absolute index, so a dp-only mesh gives
    the one-device results (bit for bit on the CPU); the float ViT's tp
    split sums partial products in another order (float tolerance), the
    int8 ViT's sums int32 accumulators (the one-device results, bit for bit
    on the CPU).

    ``live_dir``: every ``live_every`` rollout segments (counted over the
    run) the first episode of the current chunk is snapshotted
    (:func:`live_snapshot`) to ``live_dir/ep{abs_idx:04d}_step{t:05d}.png``
    with ``latest.png`` a symlink to the newest; the results are those of a
    run without it."""
    t_start = time.time()
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
    nets, models = [net], [model]
    if mesh is not None:
        nets = shard_vit_params(net, mesh)
        models = row_models(model, mesh)
        net = nets[0]
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
    goal_desc = goal_descriptors(net, models[0], to_device(goal_rgb, models[0].device))
    goals = {m.device: to_device(goal_desc, m.device) for m in models}
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
        quantized=bool(model.quantized), int8_static=bool(int8_static),
        fast_binned_match=bool(model.fast_binned_match))
    episodes, ckpt_extra = chunks.load_episodes(checkpoint_path, "bench", verbose,
                                                meta=ckpt_meta)

    chunk = max(1, min(chunk, n))
    if mesh is not None:
        n_dp = mesh.shape["dp"]
        chunk = max(chunk, n_dp) // n_dp * n_dp            # a whole share for every row

    def chunk_of(a: np.ndarray, lo: int, hi: int) -> np.ndarray:
        return chunks.pad_tail(np.asarray(a[lo:hi]), chunk - (hi - lo))

    def chunk_scene(ids) -> Scene:
        if textures_for is None:
            return scene
        return scene.with_texture(torch.stack(textures_for(ids)))

    def chunk_rows(ids, hook=None) -> list[ChunkRow]:
        """The chunk's dp rows: row r's share of the episodes (and of the
        textures) on its device."""
        sc = chunk_scene(ids)
        rows = []
        for rnet, rmodel, sl in zip(nets, models, row_slices(len(ids), len(models))):
            rsc = sc if sc.texture.ndim == 3 else sc._replace(texture=sc.texture[sl],
                                                              quad=sc.quad[sl])
            rhook = None if hook is None else (
                lambda inputs, res, ids=ids[sl]: hook(ids, inputs, res))
            rows.append(ChunkRow(rnet, rmodel, to_device(rsc, rmodel.device),
                                 goals[rmodel.device], rhook))
        return rows

    def generators(ids, base: int = 0) -> list[torch.Generator]:
        """Each episode's generator on its row's device, seeded base + its index."""
        shares = row_slices(len(ids), len(models))
        return [_generator(m.device, base + i) for m, sl in zip(models, shares) for i in ids[sl]]

    best_quats = np.asarray(quats, np.float32)
    if rotation_search and "best_quats" in ckpt_extra:
        best_quats = np.asarray(ckpt_extra["best_quats"], np.float32)
    elif rotation_search:
        found = []
        for lo in range(0, n, chunk):
            hi = min(lo + chunk, n)
            ids = chunk_of(abs_idx, lo, hi)
            gens = generators(ids, SEARCH_SEED_BASE)
            pos, qs = chunk_of(positions, lo, hi), chunk_of(best_quats, lo, hi)
            q = [find_best_start_pose(row.net, row.model, row.scene, row.goal_desc, pos[sl],
                                      qs[sl], generator=gens[sl])[1].cpu()
                 for row, sl in zip(chunk_rows(ids), row_slices(len(ids), len(models)))]
            found.append(torch.cat(q)[: hi - lo])
        best_quats = torch.cat(found).numpy()
        chunks.save_episodes(checkpoint_path, episodes, meta=ckpt_meta,
                             extra={"best_quats": best_quats})

    seg = max(1, min(segment_steps or T, T))
    live_segments = 0

    def snapshot(row: ChunkRow, carry, steps_done: int, abs_ep: int, gen) -> None:
        nonlocal live_segments
        live_segments += 1
        if live_segments % max(live_every, 1) == 0:
            live_snapshot(row, carry, gen, live_dir, f"ep{abs_ep:04d}_step{steps_done:05d}.png")

    device_steps = chunk_steps = 0
    for lo in range(len(episodes), n, chunk):
        hi = min(lo + chunk, n)
        ids = chunk_of(abs_idx, lo, hi)
        gens = generators(ids)
        after = None if live_dir is None else (
            lambda row, carry, t, ep=int(ids[0]), g=gens[0]: snapshot(row, carry, t, ep, g))
        res, steps = _run_chunk(chunk_rows(ids, on_step), chunk_of(positions, lo, hi),
                                chunk_of(best_quats, lo, hi), gens, T, seg, after_segment=after)
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
