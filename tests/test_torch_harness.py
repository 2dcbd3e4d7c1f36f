"""The port's run_benchmark on a tiny model on the CPU: the reference's
22-array npz (against vitvs_tpu's writer and evaluator), resume refusing a
foreign checkpoint, replays and chunk sizes that leave results unchanged
(bit for bit), the frozen fast-forward against running the device to the
end and waiting for a chunk's slowest episode, the flags that are not
ported, the port's copy of the poster texture, and the int8 serving
benchmark (``quantized=True, int8_static=True``) against vitvs_tpu's with
JAX's draws injected."""

import os
import pickle
import sys

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_rollout import Pair, make_pair  # noqa: E402

from vitvs_tpu.harness import evals as jevals  # noqa: E402
from vitvs_tpu.harness import results as jresults  # noqa: E402
from vitvs_tpu.io_bridge.images import load_image  # noqa: E402
from vitvs_tpu_torch.harness import evals as tevals  # noqa: E402
from vitvs_tpu_torch.harness.benchmark import run_benchmark  # noqa: E402
from vitvs_tpu_torch.parallel import make_mesh  # noqa: E402
from vitvs_tpu_torch.sim.scene import POSTER_ASSET  # noqa: E402

NPZ_KEYS = {"total_execution_time", "initial_positions", "initial_orientations",
            "final_positions", "final_quaternions", "convergence_flags", "position_errors",
            "orientation_errors", "best_poses", "all_position_histories",
            "all_orientation_histories", "all_iteration_histories", "lowest_position_errors",
            "lowest_orientation_errors", "all_average_velocities", "all_velocity_mean_100",
            "all_velocity_mean_10", "all_applied_velocity_x", "all_applied_velocity_y",
            "all_applied_velocity_z", "all_applied_velocity_roll",
            "all_applied_velocity_pitch", "all_applied_velocity_yaw"}


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """Tiny shapes run thousands of small ops: one intra-op thread each, as
    the suite's parallel workers share the machine's cores (restored after)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bench(pair: Pair, tmp_path, num_samples=2, num_circles=1, **kw):
    cfg = pair.tmodel.cfg.replace(num_samples=num_samples, num_circles=num_circles)
    kw.setdefault("rotation_search", False)
    kw.setdefault("verbose", False)
    kw.setdefault("chunk", 2)
    return run_benchmark(cfg, net=pair.net, model=pair.tmodel, scene=pair.tscene,
                         out_dir=str(tmp_path), device="cpu", **kw)


def _equal(x, y) -> bool:
    """Exact equality through nests of object arrays, tuples and lists."""
    if isinstance(x, (list, tuple)) or (isinstance(x, np.ndarray) and x.dtype == object):
        return len(x) == len(y) and all(_equal(a, b) for a, b in zip(x, y))
    x, y = np.asarray(x), np.asarray(y)
    return x.dtype == y.dtype and x.shape == y.shape and np.array_equal(x, y, equal_nan=True)


def _same(a: dict, b: dict, keys=("convergence_flags", "all_iteration_histories",
                                   "final_positions", "all_position_histories",
                                   "all_applied_velocity_x", "lowest_position_errors")):
    for k in keys:
        assert _equal(a[k], b[k]), k


def test_run_benchmark_writes_the_reference_npz(tmp_path):
    """Rotation search on, 4 episodes in chunks of 3, 6 steps: the npz has
    the 22 arrays (and the run time) of vitvs_tpu's writer fed the same
    episodes, equal, and vitvs_tpu's evaluator reads the same statistics."""
    pair = make_pair(pixel_identity=True, max_iterations=6)
    ckpt = str(tmp_path / "episodes.pkl")
    run = _bench(pair, tmp_path, num_samples=4, num_circles=2, rotation_search=True, chunk=3,
                 num_steps=6, config_name="tiny", checkpoint_path=ckpt)
    assert run.path.endswith("results_tiny_dino_standard.npz") and run.device_steps == 4 * 6
    ours = np.load(run.path, allow_pickle=True)
    assert set(ours.files) == NPZ_KEYS
    with open(ckpt, "rb") as fh:
        episodes = pickle.load(fh)["episodes"]
    best = [tuple(b) for b in run.summaries["best_poses"]]
    ref = jresults.episode_summaries(episodes, ours["initial_positions"],
                                     ours["initial_orientations"], best)
    ref_path = jresults.save_results(str(tmp_path / "ref"), ref,
                                     float(ours["total_execution_time"]), config_name="tiny")
    theirs = np.load(ref_path, allow_pickle=True)
    assert set(theirs.files) == NPZ_KEYS
    for k in sorted(NPZ_KEYS):
        a, b = ours[k], theirs[k]
        assert _equal(a, b), k
    assert ours["all_position_histories"][0].shape[1] == 3
    for fn in ("convergence_stats", "ape", "length_ratio"):      # NaN where none converged
        np.testing.assert_equal(vars(getattr(tevals, fn)(run.path)) if fn == "convergence_stats"
                                else getattr(tevals, fn)(run.path),
                                vars(getattr(jevals, fn)(run.path)) if fn == "convergence_stats"
                                else getattr(jevals, fn)(run.path), err_msg=fn)
    assert run.stats.num_samples == 4


def test_resume_refuses_a_foreign_checkpoint(tmp_path):
    pair = make_pair(pixel_identity=True, max_iterations=4)
    ckpt = str(tmp_path / "episodes.pkl")
    common = dict(num_steps=4, checkpoint_path=ckpt, save=False)
    first = _bench(pair, tmp_path, config_name="a", **common)
    again = _bench(pair, tmp_path, config_name="b", **common)    # another name: resumes
    assert again.device_steps == 0
    _same(first.summaries, again.summaries)
    with pytest.raises(ValueError, match="different run"):
        _bench(pair, tmp_path, config_name="c", episode_indices=[1], **common)
    with pytest.raises(ValueError, match="different run"):
        _bench(pair, tmp_path, config_name="d", **dict(common, num_steps=5))
    # the same episode index of a longer stream starts elsewhere
    with pytest.raises(ValueError, match="different run.*starts"):
        _bench(pair, tmp_path, config_name="e", num_samples=4, episode_indices=[0, 1],
               **common)


def test_episode_replay_equals_the_full_sweep(tmp_path):
    """Perturbed textures and the rotation search on: episodes 1 and 4
    replayed alone equal the same episodes of the 5-episode sweep, bit for bit."""
    pair = make_pair(pixel_identity=True, max_iterations=4)
    common = dict(num_samples=5, perturbation=True, rotation_search=True, num_steps=4,
                  save=False)
    full = _bench(pair, tmp_path, **common).summaries
    replay = _bench(pair, tmp_path, episode_indices=[4, 1], **common).summaries
    sub = {k: [v[i] for i in (1, 4)] for k, v in full.items() if isinstance(v, list)}
    _same(replay, sub, keys=("convergence_flags", "final_positions", "all_position_histories",
                             "all_applied_velocity_yaw", "best_poses"))
    np.testing.assert_array_equal(replay["initial_positions"], full["initial_positions"][[1, 4]])


def test_results_do_not_depend_on_chunk(tmp_path):
    """5 episodes on perturbed textures with the rotation search, at chunk 1,
    2 and 3 (the last chunk padded with its last episode): the same results
    bit for bit, one forward a chunk-step."""
    pair = make_pair(pixel_identity=True, max_iterations=4)
    common = dict(num_samples=5, perturbation=True, rotation_search=True, num_steps=4,
                  save=False)
    runs = {c: _bench(pair, tmp_path, chunk=c, **common) for c in (1, 2, 3)}
    for c in (2, 3):
        _same(runs[1].summaries, runs[c].summaries,
              keys=("convergence_flags", "all_iteration_histories", "final_positions",
                    "final_quaternions", "all_position_histories", "all_applied_velocity_x",
                    "lowest_position_errors", "best_poses"))
    assert [r.device_steps for r in runs.values()] == [5 * 4] * 3
    assert [r.chunk_steps for r in runs.values()] == [5 * 4, 3 * 4, 2 * 4]


def test_chunk_fast_forward_waits_for_its_slowest_episode(tmp_path):
    """Episodes 0 to 4 stop at iterations 13, 20, 20, 20 and 9 (min 3, max
    20) of 30 steps in segments of 3: one chunk of 5 runs 21 chunk-steps on
    the device, until every episode is frozen, then fills the frozen tail;
    alone they run 15 + 3 x 21 + 9 steps.  The results are the same bit for
    bit."""
    pair = make_pair(pixel_identity=True, max_iterations=20, min_iterations=3)
    common = dict(num_samples=5, num_steps=30, segment_steps=3, save=False)
    alone = _bench(pair, tmp_path, chunk=1, **common)
    chunk = _bench(pair, tmp_path, chunk=5, **common)
    assert [int(i) for i in chunk.summaries["all_iteration_histories"]] == [13, 20, 20, 20, 9]
    assert (alone.device_steps, alone.chunk_steps) == (15 + 3 * 21 + 9, 15 + 3 * 21 + 9)
    assert (chunk.device_steps, chunk.chunk_steps) == (5 * 21, 21)
    _same(alone.summaries, chunk.summaries,
          keys=("convergence_flags", "all_iteration_histories", "final_positions",
                "final_quaternions", "position_errors", "lowest_position_errors",
                "all_position_histories", "all_orientation_histories",
                "all_applied_velocity_x", "all_velocity_mean_10"))


def test_frozen_fast_forward_equals_running_the_device(tmp_path):
    """max_iterations 5 freezes the episode at step 5 of 16: segments of 3
    stop the device at step 6 and fill the rest with the frozen tail, equal
    to one segment that runs all 16 steps."""
    pair = make_pair(pixel_identity=True, max_iterations=5)
    common = dict(num_steps=16, save=False, episode_indices=[0])
    device = _bench(pair, tmp_path, segment_steps=None, **common)
    forwarded = _bench(pair, tmp_path, segment_steps=3, **common)
    assert device.device_steps == 16 and forwarded.device_steps == 6
    assert int(forwarded.summaries["all_iteration_histories"][0]) == 5
    _same(device.summaries, forwarded.summaries,
          keys=("convergence_flags", "all_iteration_histories", "final_positions",
                "final_quaternions", "position_errors", "lowest_position_errors",
                "all_position_histories", "all_orientation_histories",
                "all_applied_velocity_x", "all_velocity_mean_10"))


@pytest.mark.parametrize("flag", [dict(mesh=True), dict(live_dir=True)])
def test_flags_not_ported_raise(tmp_path, flag):
    """The two flags that raised before they were ported (a mesh, the live
    channel) run, and the results equal those of a run without them, bit for
    bit: a dp-only mesh of two CPU cells, a live directory that gets its
    snapshot."""
    pair = make_pair(pixel_identity=True, max_iterations=2)
    common = dict(num_steps=2, save=False, segment_steps=1)
    plain = _bench(pair, tmp_path, **common)
    live = tmp_path / "live"
    kw = (dict(mesh=make_mesh(devices=["cpu"] * 2)) if "mesh" in flag
          else dict(live_dir=str(live)))
    got = _bench(pair, tmp_path, **common, **kw)
    _same(plain.summaries, got.summaries)
    if "live_dir" in flag:
        assert sorted(p.name for p in live.glob("ep*.png")) == [
            "ep0000_step00001.png", "ep0000_step00002.png"]


def test_poster_asset_is_the_png():
    with np.load(POSTER_ASSET) as f:
        img = f["image"]
    png = load_image(os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                  "vitvs_tpu", "assets", "poster_resized.png"))
    assert img.dtype == np.uint8 and img.shape == (1125, 1500, 3)
    np.testing.assert_array_equal(img, np.round(png * 255).astype(np.uint8))
    assert torch.from_numpy(img).float().max() == 255.0


def test_build_model_is_bf16_whatever_the_config_says():
    """Fault 3.7: the reference's build_model builds the benchmark model in
    bf16 whatever ``cfg.compute_dtype`` says; so does the port's, on a
    float32 config, and an explicit compute_dtype still wins."""
    import jax.numpy as jnp

    from vitvs_tpu.harness.benchmark import build_model as jbuild_model
    from vitvs_tpu.io_bridge.config import VSConfig as JVSConfig
    from vitvs_tpu_torch.harness.benchmark import build_model
    from vitvs_tpu_torch.io_bridge.config import VSConfig
    from vitvs_tpu_torch.models.vit import ViT, ViTConfig

    _, jmodel = jbuild_model(JVSConfig(compute_dtype="float32"), params={})
    assert jmodel.compute_dtype == jnp.bfloat16
    cfg = VSConfig(compute_dtype="float32")
    net = ViT(ViTConfig(embed_dim=64, depth=1, num_heads=1, pos_grid=2))
    _, model = build_model(cfg, net, device="cpu")
    assert model.compute_dtype == torch.bfloat16
    _, model = build_model(cfg, net, compute_dtype=torch.float32, device="cpu")
    assert model.compute_dtype == torch.float32
    built, model = build_model(VSConfig(compute_dtype="float32", model_name="dino_vits16",
                                        stride=16, dino_input_size=224), device="cpu")
    assert model.compute_dtype == torch.bfloat16 and built.compute_dtype == torch.bfloat16


class _JaxDraws:
    """JAX's random draws injected into the port's run_benchmark: each
    search generator (seeded 1000 + i) becomes ``split(PRNGKey(1000 + i),
    4)``'s uniforms and each rollout generator (seeded i) the key chain of
    ``PRNGKey(i)`` (one split a step, carried across segments), as the
    reference's benchmark derives them."""

    def __init__(self, monkeypatch, t: int):
        from test_torch_rollout import search_scores

        from vitvs_tpu_torch.harness import benchmark as tbench

        keys = {}
        search, segment = tbench.find_best_start_pose, tbench.rollout_segment

        def find_best_start_pose(*a, generator, **kw):
            scores = torch.stack([search_scores(jax.random.PRNGKey(g.initial_seed()), 4, t)
                                  for g in generator])
            return search(*a, scores=scores, **kw)

        def rollout_segment(net, model, scene, goal, carry, nsteps, dp, dq, generator, **kw):
            rows = []
            for g in generator:
                key = keys.get(id(g), jax.random.PRNGKey(g.initial_seed()))
                steps = []
                for _ in range(nsteps):
                    key, sub = jax.random.split(key)
                    steps.append(np.asarray(jax.random.uniform(sub, (t,))))
                keys[id(g)] = key
                rows.append(np.stack(steps))
            return segment(net, model, scene, goal, carry, nsteps, dp, dq,
                           scores=torch.from_numpy(np.stack(rows)), **kw)

        monkeypatch.setattr(tbench, "find_best_start_pose", find_best_start_pose)
        monkeypatch.setattr(tbench, "rollout_segment", rollout_segment)


def test_int8_run_benchmark_matches_reference(tmp_path, monkeypatch):
    """run_benchmark(quantized=True, int8_static=True) at run AD's settings
    (2 x 2 K/V pooling by the matrix; run_benchmark adds 'nomax3', the conv
    patch embed, the 'default' resize, static scales calibrated on the goal
    view and the stream's first start views, source-quantized bins) on a
    tiny f32 model, 2 episodes with the rotation search, 12 steps in
    segments of 5, against vitvs_tpu's run_benchmark, JAX's draws injected:
    the same start orientations chosen, poses within 1e-4 and commands
    within 1e-3 (tests/test_torch_rollout.py's closed-loop tolerances), the
    flags and iterations equal; the run's fingerprint records the int8
    settings."""
    import dataclasses

    from vitvs_tpu.harness import benchmark as jbench

    pair = make_pair(max_iterations=12)
    pool = dict(kv_pool=2, kv_pool_impl="matmul")
    jmodel = dataclasses.replace(pair.jmodel, vit=dataclasses.replace(pair.jmodel.vit, **pool),
                                 cfg=pair.jmodel.cfg.replace(num_samples=2, num_circles=1, **pool))
    tmodel = dataclasses.replace(pair.tmodel, vit=dataclasses.replace(pair.tmodel.vit, **pool),
                                 cfg=pair.tmodel.cfg.replace(num_samples=2, num_circles=1, **pool))
    common = dict(quantized=True, int8_static=True, rotation_search=True, chunk=2, num_steps=12,
                  segment_steps=5, save=False, verbose=False)
    _, _, ref = jbench.run_benchmark(jmodel.cfg, pair.params, model=jmodel, scene=pair.jscene,
                                     out_dir=str(tmp_path), **common)
    _JaxDraws(monkeypatch, pair.t)
    ckpt = str(tmp_path / "int8.pkl")
    run = run_benchmark(tmodel.cfg, net=pair.net, model=tmodel, scene=pair.tscene,
                        out_dir=str(tmp_path), device="cpu", checkpoint_path=ckpt, **common)
    ours = run.summaries
    np.testing.assert_allclose(np.stack([b[1] for b in ours["best_poses"]]),
                               np.stack([np.asarray(b[1]) for b in ref["best_poses"]]), atol=1e-6)
    for k in ("convergence_flags", "all_iteration_histories"):
        assert _equal(ours[k], [np.asarray(x) for x in ref[k]]), k
    for k in ("all_position_histories", "all_orientation_histories", "final_positions"):
        for a, b in zip(ours[k], ref[k]):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-4, rtol=0, err_msg=k)
    for k in ("all_applied_velocity_x", "all_applied_velocity_yaw"):
        for a, b in zip(ours[k], ref[k]):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-3, rtol=0, err_msg=k)
    assert run.device_steps == 2 * 12
    with open(ckpt, "rb") as fh:
        meta = pickle.load(fh)["meta"]
    assert meta["quantized"] and meta["int8_static"]
    with pytest.raises(ValueError, match="different run"):
        run_benchmark(tmodel.cfg, net=pair.net, model=tmodel, scene=pair.tscene,
                      out_dir=str(tmp_path), device="cpu", checkpoint_path=ckpt,
                      **dict(common, int8_static=False))
