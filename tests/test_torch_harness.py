"""The port's run_benchmark on a tiny model on the CPU: the reference's
22-array npz (against vitvs_tpu's writer and evaluator), resume refusing a
foreign checkpoint, replays and chunk sizes that leave results unchanged,
the frozen fast-forward against running the device to the end, the flags
that are not ported, and the port's copy of the poster texture."""

import os
import pickle
import sys

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
    pair = make_pair(pixel_identity=True, max_iterations=4)
    common = dict(num_samples=3, perturbation=True, num_steps=4, save=False)
    _same(_bench(pair, tmp_path, chunk=1, **common).summaries,
          _bench(pair, tmp_path, chunk=3, **common).summaries)


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


@pytest.mark.parametrize("flag", [dict(quantized=True), dict(mesh=object()),
                                  dict(live_dir="live")])
def test_flags_not_ported_raise(tmp_path, flag):
    pair = make_pair(pixel_identity=True, max_iterations=2)
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1, item"):
        _bench(pair, tmp_path, num_steps=2, save=False, **flag)


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
