"""The port's visualization and live channel (``harness/viz.py``,
``run_benchmark(live_dir=, live_every=)``, ``ServoLoop(viz_every=,
viz_sink=)``) on a tiny pixel-identity model on the CPU: the live files'
names, count and cadence as tests/test_harness.py:119-135 asks of the JAX
package, results identical with and without the channel (its snapshot draws
from a clone of the episode's generator), draw_points equal to JAX's, the
ServoLoop hook, and the matplotlib figures (skipped without matplotlib; the
error that says what is missing)."""

import os
import sys

import numpy as np
import pytest
import torch
from PIL import Image

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_rollout import GOAL_POS, GOAL_QUAT, make_pair  # noqa: E402

from vitvs_tpu.harness import viz as jviz  # noqa: E402
from vitvs_tpu_torch.harness import viz  # noqa: E402
from vitvs_tpu_torch.harness.benchmark import (ChunkRow, live_snapshot,  # noqa: E402
                                               run_benchmark)
from vitvs_tpu_torch.harness.pipeline import goal_descriptors  # noqa: E402
from vitvs_tpu_torch.harness.rollout import episode_init, goal_pose  # noqa: E402
from vitvs_tpu_torch.io_bridge.host_loop import ServoLoop  # noqa: E402
from vitvs_tpu_torch.sim.env import observe  # noqa: E402

RNG = np.random.default_rng(59)


@pytest.fixture(autouse=True)
def _fresh_rng():
    """Each test draws its inputs from the same seed, whatever ran before it."""
    global RNG
    RNG = np.random.default_rng(59)


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bench(tmp_path, live=None, **kw):
    pair = make_pair(pixel_identity=True, max_iterations=12)
    cfg = pair.tmodel.cfg.replace(num_samples=2, num_circles=1)
    return run_benchmark(cfg, net=pair.net, model=pair.tmodel, scene=pair.tscene,
                         out_dir=str(tmp_path), rotation_search=False, num_steps=12,
                         segment_steps=4, verbose=False, save=False, device="cpu",
                         live_dir=None if live is None else str(live), **kw)


def test_live_channel_files_and_identical_results(tmp_path):
    """2 episodes in one chunk, 12 steps in 4-step segments: three snapshots
    of episode 0 (ep0000_step00004.png first), latest.png linking the last,
    PNGs Pillow reads as RGB frames; every result equal to a run without the
    channel, bit for bit."""
    live = tmp_path / "live"
    with_live = _bench(tmp_path, live, chunk=2)
    plain = _bench(tmp_path, chunk=2)
    pngs = sorted(p.name for p in live.glob("ep*.png"))
    assert pngs == ["ep0000_step00004.png", "ep0000_step00008.png", "ep0000_step00012.png"]
    assert os.readlink(live / "latest.png") == pngs[-1]
    img = np.asarray(Image.open(live / pngs[0]))
    assert img.shape == (128, 128, 3) and img.dtype == np.uint8
    for k in ("convergence_flags", "final_positions", "final_quaternions",
              "all_position_histories", "all_applied_velocity_x", "lowest_position_errors"):
        for a, b in zip(with_live.summaries[k], plain.summaries[k]):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=k)


def test_live_cadence_counts_segments_over_the_run(tmp_path):
    """live_every=2 with one episode a chunk: the segment count runs on
    across chunks (as the JAX package's does), so episode 0 is shot after
    its second segment and episode 1 after its first and third."""
    live = tmp_path / "live"
    _bench(tmp_path, live, chunk=1, live_every=2)
    assert sorted(p.name for p in live.glob("ep*.png")) == [
        "ep0000_step00008.png", "ep0001_step00004.png", "ep0001_step00012.png"]


def test_snapshot_leaves_the_episode_generator_where_it_was(tmp_path):
    """The snapshot's servo step draws its pair scores from a clone of the
    episode's generator: the episode's own stream does not move, and the
    drawn scores are the ones its next step draws."""
    pair = make_pair(pixel_identity=True, max_iterations=12)
    model, scene = pair.tmodel, pair.tscene
    gp, gq = goal_pose("cpu")
    goal = goal_descriptors(pair.net, model, observe(scene, model.camera, gp, gq)[0])
    carry = episode_init(GOAL_POS[None] + [[0.02, 0.0, 0.05]], GOAL_QUAT[None], gp, gq)
    gen = torch.Generator().manual_seed(4)
    before = gen.get_state()
    path = live_snapshot(ChunkRow(pair.net, model, scene, goal), carry, gen, str(tmp_path),
                         "ep0007_step00003.png")
    assert torch.equal(gen.get_state(), before) and os.path.basename(path) == "ep0007_step00003.png"
    assert os.readlink(tmp_path / "latest.png") == "ep0007_step00003.png"


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
def test_draw_points_matches_jax(dtype):
    """Current points green, goal points red, squares of radius 2 clipped at
    the border, points outside the image skipped: equal to JAX's."""
    img = RNG.random((40, 50, 3)).astype(np.float32)
    if dtype == "uint8":
        img = (img * 255).astype(np.uint8)
    cur = np.array([[0, 0], [10, 20], [49, 39], [60, 5], [-3, 4]])
    goal = np.array([[5, 5], [48, 1], [25, 38]])
    out = viz.draw_points(img, cur, goal)
    np.testing.assert_array_equal(out, jviz.draw_points(img, cur, goal))
    assert out.dtype == img.dtype and not np.shares_memory(out, img)


class _Source:
    def __init__(self, rgb, depth):
        self.rgb, self.depth = rgb, depth

    def get_frame(self):
        return self.rgb, self.depth


class _Sink:
    def __init__(self):
        self.twists = []

    def send_twist(self, twist):
        self.twists.append(twist)


@pytest.mark.parametrize("every,want", [(1, 3), (2, 2), (0, 0)])
def test_servo_loop_viz_hook(every, want):
    """viz_every=N hands every N-th frame (iterations 0, N, ...) with its
    matched points drawn to viz_sink, as the JAX package's ServoLoop does;
    0 turns the hook off."""
    pair = make_pair(pixel_identity=True, max_iterations=12)
    model, scene = pair.tmodel, pair.tscene
    gp, gq = goal_pose("cpu")
    goal_rgb, _ = observe(scene, model.camera, gp, gq)
    rgb, depth = observe(scene, model.camera, gp + torch.tensor([0.05, 0.0, 0.1]), gq)
    frames = []
    loop = ServoLoop(pair.net, model, goal_rgb.numpy(), _Source(rgb.numpy(), depth.numpy()),
                     _Sink(), viz_every=every, viz_sink=frames.append)
    infos = loop.run(max_iterations=3)
    assert all(i["feature_ok"] for i in infos) and len(frames) == want
    if frames:
        assert frames[0].shape == (128, 128, 3)
        assert not np.array_equal(frames[0], rgb.numpy())          # points were drawn


def test_figures_say_what_is_missing_without_matplotlib(monkeypatch):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError, match="need matplotlib"):
        viz.correspondence_figure(np.zeros((8, 8, 3)), np.zeros((8, 8, 3)), [[1, 1]], [[2, 2]])


def test_figures_render():
    """The correspondence figure rasterizes to an RGB frame and the
    trajectory plot builds from a results dict (needs matplotlib)."""
    pytest.importorskip("matplotlib")
    img = RNG.random((30, 40, 3))
    pts = np.array([[5.0, 6.0], [10.0, 20.0]])
    fig = viz.correspondence_figure(img, img, pts, pts + 1, valid=np.array([True, False]))
    frame = viz.figure_to_image(fig)
    assert frame.ndim == 3 and frame.shape[2] == 3 and frame.dtype == np.uint8
    d = {"all_iteration_histories": np.array([3]),
         "all_position_histories": np.array([np.array([[0.1, 0.0, 0.7], [0.05, 0.0, 0.65],
                                                       [0.0, 0.0, 0.61]])], dtype=object)}
    assert viz.plot_trajectory(d, 0) is not None
