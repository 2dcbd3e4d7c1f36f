"""The classical baselines (vitvs_tpu_torch/classical/) against jax.jit of
vitvs_tpu/classical/ on the same numpy-seeded inputs, on the CPU.

Inputs are smooth seeded images (bicubic zooms of uniform noise), and
scenes textured with them: on flat images XLA's CPU convolution leaves
rounding noise where a Sobel stencil cancels exactly (-2^-25 where the
port computes +0), and the gradient angle of such a pixel is the angle of
that noise, so descriptors sampled over flat regions differ between any
two implementations of the same arithmetic (``features.gradients``).

Tolerances: continuous maps within 1e-6 abs (Harris and Hessian responses
1e-5 relative to the map's largest magnitude); selections (NMS + top-k)
exact when fed the reference's own response maps; SIFT-like descriptors
within 1e-5 and BRIEF / M-LDB bits equal at the reference's keypoints (a
bit may flip only where its two samples lie within 1e-6, at most 0.5% of
the bits); matching indices exact; servo twists within 1e-4 where the
pair sets agree; a chunk equal to its episodes alone bit for bit."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.ndimage import zoom

from vitvs_tpu.classical import benchmark as jbench
from vitvs_tpu.classical import binary as jb
from vitvs_tpu.classical import features as jf
from vitvs_tpu.classical import pipeline as jpipe
from vitvs_tpu.classical import scalespace as js
from vitvs_tpu.control import EmaState as JEma
from vitvs_tpu.core import image as jimage
from vitvs_tpu.harness.pipeline import ServoModel as JModel
from vitvs_tpu.io_bridge.config import VSConfig as JConfig
from vitvs_tpu.models import vit as jvit
from vitvs_tpu.sim import Scene as JScene
from vitvs_tpu.sim import observe as jobserve
from vitvs_tpu_torch.classical import benchmark as tbench
from vitvs_tpu_torch.classical import binary as tb
from vitvs_tpu_torch.classical import features as tf
from vitvs_tpu_torch.classical import pipeline as tpipe
from vitvs_tpu_torch.classical import scalespace as ts
from vitvs_tpu_torch.control.ibvs import EmaState
from vitvs_tpu_torch.core import image as timage
from vitvs_tpu_torch.core.batch import item
from vitvs_tpu_torch.harness import rollout as troll
from vitvs_tpu_torch.io_bridge.config import VSConfig
from vitvs_tpu_torch.sim.scene import Scene

GOAL_POS = np.array([0.0, 0.0, 0.61], np.float32)
GOAL_QUAT = np.array([0.0, 0.7071068, 0.0, 0.7071068], np.float32)
MAP_TOL = 1e-6
RESP_REL_TOL = 1e-5
DESC_TOL = 1e-5
NEAR_EQUAL = 1e-6
MAX_FLIPPED = 0.005
TWIST_TOL = 1e-4
METHODS = ["sift", "orb", "akaze", "harris"]
# the step's keypoint budgets at the tests' sizes (K <= 256)
STEP_K = {"sift": 192, "orb": 200, "akaze": 128, "harris": 128}


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """Tiny shapes run thousands of small ops: one intra-op thread each, as
    the suite's parallel workers share the machine's cores (restored after)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def smooth(shape, seed: int, factor: int = 4) -> np.ndarray:
    """A seeded smooth image in [0, 1]: uniform noise zoomed ``factor``
    times bicubically."""
    rng = np.random.default_rng(seed)
    small = rng.random((shape[0] // factor, shape[1] // factor) + tuple(shape[2:]))
    factors = (factor, factor) + (1,) * (len(shape) - 2)
    return np.clip(zoom(small, factors, order=3), 0.0, 1.0).astype(np.float32)


IMG = smooth((96, 128), 0)


def T(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def _close(got, want, tol, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= tol, (what, err, tol)


# -- helpers and continuous maps ---------------------------------------------

def test_pack_quad_one_map_is_unchanged_and_several_maps_pack():
    """The one-image call the renderer makes stays bit for bit what it was
    (the reference's (H, W, C) packing); several maps pack as the reference's
    pack_quad(*maps); one map alone is (H, W, 1)."""
    img = smooth((9, 13, 3), 1)
    np.testing.assert_array_equal(timage.pack_quad(T(img)).numpy(),
                                  np.asarray(jimage.pack_quad(jnp.asarray(img))))
    stack = np.stack([img, img[::-1]])
    np.testing.assert_array_equal(timage.pack_quad(T(stack)).numpy()[1],
                                  np.asarray(jimage.pack_quad(jnp.asarray(img[::-1]))))
    maps = [img[..., 0], img[..., 1], img[..., 2]]
    np.testing.assert_array_equal(timage.pack_quad(*map(T, maps)).numpy(),
                                  np.asarray(jimage.pack_quad(*map(jnp.asarray, maps))))
    np.testing.assert_array_equal(timage.pack_quad(T(maps[0])[..., None]).numpy(),
                                  np.asarray(jimage.pack_quad(jnp.asarray(maps[0]))))


def _levels(img):
    h, w = img.shape
    return [(max(int(round(h / (4 / 3) ** i)), 32), max(int(round(w / (4 / 3) ** i)), 32))
            for i in (1, 2, 3)]


CONTINUOUS = {
    "gray": (lambda x: jf.grayscale(jnp.stack([x, x[::-1], x[:, ::-1]], -1)),
             lambda x: tf.grayscale(torch.stack([x, x.flip(0), x.flip(1)], -1)), None),
    "blur": (lambda x: jf._blur(x, 1.6), lambda x: tf._blur(x, 1.6), None),
    "gradients": (lambda x: jnp.stack(jf.gradients(x)),
                  lambda x: torch.stack(tf.gradients(x)), None),
    "harris": (jf.harris_response, tf.harris_response, RESP_REL_TOL),
    "dog_stack": (lambda x: js._gauss_stack(x, 3)[0], lambda x: ts._gauss_stack(x, 3)[0], None),
    "diffusion_6_steps": (lambda x: jb._diffuse(x, 6), lambda x: tb._diffuse(x, 6), None),
    "hessian_det": (lambda x: jb._hessian_det(x, 1.0), lambda x: tb._hessian_det(x, 1.0),
                    RESP_REL_TOL),
    "orb_pyramid": (lambda x: jnp.concatenate([jax.image.resize(x, s, "linear").ravel()
                                               for s in _levels(IMG)]),
                    lambda x: torch.cat([tb.pyramid_level(x, s).ravel() for s in _levels(IMG)]),
                    None),
    "shift_clamped": (lambda x: jnp.stack([jf.shift_clamped(x, dy, dx)
                                           for dy, dx in ((1, 0), (-1, 2), (0, -3))]),
                      lambda x: torch.stack([tf.shift_clamped(x, dy, dx)
                                             for dy, dx in ((1, 0), (-1, 2), (0, -3))]), None),
}


@pytest.mark.parametrize("name", CONTINUOUS)
def test_continuous_maps_match(name):
    ref_fn, port_fn, rel = CONTINUOUS[name]
    want = np.asarray(jax.jit(ref_fn)(jnp.asarray(IMG)))
    got = port_fn(T(IMG)).numpy()
    tol = MAP_TOL if rel is None else rel * np.abs(want).max()
    _close(got, want, tol, name)
    if name == "dog_stack":       # the DoG of the stack as well
        _close(np.diff(got, axis=0), np.diff(want, axis=0), MAP_TOL, "dog")


# -- selections ---------------------------------------------------------------

def test_top_k_follows_lax_top_k_on_ties():
    """Sorted descending, the lower index first among equal values, -inf
    slots included, row by row."""
    rng = np.random.default_rng(3)
    x = rng.integers(0, 5, (3, 200)).astype(np.float32)
    x[rng.random((3, 200)) < 0.6] = -np.inf
    x[0, :7] = -0.0
    for k in (1, 17, 200):
        jv, ji = jax.lax.top_k(jnp.asarray(x), k)
        tv, ti = tf.top_k_scores(T(x), k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("what", ["harris", "akaze"])
def test_peak_selection_exact_on_the_reference_response(what):
    """NMS + top-K fed the reference's response map selects exactly the
    reference's keypoints (Harris at quality 0.01 border 8, the Hessian
    determinant at AKAZE's 0.001 border 16)."""
    img = jnp.asarray(IMG)
    if what == "harris":
        r = jax.jit(jf.harris_response)(img)
        want = jax.jit(lambda x: jf.detect_corners(x, 64))(img)
        got = tf.corners_from_response(T(r), 64, 0.01, 8)
        np.testing.assert_array_equal(got.response.numpy(), np.asarray(want.response))
    else:
        r = jax.jit(lambda x: jb._hessian_det(x, 1.0))(img)
        want = jax.jit(lambda x: jb.akaze_features(x, 128, levels=1))(img)
        got = tf.corners_from_response(T(r), 128, 0.001, 16)
    np.testing.assert_array_equal(got.uv.numpy(), np.asarray(want.uv))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))


def test_dog_extrema_exact_on_the_reference_dog():
    """The 3x3x3 extrema, contrast and edge tests on the reference's DoG
    select the same voxels in the same order; the subpixel offsets agree."""
    gauss, _ = jax.jit(lambda x: js._gauss_stack(x, 3))(jnp.asarray(IMG))
    dog = gauss[1:] - gauss[:-1]
    ws, woy, wox = jax.jit(lambda d: js._octave_extrema(d, 0.008, 10.0, 8))(dog)
    gs, goy, gox = ts._octave_extrema(T(dog), 0.008, 10.0, 8)
    np.testing.assert_array_equal(np.isfinite(gs.numpy()), np.isfinite(np.asarray(ws)))
    assert np.isfinite(gs.numpy()).sum() > 10
    keep = np.isfinite(np.asarray(ws))
    _close(gs.numpy()[keep], np.asarray(ws)[keep], MAP_TOL, "score")
    _close(goy.numpy()[keep], np.asarray(woy)[keep], MAP_TOL, "oy")
    _close(gox.numpy()[keep], np.asarray(wox)[keep], MAP_TOL, "ox")
    _, wi = jax.lax.top_k(ws.reshape(-1), 64)
    _, gi = tf.top_k_scores(T(ws).flatten(), 64)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))


def test_sift_features_match():
    """The whole DoG pipeline: the same valid keypoints, subpixel positions
    within 1e-3 px (offsets divide by the DoG Hessian, which amplifies the
    blur's last bits), descriptors within 1e-5 where the positions agree."""
    want = jax.jit(lambda x: js.sift_features(x, 192))(jnp.asarray(IMG))
    got = ts.sift_features(T(IMG), 192)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    v = np.asarray(want.valid)
    _close(got.uv.numpy()[v], np.asarray(want.uv)[v], 1e-3, "uv")
    _close(got.scale.numpy(), np.asarray(want.scale), 0.0, "scale")
    _close(got.desc.numpy()[v], np.asarray(want.desc)[v], 2e-3, "desc")


# -- descriptors at the reference's keypoints ------------------------------------

def test_sift_like_descriptors_at_reference_keypoints():
    """Harris keypoints at scale 1 and DoG keypoints at their octave scales."""
    img = jnp.asarray(IMG)
    c = jax.jit(lambda x: jf.detect_corners(x, 64))(img)
    _close(tf.sift_like_descriptors(T(IMG), T(c.uv)).numpy(),
           np.asarray(jf.sift_like_descriptors(img, c.uv)), DESC_TOL, "scale 1")
    f = jax.jit(lambda x: js.sift_features(x, 96))(img)
    uv, sc = np.asarray(f.uv)[:32], np.asarray(f.scale)[:32]   # octave 0: base coordinates
    _close(tf.sift_like_descriptors(T(IMG), T(uv), scale=T(sc)).numpy(),
           np.asarray(jf.sift_like_descriptors(img, jnp.asarray(uv), scale=jnp.asarray(sc))),
           DESC_TOL, "dog scales")


def _flips_near_ties(got, want, a, b):
    """Bits that differ must compare samples within NEAR_EQUAL; their share
    is capped."""
    diff = got != want
    assert diff.mean() <= MAX_FLIPPED, diff.mean()
    assert np.all(np.abs(a - b)[diff] <= NEAR_EQUAL), np.abs(a - b)[diff].max()


def test_brief_bits_and_orientations_at_reference_keypoints():
    img = jnp.asarray(IMG)
    smooth_img = jax.jit(lambda x: jf._blur(x, 2.0))(img)
    c = jax.jit(lambda x: jf.detect_corners(x, 64, border=16))(img)
    theta = jax.jit(jb.orientation_centroid)(smooth_img, c.uv)
    _close(tb.orientation_centroid(T(smooth_img), T(c.uv)).numpy(), np.asarray(theta), 5e-5,
           "centroid")
    want = np.asarray(jax.jit(jb.steered_brief)(smooth_img, c.uv, theta))
    got = tb.steered_brief(T(smooth_img), T(c.uv), T(theta)).numpy()
    # the two samples of each test, taken by the port
    pat = T(jb._brief_pattern(256))
    th = T(theta)[:, None, None]
    rx = torch.cos(th) * pat[..., 0] - torch.sin(th) * pat[..., 1]
    ry = torch.sin(th) * pat[..., 0] + torch.cos(th) * pat[..., 1]
    vals = tf._bilinear(T(smooth_img), T(c.uv)[:, 1, None, None] + ry,
                        T(c.uv)[:, 0, None, None] + rx).numpy()
    _flips_near_ties(got, want, vals[..., 0], vals[..., 1])


def test_mldb_bits_and_dominant_orientation_at_reference_keypoints():
    img = jnp.asarray(IMG)
    L = jax.jit(lambda x: jb._diffuse(x, 6))(img)
    c = jax.jit(lambda x: jf.detect_corners(x, 64, border=16))(img)
    theta = jax.jit(jb.orientation_dominant_gradient)(L, c.uv)
    _close(tb.orientation_dominant_gradient(T(L), T(c.uv)).numpy(), np.asarray(theta), 5e-5,
           "dominant gradient")
    want = np.asarray(jax.jit(lambda *a: jb.mldb_descriptor(*a, scale=1.6))(L, c.uv, theta))
    got = tb.mldb_descriptor(T(L), T(c.uv), T(theta), scale=1.6).numpy()
    assert got.shape == (64, 486) and got.dtype == np.int8
    assert (got != want).mean() <= MAX_FLIPPED


# -- matching -------------------------------------------------------------------

def _descriptor_sets(norm: str, seed: int, k1=40, k2=48, d=64, batch=3):
    """A goal set and a batch of frame sets, each frame a noisy permutation
    of the goal's rows plus rows of its own; about a fifth invalid."""
    rng = np.random.default_rng(seed)

    def draw(n):
        if norm == "hamming":
            return (rng.random((n, d)) < 0.5).astype(np.int8)
        return rng.random((n, d)).astype(np.float32)

    g = draw(k1)
    frames = []
    for _ in range(batch):
        rows = np.concatenate([g[rng.permutation(k1)], draw(k2 - k1)])
        if norm == "hamming":
            rows = rows ^ (rng.random(rows.shape) < 0.15).astype(np.int8)
        else:
            rows = (rows + rng.normal(0, 0.05, rows.shape)).astype(np.float32)
        frames.append(rows)
    return g, np.stack(frames), rng.random(k1) > 0.2, rng.random((batch, k2)) > 0.2


@pytest.mark.parametrize("norm,ratio", [("l2", None), ("l2", 0.7), ("hamming", None),
                                        ("hamming", 0.8)])
def test_match_descriptors_indices_exact(norm, ratio):
    """Each frame of a batch against the goal, as the reference matches that
    frame alone; d = 486 bits for a ratio case (AKAZE's, padded for the
    int8 product)."""
    d = 486 if (norm, ratio) == ("hamming", 0.8) else 64
    g, frames, vg, vf = _descriptor_sets(norm, 5, d=d)
    got = tf.match_descriptors(T(g), T(frames), T(vg), T(vf), 24, norm=norm, ratio=ratio)
    ref = jax.jit(lambda a, b, va, vb: jf.match_descriptors(a, b, va, vb, 24, norm=norm,
                                                            ratio=ratio))
    for i in range(frames.shape[0]):
        want = ref(g, frames[i], vg, vf[i])
        for name in ("idx1", "idx2", "valid", "num_valid"):
            np.testing.assert_array_equal(getattr(got, name).numpy()[i],
                                          np.asarray(getattr(want, name)), f"{i} {name}")
        assert int(want.num_valid) >= 4
        v = np.asarray(want.valid)
        _close(got.distance.numpy()[i][v], np.asarray(want.distance)[v],
               0.0 if norm == "hamming" else 1e-4, "distance")


def test_match_descriptors_pads_when_fewer_than_num_pairs():
    g, frames, vg, vf = _descriptor_sets("l2", 6, k1=6, k2=8, batch=1)
    got = tf.match_descriptors(T(g), T(frames[0]), T(vg), T(vf[0]), 24)
    want = jf.match_descriptors(g, frames[0], vg, vf[0], 24)
    assert got.idx1.shape == (24,)
    for name in ("idx1", "idx2", "valid", "num_valid"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)))


# -- the servo step, the chunk, the benchmark ---------------------------------------

def _cfg(**kw) -> VSConfig:
    base = dict(u_max=128, v_max=128, f_x=100.5, f_y=100.5, num_pairs=16, lambda_=0.5,
                control_dt=0.1, ema_alpha=0.8, pinv_mode="dls", divergence_multiplier=5.0)
    base.update(kw)
    return VSConfig(**base)


def _scene_texture() -> np.ndarray:
    """Features coarse enough for the DoG detector at the tests' 128 x 128."""
    return smooth((256, 256, 3), 11, factor=8)


def _pair():
    cfg = _cfg()
    jmodel = JModel(vit=jvit.ViTConfig(model_name="unused"),
                    cfg=JConfig(**dataclasses.asdict(cfg)), compute_dtype=jnp.float32)
    tmodel = tbench.classical_model(cfg, "cpu")
    tex = _scene_texture()
    return jmodel, tmodel, JScene.create(tex, half_size=0.42), Scene.create(tex, half_size=0.42,
                                                                            device="cpu")


STEP_OFFSETS = [(0.05, -0.04, 0.06), (-0.03, 0.02, 0.03), (0.02, 0.03, 0.08)]


@pytest.mark.parametrize("method", METHODS)
def test_classical_servo_step_matches(method):
    """A chunk of 3 frames through the port's step against the jitted
    reference's step of each frame alone, on the reference's renders: pair
    sets compared, twists within 1e-4 where they agree (at least 2 of 3)."""
    jmodel, tmodel, jscene, _ = _pair()
    k = STEP_K[method]
    goal_rgb, _ = jobserve(jscene, jmodel.camera, jnp.asarray(GOAL_POS), jnp.asarray(GOAL_QUAT))
    jgoal = jpipe.extract_goal_features(jmodel, goal_rgb, k, method)
    tgoal = tpipe.extract_goal_features(tmodel, np.asarray(goal_rgb), k, method)
    assert torch.equal(tgoal.valid, T(jgoal.valid))
    frames, depths = zip(*(jobserve(jscene, jmodel.camera, jnp.asarray(GOAL_POS + np.float32(o)),
                                    jnp.asarray(GOAL_QUAT)) for o in STEP_OFFSETS))
    rng = np.random.default_rng(2)
    ema_v = rng.normal(0, 0.01, (3, 6)).astype(np.float32)
    ema_i = np.array([False, True, True])
    prev = rng.normal(0, 0.01, (3, 6)).astype(np.float32)
    got = tpipe.classical_servo_step(tmodel, tgoal, np.stack(frames), np.stack(depths),
                                     EmaState(T(ema_v), T(ema_i)), T(prev), k, method)
    jstep = jax.jit(lambda gf, rgb, d, ev, ei, pv: jpipe.classical_servo_step(
        jmodel, gf, rgb, d, JEma(ev, ei), pv, None, k, method=method))
    agree = 0
    for i in range(3):
        want = jstep(jgoal, frames[i], depths[i], ema_v[i], ema_i[i], prev[i])
        assert bool(got.feature_ok[i]) and bool(want.feature_ok)
        same = (np.array_equal(got.valid[i].numpy(), np.asarray(want.valid))
                and np.array_equal(got.s_uv[i].numpy(), np.asarray(want.s_uv))
                and np.array_equal(got.s_uv_star[i].numpy(), np.asarray(want.s_uv_star)))
        if same:
            agree += 1
            _close(got.body_twist[i].numpy(), np.asarray(want.body_twist), TWIST_TOL, "twist")
            _close(got.ema.value[i].numpy(), np.asarray(want.ema.value), TWIST_TOL, "ema")
    assert agree >= 2, agree
    one = tpipe.classical_servo_step(tmodel, tgoal, frames[0], depths[0],
                                     item(EmaState(T(ema_v), T(ema_i)), 0), T(prev[0]), k, method)
    np.testing.assert_array_equal(one.body_twist.numpy(), got.body_twist[0].numpy())


def _chunk_rollout(tmodel, scene, goal, method, starts_p, starts_q, steps):
    def step_fn(rgb, depth, ema, prev_v_c, scores):
        assert scores is None
        return tpipe.classical_servo_step(tmodel, goal, rgb, depth, ema, prev_v_c,
                                          STEP_K[method], method)

    dp, dq = troll.goal_pose("cpu")
    carry = troll.episode_init(starts_p, starts_q, dp, dq)
    return troll.rollout_segment(None, tmodel, scene, None, carry, steps, dp, dq,
                                 step_fn=step_fn, draw_scores=False)


@pytest.mark.parametrize("method", ["sift", "orb"])
def test_chunk_equals_its_episodes_alone(method):
    """Three episodes as one chunk of the classical rollout (l2 and hamming
    matching) equal each episode run alone, bit for bit."""
    _, tmodel, _, scene = _pair()
    goal_rgb, _ = troll.observe(scene, tmodel.camera, *troll.goal_pose("cpu"))
    goal = tpipe.extract_goal_features(tmodel, goal_rgb, STEP_K[method], method)
    sp = np.stack([GOAL_POS + np.float32(o) for o in STEP_OFFSETS])
    sq = np.stack([GOAL_QUAT] * 3)
    carry, ys = _chunk_rollout(tmodel, scene, goal, method, sp, sq, 3)
    for i in range(3):
        c1, y1 = _chunk_rollout(tmodel, scene, goal, method, sp[i:i + 1], sq[i:i + 1], 3)
        for name, a, b in zip(carry._fields, carry, c1):
            if isinstance(a, tuple):
                assert all(torch.equal(x[i], y[0]) for x, y in zip(a, b)), name
            else:
                assert torch.equal(a[i], b[0]), name
        for key in ys:
            assert torch.equal(ys[key][i], y1[key][0]), key


@pytest.mark.parametrize("method", ["harris", "sift"])
def test_run_classical_benchmark_matches_reference(method, tmp_path):
    """A tiny sweep (2 episodes, 8 steps, standard texture) through both
    drivers: the same npz schema and name, the same convergence flags and
    iteration counts, the start poses equal and the final poses close."""
    cfg = _cfg(num_samples=2, num_circles=1, min_iterations=4, max_iterations=8)
    tex = _scene_texture()
    jstats, jpath, _ = jbench.run_classical_benchmark(
        JConfig(**dataclasses.asdict(cfg)), scene=JScene.create(tex, half_size=0.42),
        out_dir=str(tmp_path / "jax"), config_name="tiny", method=method, chunk=2, num_steps=8,
        max_corners=STEP_K[method], verbose=False)
    run = tbench.run_classical_benchmark(
        cfg, scene=Scene.create(tex, half_size=0.42, device="cpu"),
        out_dir=str(tmp_path / "torch"), config_name="tiny", method=method, chunk=2,
        num_steps=8, max_corners=STEP_K[method], verbose=False, device="cpu")
    assert run.path.endswith(f"results_tiny_{method}_standard.npz")
    assert jpath.endswith(f"results_tiny_{method}_standard.npz")
    want, got = np.load(jpath, allow_pickle=True), np.load(run.path, allow_pickle=True)
    assert sorted(got.files) == sorted(want.files)
    for key in ("initial_positions", "initial_orientations"):
        np.testing.assert_array_equal(got[key], want[key])
    for key in ("convergence_flags", "all_iteration_histories"):
        np.testing.assert_array_equal(got[key], want[key], key)
    _close(np.stack(got["final_positions"]), np.stack(want["final_positions"]), 1e-3, "final")
    assert run.stats.num_samples == jstats.num_samples == 2
    assert run.chunk_steps == 8 and run.device_steps == 16 and run.net is None


def test_classical_benchmark_builds_no_vit_and_draws_no_scores(tmp_path, monkeypatch):
    """No ViT is constructed and the rollout draws no pair scores: the
    step sees scores None."""
    from vitvs_tpu_torch.models import vit as tvit

    def refuse(*a, **k):
        raise AssertionError("the classical benchmark built or used a ViT")

    monkeypatch.setattr(tvit.ViT, "__init__", refuse)
    monkeypatch.setattr(tvit, "init_vit", refuse)
    monkeypatch.setattr(troll, "_num_tokens", refuse)
    seen = []
    run = tbench.run_classical_benchmark(
        _cfg(num_samples=1, num_circles=1, max_iterations=3), method="harris",
        scene=Scene.create(_scene_texture(), half_size=0.42, device="cpu"), num_steps=3,
        max_corners=64, save=False, verbose=False, device="cpu",
        on_step=lambda ids, inputs, res: seen.append(inputs.scores))
    assert seen == [None] * 3 and run.net is None
    assert run.model.cfg.divergence_multiplier == 5.0 and run.model.cfg.early_divergence_abort


def test_classical_benchmark_resumes_and_perturbs(tmp_path):
    """The checkpoint resumes with identical results (and refuses another
    method's run); perturbation names the npz and changes the frames."""
    cfg = _cfg(num_samples=4, num_circles=2, max_iterations=3)
    scene = Scene.create(_scene_texture(), half_size=0.42, device="cpu")
    kw = dict(scene=scene, method="harris", chunk=2, num_steps=3, max_corners=64,
              verbose=False, device="cpu")
    ckpt = str(tmp_path / "c.pkl")
    a = tbench.run_classical_benchmark(cfg, out_dir=str(tmp_path), config_name="a",
                                       checkpoint_path=ckpt, **kw)
    b = tbench.run_classical_benchmark(cfg, out_dir=str(tmp_path), config_name="b",
                                       checkpoint_path=ckpt, **kw)
    assert b.chunk_steps == 0
    np.testing.assert_array_equal(np.load(a.path, allow_pickle=True)["final_positions"],
                                  np.load(b.path, allow_pickle=True)["final_positions"])
    with pytest.raises(ValueError, match="different run"):
        tbench.run_classical_benchmark(cfg, checkpoint_path=ckpt, save=False,
                                       **{**kw, "method": "sift"})
    frames = {}
    for perturbation in (False, True):
        run = tbench.run_classical_benchmark(
            cfg, out_dir=str(tmp_path), config_name="a", perturbation=perturbation,
            on_step=lambda ids, inputs, res: frames.setdefault(perturbation, inputs.rgb), **kw)
    assert run.path.endswith("results_a_harris_perturbed.npz")
    assert not torch.equal(frames[False], frames[True])


def test_benchmark_defaults_and_refusals():
    assert tpipe.DEFAULT_MAX_CORNERS == {"sift": 1152, "orb": 1000, "akaze": 512, "harris": 512}
    assert tpipe.METHOD_NORMS == jpipe.METHOD_NORMS
    assert tpipe.METHOD_RATIOS == jpipe.METHOD_RATIOS
    with pytest.raises(ValueError, match="unknown classical method"):
        tpipe.extract_features(torch.zeros(64, 64), 16, "surf")
