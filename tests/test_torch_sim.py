"""Port parity of the simulator and its helpers against vitvs_tpu on the
CPU: se3, camera and bilinear helpers within 1e-6; renders of the synthetic
poster (128x128 camera, several poses) and one 640x480 render of the real
poster (rgb within 4 ulps of the texture coordinate, see RGB_ULPS; depth
equal but for mm-rounding flips in 2e-4 of the pixels); the
texture perturbation on the draws of JAX's keys within 1e-6; the
convergence ladder step for step; the 500 seed-41 start poses exactly."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vitvs_tpu.control import convergence as jconv
from vitvs_tpu.core import camera as jcam
from vitvs_tpu.core import image as jimage
from vitvs_tpu.core import se3 as jse3
from vitvs_tpu.harness import samplers as jsamplers
from vitvs_tpu.io_bridge.config import VSConfig as JVSConfig
from vitvs_tpu.sim import Scene as JScene
from vitvs_tpu.sim import load_poster_scene as jload_poster_scene
from vitvs_tpu.sim import make_synthetic_poster, perturb_texture, render as jrender
from vitvs_tpu_torch.control import convergence as tconv
from vitvs_tpu_torch.core import camera as tcam
from vitvs_tpu_torch.core import image as timage
from vitvs_tpu_torch.core import se3 as tse3
from vitvs_tpu_torch.harness import samplers as tsamplers
from vitvs_tpu_torch.io_bridge.config import VSConfig as TVSConfig
from vitvs_tpu_torch.sim import perturb as tperturb
from vitvs_tpu_torch.sim import scene as tscene
from vitvs_tpu_torch.sim.env import env_step

HELPER_TOL = 1e-6
# rgb: XLA fuses the ray / plane arithmetic on the CPU and contracts it to FMAs,
# which PyTorch's separate roundings do not reproduce, so the texture
# coordinates agree to a few f32 ulps (1 to 2 measured) and not bit for bit;
# a texel step of up to 1.0 turns that into an rgb difference.  Held: 4 ulps of
# the largest texture coordinate times a unit step (3.1e-5 for a 128-texel
# poster, 4.9e-4 for the 1500-texel real one; measured 1.1e-5 and 1.7e-4), and
# the mean difference within a twentieth of that (measured 2.6e-6 on the poster).
RGB_ULPS = 4
# depth: the same ulp differences move depths a hair from a .5 mm edge to the
# other millimetre; held to 2e-4 of the pixels, each flip exactly 1 mm
# (measured: none at 128x128, 34 of the 307,200 pixels of the real poster)
DEPTH_FLIP_SHARE = 2e-4

rs = np.random.default_rng(0)
QUATS = rs.standard_normal((16, 4)).astype(np.float32)
QUATS /= np.linalg.norm(QUATS, axis=-1, keepdims=True)
VECS = rs.standard_normal((16, 3)).astype(np.float32)
TWISTS = (0.3 * rs.standard_normal((16, 6))).astype(np.float32)
TWISTS[0, 3:] = 0.0                                   # a zero angular velocity


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """Tiny shapes run thousands of small ops: one intra-op thread each, as
    the suite's parallel workers share the machine's cores (restored after)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(t, j, tol=HELPER_TOL):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=tol, rtol=0)


T = torch.from_numpy
J = jnp.asarray

SE3_CASES = {
    "quat_normalize": lambda m: m.quat_normalize((QUATS * 3)[:] if m is jse3 else T(QUATS * 3)),
    "quat_multiply": lambda m: m.quat_multiply(*((J(QUATS), J(QUATS[::-1])) if m is jse3
                                                 else (T(QUATS), T(QUATS[::-1].copy())))),
    "quat_rotate": lambda m: m.quat_rotate(*((J(QUATS), J(VECS)) if m is jse3
                                             else (T(QUATS), T(VECS)))),
    "quat_error_angle": lambda m: m.quat_error_angle(*((J(QUATS), J(QUATS[::-1])) if m is jse3
                                                       else (T(QUATS), T(QUATS[::-1].copy())))),
    "matrix_from_quat": lambda m: m.matrix_from_quat(J(QUATS) if m is jse3 else T(QUATS)),
    "quat_from_matrix": lambda m: m.quat_from_matrix(
        (jse3.matrix_from_quat(J(QUATS)) if m is jse3
         else T(np.asarray(jse3.matrix_from_quat(J(QUATS)))))),
    "integrate_body_twist": lambda m: (jnp.concatenate(jse3.integrate_body_twist(
        J(VECS), J(QUATS), J(TWISTS), 0.4), -1) if m is jse3 else torch.cat(
        tse3.integrate_body_twist(T(VECS), T(QUATS), T(TWISTS), 0.4), -1)),
    "look_at_quaternion": lambda m: m.look_at_quaternion(
        *((J(VECS + [0, 0, 2]), J(VECS[::-1] * 0.1)) if m is jse3
          else (T(VECS + np.float32([0, 0, 2])), T(VECS[::-1] * np.float32(0.1))))),
    "rotate_about_body_x": lambda m: (
        jax.vmap(lambda a: jse3.rotate_about_body_x(J(QUATS[0]), a))(J(VECS[:, 0]))
        if m is jse3 else tse3.rotate_about_body_x(T(QUATS[0]), T(VECS[:, 0]))),
    "optical_twist_to_body": lambda m: m.optical_twist_to_body(J(TWISTS) if m is jse3
                                                               else T(TWISTS)),
}


@pytest.mark.parametrize("name", sorted(SE3_CASES))
def test_se3_helper_matches_reference(name):
    _close(SE3_CASES[name](tse3), SE3_CASES[name](jse3))


def test_camera_helpers_match_reference():
    jc = jcam.CameraIntrinsics.from_hfov(160, 120, 65.0)
    tc = tcam.CameraIntrinsics.from_hfov(160, 120, 65.0)
    assert (tc.fx, tc.fy, tc.cx, tc.cy) == (jc.fx, jc.fy, jc.cx, jc.cy)
    xy = rs.standard_normal((20, 2)).astype(np.float32)
    _close(tc.normalized_to_pixel(T(xy)), jc.normalized_to_pixel(J(xy)), 1e-4)   # pixels
    np.testing.assert_array_equal(tc.ray_directions("cpu").numpy(),
                                  np.asarray(jc.ray_directions()))


def test_bilinear_packed_matches_reference():
    img = rs.random((9, 13, 3)).astype(np.float32)
    np.testing.assert_array_equal(timage.pack_quad(T(img)).numpy(),
                                  np.asarray(jimage.pack_quad(J(img))))
    ys = rs.uniform(-2, 11, (50,)).astype(np.float32)
    xs = rs.uniform(-2, 15, (50,)).astype(np.float32)
    _close(timage.bilinear_packed(timage.pack_quad(T(img)), (9, 13), T(ys), T(xs)),
           jimage.bilinear_packed(jimage.pack_quad(J(img)), (9, 13), J(ys), J(xs)))


def _render_both(jsc, tsc, cam_kw, pos, quat):
    jc, tc = jcam.CameraIntrinsics(**cam_kw), tcam.CameraIntrinsics(**cam_kw)
    jrgb, jdepth = jax.jit(lambda s, p, q: jrender(s, jc, p, q))(jsc, J(pos), J(quat))
    trgb, tdepth = tscene.render(tsc, tc, T(pos), T(quat))
    tol = RGB_ULPS * float(np.spacing(np.float32(max(tsc.texture.shape[:2]) - 1)))
    diff = np.abs(trgb.numpy() - np.asarray(jrgb))
    assert diff.max() <= tol and diff.mean() <= tol / 20, (diff.max(), tol, diff.mean())
    background = np.all(np.asarray(jrgb) == 0.5, axis=-1)
    np.testing.assert_array_equal(trgb.numpy()[background], np.asarray(jrgb)[background])
    flips = np.abs(tdepth.numpy() - np.asarray(jdepth))
    assert flips.max() <= 1.0001e-3 and int((flips > 0).sum()) <= DEPTH_FLIP_SHARE * flips.size, \
        (flips.max(), int((flips > 0).sum()))
    return trgb, tdepth


GOAL_Q = np.array([0.0, 0.7071068, 0.0, 0.7071068], np.float32)
RENDER_POSES = [
    ((0.0, 0.0, 0.61), GOAL_Q),
    ((0.12, -0.05, 0.45), np.asarray(jse3.rotate_about_body_x(J(GOAL_Q), 0.7))),
    ((-0.2, 0.3, 0.9), np.asarray(jse3.look_at_quaternion(J([-0.2, 0.3, 0.9]),
                                                           J([0.1, 0.0, 0.005])))),
    ((0.5, 0.5, 0.2), np.asarray(jse3.look_at_quaternion(J([0.5, 0.5, 0.2]),
                                                          J([-2.0, 1.0, 0.3])))),  # horizon
]


@pytest.mark.parametrize("pose", range(len(RENDER_POSES)))
def test_render_synthetic_poster_matches_reference(pose):
    tex = make_synthetic_poster(128, seed=4)
    jsc = JScene.create(tex, half_size=0.42)
    tsc = tscene.Scene.create(tex, half_size=0.42, device="cpu")
    pos, quat = RENDER_POSES[pose]
    cam_kw = dict(width=128, height=128, fx=100.5, fy=100.5)
    trgb, tdepth = _render_both(jsc, tsc, cam_kw, np.float32(pos), np.float32(quat))
    assert trgb.shape == (128, 128, 3) and tdepth.shape == (128, 128)


def test_render_real_poster_matches_reference():
    """640x480 at a start-like pose on the real poster (the port's npz copy
    of the texture against the JAX package's PNG)."""
    jsc = jload_poster_scene()
    tsc = tscene.load_poster_scene(device="cpu")
    pos = np.float32([0.08, -0.1, 0.7])
    quat = np.asarray(jse3.look_at_quaternion(J(pos), J([0.02, 0.05, 0.01])))
    trgb, tdepth = _render_both(jsc, tsc, {}, pos, quat)
    assert trgb.shape == (480, 640, 3) and float(tdepth.min()) > 0.5


def test_env_step_is_the_body_twist_integrator():
    p, q = env_step(T(VECS[0]), T(QUATS[0]), T(TWISTS[1]), 0.4)
    jp, jq = jse3.integrate_body_twist(J(VECS[0]), J(QUATS[0]), J(TWISTS[1]), 0.4)
    _close(p, jp)
    _close(q, jq)


def jax_draws(key, shape):
    """vitvs_tpu/sim/perturb.py's draws for ``key``, by repeating its splits."""
    h, w, _ = shape
    ke, kj, kn = jax.random.split(key, 3)
    kp, ka, kr, ky, kx = jax.random.split(ke, 5)
    area = jax.random.uniform(ka, (), minval=0.02, maxval=0.33) * h * w
    aspect = jnp.exp(jax.random.uniform(kr, (), minval=jnp.log(0.3), maxval=jnp.log(3.3)))
    eh = jnp.clip(jnp.sqrt(area * aspect), 1, h).astype(jnp.int32)
    ew = jnp.clip(jnp.sqrt(area / aspect), 1, w).astype(jnp.int32)
    top = jax.random.randint(ky, (), 0, jnp.maximum(h - eh + 1, 1))
    left = jax.random.randint(kx, (), 0, jnp.maximum(w - ew + 1, 1))
    kb, kc, korder = jax.random.split(kj, 3)
    t = lambda x, dt=None: torch.tensor(np.asarray(x), dtype=dt)  # noqa: E731
    return tperturb.PerturbDraws(
        erase=t(jax.random.bernoulli(kp, 0.5)),
        erase_hw=t([eh, ew], torch.int32), erase_origin=t([top, left], torch.int32),
        brightness=t(jax.random.uniform(kb, (), minval=0.4, maxval=1.6)),
        contrast=t(jax.random.uniform(kc, (), minval=0.6, maxval=1.4)),
        brightness_first=t(jax.random.bernoulli(korder)),
        noise=t(jax.random.normal(kn, shape)))


@pytest.mark.parametrize("key_id", [0, 1, 2, 3, 5])
def test_apply_perturbation_matches_reference(key_id):
    tex = make_synthetic_poster(64, seed=1)[:48]
    key = jax.random.PRNGKey(key_id)
    want = np.asarray(jax.jit(perturb_texture)(key, J(tex)))
    _close(tperturb.apply_perturbation(T(tex), jax_draws(key, tex.shape)), want)


def test_draw_perturbation_on_the_generator_device():
    gen = torch.Generator().manual_seed(4)
    d = tperturb.draw_perturbation(gen, (40, 30, 3))
    eh, ew = d.erase_hw.tolist()
    top, left = d.erase_origin.tolist()
    assert 1 <= eh <= 40 and 1 <= ew <= 30 and 0 <= top <= 40 - eh and 0 <= left <= 30 - ew
    assert d.noise.shape == (40, 30, 3) and 0.4 <= float(d.brightness) <= 1.6
    out = tperturb.perturb_texture(torch.Generator().manual_seed(4), torch.full((40, 30, 3), 0.5))
    assert out.shape == (40, 30, 3) and float(out.min()) >= 0.0 and float(out.max()) <= 1.0


def test_convergence_ladder_matches_reference():
    """450 seeded steps of commands and errors whose scale shrinks, so the
    trend stop can fire after min_iterations 20; every 7th step a feature
    failure: iteration, done and converged identical at every step."""
    cfg_kw = dict(min_iterations=20, max_iterations=440)
    jcfg, tcfg = JVSConfig(**cfg_kw), TVSConfig(**cfg_kw)
    r = np.random.default_rng(11)
    decay = np.exp(-np.arange(450) / 60.0)[:, None].astype(np.float32)
    v = (r.standard_normal((450, 6)).astype(np.float32) * 1e-3 * decay
         + np.float32(2e-5) * (np.arange(450) > 330)[:, None])
    errs = (np.abs(r.standard_normal((450, 2))) * decay * [5.0, 3.0] + 0.01).astype(np.float32)
    ok = (np.arange(450) % 7) != 3
    js = jconv.convergence_init(10.0, 20.0)
    ts = tconv.convergence_init(torch.tensor(10.0), torch.tensor(20.0))
    jstep = jax.jit(lambda s, v, et, er, u: jconv.convergence_step(s, v, et, er, jcfg, u))
    done_at = None
    for i in range(450):
        js = jstep(js, J(v[i]), J(errs[i, 0]), J(errs[i, 1]), J(ok[i]))
        ts = tconv.convergence_step(ts, T(v[i]), torch.tensor(errs[i, 0]),
                                    torch.tensor(errs[i, 1]), tcfg,
                                    torch.tensor(bool(ok[i])))
        for name in ("iteration", "done", "converged", "vel_count"):
            assert getattr(ts, name).item() == np.asarray(getattr(js, name)).item(), (i, name)
        if done_at is None and bool(ts.done):
            done_at = i
    assert done_at is not None and 20 <= done_at < 440      # the trend stop fired
    np.testing.assert_array_equal(ts.vel_buffer.numpy(), np.asarray(js.vel_buffer))


def test_generate_episode_starts_identical():
    jp, jq, jn = jsamplers.generate_episode_starts(JVSConfig(), seed=41)
    tp, tq, tn = tsamplers.generate_episode_starts(TVSConfig(), seed=41)
    assert tn == jn == 500
    assert np.array_equal(tp, jp) and np.array_equal(tq, jq)
    assert tsamplers.pose_error_stats(tp, tsamplers.DESIRED_POSITION) == \
        jsamplers.pose_error_stats(jp, jsamplers.DESIRED_POSITION)
    assert math.isfinite(tsamplers.orientation_error_stats(tq, tsamplers.DESIRED_ORIENTATION)[0])
