"""The emulated RealSense's other sensors in the port
(``sim/scene.py:render_ir``, ``sim/pointcloud.py``) against vitvs_tpu on
numpy-seeded inputs: the IR pair without noise (the luma as XLA's fused
dot computes it: bit for bit on the same colour render, within one 8-bit
level at 0.1% of the pixels from the port's own render), the
noise's spread and the generator that gates it, and the organized point
cloud within 1e-6 with the same NaN positions."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vitvs_tpu.core.camera import CameraIntrinsics as JCam
from vitvs_tpu.sim import Scene as JScene
from vitvs_tpu.sim import make_synthetic_poster
from vitvs_tpu.sim import organized_point_cloud as jcloud
from vitvs_tpu.sim import render_ir as jrender_ir
from vitvs_tpu.sim.scene import render as jrender
from vitvs_tpu_torch import sim as tsim
from vitvs_tpu_torch.core.camera import CameraIntrinsics as TCam
from vitvs_tpu_torch.sim import scene as tscene_mod

RNG = np.random.default_rng(47)


@pytest.fixture(autouse=True)
def _fresh_rng():
    """Each test draws its inputs from the same seed, whatever ran before it."""
    global RNG
    RNG = np.random.default_rng(47)
GOAL_POS = np.array([0.0, 0.0, 0.61], np.float32)
GOAL_QUAT = np.array([0.0, 0.7071068, 0.0, 0.7071068], np.float32)
CAM = dict(width=96, height=72, fx=75.0, fy=75.0)


def _scenes():
    tex = make_synthetic_poster(128, seed=3)
    return JScene.create(tex, half_size=0.42), tsim.Scene.create(tex, half_size=0.42, device="cpu")


def _poses():
    pos = np.stack([GOAL_POS, GOAL_POS + [0.02, -0.03, 0.0], GOAL_POS + [0.1, 0.05, 0.09]])
    quat = np.stack([GOAL_QUAT, GOAL_QUAT, [0.05, 0.70, 0.02, 0.71]]).astype(np.float32)
    return pos.astype(np.float32), quat / np.linalg.norm(quat, axis=1, keepdims=True)


def test_exports_match_the_jax_package():
    import vitvs_tpu.sim as jsim

    assert sorted(tsim.__all__) == sorted(jsim.__all__)


def test_luma_is_xlas_fused_dot():
    """On the same f32 rgb, the port's luma equals the JAX package's
    (jit of rgb @ BT.601) bit for bit: fma(b, .114, fma(g, .587, r * .299))."""
    rgb = RNG.random((64, 80, 3)).astype(np.float32)
    ref = np.asarray(jax.jit(lambda x: x @ jnp.asarray(np.array([0.299, 0.587, 0.114],
                                                                np.float32)))(rgb))
    out = tscene_mod._luma(torch.from_numpy(rgb)).numpy()
    np.testing.assert_array_equal(out, ref)


def test_render_ir_matches_jax_without_noise():
    """Three poses rendered at once (the port's render is batched) against
    JAX's render_ir one pose at a time.  Not bit for bit: the two packages'
    colour renders differ in the last bits (up to 1e-5 here), which moves at
    most 0.1% of the pixels by one 8-bit level.  The IR arithmetic itself is
    bit for bit: JAX's left-IR colour render through the port's luma and
    levels gives JAX's ir1 exactly."""
    js, ts = _scenes()
    pos, quat = _poses()
    tir = tsim.render_ir(ts, TCam(**CAM), torch.from_numpy(pos), torch.from_numpy(quat))
    assert tir[0].shape == (3, 72, 96)
    for b in range(3):
        jir = jax.jit(lambda p, q: jrender_ir(js, JCam(**CAM), p, q))(pos[b], quat[b])
        for j, t in zip(jir, tir):
            diff = np.abs(np.asarray(j) - t[b].numpy())
            assert diff.max() <= 1 / 255 + 1e-7 and (diff > 0).mean() <= 1e-3
            levels = t[b].numpy() * 255
            np.testing.assert_allclose(levels, np.round(levels), atol=1e-4)
        jrgb = jax.jit(lambda p, q: jrender(js, JCam(**CAM), p, q,
                                            quantize_depth_mm=False)[0])(pos[b], quat[b])
        lum = tscene_mod._luma(torch.from_numpy(np.array(jrgb)))
        ours = torch.round(torch.clamp(lum, 0.0, 1.0) * 255.0) * (1.0 / 255.0)
        np.testing.assert_array_equal(ours.numpy(), np.asarray(jir[0]))


def test_render_ir_stereo_offset():
    """The right IR sits 50 mm along body -y: looking straight down at the
    goal pose, the pair differs, and the left IR is the luma of the render
    at the depth frame's pose."""
    _, ts = _scenes()
    cam = TCam(**CAM)
    p, q = torch.from_numpy(GOAL_POS), torch.from_numpy(GOAL_QUAT)
    ir1, ir2 = tsim.render_ir(ts, cam, p, q)
    assert not torch.equal(ir1, ir2)
    rgb, _ = tsim.render(ts, cam, p, q, quantize_depth_mm=False)
    torch.testing.assert_close(ir1, torch.round(torch.clamp(tscene_mod._luma(rgb), 0, 1) * 255)
                               / 255, rtol=0, atol=1e-7)


def test_render_ir_noise_spread_and_generator():
    """With a generator the plugin's noise (std 0.05) is added before the
    8-bit levels: the spread where the image is mid-grey is 0.05 within
    0.004; the same seed gives the same frames, another seed others; None
    gives the noise-free pair."""
    _, ts = _scenes()
    cam = TCam(width=160, height=120, fx=125.0, fy=125.0)
    p, q = torch.from_numpy(GOAL_POS), torch.from_numpy(GOAL_QUAT)
    clean = tsim.render_ir(ts, cam, p, q)
    a, b, c = (tsim.render_ir(ts, cam, p, q, generator=torch.Generator().manual_seed(s))
               for s in (1, 1, 2))
    mid = (clean[0] > 0.2) & (clean[0] < 0.8)
    assert mid.float().mean() > 0.5
    assert abs(float((a[0] - clean[0])[mid].std()) - 0.05) <= 0.004
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]) and not torch.equal(a[0], c[0])
    assert all(torch.equal(x, y) for x, y in zip(tsim.render_ir(ts, cam, p, q, None), clean))


@pytest.mark.parametrize("color", ["rgb", "mono", "none"])
def test_point_cloud_matches_jax(color):
    """Depths across the cut-offs (below 0.5 m, above 5 m, 0): the cloud
    within 1e-6 of JAX's, the same NaN positions, colours per branch; a
    batch of two equals each alone."""
    d = RNG.uniform(0.0, 6.0, (2, 24, 32)).astype(np.float32)
    d[:, 0, :4] = 0.0
    rgb = {"rgb": RNG.random((2, 24, 32, 3)).astype(np.float32),
           "mono": RNG.random((2, 24, 32)).astype(np.float32), "none": None}[color]
    out = tsim.organized_point_cloud(torch.from_numpy(d),
                                     None if rgb is None else torch.from_numpy(rgb)).numpy()
    assert out.shape == (2, 24, 32, 6)
    for b in range(2):
        ref = np.asarray(jcloud(jnp.asarray(d[b]), None if rgb is None else jnp.asarray(rgb[b])))
        np.testing.assert_array_equal(np.isnan(out[b]), np.isnan(ref))
        np.testing.assert_allclose(np.nan_to_num(out[b]), np.nan_to_num(ref), rtol=0, atol=1e-6)
        one = tsim.organized_point_cloud(torch.from_numpy(d[b]),
                                         None if rgb is None else torch.from_numpy(rgb[b]))
        np.testing.assert_array_equal(one.numpy(), out[b])
    assert np.isnan(out[..., :3]).any() and not np.isnan(out[..., 3:]).any()
