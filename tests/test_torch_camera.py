"""Port parity: the camera's plane reprojection (``core/camera.py``) and the
geometric patch correspondence of the trainer (``train/finetune.py``)
against ``jax.jit`` of vitvs_tpu on the CPU, on poses of the servo
sampler's distribution at 128x128 / 112 and at 640x480 with 308 and 518.

Held against the jitted reference (not the eager one): under jit XLA folds
constant chains and contracts multiply-adds, and a patch index is a floor of
a reprojected coordinate, so an ulp can flip it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vitvs_tpu.harness.pipeline import ServoModel as JModel
from vitvs_tpu.io_bridge.config import VSConfig as JCfg
from vitvs_tpu.sim import Scene as JScene
from vitvs_tpu.train import finetune as jft
from vitvs_tpu_torch.harness.pipeline import ServoModel
from vitvs_tpu_torch.io_bridge.config import VSConfig
from vitvs_tpu_torch.sim.scene import Scene, make_synthetic_poster
from vitvs_tpu_torch.train import finetune as tft

GOAL_POS = torch.tensor([0.0, 0.0, 0.61])
GOAL_QUAT = torch.tensor([0.0, 0.7071068, 0.0, 0.7071068])


def _jax_scene(tex):
    return JScene.create(tex, half_size=(0.3, 0.4), plane_z=0.01)


@pytest.mark.parametrize("cfg_kw", [dict(u_max=128, v_max=128, f_x=100.5, f_y=100.5,
                                         dino_input_size=112),
                                    dict(dino_input_size=308), dict(dino_input_size=518)],
                         ids=["128x128_112", "640x480_308", "640x480_518"])
def test_geometric_correspondences_match_jitted_reference(cfg_kw):
    """idx and valid of goal -> view and view -> goal on 256 poses of the
    servo sampler, against ``jax.jit`` of the reference.  valid agrees bit
    for bit.  idx may flip at most once per 1,000 patches: XLA contracts the
    reprojection's multiply-adds (the 3-term dots, the plane hit) into FMAs,
    which the port's separately rounded products do not reproduce, so a
    reprojected coordinate can sit an ulp to the other side of a patch border
    (1 flip in 350,464 patches at 518, none at 112 and 308)."""
    jm = JModel.create(JCfg(**cfg_kw), compute_dtype=jnp.float32)
    tm = ServoModel.create(VSConfig(**cfg_kw), compute_dtype=torch.float32, device="cpu")
    tex = make_synthetic_poster(64, seed=0)
    tscene = Scene.create(tex, half_size=(0.3, 0.4), plane_z=0.01, device="cpu")
    jscene = _jax_scene(tex)
    poses = tft.draw_servo_poses(torch.Generator().manual_seed(0), 256)
    gp, gq = jnp.asarray(GOAL_POS.numpy()), jnp.asarray(GOAL_QUAT.numpy())
    pb, qb = jnp.asarray(poses.position.numpy()), jnp.asarray(poses.quat.numpy())
    ab = jax.jit(jax.vmap(lambda p, q: jft.geometric_correspondences(jm, jscene, gp, gq, p, q)))
    ba = jax.jit(jax.vmap(lambda p, q: jft.geometric_correspondences(jm, jscene, p, q, gp, gq)))
    got_ab = tft.geometric_correspondences(tm, tscene, GOAL_POS, GOAL_QUAT, poses.position,
                                           poses.quat)
    got_ba = tft.geometric_correspondences(tm, tscene, poses.position, poses.quat, GOAL_POS,
                                           GOAL_QUAT)
    for (ji, jv), (ti, tv) in ((ab(pb, qb), got_ab), (ba(pb, qb), got_ba)):
        ji, jv = np.asarray(ji), np.asarray(jv)
        assert ti.shape == ji.shape == (256, tm.grid()[0] * tm.grid()[1])
        np.testing.assert_array_equal(tv.numpy(), jv)
        assert jv.sum() > ji.size // 4
        assert (ti.numpy() != ji).sum() <= ji.size // 1000


def test_reproject_via_plane_matches_jitted_reference():
    """The camera helper itself on pixels of a 640 x 480 view, single and
    batched poses: within f32 rounding of the jitted reference."""
    from vitvs_tpu.core import camera as jcam
    from vitvs_tpu_torch.core import camera as tcam

    rs = np.random.default_rng(4)
    uv = rs.uniform([0, 0], [640, 480], (300, 2)).astype(np.float32)
    poses = tft.draw_servo_poses(torch.Generator().manual_seed(1), 4)
    jc, tc = jcam.CameraIntrinsics(), tcam.CameraIntrinsics()
    f = jax.jit(jax.vmap(lambda p, q: jcam.reproject_via_plane(
        jc, uv, jnp.asarray(GOAL_POS.numpy()), jnp.asarray(GOAL_QUAT.numpy()), p, q, 0.01)))
    ref = f(jnp.asarray(poses.position.numpy()), jnp.asarray(poses.quat.numpy()))
    got = tcam.reproject_via_plane(tc, torch.from_numpy(uv), GOAL_POS, GOAL_QUAT,
                                   poses.position, poses.quat, 0.01)
    one = tcam.reproject_via_plane(tc, torch.from_numpy(uv), GOAL_POS, GOAL_QUAT,
                                   poses.position[2], poses.quat[2], 0.01)
    # world and t_hit depend on view A alone, which is the one goal pose here
    for r, g, o, tol in zip(ref, got, one, (1e-3, 1e-6, 1e-6, 1e-6)):
        r = np.asarray(r)
        g = g.expand(r.shape)
        np.testing.assert_allclose(g.numpy(), r, rtol=1e-5, atol=tol)
        np.testing.assert_array_equal(o.expand(r.shape[1:]).numpy(), g[2].numpy())


@pytest.mark.parametrize("cfg_kw", [dict(u_max=128, v_max=128, f_x=100.5, f_y=100.5,
                                         dino_input_size=112),
                                    dict(dino_input_size=308), dict(dino_input_size=518)],
                         ids=["128x128_112", "640x480_308", "640x480_518"])
def test_patch_centers_match_jitted_reference(cfg_kw):
    """The patch centres bit for bit: XLA folds the reference's constant
    chain (i + 0.5) * scale * u_max / s into one f32 factor per axis."""
    jm = JModel.create(JCfg(**cfg_kw), compute_dtype=jnp.float32)
    tm = ServoModel.create(VSConfig(**cfg_kw), compute_dtype=torch.float32, device="cpu")
    ref = np.asarray(jax.jit(lambda: jft._patch_centers_px(jm))())
    np.testing.assert_array_equal(tft._patch_centers_px(tm).numpy(), ref)


def test_normalized_pixel_round_trip():
    from vitvs_tpu_torch.core.camera import CameraIntrinsics

    cam = CameraIntrinsics()
    uv = torch.tensor([[0.0, 0.0], [320.0, 240.0], [639.5, 479.5]])
    xy = cam.pixel_to_normalized(uv)
    torch.testing.assert_close(xy[1], torch.zeros(2))
    torch.testing.assert_close(cam.normalized_to_pixel(xy), uv, rtol=0, atol=1e-4)
