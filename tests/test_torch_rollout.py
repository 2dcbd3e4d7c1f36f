"""Port parity of the closed loop: vitvs_tpu_torch's rollout (render ->
servo_step -> integrate -> convergence ladder), its feature-failure abort,
its rotation search and the benchmark's cast bf16 goal descriptors, against
vitvs_tpu on the CPU, on a tiny 1-block ViT with the pair scores of JAX's
key chain injected."""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vitvs_tpu.core import se3 as jse3
from vitvs_tpu.harness import pipeline as jpipe
from vitvs_tpu.harness import rollout as jroll
from vitvs_tpu.io_bridge.config import VSConfig as JVSConfig
from vitvs_tpu.models import vit as jvit
from vitvs_tpu.sim import Scene as JScene
from vitvs_tpu.sim import make_synthetic_poster, observe as jobserve
from vitvs_tpu_torch.harness import benchmark as tbench
from vitvs_tpu_torch.harness import pipeline as tpipe
from vitvs_tpu_torch.harness import rollout as troll
from vitvs_tpu_torch.io_bridge.config import VSConfig as TVSConfig
from vitvs_tpu_torch.models import vit as tvit
from vitvs_tpu_torch.models.convert import from_jax_params
from vitvs_tpu_torch.sim.env import observe as tobserve
from vitvs_tpu_torch.sim.scene import Scene as TScene

GOAL_POS = np.array([0.0, 0.0, 0.61], np.float32)
GOAL_QUAT = np.array([0.0, 0.7071068, 0.0, 0.7071068], np.float32)
# f32 rollouts: the two packages' descriptors and rays differ in the last bits,
# and 30 integrated steps carry that: poses within 1e-4 (measured 2.9e-5).
# Commands within BASELINE.md's velocity clause, 1e-3: a pose a few ulps away
# can move a matched pixel's depth across a mm-rounding edge, and a 1 mm change
# of one of 16 depths near 0.6 m moves the solve by up to 0.2% (measured 3.5e-4
# at one step, the EMA then decays it).
TRAJ_TOL = 1e-4
VEL_TOL = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """Tiny shapes run thousands of small ops: one intra-op thread each, as
    the suite's parallel workers share the machine's cores (restored after)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class Pair:
    """The same tiny closed loop in both packages: config, model, weights,
    scene (tests/test_rollout.py:tiny_setup's, f32)."""

    def __init__(self, pixel_identity=False, max_iterations=120, octaves=(2, 7),
                 compute_dtype="float32", **cfg_kw):
        cfg = dict(u_max=128, v_max=128, f_x=100.5, f_y=100.5, dino_input_size=112,
                   num_pairs=16, lambda_=0.5, control_dt=0.1, ema_alpha=0.8,
                   use_feature_binning=True, layer=0, model_name="tiny",
                   max_iterations=max_iterations, min_iterations=min(300, max_iterations),
                   pinv_mode="dls", subpixel_matching=False, compute_dtype=compute_dtype)
        cfg.update(cfg_kw)
        dim = 8 * 8 * 3 if pixel_identity else 128
        vit = dict(patch_size=8, embed_dim=dim, depth=1, num_heads=4, pos_grid=16, stride=8,
                   model_name="tiny")
        params = jvit.init_vit(jvit.ViTConfig(**vit), jax.random.PRNGKey(0))
        params = jax.tree.map(np.asarray, params)
        params["pos_embed"] = np.zeros_like(params["pos_embed"])
        if pixel_identity:
            params["patch_embed"]["kernel"] = np.eye(dim, dtype=np.float32).reshape(8, 8, 3, dim)
            for name in ("ls1", "ls2"):
                params["blocks"][name] = params["blocks"][name] * 1e-8
        jdt, tdt = getattr(jnp, compute_dtype), getattr(torch, compute_dtype)
        self.params = params
        self.jmodel = jpipe.ServoModel(vit=jvit.ViTConfig(**vit), cfg=JVSConfig(**cfg),
                                       compute_dtype=jdt)
        self.tmodel = tpipe.ServoModel(vit=tvit.ViTConfig(**vit), cfg=TVSConfig(**cfg),
                                       compute_dtype=tdt, device="cpu")
        self.net = self.tmodel.load_vit(from_jax_params(params))
        tex = make_synthetic_poster(256, seed=3, octaves=octaves)
        self.jscene = JScene.create(tex, half_size=0.42)
        self.tscene = TScene.create(tex, half_size=0.42, device="cpu")

    @property
    def t(self) -> int:
        gh, gw = self.tmodel.grid()
        return gh * gw

    def goal(self):
        jrgb, _ = jobserve(self.jscene, self.jmodel.camera, jnp.asarray(GOAL_POS),
                           jnp.asarray(GOAL_QUAT))
        trgb, _ = tobserve(self.tscene, self.tmodel.camera, torch.from_numpy(GOAL_POS),
                           torch.from_numpy(GOAL_QUAT))
        jgoal = jax.jit(lambda p, f: jpipe.goal_descriptors(p, self.jmodel, f))
        return jgoal(self.params, jrgb), tpipe.goal_descriptors(self.net, self.tmodel, trgb)


@functools.lru_cache(maxsize=None)
def make_pair(**kw) -> Pair:
    """One Pair per setting in a test process (the tests only read it)."""
    return Pair(**kw)


def rollout_scores(key, num_steps: int, t: int) -> torch.Tensor:
    """The pair scores of JAX's rollout: ``key, sub = split(key)`` a step,
    then ``uniform(sub, (t,))`` (a frozen carry keeps its key, but frozen
    steps' results are discarded)."""
    out = []
    for _ in range(num_steps):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.uniform(sub, (t,))))
    return torch.from_numpy(np.stack(out))


def search_scores(key, views: int, t: int) -> torch.Tensor:
    """The rotation search's scores: ``uniform(k, (t,))`` of each of
    ``split(key, views)``."""
    return torch.from_numpy(np.stack([np.asarray(jax.random.uniform(k, (t,)))
                                      for k in jax.random.split(key, views)]))


def _run_both(pair: Pair, start_p, start_q, key_id: int, num_steps: int, goal=None):
    jg, tg = goal if goal is not None else pair.goal()
    key = jax.random.PRNGKey(key_id)
    jres = jroll.rollout_episode(pair.params, pair.jmodel, pair.jscene, jg, jnp.asarray(start_p),
                                 jnp.asarray(start_q), key, num_steps=num_steps)
    tres = troll.rollout_episode(pair.net, pair.tmodel, pair.tscene, tg, start_p, start_q,
                                 scores=rollout_scores(key, num_steps, pair.t),
                                 num_steps=num_steps)
    return jres, tres


def _hold(jres, tres, tol=TRAJ_TOL):
    for name in ("active", "converged", "aborted", "iterations"):
        np.testing.assert_array_equal(getattr(tres, name).numpy(),
                                      np.asarray(getattr(jres, name)), err_msg=name)
    for name in ("position_history", "orientation_history", "final_position", "final_quat"):
        np.testing.assert_allclose(getattr(tres, name).numpy(), np.asarray(getattr(jres, name)),
                                   atol=tol, rtol=0, err_msg=name)
    for name in ("v_c_history", "applied_twist_history"):
        np.testing.assert_allclose(getattr(tres, name).numpy(), np.asarray(getattr(jres, name)),
                                   atol=VEL_TOL, rtol=0, err_msg=name)
    # cm and deg, from the poses above
    for name in ("error_history", "position_error", "orientation_error",
                 "lowest_position_error", "lowest_orientation_error"):
        np.testing.assert_allclose(getattr(tres, name).numpy(), np.asarray(getattr(jres, name)),
                                   atol=100 * tol, rtol=0, err_msg=name)


@pytest.mark.parametrize("offset,rot_deg,max_iterations", [
    ((0.10, -0.08, 0.15), 0.0, 120),     # the ladder does not stop in 30 steps
    ((-0.08, 0.06, 0.12), 15.0, 20),     # max_iterations 20: frozen for the last 10
])
def test_rollout_matches_reference(offset, rot_deg, max_iterations):
    """30 f32 steps with JAX's scores injected: poses within 1e-4, commands
    within 1e-3, errors within 1e-2 cm / deg; the active mask, iterations
    and the converged and aborted flags identical."""
    pair = make_pair(max_iterations=max_iterations)
    start_p = GOAL_POS + np.asarray(offset, np.float32)
    start_q = np.asarray(jse3.rotate_about_body_x(jnp.asarray(GOAL_QUAT), np.radians(rot_deg)))
    jres, tres = _run_both(pair, start_p, start_q, key_id=5, num_steps=30)
    _hold(jres, tres)
    assert tres.position_history.shape == (30, 3)
    assert float(tres.error_history[-1, 0]) < float(tres.error_history[0, 0])
    if max_iterations == 20:
        assert bool(tres.active[:20].all()) and not bool(tres.active[20:].any())
        assert int(tres.iterations) == 20
        # frozen steps: the pose held, zero commands recorded
        assert torch.equal(tres.position_history[20:],
                           tres.position_history[19:20].expand(10, 3))
        assert not bool(tres.v_c_history[20:].any())


def test_rollout_aborts_after_ten_feature_failures():
    """With 3 pairs a step (fewer than the 4 a solve needs) every step is a
    feature failure: aborted after 10 steps with inf errors, the command
    kept at zero, as JAX."""
    pair = make_pair(max_iterations=120, num_pairs=3)
    start_p = GOAL_POS + np.asarray((0.03, 0.02, 0.05), np.float32)
    jres, tres = _run_both(pair, start_p, GOAL_QUAT, key_id=7, num_steps=14)
    _hold(jres, tres)
    assert bool(tres.aborted) and not bool(tres.converged)
    assert int(tres.active.sum()) == 10 and int(tres.iterations) == 10
    for name in ("position_error", "orientation_error", "lowest_position_error",
                 "lowest_orientation_error"):
        assert math.isinf(float(getattr(tres, name))), name
    assert not bool(tres.v_c_history.any())       # failures keep the zero command


def test_find_best_start_pose_matches_reference():
    """The 4-view search picks JAX's view on JAX's scores, and undoes a
    180 deg spin (tests/test_rollout.py's case)."""
    pair = make_pair(pixel_identity=True, octaves=(2, 5))
    jg, tg = pair.goal()
    spun = np.asarray(jse3.rotate_about_body_x(jnp.asarray(GOAL_QUAT), np.radians(180.0)))
    pos = GOAL_POS + np.array([0.0, 0.0, 0.05], np.float32)
    key = jax.random.PRNGKey(3)
    search = jax.jit(lambda p, g, x, q, k: jroll.find_best_start_pose(
        p, pair.jmodel, pair.jscene, g, x, q, k)[1])
    jq = search(pair.params, jg, jnp.asarray(pos), jnp.asarray(spun), key)
    _, tq = troll.find_best_start_pose(pair.net, pair.tmodel, pair.tscene, tg, pos, spun,
                                       scores=search_scores(key, 4, pair.t))
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), atol=1e-6)
    ang = math.degrees(float(jse3.quat_error_angle(jnp.asarray(tq.numpy()),
                                                   jnp.asarray(GOAL_QUAT))))
    assert ang < 5.0, ang


def test_benchmark_cast_goal_descriptors_match_reference():
    """The benchmark's whole-ViT bf16 cast (the patch embedding in bf16, as
    the JAX benchmark's parameter cast) against vitvs_tpu's cast parameters:
    bf16 goal descriptors within 2 bf16 ulps of their scale, every row's
    cosine >= 0.9999; the servo step's own f32 embedding gives other bits."""
    pair = make_pair(compute_dtype="bfloat16")
    jcast = jax.tree.map(lambda a: a.astype(jnp.bfloat16) if a.dtype == np.float32 else a,
                         pair.params)
    jrgb, _ = jobserve(pair.jscene, pair.jmodel.camera, jnp.asarray(GOAL_POS),
                       jnp.asarray(GOAL_QUAT))
    jgoal = jax.jit(lambda p, f: jpipe.goal_descriptors(p, pair.jmodel, f))
    jg = np.asarray(jgoal(jcast, jrgb).astype(jnp.float32))
    cast = tbench.cast_for_benchmark(pair.net, torch.bfloat16)
    assert cast.patch_embed.proj.weight.dtype == torch.bfloat16
    assert pair.net.patch_embed.proj.weight.dtype == torch.float32   # the caller's ViT is left alone
    trgb, _ = tobserve(pair.tscene, pair.tmodel.camera, torch.from_numpy(GOAL_POS),
                       torch.from_numpy(GOAL_QUAT))
    tg = tpipe.goal_descriptors(cast, pair.tmodel, trgb)
    assert tg.dtype == torch.bfloat16
    tg = tg.float().numpy()
    scale = np.abs(jg).max()
    assert np.abs(tg - jg).max() <= 2 * 2 ** -8 * scale
    cos = (tg * jg).sum(-1) / (np.linalg.norm(tg, axis=-1) * np.linalg.norm(jg, axis=-1))
    assert cos.min() >= 0.9999
    uncast = tpipe.goal_descriptors(pair.net, pair.tmodel, trgb).float().numpy()
    assert not np.array_equal(uncast, tg)
