"""The batched chunk on the CPU: B episodes a step through the renderer, the
servo step, the matcher and the ladder equal the same episodes run alone,
bit for bit (one implementation, one frame being the chunk of one), and
equal ``jax.vmap`` of vitvs_tpu's functions within the closed-loop parity
tolerances of tests/test_torch_rollout.py.  Each function the chunk goes
through is held batched against its per-episode calls on episodes that
differ, so a reduction over the batch fails it."""

import dataclasses
import math
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_rollout import (GOAL_POS, GOAL_QUAT, TRAJ_TOL, VEL_TOL, make_pair,  # noqa: E402
                                rollout_scores, search_scores)

from vitvs_tpu.control.ibvs import EmaState as JEmaState  # noqa: E402
from vitvs_tpu.core import se3 as jse3  # noqa: E402
from vitvs_tpu.harness import pipeline as jpipe  # noqa: E402
from vitvs_tpu.harness import rollout as jroll  # noqa: E402
from vitvs_tpu_torch.control import convergence as tconv  # noqa: E402
from vitvs_tpu_torch.control import ibvs as tibvs  # noqa: E402
from vitvs_tpu_torch.control.ibvs import EmaState  # noqa: E402
from vitvs_tpu_torch.core import se3 as tse3  # noqa: E402
from vitvs_tpu_torch.core.batch import item  # noqa: E402
from vitvs_tpu_torch.harness import benchmark as tbench  # noqa: E402
from vitvs_tpu_torch.harness import pipeline as tpipe  # noqa: E402
from vitvs_tpu_torch.harness import rollout as troll  # noqa: E402
from vitvs_tpu_torch.match import correspondence as tcorr  # noqa: E402
from vitvs_tpu_torch.match.binned import QuantizedBinned, quantize_binned_int8  # noqa: E402
from vitvs_tpu_torch.ops import matcher  # noqa: E402
from vitvs_tpu_torch.sim import scene as tscene  # noqa: E402
from vitvs_tpu_torch.sim.env import observe as tobserve  # noqa: E402
from vitvs_tpu_torch.sim.perturb import perturb_texture  # noqa: E402

# start offsets (m) of the chunk's episodes from the goal pose, and their spins
OFFSETS = [(0.06, -0.04, 0.08), (-0.05, 0.03, 0.05), (0.03, 0.05, 0.11)]
SPINS_DEG = [0.0, 12.0, -8.0]
OFF_POSTER = (1.5, 0.0, 0.0)      # a camera that sees only the background


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """Tiny shapes run thousands of small ops: one intra-op thread each, as
    the suite's parallel workers share the machine's cores (restored after)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _starts(offsets=OFFSETS, spins=SPINS_DEG):
    pos = np.stack([GOAL_POS + np.float32(o) for o in offsets]).astype(np.float32)
    quat = np.stack([np.asarray(jse3.rotate_about_body_x(jnp.asarray(GOAL_QUAT), np.radians(a)))
                     for a in spins]).astype(np.float32)
    return pos, quat


def _same(a, b, what=""):
    """Bit-for-bit equality through nests of NamedTuples, dicts and tensors."""
    if isinstance(a, dict):
        assert a.keys() == b.keys(), what
        for k in a:
            _same(a[k], b[k], f"{what}.{k}")
    elif isinstance(a, tuple):
        assert len(a) == len(b), what
        for name, x, y in zip(getattr(a, "_fields", range(len(a))), a, b):
            _same(x, y, f"{what}.{name}")
    else:
        assert a.dtype == b.dtype and a.shape == b.shape, (what, a.shape, b.shape)
        assert torch.equal(a, b) or (a.is_floating_point() and torch.equal(a.isnan(), b.isnan())
                                     and torch.equal(a.nan_to_num(), b.nan_to_num())), what


def _stack(items):
    """Stack per-episode nests along a new leading axis."""
    first = items[0]
    if isinstance(first, dict):
        return {k: _stack([x[k] for x in items]) for k in first}
    if isinstance(first, tuple):
        fields = [_stack(list(xs)) for xs in zip(*items)]
        return type(first)(*fields) if hasattr(first, "_fields") else tuple(fields)
    return torch.stack(items)


def _frames(pair, offsets=OFFSETS, spins=SPINS_DEG):
    pos, quat = _starts(offsets, spins)
    return tscene.render(pair.tscene, pair.tmodel.camera, torch.from_numpy(pos),
                         torch.from_numpy(quat))


def _states(n):
    """Per-episode EMA states and previous commands that differ: episode 0
    has no EMA yet, the others carry one."""
    rs = np.random.default_rng(n)
    value = torch.from_numpy((1e-3 * rs.standard_normal((n, 6))).astype(np.float32))
    init = torch.tensor([i > 0 for i in range(n)])
    prev = torch.from_numpy((1e-3 * rs.standard_normal((n, 6))).astype(np.float32))
    return EmaState(value, init), prev


@pytest.mark.parametrize("pinv_mode,subpixel,dtype", [
    ("dls", False, "float32"), ("svd", False, "float32"), ("dls", True, "float32"),
    ("svd", True, "float32"), ("dls", False, "bfloat16")])
def test_servo_step_chunk_equals_single_frames(pinv_mode, subpixel, dtype):
    """A chunk of 3 frames (the last one all background: fewer than 4
    pairs, so its command is kept) equals 3 single-frame steps bit for bit."""
    pair = make_pair(pinv_mode=pinv_mode, subpixel_matching=subpixel, compute_dtype=dtype)
    _, tg = pair.goal()
    rgb, depth = _frames(pair, OFFSETS[:2] + [OFF_POSTER])
    ema, prev = _states(3)
    scores = torch.rand((3, pair.t), generator=torch.Generator().manual_seed(1))
    chunk = tpipe.servo_step(pair.net, pair.tmodel, tg, rgb, depth, ema, prev, scores=scores)
    alone = [tpipe.servo_step(pair.net, pair.tmodel, tg, rgb[i], depth[i],
                              EmaState(ema.value[i], ema.initialized[i]), prev[i],
                              scores=scores[i]) for i in range(3)]
    _same(chunk, _stack(alone))
    assert chunk.feature_ok.tolist() == [True, True, False]
    assert torch.equal(chunk.v_c[2], prev[2]) and int(chunk.num_valid[2]) < 4


def test_servo_step_chunk_matches_vmapped_reference():
    """The chunk's step against ``jax.vmap`` of vitvs_tpu's servo_step (the
    goal unmapped) on the same frames, EMA, commands and keys: commands
    within 1e-3 (tests/test_torch_rollout.py's), the pairs and flags equal."""
    pair = make_pair()
    jg, tg = pair.goal()
    rgb, depth = _frames(pair)
    ema, prev = _states(3)
    keys = jax.vmap(jax.random.PRNGKey)(jnp.arange(3))
    step = jax.jit(jax.vmap(lambda r, d, v, i, p, k: jpipe.servo_step(
        pair.params, pair.jmodel, jg, r, d, JEmaState(v, i), p, k)))
    jres = step(jnp.asarray(rgb.numpy()), jnp.asarray(depth.numpy()),
                jnp.asarray(ema.value.numpy()), jnp.asarray(ema.initialized.numpy()),
                jnp.asarray(prev.numpy()), keys)
    scores = torch.from_numpy(np.stack([np.asarray(jax.random.uniform(k, (pair.t,)))
                                        for k in keys]))
    tres = tpipe.servo_step(pair.net, pair.tmodel, tg, rgb, depth, ema, prev, scores=scores)
    for name in ("valid", "feature_ok", "num_valid", "s_uv_star", "s_uv"):
        np.testing.assert_array_equal(getattr(tres, name).numpy(),
                                      np.asarray(getattr(jres, name)), err_msg=name)
    for name in ("v_c", "body_twist"):
        np.testing.assert_allclose(getattr(tres, name).numpy(), np.asarray(getattr(jres, name)),
                                   atol=VEL_TOL, rtol=0, err_msg=name)


def _chunk_carry(pair, offsets, spins, iteration=None):
    desired = troll.goal_pose("cpu")
    pos, quat = _starts(offsets, spins)
    carry = troll.episode_init(pos, quat, *desired)
    if iteration is not None:
        carry = carry._replace(conv=carry.conv._replace(
            iteration=torch.tensor(iteration, dtype=torch.int32)))
    return carry, desired


def test_rollout_segment_chunk_equals_episodes_alone():
    """14 steps of a chunk of 3 from carries that differ: episode 0 resumes
    at iteration 115 of 120 and freezes at the ladder's max_iterations after
    5 steps, episode 1 sees only the background and aborts after 10 feature
    failures, episode 2 runs on.  Carry and histories equal the episodes run
    alone bit for bit, each drawing its scores from its own generator."""
    pair = make_pair(max_iterations=120)
    _, tg = pair.goal()
    offsets = [OFFSETS[0], OFF_POSTER, OFFSETS[2]]
    carry, desired = _chunk_carry(pair, offsets, SPINS_DEG, iteration=[115, 0, 0])
    gens = lambda i: torch.Generator().manual_seed(100 + i)  # noqa: E731
    chunk = troll.rollout_segment(pair.net, pair.tmodel, pair.tscene, tg, carry, 14, *desired,
                                  generator=[gens(i) for i in range(3)])
    alone = [troll.rollout_segment(pair.net, pair.tmodel, pair.tscene, tg,
                                   item(carry, i), 14, *desired, generator=gens(i))
             for i in range(3)]
    _same(chunk[0], _stack([a[0] for a in alone]), "carry")
    _same(chunk[1], _stack([a[1] for a in alone]), "histories")
    active = chunk[1]["active"].sum(1).tolist()
    assert active == [5, 10, 14]
    assert chunk[0].conv.done.tolist() == [True, False, False]
    assert chunk[0].aborted.tolist() == [False, True, False]


def test_rollout_segment_chunk_matches_vmapped_reference():
    """20 steps of a chunk of 3 against ``jax.vmap`` of vitvs_tpu's
    rollout_segment, JAX's per-episode scores injected: poses within 1e-4,
    commands within 1e-3, the active masks equal."""
    pair = make_pair(max_iterations=120)
    jg, tg = pair.goal()
    pos, quat = _starts()
    keys = [jax.random.PRNGKey(20 + i) for i in range(3)]
    dp, dq = jnp.asarray(GOAL_POS), jnp.asarray(GOAL_QUAT)
    jcarry = jax.vmap(lambda p, q, k: jroll.episode_init(p, q, k, dp, dq))(
        jnp.asarray(pos), jnp.asarray(quat), jnp.stack(keys))
    seg = jax.jit(jax.vmap(lambda c: jroll.rollout_segment(pair.params, pair.jmodel, pair.jscene,
                                                           jg, c, 20, dp, dq)))
    jc, jys = seg(jcarry)
    desired = troll.goal_pose("cpu")
    carry = troll.episode_init(pos, quat, *desired)
    scores = torch.stack([rollout_scores(k, 20, pair.t) for k in keys])
    tc, tys = troll.rollout_segment(pair.net, pair.tmodel, pair.tscene, tg, carry, 20, *desired,
                                    scores=scores)
    np.testing.assert_array_equal(tys["active"].numpy(), np.asarray(jys["active"]))
    for name in ("position", "quat"):
        np.testing.assert_allclose(tys[name].numpy(), np.asarray(jys[name]), atol=TRAJ_TOL,
                                   rtol=0, err_msg=name)
    for name in ("v_c", "twist"):
        np.testing.assert_allclose(tys[name].numpy(), np.asarray(jys[name]), atol=VEL_TOL,
                                   rtol=0, err_msg=name)
    np.testing.assert_array_equal(tc.conv.iteration.numpy(), np.asarray(jc.conv.iteration))


def test_find_best_start_pose_chunk_equals_single_searches():
    """The search over a chunk of 3 poses (their 12 views in one render, one
    forward and one match) equals 3 single searches, and against ``jax.vmap``
    of the reference on its scores picks the same views, undoing the spins."""
    pair = make_pair(pixel_identity=True, octaves=(2, 5))
    jg, tg = pair.goal()
    spins = [180.0, 90.0, 0.0]
    pos, quat = _starts([(0.0, 0.0, 0.05), (0.01, -0.01, 0.04), (-0.01, 0.0, 0.06)], spins)
    gens = lambda i: torch.Generator().manual_seed(1000 + i)  # noqa: E731
    _, chunk = troll.find_best_start_pose(pair.net, pair.tmodel, pair.tscene, tg, pos, quat,
                                          generator=[gens(i) for i in range(3)])
    alone = [troll.find_best_start_pose(pair.net, pair.tmodel, pair.tscene, tg, pos[i], quat[i],
                                        generator=gens(i))[1] for i in range(3)]
    _same(chunk, torch.stack(alone))
    keys = [jax.random.PRNGKey(3 + i) for i in range(3)]
    search = jax.jit(jax.vmap(lambda x, q, k: jroll.find_best_start_pose(
        pair.params, pair.jmodel, pair.jscene, jg, x, q, k)[1]))
    jq = search(jnp.asarray(pos), jnp.asarray(quat), jnp.stack(keys))
    scores = torch.stack([search_scores(k, 4, pair.t) for k in keys])
    _, tq = troll.find_best_start_pose(pair.net, pair.tmodel, pair.tscene, tg, pos, quat,
                                       scores=scores)
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), atol=1e-6)
    for q in tq:
        assert math.degrees(float(jse3.quat_error_angle(jnp.asarray(q.numpy()),
                                                        jnp.asarray(GOAL_QUAT)))) < 5.0


@pytest.mark.parametrize("mode", ["bf16", "f32"])
def test_batched_matcher_plain_equals_single_calls(mode):
    """The matcher's plain version (what the CPU takes) on one goal against a
    batch of frames equals one call per frame, bit for bit."""
    fn = matcher.dual_argmax_cosine_bf16 if mode == "bf16" else matcher.dual_argmax_cosine
    rs = np.random.default_rng(5)
    a = torch.from_numpy(rs.standard_normal((49, 72)).astype(np.float32)).bfloat16()
    b = torch.from_numpy(rs.standard_normal((4, 40, 72)).astype(np.float32)).bfloat16()
    got = fn(a, b)
    assert got[0].shape == (4, 49) and got[3].shape == (4, 40)
    _same(tuple(got), _stack([tuple(fn(a, b[i])) for i in range(4)]))


def _cat(items):
    """Concatenate per-episode nests along their leading axis."""
    first = items[0]
    if isinstance(first, tuple):
        fields = [_cat(list(xs)) for xs in zip(*items)]
        return type(first)(*fields) if hasattr(first, "_fields") else tuple(fields)
    return torch.cat(items)


def _per_episode(fn, batched_args, n):
    """``fn`` on the batched args, and on each episode's slice of them (a
    chunk of one, as the single-episode entry points run it)."""
    one = lambda i: [x[i:i + 1] for x in batched_args]  # noqa: E731
    return fn(*batched_args), _cat([fn(*one(i)) for i in range(n)])


def _rand(*shape, seed=0, scale=1.0):
    return torch.from_numpy((scale * np.random.default_rng(seed).standard_normal(shape))
                            .astype(np.float32))


def _quats(n, seed):
    q = _rand(n, 4, seed=seed)
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)


def _match_inputs(n=3):
    """Goal descriptors, a chunk of frames' (the second a copy of the goal:
    the same-image shortcut) on a 5 x 6 grid, and scores."""
    goal = _rand(30, 16, seed=1)
    cur = torch.stack([_rand(30, 16, seed=2), goal, goal + 0.3 * _rand(30, 16, seed=3)])[:n]
    return goal, cur, torch.rand((n, 30), generator=torch.Generator().manual_seed(4))


def _find(goal, cur, scores):
    return tcorr.find_correspondences(goal, cur, (5, 6), 8, scores, use_kernel=False)


def _refine(goal, cur, scores):
    return tcorr.refine_matches_subpixel(goal, cur, _find(goal, cur, scores), (5, 6))


def _convergence(v, et, er, ok):
    """12 ladder steps from initial errors; the episodes' rings fill at
    other rates (feature failures), so their write positions differ."""
    cfg = make_pair().tmodel.cfg.replace(min_iterations=3, max_iterations=40)
    state = tconv.convergence_init(et[..., 0] * 10, er[..., 0] * 10)
    for i in range(12):
        state = tconv.convergence_step(state, v[..., i, :], et[..., i], er[..., i], cfg,
                                       update_velocity=ok[..., i])
    return state


def _scene(textures):
    return tscene.Scene.create(np.zeros((40, 50, 3), np.float32), half_size=0.42,
                               device="cpu").with_texture(textures)


TEXTURES = torch.stack([perturb_texture(torch.Generator().manual_seed(i), torch.full(
    (40, 50, 3), 0.5) + 0.3 * _rand(40, 50, 1, seed=9)).clamp(0, 1) for i in range(3)])
TRAP_CASES = {
    "se3.matrix_from_quat": (tse3.matrix_from_quat, [_quats(3, 0)]),
    "se3.quat_rotate": (tse3.quat_rotate, [_quats(3, 1), _rand(3, 3, seed=2)]),
    "se3.integrate_body_twist": (lambda p, q, w: torch.cat(tse3.integrate_body_twist(p, q, w, 0.1),
                                                           -1),
                                 [_rand(3, 3, seed=3), _quats(3, 4), _rand(3, 6, seed=5)]),
    "se3.quat_error_angle": (tse3.quat_error_angle, [_quats(3, 6), _quats(3, 7)]),
    "se3.rotate_about_body_x": (lambda q: tse3.rotate_about_body_x(
        q[..., None, :], torch.tensor([0.0, 1.0, 2.5])), [_quats(3, 8)]),
    "rollout.pose_errors": (lambda p, q: torch.stack(troll.pose_errors(
        p, q, torch.from_numpy(GOAL_POS), torch.from_numpy(GOAL_QUAT)), -1),
        [torch.from_numpy(GOAL_POS) + _rand(3, 3, seed=9, scale=0.05), _quats(3, 10)]),
    "scene.render": (lambda p, q: tscene.render(
        tscene.Scene.create(np.asarray(TEXTURES[0]), device="cpu"),
        tscene.CameraIntrinsics(width=40, height=30, fx=30.0, fy=30.0), p, q),
        [torch.from_numpy(_starts()[0]), torch.from_numpy(_starts()[1])]),
    "scene.render, a texture an episode": (
        lambda tex, p, q: tscene.render(_scene(tex), tscene.CameraIntrinsics(
            width=40, height=30, fx=30.0, fy=30.0), p, q)[0],
        [TEXTURES, torch.from_numpy(_starts()[0]), torch.from_numpy(_starts()[1])]),
    "ibvs.interaction_matrix": (tibvs.interaction_matrix,
                                [_rand(3, 8, 2, seed=11, scale=0.3),
                                 0.6 + _rand(3, 8, seed=12, scale=0.05)]),
    "ibvs.ibvs_velocity, dls": (
        lambda s, ss, z, m: tibvs.ibvs_velocity(s, ss, z, 0.5, valid=m, mode="dls"),
        [_rand(3, 8, 2, seed=13, scale=0.3), _rand(3, 8, 2, seed=14, scale=0.3),
         0.6 + _rand(3, 8, seed=15, scale=0.05),
         torch.tensor([[True] * 8, [True] * 2 + [False] * 6, [True] * 5 + [False] * 3])]),
    "ibvs.ibvs_velocity, svd": (
        lambda s, ss, z, m: tibvs.ibvs_velocity(s, ss, z, 0.5, valid=m, mode="svd"),
        [_rand(3, 8, 2, seed=16, scale=0.3), _rand(3, 8, 2, seed=17, scale=0.3),
         0.6 + _rand(3, 8, seed=18, scale=0.05),
         torch.tensor([[True] * 8, [True] * 2 + [False] * 6, [True] * 5 + [False] * 3])]),
    "ibvs.depth_at_points": (tibvs.depth_at_points,
                             [torch.round(_rand(3, 30, 40, seed=19).abs() * 1000) / 1000,
                              torch.stack([_rand(3, 8, seed=20).abs() * 45,
                                           _rand(3, 8, seed=21).abs() * 35], -1)]),
    "ibvs.ema_update": (lambda v, i, new: tuple(tibvs.ema_update(EmaState(v, i), new, 0.8)[0]),
                        [_rand(3, 6, seed=22), torch.tensor([True, False, True]),
                         _rand(3, 6, seed=23)]),
    "convergence.convergence_step": (
        _convergence, [1e-4 * _rand(3, 12, 6, seed=24), 0.1 + _rand(3, 12, seed=25).abs(),
                       0.1 + _rand(3, 12, seed=26).abs(),
                       torch.from_numpy(np.random.default_rng(27).random((3, 12)) > 0.3)]),
    "correspondence.find_correspondences": (_find, list(_match_inputs())),
    "correspondence.refine_matches_subpixel": (_refine, list(_match_inputs())),
    "correspondence.match_points_to_pixels": (
        lambda p: tcorr.match_points_to_pixels(p, 6, 84, (96, 72), round_px=False),
        [_rand(3, 8, 2, seed=28).abs() * 5]),
}


@pytest.mark.parametrize("case", sorted(TRAP_CASES))
def test_chunk_functions_reduce_per_episode(case):
    """Each function of the chunk's path, on a batch of 3 episodes that
    differ, equals its calls on each episode alone (a chunk of one; the
    matcher's cases on one frame) bit for bit."""
    fn, args = TRAP_CASES[case]
    if case == "correspondence.find_correspondences" or case.startswith("correspondence.refine"):
        goal, cur, scores = args
        got = fn(goal, cur, scores)
        want = _stack([fn(goal, cur[i], scores[i]) for i in range(3)])
        assert got.same_image.tolist() == [False, True, False]
    else:
        got, want = _per_episode(fn, args, 3)
    _same(got, want, case)


def test_dls_singular_episode_leaves_the_others():
    """dls over a chunk where one episode has 2 live pairs (L^T L singular in
    f32, fault 3.1): its command is non-finite, the others' are finite (and
    as if solved alone: the case above)."""
    fn, args = TRAP_CASES["ibvs.ibvs_velocity, dls"]
    got = fn(*args)
    assert not bool(torch.isfinite(got[1]).any())
    assert bool(torch.isfinite(got[[0, 2]]).all())


def test_step_fn_servo_step_equals_the_default():
    """rollout_segment's hook: a step_fn that calls servo_step runs the
    chunk as the default step does, bit for bit."""
    pair = make_pair(max_iterations=120)
    _, tg = pair.goal()
    carry, desired = _chunk_carry(pair, OFFSETS, SPINS_DEG)
    scores = torch.rand((3, 6, pair.t), generator=torch.Generator().manual_seed(7))

    def step_fn(rgb, depth, ema, prev_v_c, s):
        return tpipe.servo_step(pair.net, pair.tmodel, tg, rgb, depth, ema, prev_v_c, scores=s)

    default = troll.rollout_segment(pair.net, pair.tmodel, pair.tscene, tg, carry, 6, *desired,
                                    scores=scores)
    hooked = troll.rollout_segment(None, pair.tmodel, pair.tscene, None, carry, 6, *desired,
                                   scores=scores, step_fn=step_fn)
    _same(default, hooked)


def test_constant_twist_step_fn_integrates_as_the_reference():
    """A step_fn that commands a constant body twist: rollout_episode
    integrates it as vitvs_tpu's rollout_episode does with the same
    override (poses within 1e-4), the commands recorded as given."""
    pair = make_pair(max_iterations=120)
    twist = np.float32([0.01, -0.02, 0.005, 0.02, 0.0, -0.03])
    pos, quat = _starts()

    def tstep(rgb, depth, ema, prev_v_c, s):
        n = rgb.shape[0]
        tw = torch.from_numpy(twist).expand(n, 6)
        return tpipe.StepResult(v_c=tw, body_twist=tw, ema=ema,
                                feature_ok=torch.ones(n, dtype=torch.bool),
                                num_valid=torch.full((n,), 16, dtype=torch.int32),
                                mean_sim=torch.ones(n), s_uv=torch.zeros(n, 16, 2),
                                s_uv_star=torch.zeros(n, 16, 2),
                                valid=torch.ones(n, 16, dtype=torch.bool))

    def jstep(rgb, depth, ema, prev_v, key):
        tw = jnp.asarray(twist)
        return jpipe.StepResult(v_c=tw, body_twist=tw, ema=ema, feature_ok=jnp.asarray(True),
                                num_valid=jnp.asarray(16, jnp.int32), mean_sim=jnp.asarray(1.0),
                                s_uv=jnp.zeros((16, 2)), s_uv_star=jnp.zeros((16, 2)),
                                valid=jnp.ones(16, bool))

    jres = jax.jit(jax.vmap(lambda p, q, k: jroll.rollout_episode(
        pair.params, pair.jmodel, pair.jscene, None, p, q, k, num_steps=12, step_fn=jstep)))(
        jnp.asarray(pos), jnp.asarray(quat), jnp.stack([jax.random.PRNGKey(i) for i in range(3)]))
    tres = troll.rollout_episode(None, pair.tmodel, pair.tscene, None, pos, quat,
                                 scores=torch.zeros(3, 12, pair.t), num_steps=12, step_fn=tstep)
    for name in ("position_history", "orientation_history", "final_position", "final_quat"):
        np.testing.assert_allclose(getattr(tres, name).numpy(), np.asarray(getattr(jres, name)),
                                   atol=TRAJ_TOL, rtol=0, err_msg=name)
    np.testing.assert_array_equal(tres.applied_twist_history.numpy(),
                                  np.broadcast_to(twist, (3, 12, 6)))


def _int8_pair(pair, pool_where="post"):
    """The pair's ViT in the int8 serving configuration of run AD (2 x 2 K/V
    pooling by the matrix, 'nomax3', conv patch embed, 'default' resize,
    static scales calibrated on the goal view and the chunk's start views,
    source-quantized bins), through harness/benchmark.py's int8_serving."""
    model = dataclasses.replace(pair.tmodel, vit=dataclasses.replace(
        pair.tmodel.vit, kv_pool=2, kv_pool_impl="matmul", kv_pool_where=pool_where))
    pos, quat = _starts()
    calib = (np.concatenate([GOAL_POS[None], pos]), np.concatenate([GOAL_QUAT[None], quat]))
    qnet, qmodel = tbench.int8_serving(pair.net, model, pair.tscene, calib)
    assert qmodel.quantized and qmodel.source_quantized_bins and qmodel.pp_precision == "default"
    assert (qmodel.vit.quant_attn, qmodel.vit.patch_embed_impl) == ("nomax3", "conv")
    return qnet, qmodel


def _int8_goal(pair, qnet, qmodel):
    rgb, _ = tobserve(pair.tscene, qmodel.camera, torch.from_numpy(GOAL_POS),
                      torch.from_numpy(GOAL_QUAT))
    return tpipe.goal_descriptors(qnet, qmodel, rgb)


@pytest.mark.parametrize("pool_where", ["post", "pre"])
def test_int8_paths_take_one_frame(pool_where):
    """The int8 serving step on a chunk of 3 frames (the last one all
    background) equals the 3 frames stepped alone bit for bit: one forward,
    the batched source quantizer, one int8 product against the goal and
    each frame's max/argmax.  int8 matching of a chunk of float rows
    (``int8=True``) and of QuantizedBinned rows equals its frames matched
    alone, and the batched quantizer its frames quantized alone."""
    pair = make_pair(compute_dtype="bfloat16")
    qnet, qmodel = _int8_pair(pair, pool_where)
    goal = _int8_goal(pair, qnet, qmodel)
    assert isinstance(goal, QuantizedBinned) and goal.q.dtype == torch.int8
    rgb, depth = _frames(pair, OFFSETS[:2] + [OFF_POSTER])
    ema, prev = _states(3)
    scores = torch.rand((3, pair.t), generator=torch.Generator().manual_seed(1))
    chunk = tpipe.servo_step(qnet, qmodel, goal, rgb, depth, ema, prev, scores=scores)
    alone = [tpipe.servo_step(qnet, qmodel, goal, rgb[i], depth[i],
                              EmaState(ema.value[i], ema.initialized[i]), prev[i],
                              scores=scores[i]) for i in range(3)]
    _same(chunk, _stack(alone))
    assert chunk.feature_ok.tolist() == [True, True, False]
    descs = tpipe.batch_descriptors(qnet, qmodel, rgb)
    _same(descs, _stack([tpipe.goal_descriptors(qnet, qmodel, rgb[i]) for i in range(3)]))
    base = _rand(3, 30, 16, seed=9)
    _same(quantize_binned_int8(base, (5, 6)),
          _stack([quantize_binned_int8(base[i], (5, 6)) for i in range(3)]))
    goal_f, cur_f, sc = _match_inputs(3)
    for g, c in ((goal_f, cur_f), (quantize_binned_int8(goal_f, (5, 6)),
                                   quantize_binned_int8(cur_f, (5, 6)))):
        m = tcorr.find_correspondences(g, c, (5, 6), 8, sc, use_kernel=False, int8=True)
        _same(m, _stack([tcorr.find_correspondences(g, item(c, i), (5, 6), 8, sc[i],
                                                    use_kernel=False, int8=True)
                         for i in range(3)]))


def test_int8_rollout_segment_chunk_equals_episodes_alone():
    """12 steps of an int8 chunk of 3 (run AD's settings, as above) from
    carries that differ (episode 1 sees only the background and aborts
    after 10 feature failures), each episode drawing from its own
    generator: carry and histories equal the episodes run alone bit for
    bit."""
    pair = make_pair(compute_dtype="bfloat16")
    qnet, qmodel = _int8_pair(pair)
    goal = _int8_goal(pair, qnet, qmodel)
    carry, desired = _chunk_carry(pair, [OFFSETS[0], OFF_POSTER, OFFSETS[2]], SPINS_DEG)
    gens = lambda i: torch.Generator().manual_seed(200 + i)  # noqa: E731
    chunk = troll.rollout_segment(qnet, qmodel, pair.tscene, goal, carry, 12, *desired,
                                  generator=[gens(i) for i in range(3)])
    alone = [troll.rollout_segment(qnet, qmodel, pair.tscene, goal, item(carry, i), 12,
                                   *desired, generator=gens(i)) for i in range(3)]
    _same(chunk[0], _stack([a[0] for a in alone]), "carry")
    _same(chunk[1], _stack([a[1] for a in alone]), "histories")
    assert chunk[0].aborted.tolist() == [False, True, False]


def test_int8_search_chunk_equals_single_searches():
    """The int8 rotation search over a chunk of 3 poses (12 views in one
    forward, source-quantized, one int8 product) equals 3 single searches."""
    pair = make_pair(compute_dtype="bfloat16", pixel_identity=True, octaves=(2, 5))
    qnet, qmodel = _int8_pair(pair)
    goal = _int8_goal(pair, qnet, qmodel)
    pos, quat = _starts([(0.0, 0.0, 0.05), (0.01, -0.01, 0.04), (-0.01, 0.0, 0.06)],
                        [180.0, 90.0, 0.0])
    gens = lambda i: torch.Generator().manual_seed(1000 + i)  # noqa: E731
    _, chunk = troll.find_best_start_pose(qnet, qmodel, pair.tscene, goal, pos, quat,
                                          generator=[gens(i) for i in range(3)])
    alone = [troll.find_best_start_pose(qnet, qmodel, pair.tscene, goal, pos[i], quat[i],
                                        generator=gens(i))[1] for i in range(3)]
    _same(chunk, torch.stack(alone))
