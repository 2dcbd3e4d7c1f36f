"""Port parity: factorized binned matching (``ServoModel.fast_binned_match``,
``match/binned.py:binned_cosine_similarity``) against ``jax.jit`` of
vitvs_tpu's, float and int8, one frame and a chunk: the similarity, its
identity with the materialized binned path, the match and the subpixel
refinement on it, the servo step, the rotation search and
``matching_quality``."""

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
from test_torch_pipeline import _frames, _setup  # noqa: E402
from test_torch_rollout import GOAL_POS, GOAL_QUAT, make_pair, search_scores  # noqa: E402

from vitvs_tpu.control import EmaState as JEma  # noqa: E402
from vitvs_tpu.core import se3 as jse3  # noqa: E402
from vitvs_tpu.harness import pipeline as jpipe  # noqa: E402
from vitvs_tpu.harness import rollout as jroll  # noqa: E402
from vitvs_tpu.match import binned as jbinned  # noqa: E402
from vitvs_tpu.match import correspondence as jcorr  # noqa: E402
from vitvs_tpu.models import quant as jquant  # noqa: E402
from vitvs_tpu.sim.env import observe as jobserve  # noqa: E402
from vitvs_tpu_torch.control.ibvs import EmaState as TEma  # noqa: E402
from vitvs_tpu_torch.core.batch import item  # noqa: E402
from vitvs_tpu_torch.harness import pipeline as tpipe  # noqa: E402
from vitvs_tpu_torch.harness import rollout as troll  # noqa: E402
from vitvs_tpu_torch.io_bridge.config import VSConfig as TVSConfig  # noqa: E402
from vitvs_tpu_torch.match import binned as tbinned  # noqa: E402
from vitvs_tpu_torch.match import correspondence as tcorr  # noqa: E402
from vitvs_tpu_torch.models import vit as tvit  # noqa: E402
from vitvs_tpu_torch.models.convert import from_jax_quant_params  # noqa: E402
from vitvs_tpu_torch.models.extractor import log_bin  # noqa: E402
from vitvs_tpu_torch.sim.env import observe as tobserve  # noqa: E402
from vitvs_tpu_torch.sim.scene import Scene, make_synthetic_poster  # noqa: E402
from vitvs_tpu_torch.train import finetune as tft  # noqa: E402

GRID = (6, 5)                 # a grid that is not square catches a swapped axis
T = GRID[0] * GRID[1]


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One intra-op thread: the chunk's products then sum each entry as a
    frame's alone does (restored after)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _descs(n, d=48, seed=0, dtype=np.float32):
    rs = np.random.default_rng(seed)
    base = rs.standard_normal((d,)).astype(np.float32)      # a shared offset: cosines near 1
    out = [0.5 * base + rs.standard_normal((T, d)).astype(np.float32) for _ in range(n)]
    return np.stack(out).astype(dtype)


def _jit_binned(a, b, int8):
    return np.asarray(jax.jit(lambda x, y: jbinned.binned_cosine_similarity(
        x, y, GRID, int8=int8))(jnp.asarray(a), jnp.asarray(b)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("int8", [False, True], ids=["float", "int8"])
def test_binned_cosine_similarity_matches(int8, dtype):
    """One frame and a chunk of 3 against the jitted reference, within 2e-6
    (f32 sums in other orders; the int8 products exact and the row
    quantizer the reference's bit for bit); each frame of the chunk equal
    to it alone bit for bit."""
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    goal = np.asarray(jnp.asarray(_descs(1, seed=1)[0]).astype(jdt))
    frames = np.asarray(jnp.asarray(_descs(3, seed=2)).astype(jdt))
    tdt = getattr(torch, dtype)
    tg = torch.from_numpy(goal.astype(np.float32)).to(tdt)
    tf = torch.from_numpy(frames.astype(np.float32)).to(tdt)
    chunk = tbinned.binned_cosine_similarity(tg, tf, GRID, int8=int8)
    assert chunk.shape == (3, T, T) and chunk.dtype == torch.float32
    for b in range(3):
        alone = tbinned.binned_cosine_similarity(tg, tf[b], GRID, int8=int8)
        assert alone.shape == (T, T)
        assert torch.equal(alone, chunk[b]), b
        ref = _jit_binned(goal, frames[b], int8)
        np.testing.assert_allclose(alone.numpy(), ref, rtol=0, atol=2e-6)


def test_factorized_equals_materialized_binned_cosine():
    """The identity the reference's tests/test_match.py holds: the
    factorized similarity equals the cosine of log_bin's materialized rows,
    within 1e-6 in f32."""
    goal, frames = _descs(1, seed=3)[0], _descs(2, seed=4)
    tg, tf = torch.from_numpy(goal), torch.from_numpy(frames)
    fast = tbinned.binned_cosine_similarity(tg, tf, GRID)
    bg = log_bin(tg[None], GRID)[0]
    for b in range(2):
        mat = tcorr.cosine_similarity_matrix(bg, log_bin(tf[b][None], GRID)[0])
        np.testing.assert_allclose(fast[b].numpy(), mat.numpy(), rtol=0, atol=1e-6)


@pytest.mark.parametrize("int8", [False, True], ids=["float", "int8"])
def test_match_and_refinement_on_the_similarity_match_reference(int8):
    """find_correspondences(sim_matrix=) and refine_matches_subpixel(
    sim_matrix=) on the factorized similarity against the jitted reference
    on the same pair scores (JAX's): the same pairs, offsets within 1e-4; a
    chunk's match equals its frames' alone bit for bit; use_kernel with a
    given similarity raises."""
    goal, frames = _descs(1, seed=5)[0], _descs(2, seed=6)
    tg, tf = torch.from_numpy(goal), torch.from_numpy(frames)
    sim = tbinned.binned_cosine_similarity(tg, tf, GRID, int8=int8)
    keys = [jax.random.PRNGKey(7 + b) for b in range(2)]
    scores = torch.from_numpy(np.stack([np.asarray(jax.random.uniform(k, (T,))) for k in keys]))

    @jax.jit
    def ref_fn(g, f, k):
        s = jbinned.binned_cosine_similarity(g, f, GRID, int8=int8)
        m = jcorr.find_correspondences(g, f, GRID, 8, k, sim_matrix=s, int8=int8)
        return jcorr.refine_matches_subpixel(g, f, m, GRID, sim_matrix=s)

    m = tcorr.find_correspondences(tg, tf, GRID, 8, scores, use_kernel=False, int8=int8,
                                   sim_matrix=sim)
    r = tcorr.refine_matches_subpixel(tg, tf, m, GRID, sim_matrix=sim)
    for b in range(2):
        ref = ref_fn(jnp.asarray(goal), jnp.asarray(frames[b]), keys[b])
        rb = item(r, b)
        np.testing.assert_array_equal(rb.valid.numpy(), np.asarray(ref.valid))
        np.testing.assert_array_equal(rb.points1.numpy(), np.asarray(ref.points1))
        np.testing.assert_allclose(rb.points2.numpy(), np.asarray(ref.points2), rtol=0, atol=1e-4)
        alone = tcorr.find_correspondences(tg, tf[b], GRID, 8, scores[b], use_kernel=False,
                                           int8=int8, sim_matrix=sim[b])
        ra = tcorr.refine_matches_subpixel(tg, tf[b], alone, GRID, sim_matrix=sim[b])
        for name in ("points1", "points2", "sim", "valid"):
            assert torch.equal(getattr(ra, name), getattr(rb, name)), name
    with pytest.raises(ValueError, match="sim_matrix"):
        tcorr.find_correspondences(tg, tf, GRID, 8, scores, use_kernel=True, sim_matrix=sim)


def test_refinement_on_the_similarity_reproduces_the_materialized_path():
    """The reference's test_match.py case in the port: match and refine on
    the factorized similarity reproduce match and refine on the materialized
    binned rows: the same valid slots, offsets within 1e-3."""
    goal, frame = _descs(1, d=24, seed=8)[0], _descs(1, d=24, seed=9)[0]
    tg, tf = torch.from_numpy(goal), torch.from_numpy(frame)
    scores = torch.rand(T, generator=torch.Generator().manual_seed(0))
    sim = tbinned.binned_cosine_similarity(tg, tf, GRID)
    fast = tcorr.refine_matches_subpixel(tg, tf, tcorr.find_correspondences(
        tg, tf, GRID, 8, scores, use_kernel=False, sim_matrix=sim), GRID, sim_matrix=sim)
    bg, bf = log_bin(tg[None], GRID)[0], log_bin(tf[None], GRID)[0]
    mat = tcorr.refine_matches_subpixel(bg, bf, tcorr.find_correspondences(
        bg, bf, GRID, 8, scores, use_kernel=False, use_match_kernel=True), GRID)
    np.testing.assert_array_equal(fast.valid.numpy(), mat.valid.numpy())
    np.testing.assert_allclose(fast.points2.numpy(), mat.points2.numpy(), rtol=0, atol=1e-3)


# ---------------------------------------------------------------------------
# the servo step, the search, matching_quality
# ---------------------------------------------------------------------------


def _fast_models(quantized: bool):
    """The tiny step of tests/test_torch_pipeline.py (96 wide, 6 x 6 grid,
    binned, subpixel on) with fast_binned_match, float or int8 (the
    reference's int8 weights, static scales calibrated on the goal and the
    frames, loaded into the port as tests/test_torch_quant.py loads them)."""
    params, jmodel, tmodel, net = _setup(pinv_mode="dls", subpixel_matching=True)
    jmodel = dataclasses.replace(jmodel, fast_binned_match=True, quantized=quantized)
    tmodel = dataclasses.replace(tmodel, fast_binned_match=True, quantized=quantized)
    assert not (jmodel.materialize_bins or tmodel.materialize_bins)
    assert not (jmodel.source_quantized_bins or tmodel.source_quantized_bins)
    assert tmodel.desc_dim() == jmodel.desc_dim() == 96
    goal, frames, depth = _frames([(18, 20), (16, 17), (10, 15)])
    if quantized:
        jcal = jnp.stack([jpipe.preprocess(jmodel, jnp.asarray(f)) for f in (goal, *frames)])
        params = jax.tree.map(np.asarray, jquant.quantize_vit_params(
            params, cfg=jmodel.vit, calib_images=jcal, layer=jmodel.cfg.layer,
            compute_dtype=jnp.float32))
        net = from_jax_quant_params(params, tmodel.vit, torch.float32)
    return params, jmodel, tmodel, net, goal, frames, depth


@pytest.mark.parametrize("quantized", [False, True], ids=["float", "int8"])
def test_fast_binned_servo_step_matches(quantized):
    """goal_descriptors (unbinned) and 3 servo steps against the jitted
    reference step on its pair scores: the same valid pairs, goal points
    equal, current points within 1e-3 px (int8: 5e-2), twists within 1e-3;
    then the 3 frames as one chunk equal the steps alone bit for bit."""
    params, jmodel, tmodel, net, goal, frames, depth = _fast_models(quantized)
    jg = jax.jit(jpipe.goal_descriptors, static_argnums=1)(params, jmodel, jnp.asarray(goal))
    tg = tpipe.goal_descriptors(net, tmodel, goal)
    assert tg.shape == jg.shape == (36, 96)
    if quantized:
        # the two preprocesses differ in the last bit (3.6e-7 here), and a
        # static int8 activation near a rounding tie then moves by one step:
        # within 1e-2 of the scale, 5e-4 on average (tests/test_torch_quant.py's
        # _hold_loose); on the same input the int8 forwards agree within 1e-6
        scale = np.abs(np.asarray(jg)).max()
        assert np.abs(tg.numpy() - np.asarray(jg)).max() <= 1e-2 * scale
        assert np.abs(tg.numpy() - np.asarray(jg)).mean() <= 5e-4 * scale
    else:
        np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-5, atol=1e-5)
    jstep = jax.jit(jpipe.servo_step, static_argnums=1)
    t = tg.shape[0]
    keys = [jax.random.PRNGKey(40 + i) for i in range(len(frames))]
    scores = torch.from_numpy(np.stack([np.asarray(jax.random.uniform(k, (t,))) for k in keys]))
    alone = []
    for i, frame in enumerate(frames):
        jr = jstep(params, jmodel, jg, jnp.asarray(frame), jnp.asarray(depth), JEma.init(),
                   jnp.zeros(6), keys[i])
        tr = tpipe.servo_step(net, tmodel, tg, frame, depth, TEma.init(device="cpu"),
                              torch.zeros(6), scores=scores[i])
        for name in ("valid", "num_valid", "feature_ok"):
            np.testing.assert_array_equal(getattr(tr, name).numpy(),
                                          np.asarray(getattr(jr, name)), err_msg=name)
        np.testing.assert_array_equal(tr.s_uv_star.numpy(), np.asarray(jr.s_uv_star))
        # int8: the moved activations above move a sub-patch offset by
        # hundredths of a pixel; the twists stay within 1e-3
        np.testing.assert_allclose(tr.s_uv.numpy(), np.asarray(jr.s_uv),
                                   atol=5e-2 if quantized else 1e-3)
        for name in ("v_c", "body_twist"):
            np.testing.assert_allclose(getattr(tr, name).numpy(),
                                       np.asarray(getattr(jr, name)), atol=1e-3, err_msg=name)
        assert bool(tr.feature_ok) and float(torch.abs(tr.v_c).max()) > 1e-2
        alone.append(tr)
    nb = len(frames)
    chunk = tpipe.servo_step(net, tmodel, tg, np.stack(frames), np.stack([depth] * nb),
                             TEma.init(batch=(nb,), device="cpu"), torch.zeros(nb, 6),
                             scores=scores)
    for i, tr in enumerate(alone):
        for name in ("v_c", "body_twist", "s_uv", "s_uv_star", "valid", "mean_sim"):
            assert torch.equal(getattr(item(chunk, i), name), getattr(tr, name)), (i, name)


def _goals(pair, jmodel, tmodel):
    """The goal view's descriptors in both packages (tests/test_torch_rollout.py's Pair.goal)."""
    jrgb, _ = jobserve(pair.jscene, jmodel.camera, jnp.asarray(GOAL_POS), jnp.asarray(GOAL_QUAT))
    trgb, _ = tobserve(pair.tscene, tmodel.camera, torch.from_numpy(GOAL_POS),
                       torch.from_numpy(GOAL_QUAT))
    jg = jax.jit(lambda p, f: jpipe.goal_descriptors(p, jmodel, f))(pair.params, jrgb)
    return jg, tpipe.goal_descriptors(pair.net, tmodel, trgb)


def test_fast_binned_search_matches_reference():
    """The rotation search scored on the factorized similarity picks the
    jitted reference's view on its scores, and undoes a 180 deg spin."""
    pair = make_pair(pixel_identity=True, octaves=(2, 5))
    jmodel = dataclasses.replace(pair.jmodel, fast_binned_match=True)
    tmodel = dataclasses.replace(pair.tmodel, fast_binned_match=True)
    jg, tg = _goals(pair, jmodel, tmodel)
    assert tg.shape[-1] == tmodel.desc_dim() == 192
    spun = np.asarray(jse3.rotate_about_body_x(jnp.asarray(GOAL_QUAT), np.radians(180.0)))
    pos = GOAL_POS + np.array([0.0, 0.0, 0.05], np.float32)
    key = jax.random.PRNGKey(3)
    jq = jax.jit(lambda p, g, x, q, k: jroll.find_best_start_pose(
        p, jmodel, pair.jscene, g, x, q, k)[1])(pair.params, jg, jnp.asarray(pos),
                                                jnp.asarray(spun), key)
    _, tq = troll.find_best_start_pose(pair.net, tmodel, pair.tscene, tg, pos, spun,
                                       scores=search_scores(key, 4, pair.t))
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), atol=1e-6)
    ang = math.degrees(float(jse3.quat_error_angle(jnp.asarray(tq.numpy()),
                                                   jnp.asarray(GOAL_QUAT))))
    assert ang < 5.0, ang


@pytest.mark.parametrize("quantized", [False, True], ids=["float", "int8"])
def test_matching_quality_on_the_factorized_path(quantized):
    """matching_quality with fast_binned_match on a tiny binned model
    (tests/test_torch_train.py's, 64 wide, 8 x 8 grid): the factorized
    similarity equals the materialized one up to float association, so on
    the same draws the f32 path finds the same pairs and scores; int8
    quantizes the unbinned rows where the materialized path quantizes the
    binned ones, another rounding, and scores within 0.1 of it."""
    vcfg = tvit.ViTConfig(patch_size=14, embed_dim=64, depth=2, num_heads=2, pos_grid=16,
                          stride=14, model_name="tiny")
    cfg = TVSConfig(u_max=128, v_max=128, f_x=100.5, f_y=100.5, dino_input_size=112,
                    model_name="tiny", layer=1, use_feature_binning=True)
    base = tpipe.ServoModel(vit=vcfg, cfg=cfg, compute_dtype=torch.float32, device="cpu",
                            quantized=quantized, fused_bin_quant=False)
    net = tvit.init_vit(vcfg, torch.Generator().manual_seed(0), device="cpu")
    scene = Scene.create(make_synthetic_poster(256, seed=3), device="cpu")
    got = {}
    for fast in (False, True):
        model = dataclasses.replace(base, fast_binned_match=fast)
        got[fast] = tft.matching_quality(net, model, scene, torch.Generator().manual_seed(2),
                                         num_views=2)
    frac, acc = got[True]
    assert 0.0 < frac <= 1.0 and 0.0 <= acc <= 1.0
    if quantized:
        assert np.abs(np.subtract(got[True], got[False])).max() <= 0.1, got
    else:
        assert got[True] == got[False], got


def test_chip_smoke_phase_3k_runs_tiny_on_cpu():
    """chip_smoke.py phase 3k's checks with a tiny 2-block SwiGLU ViT on the
    CPU (plain versions on both sides): the factorized against the
    materialized step and similarity, one frame and a chunk, float and
    int8, teacher-forced; the chunk kernels-vs-plain run; vit_forward; the
    'attn' facet and saliency, float and int8, against the CPU copy; the
    int8 block's check."""
    import chip_smoke

    cfg = TVSConfig(u_max=96, v_max=72, f_x=75.0, f_y=75.0, dino_input_size=84, num_pairs=12,
                    layer=1, model_name="tiny", pinv_mode="dls")
    vcfg = tvit.ViTConfig(patch_size=14, embed_dim=96, depth=2, num_heads=6, pos_grid=5,
                          gelu_approx=True, model_name="tiny", ffn="swiglu")
    model = tpipe.ServoModel(vit=vcfg, cfg=cfg, compute_dtype=torch.bfloat16, device="cpu")
    net32 = tvit.init_vit(vcfg, torch.Generator().manual_seed(0), device="cpu", layerscale=1.0)
    net = tvit.ViT.from_state_dict(vcfg, net32.state_dict()).cast_blocks(torch.bfloat16).eval()
    goal, frames, depth = chip_smoke.make_frames(cfg, 0)
    one = chip_smoke.run_fast_binned(net, model, (goal, frames, depth),
                                     chip_smoke.pair_scores(model, len(frames)))
    assert one["pairs"] == 12 * len(frames) and not any(one["launches"].values())
    assert one["sim_max_abs_diff"] <= chip_smoke.FAST_SIM_TOL["float"]
    chunks = [torch.from_numpy(np.stack(frames[i:i + 3])) for i in (0, 2)]
    depths = [torch.from_numpy(np.stack([depth] * 3))] * 2
    scores = chip_smoke.chunk_scores(model, 2, 3)
    many = chip_smoke.run_fast_binned(net, model, (goal, chunks, depths), scores)
    assert many["pairs"] == 2 * 3 * 12 and many["steps_compared"] <= 6
    summary = chip_smoke.run_main_path(net, cfg, model, frames=(goal, chunks, depths),
                                       every_step=True, scores=scores)
    assert summary["differing_pairs"] == [0, 0] and summary["steps_compared"] == 6
    fwd = chip_smoke.run_vit_forward(net, model, goal)
    assert fwd["rel_err"] == 0.0 and fwd["shape"] == [1, 37, 96]
    facet = chip_smoke.check_attn_facet(net, model, goal)
    assert facet["max_abs_err"] == 0.0 and facet["saliency_range"] == [0.0, 1.0]
    qmodel = dataclasses.replace(model, quantized=True)
    qnet = tpipe.quantized_vit(net32, qmodel, [goal, *frames[:2]])
    qfacet = chip_smoke.check_attn_facet(qnet, qmodel, goal)
    assert qfacet["max_abs_err"] == 0.0 and qfacet["shape"] == [1, 6, 37, 37]
    qone = chip_smoke.run_fast_binned(qnet, qmodel, (goal, frames[:2], depth),
                                      chip_smoke.pair_scores(qmodel, 2))
    assert qone["sim_max_abs_diff"] <= chip_smoke.FAST_SIM_TOL["int8"]
    assert chip_smoke.check_int8_block(qnet, qmodel, goal)["rel_err"] == 0.0
    # the tiny FFN moves the block's output little (the swapped SwiGLU halves
    # by 0.85% of its largest): a bound below that, in place of ViT-g's 2/127
    parts = chip_smoke.check_int8_parts(qnet, qmodel, goal, tol=1e-3)
    assert parts["rel_err"] == parts["attn_rel_err"] == 0.0
    assert sorted(parts["plants"]) == sorted(chip_smoke.INT8_PLANTS)
