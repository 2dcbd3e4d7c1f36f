"""The port's (dp, tp) mesh (``vitvs_tpu_torch/parallel/mesh.py``) on grids
of the CPU, against the port on one device and against vitvs_tpu's rules:
a dp-only mesh equals one device bit for bit (the chunk invariance of the
CPU), tp = 2 lands within 1e-4 of one device in the closed loop (softmax,
and relu scores with 2 x 2 K/V pooling, as tests/test_parallel.py asks of
the JAX mesh), the Megatron split of a full-width ViT-g block (SwiGLU),
every consumer of ``net.blocks`` on the split, one f32 train step on it,
heads that tp does not divide raising ValueError as JAX's device_put does,
and the int8 serving ViT's split (``TPQuantViT``): bit for bit against the
unsplit int8 ViT in every int8 mode, against jax.jit of the reference's
int8 forward on params sharded over a (1, 2) JAX mesh, and through
run_benchmark and the command line."""

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_rollout import GOAL_POS, GOAL_QUAT, make_pair  # noqa: E402

from vitvs_tpu.models import quant as jq  # noqa: E402
from vitvs_tpu.models import vit as jvit  # noqa: E402
from vitvs_tpu.parallel import make_mesh as jmake_mesh  # noqa: E402
from vitvs_tpu.parallel import shard_vit_params as jshard  # noqa: E402
from vitvs_tpu_torch.control.ibvs import EmaState  # noqa: E402
from vitvs_tpu_torch.harness import pipeline as tpipe  # noqa: E402
from vitvs_tpu_torch.harness.benchmark import run_benchmark  # noqa: E402
from vitvs_tpu_torch.models import extractor as text  # noqa: E402
from vitvs_tpu_torch.models import vit as tvit  # noqa: E402
from vitvs_tpu_torch.models import quant as tq  # noqa: E402
from vitvs_tpu_torch.models.convert import from_jax_quant_params  # noqa: E402
from vitvs_tpu_torch.models.quant import quantize_vit_params  # noqa: E402
from vitvs_tpu_torch.parallel import (batch_servo_step, make_mesh, replicate,  # noqa: E402
                                      shard_vit_params, sharded_batch_rollout)
from vitvs_tpu_torch.parallel.mesh import TPQuantViT, TPViT  # noqa: E402
from vitvs_tpu_torch.sim.env import observe  # noqa: E402
from vitvs_tpu_torch.train import finetune as tft  # noqa: E402

CPU = torch.device("cpu")
RNG = np.random.default_rng(31)


@pytest.fixture(autouse=True)
def _fresh_rng():
    """Each test draws its inputs from the same seed, whatever ran before it."""
    global RNG
    RNG = np.random.default_rng(31)


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bench(pair, tmp_path, mesh=None, model=None, net=None, **kw):
    model = model or pair.tmodel
    cfg = model.cfg.replace(num_samples=4, num_circles=2)
    kw.setdefault("rotation_search", True)
    return run_benchmark(cfg, net=net or pair.net, model=model, scene=pair.tscene,
                         out_dir=str(tmp_path), save=False, verbose=False, device="cpu",
                         mesh=mesh, **kw)


def test_make_mesh_grids_and_refusals():
    mesh = make_mesh(devices=["cpu"] * 8, tp=2)
    assert mesh.shape == {"dp": 4, "tp": 2} and mesh.devices == ((CPU, CPU),) * 4
    assert mesh.first == CPU and mesh.distinct() == [CPU]
    assert make_mesh(6, tp=3, devices=["cpu"] * 8).shape == {"dp": 2, "tp": 3}
    with pytest.raises(ValueError, match="divisible by tp=3"):
        make_mesh(devices=["cpu"] * 8, tp=3)
    with pytest.raises(ValueError, match="a mesh of 9 devices"):
        make_mesh(9, devices=["cpu"] * 8)
    scene = make_pair(pixel_identity=True).tscene
    copies = replicate(scene, mesh)
    assert list(copies) == [CPU] and copies[CPU].texture is scene.texture


def test_heads_tp_does_not_divide_raise_as_in_jax():
    """3 heads over tp = 2: JAX's device_put refuses the head split
    (ValueError) on its 8-device CPU mesh; the port refuses it too."""
    jcfg = jvit.ViTConfig(patch_size=8, embed_dim=96, depth=1, num_heads=3, pos_grid=4,
                          stride=8, model_name="t")
    with pytest.raises(ValueError, match="divisible by 2"):
        jshard(jvit.init_vit(jcfg, jax.random.PRNGKey(0)), jmake_mesh(8, tp=2))
    tcfg = tvit.ViTConfig(patch_size=8, embed_dim=96, depth=1, num_heads=3, pos_grid=4,
                          stride=8, model_name="t")
    net = tvit.init_vit(tcfg, torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(ValueError, match="3 heads are not divisible by tp=2"):
        shard_vit_params(net, make_mesh(devices=["cpu"] * 8, tp=2))


def _flat(x) -> np.ndarray:
    """An episode's entry of the npz (an array, or a tuple of them) as f64."""
    parts = x if isinstance(x, (tuple, list)) else (x,)
    return np.concatenate([np.ravel(np.asarray(v, np.float64)) for v in parts])


@pytest.mark.parametrize("dp,chunk", [(2, 4), (4, 2)])
def test_dp_mesh_equals_one_device_bit_for_bit(tmp_path, dp, chunk):
    """Rotation search on, 4 episodes, 6 steps: a dp-only mesh (chunk
    rounded up to a multiple of dp) gives what one device gives, bit for bit,
    and the per-episode hook sees every episode once a step."""
    pair = make_pair(pixel_identity=True, max_iterations=6)
    one = _bench(pair, tmp_path, num_steps=6, chunk=4)
    seen = []
    meshed = _bench(pair, tmp_path, mesh=make_mesh(devices=["cpu"] * dp), num_steps=6,
                    chunk=chunk, on_step=lambda ids, inputs, res: seen.extend(ids.tolist()))
    for k in ("convergence_flags", "final_positions", "final_quaternions", "best_poses",
              "all_position_histories", "all_applied_velocity_x", "lowest_position_errors"):
        a, b = one.summaries[k], meshed.summaries[k]
        assert len(a) == len(b) and all(np.array_equal(_flat(x), _flat(y))
                                        for x, y in zip(a, b)), k
    assert sorted(set(seen)) == [0, 1, 2, 3] and len(seen) == 6 * max(4, dp)


@pytest.mark.parametrize("score", ["softmax", "relu_pool2"])
def test_tp_mesh_closed_loop_within_float_tolerance(tmp_path, score):
    """tp = 2 (2 of the 4 heads on each shard) on a (2, 2) grid: the closed
    loop within 1e-4 of one device over 6 steps (the partial products sum in
    another order), softmax and relu scores with 2 x 2 K/V pooling."""
    pair = make_pair(max_iterations=6)
    model = pair.tmodel
    if score != "softmax":
        model = dataclasses.replace(model, vit=dataclasses.replace(
            model.vit, attn_score="relu", kv_pool=2))
    net = model.load_vit(pair.net.state_dict())
    common = dict(net=net, model=model, rotation_search=False, num_steps=6, chunk=2)
    one = _bench(pair, tmp_path, **common)
    meshed = _bench(pair, tmp_path, mesh=make_mesh(devices=["cpu"] * 4, tp=2), **common)
    assert isinstance(meshed.net, TPViT)
    np.testing.assert_allclose(np.asarray(meshed.summaries["final_positions"], np.float64),
                               np.asarray(one.summaries["final_positions"], np.float64),
                               rtol=0, atol=1e-4)


def _tiny_net(ffn="mlp", depth=2, heads=4, dim=64, final_norm=True):
    cfg = tvit.ViTConfig(patch_size=8, embed_dim=dim, depth=depth, num_heads=heads,
                         pos_grid=4, stride=8, model_name="t", ffn=ffn)
    net = tvit.init_vit(cfg, torch.Generator().manual_seed(1), device="cpu", layerscale=1.0)
    with torch.no_grad():
        for name, p in net.named_parameters():       # biases and norms that matter
            if name.endswith("bias") or ".norm" in name:
                p.add_(0.1 * torch.randn(p.shape, generator=torch.Generator().manual_seed(2)))
    if not final_norm:
        net = tvit.ViT.from_state_dict(cfg, {k: v for k, v in net.state_dict().items()
                                             if not k.startswith("norm.")})
    return net.eval()


def test_swiglu_split_of_a_vitg_block():
    """One block of DINOv2 ViT-g/14 at full width (1536, 24 heads, the fused
    SwiGLU FFN 2 x 4096 wide) split over tp = 2 and tp = 4: each shard holds
    matching slices of x1 and x2; the block's output within 2e-5 of the
    unsplit block's (f32, O(1) outputs, sums over 1536 and 4096 in another
    order); merged() rebuilds the unsplit weights exactly."""
    cfg = dataclasses.replace(tvit.make_config("dinov2_vitg14"), depth=1)
    net = tvit.init_vit(cfg, torch.Generator().manual_seed(0), device="cpu", layerscale=1.0)
    x = torch.from_numpy(RNG.standard_normal((1, 5, cfg.embed_dim)).astype(np.float32))
    with torch.no_grad():
        ref = net.blocks[0](x, use_kernels=True)
        for tp in (2, 4):
            split = TPViT(net, [CPU] * tp)
            sh = split.blocks[0].shards[0]
            H = cfg.hidden_dim
            w12 = net.blocks[0].mlp.w12.weight
            assert torch.equal(sh.fc1.weight, torch.cat([w12[:H // tp], w12[H:H + H // tp]]))
            torch.testing.assert_close(split.blocks[0](x, use_kernels=True), ref,
                                       rtol=0, atol=2e-5)
            merged = split.merged()
            assert all(torch.equal(merged[k], v) for k, v in net.state_dict().items())


def test_every_consumer_of_the_blocks_takes_the_split():
    """vit_features (token, query, attn), vit_forward, extract_descriptors
    (binned) and the saliency maps on a tp = 2 split within 1e-6 of the
    unsplit ViT (f32); int8 calibration refuses the split (TypeError)."""
    net = _tiny_net()
    split = shard_vit_params(net, make_mesh(devices=["cpu"] * 2, tp=2))[0]
    img = torch.from_numpy(RNG.random((2, 32, 32, 3)).astype(np.float32))
    with torch.no_grad():
        for facet in ("token", "query", "attn"):
            torch.testing.assert_close(tvit.vit_features(split, img, 1, facet),
                                       tvit.vit_features(net, img, 1, facet), rtol=0, atol=1e-6)
        torch.testing.assert_close(tvit.vit_forward(split, img), tvit.vit_forward(net, img),
                                   rtol=0, atol=1e-6)
        torch.testing.assert_close(
            text.extract_descriptors(split, img, layer=1, bin=True),
            text.extract_descriptors(net, img, layer=1, bin=True), rtol=0, atol=1e-6)
        torch.testing.assert_close(text.extract_saliency_maps(split, img, head_idxs=(0, 3)),
                                   text.extract_saliency_maps(net, img, head_idxs=(0, 3)),
                                   rtol=0, atol=1e-5)
    with pytest.raises(TypeError, match="unsplit"):
        quantize_vit_params(split)
    with pytest.raises(ValueError, match="vit_forward needs one"):
        tvit.vit_forward(TPViT(_tiny_net(final_norm=False), [CPU] * 2), img)


def test_train_step_on_the_split_matches_the_unsplit():
    """One f32 InfoNCE step at tp = 2: the loss within 1e-6 and every
    gradient, merged back to the unsplit layout, within 1e-5 of the largest
    gradient of the unsplit step (the split's sums in another order)."""
    pair = make_pair(max_iterations=4)
    model = pair.tmodel
    batch = tft.make_pair_batch(model, pair.tscene, torch.Generator().manual_seed(0), batch=2,
                                perturb=False)
    net = tvit.ViT.from_state_dict(model.vit, pair.net.state_dict())
    split = TPViT(net, [CPU] * 2)
    loss = tft._batch_loss(net, model, batch)
    loss.backward()
    loss_split = tft._batch_loss(split, model, batch)
    loss_split.backward()
    assert abs(loss.item() - loss_split.item()) <= 1e-6
    grads = split.merged(lambda p: torch.zeros_like(p) if p.grad is None else p.grad)
    scale = max(p.grad.abs().max().item() for p in net.parameters() if p.grad is not None)
    for name, p in net.named_parameters():
        ref = torch.zeros_like(p) if p.grad is None else p.grad
        torch.testing.assert_close(grads[name], ref, rtol=0, atol=1e-5 * scale, msg=name)


def test_batch_step_and_rollout_over_the_mesh():
    """batch_servo_step on a (2, 2) grid: the goal frame 4 times gives
    near-zero commands (tests/test_parallel.py's check) and each row's
    share equals the unsplit step's within 1e-5; sharded_batch_rollout's
    histories have their shapes and equal the unsharded chunk's within 1e-4."""
    pair = make_pair(max_iterations=5)
    model, net, scene = pair.tmodel, pair.net, pair.tscene
    mesh = make_mesh(devices=["cpu"] * 4, tp=2)
    gp, gq = torch.from_numpy(GOAL_POS), torch.from_numpy(GOAL_QUAT)
    rgb, depth = observe(scene, model.camera, gp, gq)
    goal = tpipe.goal_descriptors(net, model, rgb)
    B, t = 4, pair.t
    rgbs, depths = rgb.expand(B, *rgb.shape), depth.expand(B, *depth.shape)
    ema, prev = EmaState.init(device="cpu", batch=(B,)), torch.zeros(B, 6)
    scores = torch.rand((B, t), generator=torch.Generator().manual_seed(0))
    res = batch_servo_step(net, model, mesh)(goal, rgbs, depths, ema, prev, scores)
    ref = tpipe.servo_step(net, model, goal, rgbs, depths, ema, prev, scores=scores)
    assert res.v_c.shape == (B, 6)
    np.testing.assert_allclose(res.v_c.numpy(), 0.0, atol=1e-3)
    torch.testing.assert_close(res.body_twist, ref.body_twist, rtol=0, atol=1e-5)
    starts = GOAL_POS + RNG.uniform(-0.05, 0.05, (B, 3)).astype(np.float32)
    quats = np.broadcast_to(GOAL_QUAT, (B, 4)).copy()
    gens = lambda: [torch.Generator().manual_seed(i) for i in range(B)]  # noqa: E731
    out = sharded_batch_rollout(net, model, scene, mesh, num_steps=5)(goal, starts, quats, gens())
    assert out.position_history.shape == (B, 5, 3) and out.error_history.shape == (B, 5, 2)
    from vitvs_tpu_torch.harness.rollout import rollout_episode

    alone = rollout_episode(net, model, scene, goal, starts, quats, generator=gens(), num_steps=5)
    torch.testing.assert_close(out.position_history, alone.position_history, rtol=0, atol=1e-4)


# ---------------------------------------------------------------------------
# the int8 serving ViT split over tp (TPQuantViT)
# ---------------------------------------------------------------------------

# the int8 attention modes the split serves: ViTConfig fields over the tiny ViT's
INT8_MODES = {"none": dict(quant_attn="none"),
              "fused": dict(quant_attn="fused"),
              "nomax3_post": dict(quant_attn="nomax3", kv_pool=2, kv_pool_impl="matmul"),
              "nomax3_pre": dict(quant_attn="nomax3", kv_pool=2, kv_pool_impl="matmul",
                                 kv_pool_where="pre"),
              "pv": dict(quant_attn="pv"),
              "qk+pv": dict(quant_attn="qk+pv"),
              "relu": dict(quant_attn="none", attn_score="relu")}


def _int8_cfg(mode: str, ffn: str) -> tvit.ViTConfig:
    """A 2-block ViT 128 wide with 4 heads of 32; SwiGLU 2 x 384 wide, so
    that a shard's hidden slice (192, 96) is a whole number of the CPU's
    16-lane f32 vectors, as every preset's is (see
    test_int8_split_at_a_ragged_ffn_slice)."""
    return tvit.ViTConfig(patch_size=8, embed_dim=128, depth=2, num_heads=4, pos_grid=4,
                          stride=8, model_name="t", ffn=ffn, gelu_approx=True,
                          ffn_hidden=384 if ffn == "swiglu" else None, **INT8_MODES[mode])


def _int8_pair(cfg: tvit.ViTConfig, static: bool, tp: int, dtype=torch.float32):
    net = tvit.init_vit(cfg, torch.Generator().manual_seed(1), device="cpu", layerscale=1.0)
    img = torch.from_numpy(RNG.random((2, 40, 40, 3)).astype(np.float32))
    qnet = quantize_vit_params(net.eval(), cfg, img if static else None, layer=1,
                               compute_dtype=dtype)
    return qnet, TPQuantViT(qnet, [CPU] * tp), img


@pytest.mark.parametrize("ffn", ["mlp", "swiglu"])
@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("static", [False, True], ids=["dynamic", "static"])
@pytest.mark.parametrize("mode", sorted(INT8_MODES))
def test_int8_split_equals_the_unsplit_bit_for_bit(mode, static, tp, ffn):
    """The int8 ViT split over tp = 2 and 4 in every int8 mode it serves,
    dynamic and static activation scales, MLP and SwiGLU, f32: the token
    facet of both blocks and the query / attn facets of block 1 equal the
    unsplit ViT's bit for bit (int32 accumulators summed, the row's maxima
    reduced by a max: exact).  Each shard holds h / tp heads, its tensors
    on its device, the proj / fc2 scales and biases only on the first."""
    cfg = _int8_cfg(mode, ffn)
    qnet, split, img = _int8_pair(cfg, static, tp)
    devices = split.devices
    for blk in split.blocks:
        assert [sh.heads for sh in blk.shards] == [cfg.num_heads // tp] * tp
        for sh, dev in zip(blk.shards, devices):
            assert all(b.device == dev for b in sh.buffers())
            assert sh.qkv.weight.shape == (3 * cfg.embed_dim // tp, cfg.embed_dim)
        assert blk.proj_bias.device == devices[0] and blk.fc2_scale.device == devices[0]
    with torch.no_grad():
        for facet in ("token", "query", "attn"):
            ref = tq.vit_features_quant(qnet, img, 1, facet)
            out = tq.vit_features_quant(split, img, 1, facet)
            assert torch.equal(out, ref), (facet, (out - ref).abs().max().item())


def test_int8_split_bf16_equals_the_unsplit():
    """The serving dtype: bf16 'nomax3' with 2 x 2 K/V pooling before the
    projection, static scales, tp = 2: bit for bit."""
    qnet, split, img = _int8_pair(_int8_cfg("nomax3_pre", "mlp"), True, 2, torch.bfloat16)
    with torch.no_grad():
        ref = tq.vit_features_quant(qnet, img, 1)
        assert ref.dtype == torch.bfloat16
        assert torch.equal(tq.vit_features_quant(split, img, 1), ref)


def test_int8_split_at_a_ragged_ffn_slice():
    """A SwiGLU 2 x 344 wide over tp = 2 (slices 172 wide, not a whole
    number of 16-lane vectors): the CPU's silu takes its scalar tail on
    other elements than the unsplit's (a last-bit difference of f32 silu,
    not of the split), so with dynamic scales an fc2 activation may move by
    an int8 step: within 1e-5 of the output scale.  bf16 rounds that
    difference away: bit for bit."""
    cfg = dataclasses.replace(_int8_cfg("none", "swiglu"), ffn_hidden=None)
    assert cfg.hidden_dim == 344
    qnet, split, img = _int8_pair(cfg, False, 2)
    with torch.no_grad():
        ref, out = tq.vit_features_quant(qnet, img, 1), tq.vit_features_quant(split, img, 1)
        assert (out - ref).abs().max() <= 1e-5 * ref.abs().max()
        qnet, split, img = _int8_pair(cfg, False, 2, torch.bfloat16)
        assert torch.equal(tq.vit_features_quant(split, img, 1),
                           tq.vit_features_quant(qnet, img, 1))


def test_int8_split_refusals():
    """Heads tp does not divide raise as for the float ViT; a split is not
    split again; int8 calibration still refuses a float split."""
    cfg = _int8_cfg("none", "mlp")
    qnet, split, _ = _int8_pair(cfg, False, 2)
    with pytest.raises(ValueError, match="4 heads are not divisible by tp=3"):
        TPQuantViT(qnet, [CPU] * 3)
    with pytest.raises(ValueError, match="split already"):
        shard_vit_params(split, make_mesh(devices=["cpu"] * 2, tp=2))
    assert isinstance(shard_vit_params(qnet, make_mesh(devices=["cpu"] * 2, tp=2))[0],
                      TPQuantViT)



@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("tp", [2, 3])
def test_matmul_pooling_of_a_shards_heads_is_the_wholes(dtype, tp):
    """The K/V pooling product ('matmul', pool 2) is the f32 product of the
    pooling matrix and the tokens rounded once to their dtype, as the TPU's
    f32 accumulation gives it, so a tp shard's heads pool to the whole's
    heads bit for bit whatever GEMM a width gets; the reference's jitted
    pooling agrees with it in bf16."""
    rs = np.random.default_rng(tp)
    x = rs.standard_normal((2, 1 + 9 * 9, 6, 64)).astype(np.float32)
    t = torch.from_numpy(x).to(dtype)
    whole = tvit.pool_kv(t, 2, "matmul")
    want = torch.einsum("ot,bthd->bohd", torch.from_numpy(tvit._pool_matrix(82, 2)),
                        t.float()).to(dtype)
    assert whole.dtype == dtype and torch.equal(whole, want)
    n = 6 // tp
    for s in range(tp):
        part = tvit.pool_kv(t[:, :, s * n:(s + 1) * n].contiguous(), 2, "matmul")
        assert torch.equal(part, whole[:, :, s * n:(s + 1) * n])
    if dtype == torch.bfloat16:
        ref = jax.jit(lambda a: jvit._pool_kv(a, 2, "matmul"))(jnp.asarray(x, jnp.bfloat16))
        np.testing.assert_array_equal(np.asarray(ref, np.float32), whole.float().numpy())

@pytest.mark.parametrize("mode", ["none", "nomax3_post", "pv"])
def test_int8_split_matches_the_jax_tp_sharded_forward(mode):
    """The JAX package's int8 params (static scales) placed by its
    shard_vit_params on a (1, 2) mesh of the 8 CPU devices and run by
    jax.jit(vit_features_quant) (GSPMD sums the int32 proj / fc2 products
    across the shards), against the port's tp = 2 split of the same int8
    weights: within 1e-5 of the output scale (tests/test_torch_quant.py's
    hold on the same int8 weights and static scales), f32."""
    kw = dict(patch_size=14, embed_dim=128, depth=2, num_heads=2, pos_grid=5, stride=14,
              gelu_approx=True, model_name="tiny", **INT8_MODES[mode])
    jcfg, tcfg = jvit.ViTConfig(**kw), tvit.ViTConfig(**kw)
    params = jax.tree.map(np.asarray, jvit.init_vit(jcfg, jax.random.PRNGKey(3)))
    rs = np.random.default_rng(5)
    for name in ("qkv_bias", "proj_bias", "fc1_bias", "fc2_bias"):
        params["blocks"][name] = 0.1 * rs.standard_normal(params["blocks"][name].shape).astype(
            np.float32)
    params["blocks"]["ls1"] = np.ones_like(params["blocks"]["ls1"])
    params["blocks"]["ls2"] = np.ones_like(params["blocks"]["ls2"])
    calib = rs.standard_normal((2, 70, 70, 3)).astype(np.float32)
    img = rs.standard_normal((1, 70, 70, 3)).astype(np.float32)
    qp = jax.tree.map(np.asarray, jq.quantize_vit_params(
        params, cfg=jcfg, calib_images=jnp.asarray(calib), layer=1, compute_dtype=jnp.float32))
    sharded = jshard(qp, jmake_mesh(2, tp=2))
    assert len(sharded["blocks"]["proj_kernel"].sharding.device_set) == 2
    ref = np.asarray(jax.jit(lambda q, x: jq.vit_features_quant(
        q, jcfg, x, layer=1, compute_dtype=jnp.float32))(sharded, jnp.asarray(img)))
    split = TPQuantViT(from_jax_quant_params(qp, tcfg, torch.float32), [CPU] * 2)
    with torch.no_grad():
        out = tq.vit_features_quant(split, torch.from_numpy(img), layer=1).numpy()
    assert out.shape == ref.shape == (1, 26, 128)
    assert np.abs(out - ref).max() <= 1e-5 * np.abs(ref).max()


def test_int8_benchmark_over_tp_equals_no_mesh_and_the_cli_runs(tmp_path):
    """run_benchmark(quantized=True, int8_static=True) on a (1, 2) grid:
    the int8 ViT split over tp = 2 gives the no-mesh run's results bit for
    bit (4 episodes, rotation search, 5 steps); the command line's --int8
    --int8-static --mesh --tp 2 runs a tiny config on the CPU."""
    pair = make_pair(max_iterations=5)
    common = dict(quantized=True, int8_static=True, num_steps=5, chunk=4)
    one = _bench(pair, tmp_path, **common)
    meshed = _bench(pair, tmp_path, mesh=make_mesh(devices=["cpu"] * 2, tp=2), **common)
    assert isinstance(meshed.net, TPQuantViT) and meshed.net.blocks[0].act_scales is not None
    for k in ("convergence_flags", "final_positions", "best_poses", "all_position_histories",
              "all_applied_velocity_x", "lowest_position_errors"):
        a, b = one.summaries[k], meshed.summaries[k]
        assert len(a) == len(b) and all(np.array_equal(_flat(x), _flat(y))
                                        for x, y in zip(a, b)), k
    from vitvs_tpu_torch.io_bridge import cli

    cfg = tmp_path / "tiny.yaml"
    cfg.write_text("u_max: 128\nv_max: 128\nf_x: 100.5\nf_y: 100.5\nnum_pairs: 12\n"
                   "num_circles: 1\ndino_input_size: 56\nlayer: 1\npinv_mode: dls\n")
    assert cli.main(["--config", str(cfg), "--poster", "synthetic", "--num-samples", "2",
                     "--num-steps", "2", "--chunk", "2", "--no-rotation-search", "--int8",
                     "--int8-static", "--mesh", "--tp", "2", "--device", "cpu",
                     "--out", str(tmp_path)]) == 0
    assert list(tmp_path.glob("results_tiny_int8cal_*.npz"))


def test_int8_tp_gap_script_finds_no_gap_on_the_cpu(capsys):
    """``scripts/port_int8_tp_gap.py`` (where a tp shard's 'nomax3'
    attention departs from the whole's on the card, op by op) runs on the
    CPU, where every op of a shard equals the whole's to the bit."""
    import importlib.util
    import json

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scripts",
                        "port_int8_tp_gap.py")
    spec = importlib.util.spec_from_file_location("port_int8_tp_gap", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.main(["--device", "cpu", "--batch", "1", "2", "--tp", "3"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[-1] == "device cpu (no card measured)" and len(lines) == 3
    for line in lines[:2]:
        gaps = json.loads(line)["gaps"]
        assert set(gaps) == {"pooled_k", "pooled_v", "logits", "exp2", "denominator",
                             "denominator_f32_sum", "pv", "attention"}
        assert all(g == {"share_differing": 0.0, "max_abs_diff": 0.0} for g in gaps.values())
