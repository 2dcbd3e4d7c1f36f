"""Port parity: the whole servo step (goal_descriptors + servo_step) of
vitvs_tpu_torch against vitvs_tpu, f32, on a tiny 2-block 96-wide ViT, in
float and in the int8 W8A8 serving configuration.
Acceptance is the BASELINE.md parity clause: velocity within 1e-3."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vitvs_tpu.control import EmaState as JEma
from vitvs_tpu.harness import pipeline as jpipe
from vitvs_tpu.io_bridge.config import VSConfig as JVSConfig
from vitvs_tpu.models import quant as jquant
from vitvs_tpu.models import vit as jvit
from vitvs_tpu_torch.control.ibvs import EmaState as TEma
from vitvs_tpu_torch.harness import pipeline as tpipe
from vitvs_tpu_torch.io_bridge.config import VSConfig as TVSConfig
from vitvs_tpu_torch.models import vit as tvit
from vitvs_tpu_torch.models.convert import from_jax_params

CFG = dict(u_max=96, v_max=72, f_x=75.0, f_y=75.0, dino_input_size=84, num_pairs=12,
           lambda_=0.5, layer=1, model_name="tiny", use_feature_binning=True)
VIT = dict(patch_size=14, embed_dim=96, depth=2, num_heads=3, pos_grid=5, stride=14,
           model_name="tiny")


def texture(h, w, seed, smooth=4):
    """Smoothed seeded noise, uint8 (h, w, 3)."""
    rs = np.random.default_rng(seed)
    x = rs.standard_normal((h + 2 * smooth, w + 2 * smooth, 3))
    k = np.ones(2 * smooth + 1) / (2 * smooth + 1)
    for ax in (0, 1):
        x = np.apply_along_axis(lambda r: np.convolve(r, k, mode="valid"), ax, x)
    x = (x - x.min()) / (x.max() - x.min())
    return (255 * x).astype(np.uint8)


def _setup(**cfg_kw):
    jcfg, tcfg = JVSConfig(**CFG, **cfg_kw), TVSConfig(**CFG, **cfg_kw)
    jv = jvit.ViTConfig(**VIT)
    params = jax.tree.map(np.asarray, jvit.init_vit(jv, jax.random.PRNGKey(0)))
    # content-dominated descriptors with working residual branches
    params["pos_embed"] = np.zeros_like(params["pos_embed"])
    for name in ("ls1", "ls2"):
        params["blocks"][name] = np.ones_like(params["blocks"][name])
    jmodel = jpipe.ServoModel(vit=jv, cfg=jcfg, compute_dtype=jnp.float32)
    tmodel = tpipe.ServoModel(vit=tvit.ViTConfig(**VIT), cfg=tcfg,
                              compute_dtype=torch.float32, device="cpu")
    return params, jmodel, tmodel, tmodel.load_vit(from_jax_params(params))


def _frames(shifts, seed=2):
    m = 24
    big = texture(CFG["v_max"] + 2 * m, CFG["u_max"] + 2 * m, seed)
    crop = lambda dy, dx: big[m + dy: m + dy + CFG["v_max"], m + dx: m + dx + CFG["u_max"]]
    depth = np.full((CFG["v_max"], CFG["u_max"]), 0.6, np.float32)
    depth[:, : CFG["u_max"] // 3] = 0.0   # no-return band -> 100 m sentinel
    return crop(0, 0), [crop(dy, dx) for dy, dx in shifts], depth


@pytest.mark.parametrize("pinv_mode,subpixel,pad_bug",
                         [("dls", True, False), ("svd", False, False), ("dls", False, True)])
def test_servo_step_matches(pinv_mode, subpixel, pad_bug):
    params, jmodel, tmodel, net = _setup(pinv_mode=pinv_mode, subpixel_matching=subpixel,
                                         reference_pad_bug=pad_bug)
    # shifts beyond a patch (14 px at 84 is 16 px of the 96 px frame)
    goal, frames, depth = _frames([(18, 20), (16, 17), (10, 15), (20, -18)])
    jg = jpipe.goal_descriptors(params, jmodel, jnp.asarray(goal))
    tg = tpipe.goal_descriptors(net, tmodel, goal)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-5, atol=1e-5)

    jema, jprev = JEma.init(), jnp.zeros(6)
    tema, tprev = TEma.init(device="cpu"), torch.zeros(6)
    t = tg.shape[0]
    # the last step asks for 3 pairs: a feature failure keeps v_c and the EMA
    speeds = []
    for i, (frame, k) in enumerate(zip(frames, (None, None, None, 3))):
        key = jax.random.PRNGKey(10 + i)
        jr = jpipe.servo_step(params, jmodel, jg, jnp.asarray(frame), jnp.asarray(depth),
                              jema, jprev, key, num_pairs=k)
        scores = torch.tensor(np.asarray(jax.random.uniform(key, (t,))))
        tr = tpipe.servo_step(net, tmodel, tg, frame, depth, tema, tprev, scores=scores,
                              num_pairs=k)
        for name in ("valid", "num_valid", "feature_ok"):
            np.testing.assert_array_equal(getattr(tr, name).numpy(),
                                          np.asarray(getattr(jr, name)), err_msg=name)
        for name in ("s_uv", "s_uv_star"):
            np.testing.assert_allclose(getattr(tr, name).numpy(),
                                       np.asarray(getattr(jr, name)), atol=1e-3, err_msg=name)
        for name in ("v_c", "body_twist"):
            np.testing.assert_allclose(getattr(tr, name).numpy(),
                                       np.asarray(getattr(jr, name)), atol=1e-3, err_msg=name)
        np.testing.assert_allclose(tr.mean_sim.numpy(), np.asarray(jr.mean_sim), atol=1e-5)
        np.testing.assert_allclose(tr.ema.value.numpy(), np.asarray(jr.ema.value), atol=1e-3)
        jema, jprev, tema, tprev = jr.ema, jr.v_c, tr.ema, tr.v_c
        speeds.append(float(torch.abs(tr.v_c).max()))
    assert not bool(tr.feature_ok)
    assert min(speeds) > 1e-2, speeds   # the loop really commands motion


@pytest.mark.parametrize("num_pairs", [1, 2])
def test_servo_step_dls_few_pairs_keeps_command(num_pairs):
    """A dls step asking for 1 or 2 pairs: L^T L is singular, the reference's
    solve gives non-finite values and its feature-failure select discards
    them.  The port's step must not raise, and like the reference it keeps
    the previous command and freezes the EMA."""
    params, jmodel, tmodel, net = _setup(pinv_mode="dls")
    goal, frames, depth = _frames([(18, 20), (16, 17)])
    jg = jpipe.goal_descriptors(params, jmodel, jnp.asarray(goal))
    tg = tpipe.goal_descriptors(net, tmodel, goal)
    jema, jprev = JEma.init(), jnp.zeros(6)
    tema, tprev = TEma.init(device="cpu"), torch.zeros(6)
    t = tg.shape[0]
    for i, (frame, k) in enumerate(zip(frames, (None, num_pairs))):
        key = jax.random.PRNGKey(30 + i)
        jr = jpipe.servo_step(params, jmodel, jg, jnp.asarray(frame), jnp.asarray(depth),
                              jema, jprev, key, num_pairs=k)
        scores = torch.tensor(np.asarray(jax.random.uniform(key, (t,))))
        tr = tpipe.servo_step(net, tmodel, tg, frame, depth, tema, tprev, scores=scores,
                              num_pairs=k)
        for name in ("valid", "num_valid", "feature_ok"):
            np.testing.assert_array_equal(getattr(tr, name).numpy(),
                                          np.asarray(getattr(jr, name)), err_msg=name)
        for name in ("v_c", "body_twist"):
            np.testing.assert_allclose(getattr(tr, name).numpy(),
                                       np.asarray(getattr(jr, name)), atol=1e-3, err_msg=name)
        np.testing.assert_allclose(tr.ema.value.numpy(), np.asarray(jr.ema.value), atol=1e-3)
        if k is not None:
            assert not bool(tr.feature_ok) and int(tr.num_valid) == num_pairs
            np.testing.assert_array_equal(tr.v_c.numpy(), tprev.numpy())
            np.testing.assert_array_equal(tr.ema.value.numpy(), tema.value.numpy())
            assert bool(tr.ema.initialized)
        jema, jprev, tema, tprev = jr.ema, jr.v_c, tr.ema, tr.v_c
    assert float(torch.abs(tprev).max()) > 1e-2     # the held command is a real one


def test_servo_step_bf16_matches():
    """The bf16 step (blocks and descriptors in bf16, matching in the
    reference's default arithmetic) against vitvs_tpu's bf16 step: the
    same pairs and the velocity within 1e-3 (BASELINE.md)."""
    params, _, _, _ = _setup(pinv_mode="dls")
    jcfg, tcfg = JVSConfig(**CFG, pinv_mode="dls"), TVSConfig(**CFG, pinv_mode="dls")
    jmodel = jpipe.ServoModel(vit=jvit.ViTConfig(**VIT), cfg=jcfg, compute_dtype=jnp.bfloat16)
    tmodel = tpipe.ServoModel(vit=tvit.ViTConfig(**VIT), cfg=tcfg,
                              compute_dtype=torch.bfloat16, device="cpu")
    net = tmodel.load_vit(from_jax_params(params))
    goal, frames, depth = _frames([(18, 20), (16, 17), (10, 15)])
    jg = jpipe.goal_descriptors(params, jmodel, jnp.asarray(goal))
    tg = tpipe.goal_descriptors(net, tmodel, goal)
    assert jg.dtype == jnp.bfloat16 and tg.dtype == torch.bfloat16
    jema, jprev = JEma.init(), jnp.zeros(6)
    tema, tprev = TEma.init(device="cpu"), torch.zeros(6)
    t = tg.shape[0]
    for i, frame in enumerate(frames):
        key = jax.random.PRNGKey(40 + i)
        jr = jpipe.servo_step(params, jmodel, jg, jnp.asarray(frame), jnp.asarray(depth),
                              jema, jprev, key)
        scores = torch.tensor(np.asarray(jax.random.uniform(key, (t,))))
        tr = tpipe.servo_step(net, tmodel, tg, frame, depth, tema, tprev, scores=scores)
        for name in ("valid", "num_valid", "feature_ok"):
            np.testing.assert_array_equal(getattr(tr, name).numpy(),
                                          np.asarray(getattr(jr, name)), err_msg=name)
        np.testing.assert_array_equal(tr.s_uv_star.numpy(), np.asarray(jr.s_uv_star))
        # the same matched patches; the sub-patch offsets come from the two
        # packages' bf16 descriptors, which round at different points of the
        # forward (per-token cosine >= 0.9999, test_torch_vit.py): 0.05 px
        np.testing.assert_allclose(tr.s_uv.numpy(), np.asarray(jr.s_uv), atol=5e-2)
        for name in ("v_c", "body_twist"):
            np.testing.assert_allclose(getattr(tr, name).numpy(),
                                       np.asarray(getattr(jr, name)), atol=1e-3, err_msg=name)
        assert bool(tr.feature_ok) and float(torch.abs(tr.v_c).max()) > 1e-2
        jema, jprev, tema, tprev = jr.ema, jr.v_c, tr.ema, tr.v_c


def test_servo_step_draws_scores_from_generator():
    params, _, tmodel, net = _setup(pinv_mode="dls")
    goal, (frame,), depth = _frames([(18, 20)])
    tg = tpipe.goal_descriptors(net, tmodel, goal)
    run = lambda: tpipe.servo_step(net, tmodel, tg, frame, depth, TEma.init(device="cpu"),
                                   torch.zeros(6), generator=torch.Generator().manual_seed(3))
    a, b = run(), run()
    np.testing.assert_array_equal(a.s_uv_star.numpy(), b.s_uv_star.numpy())
    assert a.v_c.shape == (6,) and torch.isfinite(a.v_c).all()


def test_servo_model_checks_weights_dtype():
    _, _, tmodel, net = _setup()
    net.cast_blocks(torch.bfloat16)
    goal, _, _ = _frames([])
    with pytest.raises(ValueError):
        tpipe.goal_descriptors(net, tmodel, goal)


# ---------------------------------------------------------------------------
# the int8 W8A8 serving step (static calibrated scales, source-quantized bins)
# ---------------------------------------------------------------------------

# variant F: the fused int8-QK^T kernel; variant N: bf16 attention through the
# no-max kernel.  The JAX side runs its Pallas kernels in interpret mode: off
# the TPU its fallbacks compute exact softmax instead.
QUANT_VARIANTS = {"F": dict(quant_attn="fused", attn_impl="xla"),
                  "N": dict(quant_attn="none", attn_impl="fast")}


@pytest.mark.parametrize("variant", sorted(QUANT_VARIANTS))
def test_quantized_servo_step_matches(variant):
    """goal_descriptors + 3 servo steps of the int8 serving step, each
    package quantizing the same float weights with static scales calibrated
    on the goal frame and the three current frames: the same pairs are
    selected and the velocity agrees within 1e-3."""
    params, _, _, fnet = _setup(pinv_mode="dls", subpixel_matching=True)
    over = QUANT_VARIANTS[variant]
    jcfg, tcfg = JVSConfig(**CFG, pinv_mode="dls"), TVSConfig(**CFG, pinv_mode="dls")
    jv = jvit.ViTConfig(**VIT, quant_attn=over["quant_attn"],
                        attn_impl=over["attn_impl"] + "-interpret")
    tv = tvit.ViTConfig(**VIT, **over)
    jmodel = jpipe.ServoModel(vit=jv, cfg=jcfg, compute_dtype=jnp.float32, quantized=True)
    tmodel = tpipe.ServoModel(vit=tv, cfg=tcfg, compute_dtype=torch.float32, device="cpu",
                              quantized=True)
    assert jmodel.source_quantized_bins and tmodel.source_quantized_bins
    goal, frames, depth = _frames([(18, 20), (16, 17), (10, 15)])
    calib = [goal, *frames]
    jcal = jnp.stack([jpipe.preprocess(jmodel, jnp.asarray(f)) for f in calib])
    jq_params = jquant.quantize_vit_params(params, cfg=jv, calib_images=jcal, layer=jcfg.layer,
                                           compute_dtype=jnp.float32)
    net = tpipe.quantized_vit(fnet, tmodel, calib)
    assert net.blocks[0].act_scales is not None

    jg = jpipe.goal_descriptors(jq_params, jmodel, jnp.asarray(goal))
    tg = tpipe.goal_descriptors(net, tmodel, goal)
    np.testing.assert_array_equal(tg.q.numpy(), np.asarray(jg.q))
    np.testing.assert_allclose(tg.nq.numpy(), np.asarray(jg.nq), rtol=1e-6)

    jema, jprev = JEma.init(), jnp.zeros(6)
    tema, tprev = TEma.init(device="cpu"), torch.zeros(6)
    t = tg.q.shape[0]
    for i, frame in enumerate(frames):
        key = jax.random.PRNGKey(20 + i)
        jr = jpipe.servo_step(jq_params, jmodel, jg, jnp.asarray(frame), jnp.asarray(depth),
                              jema, jprev, key)
        scores = torch.tensor(np.asarray(jax.random.uniform(key, (t,))))
        tr = tpipe.servo_step(net, tmodel, tg, frame, depth, tema, tprev, scores=scores)
        for name in ("valid", "num_valid", "feature_ok"):
            np.testing.assert_array_equal(getattr(tr, name).numpy(),
                                          np.asarray(getattr(jr, name)), err_msg=name)
        np.testing.assert_array_equal(tr.s_uv_star.numpy(), np.asarray(jr.s_uv_star))
        np.testing.assert_allclose(tr.s_uv.numpy(), np.asarray(jr.s_uv), atol=1e-3)
        for name in ("v_c", "body_twist"):
            np.testing.assert_allclose(getattr(tr, name).numpy(),
                                       np.asarray(getattr(jr, name)), atol=1e-3, err_msg=name)
        assert bool(tr.feature_ok) and float(torch.abs(tr.v_c).max()) > 1e-2
        jema, jprev, tema, tprev = jr.ema, jr.v_c, tr.ema, tr.v_c


def test_quantized_model_checks_its_vit():
    """A quantized model refuses the float ViT and the other way round."""
    params, _, tmodel, net = _setup()
    qmodel = dataclasses.replace(tmodel, quantized=True)
    goal, _, _ = _frames([])
    with pytest.raises(TypeError):
        tpipe.goal_descriptors(net, qmodel, goal)
    qnet = tpipe.quantized_vit(net, qmodel)
    with pytest.raises(TypeError):
        tpipe.goal_descriptors(qnet, tmodel, goal)
    desc = tpipe.goal_descriptors(qnet, dataclasses.replace(qmodel, fused_bin_quant=False), goal)
    assert desc.shape == (qmodel.grid()[0] * qmodel.grid()[1], qmodel.desc_dim())


def test_f32_servo_step_full_size_on_trained_weights_matches():
    """The f32 step at full size (ROADMAP.md fault 3.4's path: f32 compute,
    exact GELU, the reference's strict-parity numerics): ViT-S/14 @ 308 on
    the trained ckpt_real308, layer-11 binned descriptors (d = 3456), the
    dls solve, against vitvs_tpu's f32 step on the CPU.  The frames are two
    308 px crops of a seeded smoothed texture shifted by (6, 9) px, so the
    preprocess keeps the size; the goal descriptors agree within 1e-4
    (largest magnitude about 9), every nearest neighbour agrees both ways,
    and two steps select the same pairs with the velocity within 1e-5
    (4.7e-6 seen, on velocities of about 1e-2)."""
    import os

    from vitvs_tpu.models.convert import load_params
    from vitvs_tpu.ops import matcher as jm
    from vitvs_tpu_torch.ops import matcher as tm

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    params = jax.tree.map(np.asarray, load_params(os.path.join(repo, "artifacts", "ckpt_real308")))
    kw = dict(u_max=308, v_max=308, pinv_mode="dls")
    jmodel = jpipe.ServoModel.create(JVSConfig(**kw), compute_dtype=jnp.float32, gelu_approx=False)
    tmodel = tpipe.ServoModel.create(TVSConfig(**kw), compute_dtype=torch.float32,
                                     gelu_approx=False, device="cpu")
    assert tmodel.grid() == (22, 22) and tmodel.desc_dim() == 3456
    net = tmodel.load_vit(from_jax_params(params))
    big = texture(340, 340, seed=3)
    goal, frame = big[16:324, 16:324], big[22:330, 25:333]
    depth = np.full((308, 308), 0.6, np.float32)

    jg = jpipe.goal_descriptors(params, jmodel, jnp.asarray(goal))
    tg = tpipe.goal_descriptors(net, tmodel, goal)
    assert tg.shape == (484, 3456) and tg.dtype == torch.float32
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=0, atol=1e-4)
    jf = jpipe.goal_descriptors(params, jmodel, jnp.asarray(frame))
    tf = tpipe.goal_descriptors(net, tmodel, frame)
    ref, got = jm.dual_argmax_cosine(jf, jg), tm.dual_argmax_cosine(tf, tg)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(ref[3]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), rtol=0, atol=1e-6)

    jema, jprev = JEma.init(), jnp.zeros(6)
    tema, tprev = TEma.init(device="cpu"), torch.zeros(6)
    for i in range(2):
        key = jax.random.PRNGKey(50 + i)
        jr = jpipe.servo_step(params, jmodel, jg, jnp.asarray(frame), jnp.asarray(depth),
                              jema, jprev, key)
        scores = torch.tensor(np.asarray(jax.random.uniform(key, (484,))))
        tr = tpipe.servo_step(net, tmodel, tg, frame, depth, tema, tprev, scores=scores)
        for name in ("valid", "num_valid", "feature_ok", "s_uv_star"):
            np.testing.assert_array_equal(getattr(tr, name).numpy(),
                                          np.asarray(getattr(jr, name)), err_msg=name)
        # the sub-patch offsets come from ratios of neighbouring similarities,
        # which carry the f32 descriptors' last-bit differences (1.7e-4 px seen)
        np.testing.assert_allclose(tr.s_uv.numpy(), np.asarray(jr.s_uv), rtol=0, atol=1e-3)
        for name in ("v_c", "body_twist"):
            np.testing.assert_allclose(getattr(tr, name).numpy(), np.asarray(getattr(jr, name)),
                                       rtol=0, atol=1e-5, err_msg=name)
        assert bool(tr.feature_ok) and float(torch.abs(tr.v_c).max()) > 1e-3
        jema, jprev, tema, tprev = jr.ema, jr.v_c, tr.ema, tr.v_c


@pytest.mark.parametrize("fast_binned", [False, True])
def test_quantized_model_with_match_kernel_raises_as_the_reference(fast_binned):
    """Fault 3.8: a quantized model with use_match_kernel=True (dynamic
    scales, quant_attn 'none').  Both packages quantize no bins at the
    source, their goal descriptors are float binned rows of one shape (or
    unbinned rows with fast_binned_match), and both steps raise the
    reference's ValueError: its matcher kernel computes a float similarity,
    which an int8 serving configuration must not serve."""
    params, _, _, fnet = _setup(pinv_mode="dls")
    jcfg, tcfg = JVSConfig(**CFG, pinv_mode="dls"), TVSConfig(**CFG, pinv_mode="dls")
    kw = dict(quantized=True, use_match_kernel=True, fast_binned_match=fast_binned)
    jmodel = jpipe.ServoModel(vit=jvit.ViTConfig(**VIT), cfg=jcfg, compute_dtype=jnp.float32,
                              **kw)
    tmodel = tpipe.ServoModel(vit=tvit.ViTConfig(**VIT), cfg=tcfg, compute_dtype=torch.float32,
                              device="cpu", **kw)
    assert tmodel.source_quantized_bins is jmodel.source_quantized_bins is False
    jq_params = jquant.quantize_vit_params(params, compute_dtype=jnp.float32)
    net = tpipe.quantized_vit(fnet, tmodel)
    goal, (frame,), depth = _frames([(18, 20)])
    jg = jpipe.goal_descriptors(jq_params, jmodel, jnp.asarray(goal))
    tg = tpipe.goal_descriptors(net, tmodel, goal)
    assert isinstance(tg, torch.Tensor) and isinstance(jg, jax.Array)
    assert tg.shape == jg.shape == (36, 96 * (1 if fast_binned else 9))
    scores = torch.tensor(np.asarray(jax.random.uniform(jax.random.PRNGKey(0), (36,))))
    with pytest.raises(ValueError, match="does not compose with int8 matching"):
        jpipe.servo_step(jq_params, jmodel, jg, jnp.asarray(frame), jnp.asarray(depth),
                         JEma.init(), jnp.zeros(6), jax.random.PRNGKey(0))
    with pytest.raises(ValueError, match="does not compose with int8 matching"):
        tpipe.servo_step(net, tmodel, tg, frame, depth, TEma.init(device="cpu"),
                         torch.zeros(6), scores=scores)
