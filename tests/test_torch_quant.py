"""Port parity: the int8 W8A8 path (models/quant.py) of vitvs_tpu_torch
against vitvs_tpu, f32, on a tiny 2-block 128-wide ViT (2 heads of 64).

Weights: int8 values equal in every entry and scales within 1e-6 relative,
with dynamic and with static (calibrated, SmoothQuant-folded) activation
scales; end to end, the static path's calibration maxima differ in their
last bit, which may move a folded weight on a rounding tie by 1.  The int8
forward is compared on identical int8 weights (``from_jax_quant_params``),
with the JAX Pallas kernels in interpret mode.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vitvs_tpu.models import extractor as jext
from vitvs_tpu.models import quant as jq
from vitvs_tpu.models import vit as jvit
from vitvs_tpu_torch.harness.pipeline import ServoModel
from vitvs_tpu_torch.io_bridge.config import VSConfig
from vitvs_tpu_torch.models import extractor as text
from vitvs_tpu_torch.models import quant as tq
from vitvs_tpu_torch.models import vit as tvit
from vitvs_tpu_torch.models.convert import from_jax_params, from_jax_quant_params

VIT = dict(patch_size=14, embed_dim=128, depth=2, num_heads=2, pos_grid=5, stride=14,
           gelu_approx=True, model_name="tiny")
RNG = np.random.default_rng(55)
# (quant_attn, attn_impl) of the port; the JAX side runs the Pallas kernels
# in interpret mode (its fallbacks compute exact softmax)
MODES = {"exact": ("none", "xla"), "nomax": ("none", "fast"), "fused": ("fused", "xla")}


def _cfgs(mode="exact"):
    quant_attn, impl = MODES[mode]
    jimpl = impl if mode == "exact" else impl + "-interpret"
    return (jvit.ViTConfig(**VIT, quant_attn=quant_attn, attn_impl=jimpl),
            tvit.ViTConfig(**VIT, quant_attn=quant_attn, attn_impl=impl))


def _params(seed=3):
    """Seeded weights with LayerScale near 1 and nonzero biases, so every
    term of the block matters."""
    jcfg, _ = _cfgs()
    params = jax.tree.map(np.asarray, jvit.init_vit(jcfg, jax.random.PRNGKey(seed)))
    rs = np.random.default_rng(5)
    for name in ("ls1", "ls2"):
        params["blocks"][name] = rs.uniform(0.5, 1.5, params["blocks"][name].shape).astype(np.float32)
    for name in ("qkv_bias", "proj_bias", "fc1_bias", "fc2_bias", "norm1_bias"):
        params["blocks"][name] = 0.1 * rs.standard_normal(params["blocks"][name].shape).astype(np.float32)
    return params


def _images(n, size=70, seed=9):
    return np.random.default_rng(seed).standard_normal((n, size, size, 3)).astype(np.float32)


def _float_net(params, tcfg):
    net = tvit.ViT(tcfg)
    net.load_state_dict(from_jax_params(params))
    return net.eval()


def _jax_quant(params, jcfg, calib):
    qp = jq.quantize_vit_params(params, cfg=jcfg if calib is not None else None,
                                calib_images=None if calib is None else jnp.asarray(calib),
                                layer=1, compute_dtype=jnp.float32)
    return jax.tree.map(np.asarray, qp)


def _check_quantized(qnet, ref, static, max_int8_diffs=0):
    for i, blk in enumerate(qnet.blocks):
        for name in ("qkv", "proj", "fc1", "fc2"):
            lin = getattr(blk, name)
            assert lin.weight.dtype == torch.int8
            diff = lin.weight.numpy().T.astype(int) - ref[name + "_kernel"][i]
            assert np.abs(diff).max() <= (1 if max_int8_diffs else 0), name
            assert np.count_nonzero(diff) <= max_int8_diffs, (name, np.count_nonzero(diff))
            np.testing.assert_allclose(lin.scale.numpy(), ref[name + "_kernel_scale"][i, 0],
                                       rtol=1e-6, err_msg=name)
        # the SmoothQuant fold lands in the norms
        for n in (1, 2):
            np.testing.assert_allclose(getattr(blk, f"norm{n}_scale").numpy(),
                                       ref[f"norm{n}_scale"][i], rtol=1e-6)
            np.testing.assert_allclose(getattr(blk, f"norm{n}_bias").numpy(),
                                       ref[f"norm{n}_bias"][i], rtol=1e-6, atol=1e-7)
        if static:
            # act_scales come from a calibration forward: f32 in another order
            np.testing.assert_allclose(blk.act_scales.numpy(), ref["act_scales"][i], rtol=1e-6)
        else:
            assert blk.act_scales is None and "act_scales" not in ref


def test_quantize_vit_params_dynamic_matches():
    """Dynamic scales: no calibration, int8 weights equal in every entry."""
    params = _params()
    jcfg, tcfg = _cfgs()
    ref = _jax_quant(params, jcfg, None)["blocks"]
    qnet = tq.quantize_vit_params(_float_net(params, tcfg), compute_dtype=torch.float32)
    _check_quantized(qnet, ref, static=False)


def test_quantize_vit_params_static_matches():
    """Static scales end to end: the calibration maxima come from f32
    forwards in another summation order, so a folded weight that lies on a
    rounding tie may land on the neighbouring int8 value: at most 7 entries
    of a kernel (1 in 10^4 of fc1's 65536), by 1."""
    params = _params()
    jcfg, tcfg = _cfgs()
    calib = _images(3)
    ref = _jax_quant(params, jcfg, calib)["blocks"]
    qnet = tq.quantize_vit_params(_float_net(params, tcfg), tcfg, torch.from_numpy(calib),
                                  layer=1, compute_dtype=torch.float32)
    _check_quantized(qnet, ref, static=True, max_int8_diffs=7)


def test_quantize_vit_params_static_same_maxima_match(monkeypatch):
    """Given the JAX package's calibration maxima, the SmoothQuant fold and
    the weight quantization give int8 weights equal in every entry."""
    params = _params()
    jcfg, tcfg = _cfgs()
    calib = _images(3)
    ref = _jax_quant(params, jcfg, calib)["blocks"]
    jmax = jq._collect_act_amax(params, jcfg, jnp.asarray(calib), 1, jnp.float32)
    monkeypatch.setattr(tq, "_collect_act_amax",
                        lambda *a: tuple(torch.tensor(np.asarray(m)) for m in jmax))
    qnet = tq.quantize_vit_params(_float_net(params, tcfg), tcfg, torch.from_numpy(calib),
                                  layer=1, compute_dtype=torch.float32)
    _check_quantized(qnet, ref, static=True)


def test_collect_act_amax_matches():
    params = _params()
    jcfg, tcfg = _cfgs()
    calib = _images(3)
    ref = jq._collect_act_amax(params, jcfg, jnp.asarray(calib), 1, jnp.float32)
    out = tq._collect_act_amax(_float_net(params, tcfg), tcfg, torch.from_numpy(calib), 1,
                               torch.float32)
    for o, r in zip(out, ref):
        assert o.shape == r.shape
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=1e-6)


def test_static_scales_past_layer_are_one():
    """Blocks past the extraction layer never run: their activation scales
    come from amax 0 (scale 1e-6 / 127), as in JAX."""
    params = _params()
    jcfg, tcfg = _cfgs()
    calib = _images(2)
    qp = jq.quantize_vit_params(params, cfg=jcfg, calib_images=jnp.asarray(calib), layer=0,
                                compute_dtype=jnp.float32)
    qnet = tq.quantize_vit_params(_float_net(params, tcfg), tcfg, torch.from_numpy(calib),
                                  layer=0, compute_dtype=torch.float32)
    np.testing.assert_allclose(qnet.blocks[1].act_scales.numpy(),
                               np.asarray(qp["blocks"]["act_scales"][1]), rtol=1e-6)
    np.testing.assert_array_equal(qnet.blocks[1].qkv.weight.numpy().T,
                                  np.asarray(qp["blocks"]["qkv_kernel"][1]))


def _close(out, ref):
    """Same int8 weights and static activation scales: the int8 activations
    agree, and the f32 arithmetic differs by its rounding."""
    scale = np.abs(ref).max()
    assert np.abs(out - ref).max() <= 1e-5 * scale, np.abs(out - ref).max() / scale


def test_q_matmul_matches():
    """The W8A8 matmul on identical inputs, dynamic and static scales,
    against the reference as its step runs it, under ``jax.jit`` (the
    dynamic scales multiply by f32(1/127): fault 3.5): the same int8
    activations and exact int32 products, so the same f32 result."""
    x = (2 * RNG.standard_normal((2, 37, 64))).astype(np.float32)
    w = RNG.standard_normal((64, 96)).astype(np.float32)
    wq, ws = jq._quantize_weight(jnp.asarray(w))
    bias = RNG.standard_normal(96).astype(np.float32)
    q_matmul = jax.jit(lambda x, wq, ws, b, a: jq._q_matmul(x, wq, ws, b, jnp.float32,
                                                             act_scale=a))
    for act in (None, np.float32(0.05)):
        ref = q_matmul(jnp.asarray(x), wq, ws[0], jnp.asarray(bias),
                       None if act is None else jnp.asarray(act))
        out = tq._q_matmul(torch.from_numpy(x), torch.from_numpy(np.asarray(wq).T.copy()),
                           torch.tensor(np.asarray(ws[0])), torch.from_numpy(bias),
                           torch.float32, None if act is None else torch.tensor(act))
        np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("facet", ["token", "query", "key", "value"])
def test_vit_features_quant_matches(mode, facet):
    params = _params()
    jcfg, tcfg = _cfgs(mode)
    calib = _images(2)
    qp = _jax_quant(params, jcfg, calib)
    img = _images(1, seed=4)
    ref = np.asarray(jq.vit_features_quant(qp, jcfg, jnp.asarray(img), layer=1, facet=facet,
                                           compute_dtype=jnp.float32))
    qnet = from_jax_quant_params(qp, tcfg, torch.float32)
    out = tq.vit_features_quant(qnet, torch.from_numpy(img), layer=1, facet=facet).numpy()
    assert out.shape == ref.shape
    _close(out, ref)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_vit_features_quant_bf16_close(mode):
    """bf16, the serving dtype: both packages round at other points (and an
    int8 activation near a tie may then round apart), so hold the port to
    the JAX bf16 result by cosine per token (>= 0.9999)."""
    params = _params()
    jcfg, tcfg = _cfgs(mode)
    qp = jax.tree.map(np.asarray, jq.quantize_vit_params(
        params, cfg=jcfg, calib_images=jnp.asarray(_images(2)), layer=1,
        compute_dtype=jnp.bfloat16))
    img = _images(1, seed=4)
    ref = np.asarray(jq.vit_features_quant(qp, jcfg, jnp.asarray(img), layer=1,
                                           compute_dtype=jnp.bfloat16), dtype=np.float32)
    out = tq.vit_features_quant(from_jax_quant_params(qp, tcfg, torch.bfloat16),
                                torch.from_numpy(img), layer=1)
    assert out.dtype == torch.bfloat16
    out = out.float().numpy()
    cos = (out * ref).sum(-1) / (np.linalg.norm(out, axis=-1) * np.linalg.norm(ref, axis=-1))
    assert cos.min() >= 0.9999, cos.min()


def test_vit_features_quant_dynamic_scales_match():
    """Per-token dynamic scales come from each token's amax, which differs
    in its last bit where a LayerNorm output does: the token's int8 values
    may then round apart, and one such token moves the outputs of block 1 by
    up to about 5e-3 of their scale (the static-scale tests above hold the
    arithmetic to f32 rounding)."""
    params = _params()
    jcfg, tcfg = _cfgs("fused")
    qp = _jax_quant(params, jcfg, None)
    img = _images(2, seed=6)
    ref = np.asarray(jq.vit_features_quant(qp, jcfg, jnp.asarray(img), layer=1,
                                           compute_dtype=jnp.float32))
    out = tq.vit_features_quant(from_jax_quant_params(qp, tcfg, torch.float32),
                                torch.from_numpy(img), layer=1).numpy()
    scale = np.abs(ref).max()
    assert np.abs(out - ref).max() <= 1e-2 * scale
    assert np.abs(out - ref).mean() <= 5e-4 * scale


def test_extract_descriptors_quantized_matches():
    """The binned descriptors of the int8 forward (layer 0, 5x5 grid)."""
    params = _params()
    jcfg, tcfg = _cfgs("nomax")
    qp = _jax_quant(params, jcfg, _images(2))
    img = _images(1, seed=8)
    ref = np.asarray(jext.extract_descriptors(qp, jcfg, jnp.asarray(img), layer=0, bin=True,
                                              compute_dtype=jnp.float32, quantized=True))
    out = text.extract_descriptors(from_jax_quant_params(qp, tcfg, torch.float32),
                                   torch.from_numpy(img), layer=0, bin=True,
                                   quantized=True).numpy()
    assert out.shape == ref.shape == (1, 1, 25, 9 * 128)
    _close(out, ref)


def test_quantized_vit_lives_in_the_compute_dtype():
    """bf16: int8 weights, f32 scales (the LayerNorm scales among them, as
    JAX's _cast_block passes every *_scale), everything else bf16 (the
    embedding staged in bf16 as the JAX package stages it)."""
    params = _params()
    _, tcfg = _cfgs()
    qnet = tq.quantize_vit_params(_float_net(params, tcfg), compute_dtype=torch.bfloat16)
    assert qnet.compute_dtype == torch.bfloat16
    assert qnet.patch_weight.dtype == torch.bfloat16 and qnet.pos_embed.dtype == torch.bfloat16
    blk = qnet.blocks[0]
    assert blk.qkv.weight.dtype == torch.int8 and blk.qkv.scale.dtype == torch.float32
    assert blk.qkv.bias.dtype == torch.bfloat16 and blk.ls1.dtype == torch.bfloat16
    assert blk.norm1_scale.dtype == torch.float32 and blk.norm1_bias.dtype == torch.bfloat16
    out = tq.vit_features_quant(qnet, torch.from_numpy(_images(1)), layer=1)
    assert out.dtype == torch.bfloat16 and torch.isfinite(out.float()).all()


def test_unported_modes_raise():
    """'fused' takes no pooled keys and an unknown attn_impl raises.  The
    int8-probability modes, the relu / sqrelu scores
    (tests/test_torch_attn_variants.py holds them) and the 'attn' facet
    (tests/test_torch_vitg.py holds it) build and run."""
    for mode in ("pv", "qk+pv"):
        assert tvit.ViTConfig(**VIT, quant_attn=mode).quant_attn == mode
    for score in ("relu", "sqrelu"):
        assert ServoModel.create(VSConfig(attn_score=score), device="cpu").vit.attn_score == score
    _, tcfg = _cfgs()
    qnet = tq.quantize_vit_params(_float_net(_params(), tcfg), compute_dtype=torch.float32)
    with torch.no_grad():
        probs = tq.vit_features_quant(qnet, torch.from_numpy(_images(1)), layer=1, facet="attn")
    assert probs.shape == (1, 2, 26, 26) and probs.dtype == torch.float32
    with pytest.raises(ValueError):
        dataclasses.replace(tcfg, attn_impl="flash")
    fused = dataclasses.replace(tcfg, quant_attn="fused", kv_pool=2)
    qnet = tq.quantize_vit_params(_float_net(_params(), tcfg), fused, compute_dtype=torch.float32)
    with pytest.raises(ValueError, match="kv_pool"):
        tq.vit_features_quant(qnet, torch.from_numpy(_images(1)), layer=1)


POOLS = {"none": dict(),
         "post_window": dict(kv_pool=2, kv_pool_impl="window"),
         "post_matmul": dict(kv_pool=2, kv_pool_impl="matmul"),
         "pre": dict(kv_pool=2, kv_pool_impl="matmul", kv_pool_where="pre")}


def _nomax_cfgs(mode, pool):
    kw = dict(VIT, quant_attn=mode, **POOLS[pool])
    return jvit.ViTConfig(**kw), tvit.ViTConfig(**kw)


def _jitted_features(qp, jcfg, img, dtype=jnp.float32, layer=1):
    run = jax.jit(lambda q, x: jq.vit_features_quant(q, jcfg, x, layer=layer,
                                                     compute_dtype=dtype))
    return np.array(run(qp, jnp.asarray(img)), dtype=np.float32)


def _hold_loose(out, ref):
    """Within 1e-2 of the output scale at most and 5e-4 on average: a token
    whose int8 activations moved by one step (see
    test_vit_features_quant_dynamic_scales_match)."""
    scale = np.abs(ref).max()
    assert np.abs(out - ref).max() <= 1e-2 * scale
    assert np.abs(out - ref).mean() <= 5e-4 * scale


@pytest.mark.parametrize("scales", ["static", "dynamic"])
@pytest.mark.parametrize("pool", sorted(POOLS))
@pytest.mark.parametrize("mode", ["nomax", "nomax2", "nomax3"])
def test_nomax_modes_with_pooling_match(mode, pool, scales):
    """The no-max modes without and with 2 x 2 K/V pooling (after the
    projection by windows or by the matrix, or of the tokens before the K/V
    projection) on the 5 x 5 grid (odd: its edge windows hold 2 and 1
    patches), on identical int8 weights, against jax.jit of the reference's
    vit_features_quant and _block_q, f32.  Each block on the same input:
    with static scales within 1e-5 of the output scale, as the
    exact-softmax forward; with dynamic per-token scales, whose amax can
    differ in its last bit, as :func:`_hold_loose`.  End to end through both
    blocks as :func:`_hold_loose` either way: block 0's outputs agree to
    about 1e-6, and where a block-1 activation lies that close to an int8
    rounding tie its token moves by one int8 step (static 2 x 2 pooling
    after the projection does so on this input)."""
    params = _params()
    jcfg, tcfg = _nomax_cfgs(mode, pool)
    qp = _jax_quant(params, jcfg, _images(2) if scales == "static" else None)
    qnet = from_jax_quant_params(qp, tcfg, torch.float32)
    img = _images(2, seed=4)
    hold = _close if scales == "static" else _hold_loose
    x0 = _jitted_features(qp, jcfg, img, layer=0)
    hold(tq.vit_features_quant(qnet, torch.from_numpy(img), layer=0).numpy(), x0)
    block1 = jax.tree.map(lambda a: a[1], qp["blocks"])
    ref1 = np.asarray(jax.jit(lambda b, x: jq._block_q(x, jq._cast_block(b, jnp.float32), jcfg))(
        block1, jnp.asarray(x0)))
    hold(tq._block_q(torch.from_numpy(x0), qnet.blocks[1], tcfg, True).numpy(), ref1)
    ref = _jitted_features(qp, jcfg, img)
    out = tq.vit_features_quant(qnet, torch.from_numpy(img), layer=1).numpy()
    assert out.shape == ref.shape == (2, 26, 128)
    _hold_loose(out, ref)


@pytest.mark.parametrize("pool", sorted(POOLS))
def test_nomax3_bf16_close(pool):
    """nomax3 in bf16, the serving dtype (logits and exp2 in bf16): held to
    jax.jit of the reference by cosine per token (>= 0.9999), as
    test_vit_features_quant_bf16_close."""
    params = _params()
    jcfg, tcfg = _nomax_cfgs("nomax3", pool)
    qp = jax.tree.map(np.asarray, jq.quantize_vit_params(
        params, cfg=jcfg, calib_images=jnp.asarray(_images(2)), layer=1,
        compute_dtype=jnp.bfloat16))
    img = _images(1, seed=4)
    ref = _jitted_features(qp, jcfg, img, jnp.bfloat16)
    out = tq.vit_features_quant(from_jax_quant_params(qp, tcfg, torch.bfloat16),
                                torch.from_numpy(img), layer=1)
    assert out.dtype == torch.bfloat16
    out = out.float().numpy()
    cos = (out * ref).sum(-1) / (np.linalg.norm(out, axis=-1) * np.linalg.norm(ref, axis=-1))
    assert cos.min() >= 0.9999, cos.min()


@pytest.mark.parametrize("pool", ["post_window", "post_matmul", "pre"])
def test_collect_act_amax_with_pooling_matches(pool):
    """Calibration with K/V pooling: K and V pooled after the projection
    whatever kv_pool_where says, as the reference calibrates (f32)."""
    params = _params()
    jcfg, tcfg = _nomax_cfgs("nomax3", pool)
    calib = _images(3)
    ref = jq._collect_act_amax(params, jcfg, jnp.asarray(calib), 1, jnp.float32)
    out = tq._collect_act_amax(_float_net(params, tcfg), tcfg, torch.from_numpy(calib), 1,
                               torch.float32)
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=1e-6)
    # the pooled attention output is another distribution than the dense one's
    dense = tq._collect_act_amax(_float_net(params, tcfg), _cfgs()[1], torch.from_numpy(calib),
                                 1, torch.float32)
    assert not torch.equal(out[2], dense[2])
