"""Port parity for DINOv2-giant's pieces and the model entry points of the
JAX package that serve it: the SwiGLU FFN (float and int8), the ViT-g
preset, the 'attn' facet and saliency, ``vit_forward``,
``count_flops_per_image``, ``DescriptorExtractor``, the torch-hub loader
against ``tests/torch_ref.py:TorchViT`` and the quaternion helpers, each
against ``jax.jit`` of the reference on the same seeded weights, on tiny
models (2 blocks, 96 wide)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_ref import TorchViT
from vitvs_tpu.core import se3 as jse3
from vitvs_tpu.models import convert as jconvert
from vitvs_tpu.models import extractor as jext
from vitvs_tpu.models import quant as jq
from vitvs_tpu.models import vit as jvit
from vitvs_tpu_torch.core import se3 as tse3
from vitvs_tpu_torch.models import convert as tconvert
from vitvs_tpu_torch.models import extractor as text
from vitvs_tpu_torch.models import quant as tq
from vitvs_tpu_torch.models import vit as tvit
from vitvs_tpu_torch.models.convert import from_jax_params, from_jax_quant_params

# 96 wide in 6 heads of 16 (saliency's default heads 0, 2, 4, 5 exist), SwiGLU
# hidden round8(int(384 * 2 / 3)) = 256
TINY = dict(patch_size=14, embed_dim=96, depth=2, num_heads=6, pos_grid=5, stride=14,
            model_name="tiny")


def _cfgs(**kw):
    return jvit.ViTConfig(**TINY, **kw), tvit.ViTConfig(**TINY, **kw)


def _params(jcfg, seed=3):
    """Seeded weights with LayerScale near 1, nonzero biases and a final
    norm that is not the identity, so every term matters."""
    params = jax.tree.map(np.asarray, jvit.init_vit(jcfg, jax.random.PRNGKey(seed)))
    rs = np.random.default_rng(5)
    for name in ("ls1", "ls2"):
        params["blocks"][name] = rs.uniform(0.5, 1.5, params["blocks"][name].shape).astype(np.float32)
    for name in ("qkv_bias", "proj_bias", "fc1_bias", "fc2_bias", "norm1_bias"):
        params["blocks"][name] = 0.1 * rs.standard_normal(params["blocks"][name].shape).astype(np.float32)
    params["norm_scale"] = rs.uniform(0.5, 1.5, params["norm_scale"].shape).astype(np.float32)
    params["norm_bias"] = 0.1 * rs.standard_normal(params["norm_bias"].shape).astype(np.float32)
    return params


def _net(tcfg, params, dtype=torch.float32):
    net = tvit.ViT(tcfg)
    net.load_state_dict(from_jax_params(params))
    return net.cast_blocks(dtype).eval()


def _images(n=1, size=56, seed=11):
    return np.random.default_rng(seed).standard_normal((n, size, size, 3)).astype(np.float32)


def _jit_features(params, jcfg, img, layer, facet, dtype=jnp.float32):
    run = jax.jit(lambda p, x: jvit.vit_features(p, jcfg, x, layer=layer, facet=facet,
                                                 compute_dtype=dtype))
    return np.array(run(params, jnp.asarray(img)), dtype=np.float32)


def _cos_min(out, ref):
    out, ref = out.reshape(-1, out.shape[-1]), ref.reshape(-1, ref.shape[-1])
    cos = (out * ref).sum(-1) / (np.linalg.norm(out, axis=-1) * np.linalg.norm(ref, axis=-1))
    return cos.min()


# ---------------------------------------------------------------------------
# the SwiGLU FFN and the ViT-g preset
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("facet", ["token", "query", "key", "value"])
def test_swiglu_features_match_f32(facet):
    """f32 throughout, two blocks of f32 products summed in other orders:
    within 1e-5."""
    jcfg, tcfg = _cfgs(ffn="swiglu")
    params = _params(jcfg)
    assert params["blocks"]["fc1_kernel"].shape == (2, 96, 2 * 256)
    net = _net(tcfg, params)
    assert isinstance(net.blocks[0].mlp, tvit.SwiGLUFFN)
    img = _images(2)
    ref = _jit_features(params, jcfg, img, 1, facet)
    with torch.no_grad():
        out = tvit.vit_features(net, torch.from_numpy(img), layer=1, facet=facet).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("facet", ["token", "key"])
def test_swiglu_features_bf16_close(facet):
    """bf16: XLA's CPU backend fuses silu(x1) * x2 and rounds where its
    fusion puts the converts (as with GELU, fault 3.5), so the port is held
    by cosine per row, at least 0.9999."""
    jcfg, tcfg = _cfgs(ffn="swiglu")
    params = _params(jcfg)
    img = _images()
    ref = _jit_features(params, jcfg, img, 1, facet, jnp.bfloat16)
    with torch.no_grad():
        out = tvit.vit_features(_net(tcfg, params, torch.bfloat16), torch.from_numpy(img),
                                layer=1, facet=facet)
    assert out.dtype == torch.bfloat16
    assert _cos_min(out.float().numpy(), ref) >= 0.9999


def test_make_config_matches_every_preset():
    """Every preset's config equals the reference's field for field, ViT-g's
    SwiGLU width 4096 among them; an unknown FFN raises."""
    assert set(tvit.PRESETS) == set(jvit.PRESETS)
    for name in tvit.PRESETS:
        j, t = jvit.make_config(name), tvit.make_config(name)
        for f in ("patch_size", "embed_dim", "depth", "num_heads", "mlp_ratio", "pos_grid",
                  "use_layerscale", "stride", "ffn", "ffn_hidden", "hidden_dim", "head_dim"):
            assert getattr(t, f) == getattr(j, f), (name, f)
    g = tvit.make_config("dinov2_vitg14")
    assert (g.embed_dim, g.depth, g.num_heads, g.ffn, g.hidden_dim) == (1536, 40, 24, "swiglu", 4096)
    with pytest.raises(ValueError, match="ffn"):
        tvit.ViTConfig(ffn="geglu")


def test_count_flops_per_image_matches():
    for name in tvit.PRESETS:
        for size in (308, 518):
            for layer in (None, 11):
                assert tvit.count_flops_per_image(tvit.make_config(name), size, layer) == \
                    jvit.count_flops_per_image(jvit.make_config(name), size, layer), (name, size)


# ---------------------------------------------------------------------------
# the 'attn' facet, saliency, vit_forward
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ffn", ["mlp", "swiglu"])
def test_attn_facet_matches(ffn):
    """f32 softmax probabilities of block 1, within 1e-6 of the jitted
    reference (f32 logits of 16-deep products); every row sums to 1."""
    jcfg, tcfg = _cfgs(ffn=ffn)
    params = _params(jcfg)
    img = _images(2)
    ref = _jit_features(params, jcfg, img, 1, "attn")
    with torch.no_grad():
        out = tvit.vit_features(_net(tcfg, params), torch.from_numpy(img), layer=1,
                                facet="attn")
    assert out.dtype == torch.float32 and out.shape == ref.shape == (2, 6, 17, 17)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-6)
    np.testing.assert_allclose(out.sum(-1).numpy(), 1.0, atol=1e-6)


def test_attn_facet_bf16_close():
    """bf16 blocks, f32 probabilities from bf16 logits: the rounding of the
    bf16 blocks moves a probability by at most 1e-2."""
    jcfg, tcfg = _cfgs(ffn="swiglu")
    params = _params(jcfg)
    img = _images()
    ref = _jit_features(params, jcfg, img, 1, "attn", jnp.bfloat16)
    with torch.no_grad():
        out = tvit.vit_features(_net(tcfg, params, torch.bfloat16), torch.from_numpy(img),
                                layer=1, facet="attn")
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-2)
    np.testing.assert_allclose(out.sum(-1).numpy(), 1.0, atol=1e-6)


def test_saliency_maps_match():
    """Saliency of the last block and of block 0 with two heads, within 1e-5
    (min-max normalized f32 probabilities), values in [0, 1] with both ends."""
    jcfg, tcfg = _cfgs()
    params = _params(jcfg)
    img = _images(2)
    net = _net(tcfg, params)
    for layer, heads in ((None, (0, 2, 4, 5)), (0, (1, 3))):
        ref = np.asarray(jax.jit(lambda p, x: jext.extract_saliency_maps(
            p, jcfg, x, layer=layer, head_idxs=heads))(params, jnp.asarray(img)))
        with torch.no_grad():
            out = text.extract_saliency_maps(net, torch.from_numpy(img), layer=layer,
                                             head_idxs=heads).numpy()
        assert out.shape == ref.shape == (2, 16)
        np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)
        assert out.min() == 0.0 and out.max() == 1.0


@pytest.mark.parametrize("ffn", ["mlp", "swiglu"])
def test_vit_forward_matches(ffn):
    """All blocks and the final LayerNorm (f32), within 1e-5; weights
    without the final norm raise."""
    jcfg, tcfg = _cfgs(ffn=ffn)
    params = _params(jcfg)
    img = _images(2)
    ref = np.asarray(jax.jit(lambda p, x: jvit.vit_forward(p, jcfg, x))(params, jnp.asarray(img)))
    net = _net(tcfg, params)
    with torch.no_grad():
        out = tvit.vit_forward(net, torch.from_numpy(img)).numpy()
    assert out.shape == ref.shape == (2, 17, 96)
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)
    sd = {k: v for k, v in from_jax_params(params).items() if not k.startswith("norm.")}
    bare = tvit.ViT.from_state_dict(tcfg, sd)
    assert bare.norm is None and "norm.weight" not in bare.state_dict()
    with pytest.raises(ValueError, match="final norm"):
        tvit.vit_forward(bare, torch.from_numpy(img))
    with pytest.raises(RuntimeError, match="norm.weight"):   # a ViT with a norm needs one
        tvit.ViT(tcfg).load_state_dict(sd)
    normed = tvit.ViT.from_state_dict(tcfg, from_jax_params(params))   # the file's norm
    assert torch.equal(normed.norm.weight, torch.from_numpy(params["norm_scale"]))


def test_descriptor_extractor_matches():
    """DescriptorExtractor on the CPU: preprocess of a uint8 frame and
    binned key descriptors against the reference's extract_descriptors;
    random_init draws the port's seeded weights."""
    jcfg, tcfg = _cfgs(ffn="swiglu")
    params = _params(jcfg)
    ex = text.DescriptorExtractor(net=_net(tcfg, params), cfg=tcfg, device="cpu")
    rgb = (255 * np.random.default_rng(2).random((60, 80, 3))).astype(np.uint8)
    x = ex.preprocess(torch.from_numpy(rgb), 56)
    jx = jax.jit(lambda r: jext.DescriptorExtractor(params, jcfg).preprocess(r, 56))(
        jnp.asarray(rgb))
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), rtol=0, atol=1e-5)
    ref = np.asarray(jax.jit(lambda p, im: jext.extract_descriptors(
        p, jcfg, im, layer=1, facet="key", bin=True))(params, jnp.asarray(x.numpy()[None])))
    out = ex.extract_descriptors(x[None], layer=1, facet="key", bin=True).numpy()
    assert out.shape == ref.shape == (1, 1, 16, 9 * 96)
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)
    assert ex.mean == jext.DescriptorExtractor(params, jcfg).mean
    rnd = text.DescriptorExtractor.random_init("dinov2_vits14", seed=1,
                                               compute_dtype=torch.bfloat16, device="cpu")
    assert rnd.net.compute_dtype == torch.bfloat16 and rnd.cfg == tvit.make_config("dinov2_vits14")
    with pytest.raises(ValueError, match="facet"):
        ex.extract_descriptors(x[None], layer=1, facet="attn")


# ---------------------------------------------------------------------------
# the torch-hub loader against the oracle
# ---------------------------------------------------------------------------


def _oracle(swiglu: bool):
    tm = TorchViT(patch=14, dim=96, depth=2, heads=3, pos_grid=16, swiglu=swiglu).eval()
    gen = torch.Generator().manual_seed(5)
    with torch.no_grad():
        for p in tm.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.02)
        for blk in tm.blocks:
            blk.ls1.gamma.fill_(0.7)
            blk.ls2.gamma.fill_(1.2)
    return tm


@pytest.mark.parametrize("swiglu", [False, True], ids=["gelu", "swiglu"])
def test_vit_matches_torch_hub_oracle(swiglu):
    """tests/torch_ref.py:TorchViT loaded through from_torch_state_dict of
    its own state dict: the token facet, the key facet and the full forward
    with the final norm, at 112 px (pos embeddings resampled from 16 x 16),
    f32 within 2e-4 (the oracle's SDPA and convolution sum in other
    orders), as the reference's tests/test_vit.py holds the JAX ViT."""
    tm = _oracle(swiglu)
    sd, cfg = tconvert.from_torch_state_dict(tm.state_dict())
    assert cfg.ffn == ("swiglu" if swiglu else "mlp")
    assert cfg.hidden_dim == (256 if swiglu else 384)
    cfg = dataclasses.replace(cfg, num_heads=3)   # 96 wide reads as one head of 96
    net = tvit.ViT(cfg)
    net.load_state_dict(sd)
    net.eval()
    img = np.random.default_rng(7).standard_normal((1, 112, 112, 3)).astype(np.float32)
    x = torch.from_numpy(img)
    with torch.no_grad():
        nchw = x.permute(0, 3, 1, 2)
        pairs = [(tvit.vit_features(net, x, layer=1), tm.forward_features(nchw, upto=1)),
                 (tvit.vit_features(net, x, layer=1, facet="key"), tm.facet(nchw, 1, "key")),
                 (tvit.vit_forward(net, x), tm.forward_features(nchw))]
    for out, ref in pairs:
        assert out.shape == ref.shape
        np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=1e-3, atol=2e-4)


def test_from_torch_state_dict_reads_swiglu_like_the_reference():
    """The SwiGLU hub state dict gives the reference's config and the same
    weights as its loader (through from_jax_params)."""
    sd_hub = _oracle(True).state_dict()
    jparams, jcfg = jconvert.from_torch_state_dict(sd_hub)
    sd, cfg = tconvert.from_torch_state_dict(sd_hub)
    assert (cfg.ffn, cfg.ffn_hidden, cfg.hidden_dim) == (jcfg.ffn, jcfg.ffn_hidden, jcfg.hidden_dim)
    ref = from_jax_params(jax.tree.map(np.asarray, jparams))
    assert sorted(sd) == sorted(ref) and "blocks.1.mlp.w12.weight" in sd and "norm.weight" in sd
    for k, v in ref.items():
        assert torch.equal(sd[k], v), k
    with pytest.raises(ValueError, match="do not match preset"):
        tconvert.infer_config(sd_hub, "dinov2_vits14")


def test_exported_file_carries_the_ffn(tmp_path):
    """A SwiGLU ViT round-trips through save_exported / load_exported with
    its ffn and its final norm; the config of a GELU ViT carries no ffn keys,
    as the shipped ckpt_real518.npz has none."""
    jcfg, tcfg = _cfgs(ffn="swiglu")
    net = _net(dataclasses.replace(tcfg, model_name="custom_g"), _params(jcfg))
    cfg = tconvert.save_exported(tmp_path / "g.npz", net.state_dict(), net.cfg)
    assert cfg["ffn"] == "swiglu"
    sd, got = tconvert.load_exported(tmp_path / "g.npz")
    assert got == net.cfg and "norm.weight" in sd
    mlp = tconvert.save_exported(tmp_path / "m.npz", _net(tvit.ViTConfig(**TINY), _params(
        jvit.ViTConfig(**TINY))).state_dict(), tvit.ViTConfig(**TINY))
    assert "ffn" not in mlp and "ffn_hidden" not in mlp


# ---------------------------------------------------------------------------
# the int8 ViT with SwiGLU
# ---------------------------------------------------------------------------

QTINY = dict(TINY, embed_dim=128, num_heads=2, gelu_approx=True)


def test_int8_swiglu_calibration_and_blocks_match():
    """Static calibration through silu(x1) * x2 (its amax the fc2 input's)
    within 5e-6 relative (silu's f32 arithmetic differs between the two
    libraries by an ulp or two); int8 weights equal but for at most 7 entries a
    kernel moved by 1 (fault 3.3: maxima in another summation order); then on
    the reference's own int8 weights the token and 'attn' facets of the
    int8 forward within 1e-5 of their scale and 1e-6."""
    jcfg, tcfg = jvit.ViTConfig(**QTINY, ffn="swiglu"), tvit.ViTConfig(**QTINY, ffn="swiglu")
    params = _params(jcfg)
    calib = _images(2, size=70, seed=3)
    net = _net(tcfg, params)
    jmax = jq._collect_act_amax(params, jcfg, jnp.asarray(calib), 1, jnp.float32)
    tmax = tq._collect_act_amax(net, tcfg, torch.from_numpy(calib), 1, torch.float32)
    for o, r in zip(tmax, jmax):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=5e-6)
    qp = jax.tree.map(np.asarray, jq.quantize_vit_params(
        params, cfg=jcfg, calib_images=jnp.asarray(calib), layer=1, compute_dtype=jnp.float32))
    qnet = tq.quantize_vit_params(net, tcfg, torch.from_numpy(calib), layer=1,
                                  compute_dtype=torch.float32)
    for i, blk in enumerate(qnet.blocks):
        for name in ("qkv", "proj", "fc1", "fc2"):
            diff = getattr(blk, name).weight.numpy().T.astype(int) - qp["blocks"][name + "_kernel"][i]
            assert np.abs(diff).max() <= 1 and np.count_nonzero(diff) <= 7, (name, i)
    assert qnet.blocks[0].fc1.weight.shape == (2 * tcfg.hidden_dim, 128)   # w12: (2H, D)
    img = _images(1, size=70, seed=4)
    onqp = from_jax_quant_params(qp, tcfg, torch.float32)
    for facet in ("token", "attn"):
        ref = np.asarray(jax.jit(lambda q, x: jq.vit_features_quant(
            q, jcfg, x, layer=1, facet=facet, compute_dtype=jnp.float32))(qp, jnp.asarray(img)))
        out = tq.vit_features_quant(onqp, torch.from_numpy(img), layer=1, facet=facet).numpy()
        assert out.shape == ref.shape
        if facet == "token":
            assert np.abs(out - ref).max() <= 1e-5 * np.abs(ref).max()
        else:
            np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6)
            np.testing.assert_allclose(out.sum(-1), 1.0, atol=1e-6)


@pytest.mark.parametrize("mode", ["none", "fused"])
def test_int8_attn_facet_matches(mode):
    """The 'attn' facet of the int8 GELU ViT ('none' and 'fused' blocks
    before it; the reference's Pallas kernel in interpret mode), within 1e-6."""
    jcfg = jvit.ViTConfig(**QTINY, quant_attn=mode,
                          attn_impl="xla" if mode == "none" else "xla-interpret")
    tcfg = tvit.ViTConfig(**QTINY, quant_attn=mode)
    params = _params(jcfg)
    qp = jax.tree.map(np.asarray, jq.quantize_vit_params(
        params, cfg=jcfg, calib_images=jnp.asarray(_images(2, size=70)), layer=1,
        compute_dtype=jnp.float32))
    img = _images(1, size=70, seed=6)
    ref = np.asarray(jax.jit(lambda q, x: jq.vit_features_quant(
        q, jcfg, x, layer=1, facet="attn", compute_dtype=jnp.float32))(qp, jnp.asarray(img)))
    out = tq.vit_features_quant(from_jax_quant_params(qp, tcfg, torch.float32),
                                torch.from_numpy(img), layer=1, facet="attn").numpy()
    assert out.shape == ref.shape == (1, 2, 26, 26)
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# small helpers
# ---------------------------------------------------------------------------


def test_quat_identity_and_normalize_wxyz_match():
    np.testing.assert_array_equal(tse3.quat_identity(device="cpu").numpy(),
                                  np.asarray(jse3.quat_identity()))
    assert tse3.quat_identity(device="cpu").dtype == torch.float32
    q = np.random.default_rng(1).standard_normal((5, 4)).astype(np.float32)
    ref = np.asarray(jax.jit(jse3.quat_normalize_wxyz)(jnp.asarray(q)))
    np.testing.assert_allclose(tse3.quat_normalize_wxyz(torch.from_numpy(q)).numpy(), ref,
                               rtol=0, atol=1e-7)
