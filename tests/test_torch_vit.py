"""Port parity: the ViT facet forward, weight conversion and descriptor
binning of vitvs_tpu_torch against vitvs_tpu, on a tiny model (2 blocks,
96 wide, 56 px) and once at full ViT-S/14 width on the trained checkpoint."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vitvs_tpu.models import extractor as jext
from vitvs_tpu.models import vit as jvit
from vitvs_tpu_torch.models import extractor as text
from vitvs_tpu_torch.models import vit as tvit
from vitvs_tpu_torch.models.convert import from_jax_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RNG = np.random.default_rng(11)


def _tiny_cfgs(gelu_approx=False, stride=14):
    kw = dict(patch_size=14, embed_dim=96, depth=2, num_heads=3, pos_grid=5,
              stride=stride, gelu_approx=gelu_approx, model_name="tiny")
    return jvit.ViTConfig(**kw), tvit.ViTConfig(**kw)


def _tiny_params(jcfg, flat_qkv=False):
    params = jvit.init_vit(jcfg, jax.random.PRNGKey(3))
    params = jax.tree.map(np.asarray, params)
    rs = np.random.default_rng(5)
    # LayerScale near 1 and nonzero biases, so every term of the block matters
    for name in ("ls1", "ls2"):
        params["blocks"][name] = rs.uniform(0.5, 1.5, params["blocks"][name].shape).astype(np.float32)
    for name in ("qkv_bias", "proj_bias", "fc1_bias", "fc2_bias", "norm1_bias"):
        params["blocks"][name] = 0.1 * rs.standard_normal(params["blocks"][name].shape).astype(np.float32)
    if flat_qkv:
        L, D = params["blocks"]["qkv_kernel"].shape[:2]
        params["blocks"]["qkv_kernel"] = params["blocks"]["qkv_kernel"].reshape(L, D, 3 * D)
        params["blocks"]["qkv_bias"] = params["blocks"]["qkv_bias"].reshape(L, 3 * D)
    return params


def _net(tcfg, params, dtype=torch.float32):
    net = tvit.ViT(tcfg)
    net.load_state_dict(from_jax_params(params))
    return net.cast_blocks(dtype).eval()


def _images(size=56, n=1):
    return RNG.standard_normal((n, size, size, 3)).astype(np.float32)


@pytest.mark.parametrize("flat_qkv", [False, True], ids=["head_major", "flat"])
@pytest.mark.parametrize("gelu_approx", [False, True], ids=["gelu_erf", "gelu_tanh"])
def test_vit_features_token_matches(flat_qkv, gelu_approx):
    jcfg, tcfg = _tiny_cfgs(gelu_approx)
    params = _tiny_params(jcfg, flat_qkv)
    imgs = _images(n=2)
    ref = np.asarray(jvit.vit_features(params, jcfg, jnp.asarray(imgs), layer=1))
    with torch.no_grad():
        out = tvit.vit_features(_net(tcfg, params), torch.from_numpy(imgs), layer=1).numpy()
    assert out.shape == ref.shape == (2, 17, 96)
    # f32 throughout; two blocks of f32 matmuls in different summation orders
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("facet", ["query", "key", "value"])
def test_vit_features_qkv_facets_match(facet):
    jcfg, tcfg = _tiny_cfgs()
    params = _tiny_params(jcfg)
    imgs = _images()
    ref = np.asarray(jvit.vit_features(params, jcfg, jnp.asarray(imgs), layer=1, facet=facet))
    with torch.no_grad():
        out = tvit.vit_features(_net(tcfg, params), torch.from_numpy(imgs), layer=1,
                                facet=facet).numpy()
    assert out.shape == ref.shape == (1, 3, 17, 32)
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


def test_vit_features_overlapping_stride_matches():
    jcfg, tcfg = _tiny_cfgs(stride=7)
    params = _tiny_params(jcfg)
    imgs = _images()
    ref = np.asarray(jvit.vit_features(params, jcfg, jnp.asarray(imgs), layer=0))
    with torch.no_grad():
        out = tvit.vit_features(_net(tcfg, params), torch.from_numpy(imgs), layer=0).numpy()
    assert out.shape == ref.shape == (1, 50, 96)
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


def test_vit_features_bf16_close():
    """bf16 blocks: both packages round at different points, so hold the
    port to the JAX bf16 result by cosine per token (>= 0.9999)."""
    jcfg, tcfg = _tiny_cfgs()
    params = _tiny_params(jcfg)
    imgs = _images()
    ref = np.asarray(jvit.vit_features(params, jcfg, jnp.asarray(imgs), layer=1,
                                       compute_dtype=jnp.bfloat16), dtype=np.float32)
    with torch.no_grad():
        out = tvit.vit_features(_net(tcfg, params, torch.bfloat16),
                                torch.from_numpy(imgs), layer=1)
    assert out.dtype == torch.bfloat16
    out = out.float().numpy()
    cos = (out * ref).sum(-1) / (np.linalg.norm(out, axis=-1) * np.linalg.norm(ref, axis=-1))
    assert cos.min() >= 0.9999, cos.min()


@pytest.mark.parametrize("facet,bin", [("token", True), ("token", False), ("key", True)])
def test_extract_descriptors_matches(facet, bin):
    jcfg, tcfg = _tiny_cfgs()
    params = _tiny_params(jcfg)
    imgs = _images()
    ref = np.asarray(jext.extract_descriptors(params, jcfg, jnp.asarray(imgs), layer=1,
                                              facet=facet, bin=bin))
    with torch.no_grad():
        out = text.extract_descriptors(_net(tcfg, params), torch.from_numpy(imgs), layer=1,
                                       facet=facet, bin=bin).numpy()
    assert out.shape == ref.shape == (1, 1, 16, 96 * (9 if bin else 1))
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("grid,hierarchy", [((4, 5), 1), ((7, 6), 2)])
def test_log_bin_matches(grid, hierarchy):
    feats = RNG.standard_normal((2, grid[0] * grid[1], 8)).astype(np.float32)
    ref = np.asarray(jext.log_bin(jnp.asarray(feats), grid, hierarchy))
    out = text.log_bin(torch.from_numpy(feats), grid, hierarchy).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6)


def test_make_config_matches_presets():
    for name in tvit.PRESETS:
        j = dataclasses.asdict(jvit.make_config(name))
        t = dataclasses.asdict(tvit.make_config(name))
        assert {k: j[k] for k in t} == t


def test_full_width_checkpoint_descriptors_match():
    """ViT-S/14 at full width and depth on the trained real308 checkpoint
    (flat qkv layout), at a small 112 px input: binned layer-11 descriptors
    in f32 agree to 1e-5 of their largest magnitude."""
    from vitvs_tpu.models.convert import load_params

    params = jax.tree.map(np.asarray, load_params(os.path.join(REPO, "artifacts", "ckpt_real308")))
    jcfg = jvit.make_config("dinov2_vits14")
    tcfg = tvit.make_config("dinov2_vits14")
    imgs = _images(112)
    ref = np.asarray(jext.extract_descriptors(params, jcfg, jnp.asarray(imgs), layer=11, bin=True))
    with torch.no_grad():
        out = text.extract_descriptors(_net(tcfg, params), torch.from_numpy(imgs),
                                       layer=11, bin=True).numpy()
    assert out.shape == ref.shape == (1, 1, 64, 384 * 9)
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5 * np.abs(ref).max())


POOLS = {"post_window": dict(kv_pool=2, kv_pool_impl="window"),
         "post_matmul": dict(kv_pool=2, kv_pool_impl="matmul"),
         "pre": dict(kv_pool=2, kv_pool_impl="matmul", kv_pool_where="pre"),
         "pool3_window": dict(kv_pool=3, kv_pool_impl="window")}


@pytest.mark.parametrize("T,pool", [(17, 2), (26, 2), (50, 2), (50, 3), (1370, 2), (1370, 3)])
def test_pool_matrix_identical(T, pool):
    """The port's copy of the pooling matrix, even and odd grids (edge
    windows of 5 x 5 and 37 x 37 count their true members), bit for bit."""
    out = tvit._pool_matrix(T, pool)
    np.testing.assert_array_equal(out, jvit._pool_matrix(T, pool))
    np.testing.assert_allclose(out.sum(-1), 1.0, rtol=1e-6)


@pytest.mark.parametrize("impl", ["window", "matmul"])
@pytest.mark.parametrize("T", [17, 26, 50])
def test_pool_kv_matches(impl, T):
    """Both pooling implementations on (2, T, 3, 8) tokens against jax.jit
    of the reference's: f32 sums of at most 9 terms in another order."""
    t = RNG.standard_normal((2, T, 3, 8)).astype(np.float32)
    ref = np.asarray(jax.jit(lambda x: jvit._pool_kv(x, 2, impl))(t))
    out = tvit.pool_kv(torch.from_numpy(t), 2, impl).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("size", [56, 70], ids=["grid4", "grid5"])
@pytest.mark.parametrize("pool", sorted(POOLS))
def test_vit_features_pooled_matches(pool, size):
    """The float ViT with K/V pooling (plain softmax over the pooled keys)
    against jax.jit of the reference, f32, on an even and an odd patch
    grid: f32 matmuls in other summation orders, as the unpooled test."""
    jcfg, tcfg = _tiny_cfgs()
    jcfg, tcfg = (dataclasses.replace(c, **POOLS[pool]) for c in (jcfg, tcfg))
    params = _tiny_params(jcfg)
    imgs = _images(size, n=2)
    ref = np.asarray(jax.jit(lambda p, x: jvit.vit_features(p, jcfg, x, layer=1))(params, imgs))
    with torch.no_grad():
        out = tvit.vit_features(_net(tcfg, params), torch.from_numpy(imgs), layer=1,
                                use_kernels=True).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


def test_vit_features_conv_embed_matches():
    """patch_embed_impl='conv' (a convolution with stride = patch) against
    the reference's conv lowering, and against the port's reshape route:
    the same patch products, summed in another order."""
    jcfg, tcfg = _tiny_cfgs()
    jconv, tconv = (dataclasses.replace(c, patch_embed_impl="conv") for c in (jcfg, tcfg))
    params = _tiny_params(jcfg)
    imgs = _images(n=2)
    ref = np.asarray(jax.jit(lambda p, x: jvit.vit_features(p, jconv, x, layer=0))(params, imgs))
    with torch.no_grad():
        out = tvit.vit_features(_net(tconv, params), torch.from_numpy(imgs), layer=0).numpy()
        reshape = tvit.vit_features(_net(tcfg, params), torch.from_numpy(imgs), layer=0).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out, reshape, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError):
        dataclasses.replace(tcfg, patch_embed_impl="einsum6")
    with pytest.raises(ValueError):
        dataclasses.replace(tcfg, kv_pool_impl="gather")
