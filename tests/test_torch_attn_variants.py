"""Port parity: the relu / sqrelu attention scores (``ViTConfig.attn_score``)
and the int8-probability modes 'pv' and 'qk+pv' of vitvs_tpu_torch against ``jax.jit`` of vitvs_tpu on the CPU.

Tolerances, each measured on these inputs and stated where it is held:
* score attention alone, f32: 1e-6 of the output's max abs (f32 products
  and sums in other orders); bf16: within one bf16 step (2^-7 relative) of
  the output's max abs, as XLA's CPU backend rounds where its fusions put
  the converts;
* the float ViT's token facet (2 blocks): f32 within 1e-5 (the unpooled
  forward's tolerance, ``tests/test_torch_vit.py``), bf16 by cosine per
  token >= 0.9999 (``test_vit_features_bf16_close``'s);
* 'pv' / 'qk+pv': the int32 products equal on equal int8 operands; the
  int8 probabilities taken from equal scaled logits flip where an ulp of
  exp carries exp * 127 across a .5 (counted, at most 1 in 10^4); the
  output within 1e-5 of its scale;
* the int8 forward and calibration as ``tests/test_torch_quant.py`` holds
  the no-max modes.
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vitvs_tpu.control import EmaState as JEma
from vitvs_tpu.harness import pipeline as jpipe
from vitvs_tpu.io_bridge.config import VSConfig as JVSConfig
from vitvs_tpu.models import quant as jq
from vitvs_tpu.models import vit as jvit
from vitvs_tpu_torch.control.ibvs import EmaState as TEma
from vitvs_tpu_torch.harness import pipeline as tpipe
from vitvs_tpu_torch.io_bridge.config import VSConfig as TVSConfig
from vitvs_tpu_torch.models import quant as tq
from vitvs_tpu_torch.models import vit as tvit
from vitvs_tpu_torch.models.convert import from_jax_params, from_jax_quant_params
from vitvs_tpu_torch.ops.int_mm import EXACT_F32_DEPTH, int8_bmm

# 2 blocks, 2 heads of 64 (the int8 tests' model), 70 px: a 5 x 5 grid (odd, so
# 2 x 2 pooling has edge windows of 2 and 1 patches)
VIT = dict(patch_size=14, embed_dim=128, depth=2, num_heads=2, pos_grid=5, stride=14,
           gelu_approx=True, model_name="tiny")
RNG = np.random.default_rng(17)
POOLS = {"none": dict(),
         "post_window": dict(kv_pool=2, kv_pool_impl="window"),
         "post_matmul": dict(kv_pool=2, kv_pool_impl="matmul"),
         "pre": dict(kv_pool=2, kv_pool_impl="matmul", kv_pool_where="pre")}
# relu and sqrelu, and relu with each 2 x 2 pooling
SCORES = [("relu", "none"), ("sqrelu", "none"), ("relu", "post_window"),
          ("relu", "post_matmul"), ("relu", "pre")]
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """Tiny shapes run many small ops: one intra-op thread, as the suite's
    parallel workers share the machine's cores (restored after)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(**kw):
    return jvit.ViTConfig(**VIT, **kw), tvit.ViTConfig(**VIT, **kw)


def _params(seed=3):
    """Seeded weights with LayerScale near 1 and nonzero biases."""
    params = jax.tree.map(np.asarray, jvit.init_vit(_cfgs()[0], jax.random.PRNGKey(seed)))
    rs = np.random.default_rng(5)
    for name in ("ls1", "ls2"):
        params["blocks"][name] = rs.uniform(0.5, 1.5, params["blocks"][name].shape).astype(np.float32)
    for name in ("qkv_bias", "proj_bias", "fc1_bias", "fc2_bias", "norm1_bias"):
        params["blocks"][name] = 0.1 * rs.standard_normal(params["blocks"][name].shape).astype(np.float32)
    return params


def _images(n, size=70, seed=9):
    return np.random.default_rng(seed).standard_normal((n, size, size, 3)).astype(np.float32)


def _net(tcfg, params, dtype=torch.float32):
    net = tvit.ViT(tcfg)
    net.load_state_dict(from_jax_params(params))
    return net.cast_blocks(dtype).eval()


def _qkv(seed, T=26, Tk=26, h=2, hd=64, scale=1.0):
    rs = np.random.default_rng(seed)
    return tuple((scale * rs.standard_normal(s)).astype(np.float32)
                 for s in ((2, T, h, hd), (2, Tk, h, hd), (2, Tk, h, hd)))


def _rel(out, ref):
    return float(np.abs(out - ref).max() / np.abs(ref).max())


def _min_cos(out, ref):
    cos = (out * ref).sum(-1) / (np.linalg.norm(out, axis=-1) * np.linalg.norm(ref, axis=-1))
    return float(cos.min())


# ---------------------------------------------------------------------------
# the float path
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("score", ["relu", "sqrelu"])
@pytest.mark.parametrize("Tk", [26, 10], ids=["dense", "pooled"])
def test_score_attention_matches_jitted_reference(score, dtype, Tk):
    """score_attention on seeded q, k, v against jax.jit of
    vit._score_attention, with f32 scores (the float ViT's) and with
    scores in the compute dtype (the int8 ViT's and calibration's)."""
    jdt, tdt = DTYPES[dtype]
    jcfg, tcfg = _cfgs(attn_score=score)
    q, k, v = _qkv(Tk, Tk=Tk)
    tol = 1e-6 if dtype == "float32" else 2.0 ** -7
    for score_dtype in ("f32", "compute"):
        jsd, tsd = (jnp.float32, torch.float32) if score_dtype == "f32" else (jdt, tdt)
        ref = jax.jit(lambda q, k, v: jvit._score_attention(q, k, v, jcfg, jdt, None,
                                                            score_dtype=jsd))(
            *(jnp.asarray(x, jdt) for x in (q, k, v)))
        ref = np.asarray(ref, np.float32).reshape(2, 26, 128)
        out = tvit.score_attention(*(torch.from_numpy(x).to(tdt) for x in (q, k, v)), tcfg,
                                   tdt, score_dtype=tsd)
        assert out.dtype == tdt
        assert _rel(out.float().numpy(), ref) <= tol, (score_dtype, _rel(out.float().numpy(), ref))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("score,pool", SCORES)
def test_vit_token_facet_matches_jitted_reference(score, pool, dtype):
    """The float ViT's token facet (2 blocks, 5 x 5 grid) with relu /
    sqrelu scores, unpooled and with each 2 x 2 pooling, against jax.jit of
    the reference's vit_features: f32 within 1e-5 of the output's max abs,
    bf16 by cosine per token >= 0.9999."""
    jdt, tdt = DTYPES[dtype]
    jcfg, tcfg = _cfgs(attn_score=score, **POOLS[pool])
    params = _params()
    imgs = _images(2)
    ref = jax.jit(lambda p, x: jvit.vit_features(p, jcfg, x, layer=1, compute_dtype=jdt))(
        params, jnp.asarray(imgs))
    ref = np.asarray(ref, np.float32)
    with torch.no_grad():
        out = tvit.vit_features(_net(tcfg, params, tdt), torch.from_numpy(imgs), layer=1)
    assert out.dtype == tdt and out.shape == ref.shape == (2, 26, 128)
    out = out.float().numpy()
    if dtype == "float32":
        assert _rel(out, ref) <= 1e-5, _rel(out, ref)
    else:
        assert _min_cos(out, ref) >= 0.9999, _min_cos(out, ref)


@pytest.mark.parametrize("pool", ["post_window", "post_matmul", "pre"])
def test_pooled_softmax_takes_the_plain_route(pool, monkeypatch):
    """Exact softmax over pooled keys: plain PyTorch whatever use_kernels
    says (attention_core, the kernels' dispatch, is never reached), against
    jax.jit of the reference's bf16 forward by cosine per token >= 0.9999."""
    jcfg, tcfg = _cfgs(**POOLS[pool])
    params = _params()
    imgs = _images(2)
    ref = jax.jit(lambda p, x: jvit.vit_features(p, jcfg, x, layer=1,
                                                 compute_dtype=jnp.bfloat16))(params, imgs)
    ref = np.asarray(ref, np.float32)

    def refuse(*args, **kw):
        raise AssertionError("pooled softmax reached the kernels' dispatch")

    monkeypatch.setattr(tvit, "attention_core", refuse)
    with torch.no_grad():
        out = tvit.vit_features(_net(tcfg, params, torch.bfloat16), torch.from_numpy(imgs),
                                layer=1, use_kernels=True).float().numpy()
    assert _min_cos(out, ref) >= 0.9999, _min_cos(out, ref)


def test_scores_change_the_function_and_take_no_kernel(monkeypatch):
    """relu and sqrelu never reach attention_core (the kernels' dispatch),
    whatever use_kernels and attn_impl say; softmax does; and each score
    is another function than softmax."""
    params = _params()
    imgs = torch.from_numpy(_images(1))
    calls = []
    real = tvit.attention_core
    monkeypatch.setattr(tvit, "attention_core", lambda *a, **k: calls.append(1) or real(*a, **k))
    outs = {}
    for score in ("softmax", "relu", "sqrelu"):
        for impl in ("xla", "fast"):
            calls.clear()
            tcfg = tvit.ViTConfig(**VIT, attn_score=score, attn_impl=impl)
            with torch.no_grad():
                outs[score, impl] = tvit.vit_features(_net(tcfg, params), imgs, layer=1,
                                                      use_kernels=True)
            assert len(calls) == (2 if score == "softmax" else 0), (score, impl, len(calls))
    for score in ("relu", "sqrelu"):
        assert torch.equal(outs[score, "xla"], outs[score, "fast"])
        assert (outs[score, "xla"] - outs["softmax", "xla"]).abs().max() > 1e-2


# ---------------------------------------------------------------------------
# guards
# ---------------------------------------------------------------------------


def test_unknown_attn_score_raises():
    with pytest.raises(ValueError, match="unknown attn_score"):
        tvit.ViTConfig(**VIT, attn_score="softmx")
    with pytest.raises(ValueError):
        tvit.ViTConfig(**VIT, quant_attn="int4")


def _quant_net(tcfg, params=None):
    return tq.quantize_vit_params(_net(_cfgs()[1], params or _params()), tcfg,
                                  compute_dtype=torch.float32)


@pytest.mark.parametrize("mode", ["pv", "qk+pv"])
@pytest.mark.parametrize("score", ["relu", "sqrelu"])
def test_int8_probs_with_scores_raise(mode, score):
    """int8 probabilities need the softmax's row max: 'pv' and 'qk+pv' do
    not compose with relu / sqrelu (the reference raises in _attn_qkv)."""
    _, tcfg = _cfgs(attn_score=score, quant_attn=mode)
    with pytest.raises(ValueError, match="does not compose"):
        tq.vit_features_quant(_quant_net(tcfg), torch.from_numpy(_images(1)), layer=1)


@pytest.mark.parametrize("score", ["relu", "sqrelu"])
def test_fused_with_scores_raises(score):
    _, tcfg = _cfgs(attn_score=score, quant_attn="fused")
    with pytest.raises(ValueError, match="does not compose"):
        tq.vit_features_quant(_quant_net(tcfg), torch.from_numpy(_images(1)), layer=1)


# configs/real_s518_relu.yaml and configs/real_s518_relupool.yaml's values,
# written out (the card's machine has no pyyaml)
REAL_S518 = dict(u_max=640, v_max=480, lambda_=0.03, min_error=100, max_error=70000,
                 f_x=502.3016357421875, f_y=502.3016357421875, num_pairs=24, max_velocity=1.0,
                 dino_input_size=518, background_thresh=0.005, thresh_filter_keypoints=1,
                 use_feature_binning=True, num_samples=64, num_circles=4,
                 circle_radius_aug=0.08, velocity_convergence_threshold=0.00008,
                 error_threshold_ratio=0.001, error_threshold_absolute_translation=0.1,
                 error_threshold_absolute_rotation=0.1, min_iterations=300,
                 max_iterations=1500, max_velocity_vector_history=200, ema_alpha=0.8,
                 model_name="dinov2_vits14", stride=14, layer=11, facet="token",
                 pinv_mode="dls")
RELU_CONFIGS = {"real_s518_relu": dict(attn_score="relu"),
                "real_s518_relupool": dict(attn_score="relu", kv_pool=2)}


@pytest.mark.parametrize("name", sorted(RELU_CONFIGS))
def test_servo_model_builds_the_relu_configs(name):
    """ServoModel.create builds both relu configurations as the reference
    does (pipeline.py:104 passes attn_score and kv_pool to the ViT)."""
    kw = dict(REAL_S518, **RELU_CONFIGS[name])
    tm = tpipe.ServoModel.create(TVSConfig(**kw), device="cpu")
    jm = jpipe.ServoModel.create(JVSConfig(**kw))
    for field in ("attn_score", "kv_pool", "kv_pool_impl", "kv_pool_where", "embed_dim",
                  "num_heads", "depth"):
        assert getattr(tm.vit, field) == getattr(jm.vit, field), field
    assert tm.vit.attn_score == "relu" and tm.device == "cpu"
    assert tm.grid() == (37, 37)


# ---------------------------------------------------------------------------
# the int8 path: 'pv', 'qk+pv' and the scores
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(3, 5, 64, 7), (2, 17, 1370, 64), (1, 9, EXACT_F32_DEPTH, 3),
                                   (1, 4, 2 * EXACT_F32_DEPTH + 1, 5)])
def test_int8_bmm_equals_the_int64_product(shape):
    """Exact at depths below, at and past a chunk, with the extremes -128
    and 127 in every row."""
    n, m, kk, p = shape
    rs = np.random.default_rng(kk)
    a = rs.integers(-128, 128, (n, m, kk)).astype(np.int8)
    b = rs.integers(-128, 128, (n, kk, p)).astype(np.int8)
    a[..., 0], b[..., 0, :] = -128, -128
    a[..., -1], b[..., -1, :] = 127, -128
    want = np.matmul(a.astype(np.int64), b.astype(np.int64))
    got = int8_bmm(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy().astype(np.int64), want)


def _jax_int8_probs(ls):
    """The reference's row-max trick (models/quant.py:_attn_qkv, 'pv')."""
    m = jnp.max(ls, axis=-1, keepdims=True)
    e = jnp.exp(ls - m)
    return jnp.round(e * 127.0).astype(jnp.int8), jnp.sum(e, axis=-1)


def _jax_quant_v(v):
    vamax = jnp.max(jnp.abs(v), axis=1, keepdims=True).astype(jnp.float32)
    vs = jnp.maximum(vamax, 1e-12) / 127.0
    return jnp.clip(jnp.round(v * (1.0 / vs).astype(v.dtype)), -127, 127).astype(jnp.int8), vs


@pytest.mark.parametrize("mode", ["pv", "qk+pv"])
@pytest.mark.parametrize("Tk", [26, 10], ids=["dense", "pooled"])
def test_int8_prob_modes_match_jitted_reference(mode, Tk):
    """'pv' and 'qk+pv' in _attn_qkv (f32 compute) against jax.jit of the
    reference's: the int8 V and its scales equal; on equal int8 operands the
    int32 products equal; the int8 probabilities from equal scaled logits
    flip by at most one step in at most 1 of 10^4 (an ulp of exp); the
    output within 1e-5 of its max abs."""
    jcfg, tcfg = _cfgs(quant_attn=mode)
    q, k, v = _qkv(40 + Tk, Tk=Tk, scale=2.0)
    tq_, tk_, tv_ = (torch.from_numpy(x) for x in (q, k, v))
    ref = np.asarray(jax.jit(lambda q, k, v: jq._attn_qkv(q, k, v, jcfg, jnp.float32))(q, k, v))
    out = tq._attn_qkv(tq_, tk_, tv_, tcfg, use_kernels=True).numpy()
    assert _rel(out, ref) <= 1e-5, _rel(out, ref)

    jv_q, jvs = jax.jit(_jax_quant_v)(v)
    v_q, vs = tq._quant_v(tv_)
    np.testing.assert_array_equal(v_q.numpy(), np.asarray(jv_q))
    np.testing.assert_array_equal(vs.numpy(), np.asarray(jvs))
    if mode == "qk+pv":
        logits = tq._int8_qk_logits(tq_, tk_)
    else:
        logits = torch.einsum("bqhd,bkhd->bhqk", tq_, tk_)
    ls = logits * (1.0 / 8.0)
    p_q, denom = tq._int8_probs(ls)
    jp_q, jdenom = jax.jit(_jax_int8_probs)(ls.numpy())
    flips = np.abs(p_q.numpy().astype(int) - np.asarray(jp_q).astype(int))
    assert flips.max() <= 1 and flips.sum() <= max(1, p_q.numel() // 10 ** 4), flips.sum()
    np.testing.assert_allclose(denom.numpy(), np.asarray(jdenom), rtol=1e-6)
    jpv = jax.jit(lambda p, w: jnp.einsum("bhqk,bkhd->bqhd", p, w,
                                          preferred_element_type=jnp.int32))(p_q.numpy(), v_q.numpy())
    pv = tq.int8_bmm(p_q, v_q.transpose(1, 2)).transpose(1, 2)
    np.testing.assert_array_equal(pv.numpy(), np.asarray(jpv))


def test_int8_qk_logits_match_jitted_reference():
    """'qk+pv''s QK^T: Q and K quantized per (token, head) as the
    reference's _q_th under jit (bit for bit), the int32 product exact, the
    dequantized logits equal."""
    q, k, _ = _qkv(7, Tk=10, scale=3.0)

    def ref(q, k):   # models/quant.py:_attn_qkv, 'qk+pv'
        def _q_th(x):
            amax = jnp.max(jnp.abs(x), -1, keepdims=True).astype(jnp.float32)
            s = jnp.maximum(amax, 1e-12) / 127.0
            return jnp.clip(jnp.round(x * (1.0 / s).astype(x.dtype)), -127, 127).astype(jnp.int8), s
        (qq, qs), (kq, ks) = _q_th(q), _q_th(k)
        acc = jnp.einsum("bqhd,bkhd->bhqk", qq, kq, preferred_element_type=jnp.int32)
        return (acc.astype(jnp.float32) * jnp.transpose(qs, (0, 2, 1, 3))
                * jnp.transpose(ks, (0, 2, 3, 1)))

    want = np.asarray(jax.jit(ref)(q, k))
    got = tq._int8_qk_logits(torch.from_numpy(q), torch.from_numpy(k)).numpy()
    np.testing.assert_array_equal(got, want)


def _jax_quant(params, jcfg, calib, dtype=jnp.float32):
    qp = jq.quantize_vit_params(params, cfg=jcfg if calib is not None else None,
                                calib_images=None if calib is None else jnp.asarray(calib),
                                layer=1, compute_dtype=dtype)
    return jax.tree.map(np.asarray, qp)


def _jitted_quant_features(qp, jcfg, img, dtype=jnp.float32, layer=1):
    run = jax.jit(lambda q, x: jq.vit_features_quant(q, jcfg, x, layer=layer,
                                                     compute_dtype=dtype))
    return np.array(run(qp, jnp.asarray(img)), dtype=np.float32)


def _close(out, ref):
    """Static scales, same int8 weights: f32 rounding (test_torch_quant's)."""
    assert np.abs(out - ref).max() <= 1e-5 * np.abs(ref).max(), _rel(out, ref)


def _hold_loose(out, ref):
    """A token whose int8 activations moved by one step (test_torch_quant's)."""
    scale = np.abs(ref).max()
    assert np.abs(out - ref).max() <= 1e-2 * scale, _rel(out, ref)
    assert np.abs(out - ref).mean() <= 5e-4 * scale


INT8_VARIANTS = {"pv": dict(quant_attn="pv"), "qk+pv": dict(quant_attn="qk+pv"),
                 "pv_pooled": dict(quant_attn="pv", kv_pool=2, kv_pool_impl="matmul"),
                 "relu": dict(attn_score="relu", quant_attn="nomax3"),
                 "sqrelu": dict(attn_score="sqrelu", quant_attn="none"),
                 "relu_post_window": dict(attn_score="relu", quant_attn="nomax3", kv_pool=2),
                 "relu_pre": dict(attn_score="relu", quant_attn="nomax3", kv_pool=2,
                                  kv_pool_impl="matmul", kv_pool_where="pre")}


@pytest.mark.parametrize("variant", sorted(INT8_VARIANTS))
def test_int8_forward_matches_jitted_reference(variant):
    """The int8 ViT (static scales, calibrated through each variant's
    attention) on identical int8 weights against jax.jit of the reference's
    vit_features_quant, f32: block 0 and block 1 on block 0's reference
    output held to f32 rounding (_close; 'pv' and 'qk+pv' as _hold_loose);
    end to end as _hold_loose, where an activation of block 1 near an int8
    rounding tie moves its token by one step."""
    jcfg, tcfg = _cfgs(**INT8_VARIANTS[variant])
    params = _params()
    qp = _jax_quant(params, jcfg, _images(2))
    qnet = from_jax_quant_params(qp, tcfg, torch.float32)
    img = _images(2, seed=4)
    # int8 probabilities of 'pv' and 'qk+pv' flip where an ulp of exp (or of a
    # pooled V) crosses a rounding tie: those blocks are held as _hold_loose
    hold = _hold_loose if tcfg.quant_attn in tq.INT8_PROB_MODES else _close
    x0 = _jitted_quant_features(qp, jcfg, img, layer=0)
    hold(tq.vit_features_quant(qnet, torch.from_numpy(img), layer=0).numpy(), x0)
    block1 = jax.tree.map(lambda a: a[1], qp["blocks"])
    ref1 = np.asarray(jax.jit(lambda b, x: jq._block_q(x, jq._cast_block(b, jnp.float32), jcfg))(
        block1, jnp.asarray(x0)))
    hold(tq._block_q(torch.from_numpy(x0), qnet.blocks[1], tcfg, True).numpy(), ref1)
    ref = _jitted_quant_features(qp, jcfg, img)
    out = tq.vit_features_quant(qnet, torch.from_numpy(img), layer=1).numpy()
    assert out.shape == ref.shape == (2, 26, 128)
    _hold_loose(out, ref)


@pytest.mark.parametrize("variant", ["pv", "qk+pv", "relu"])
def test_int8_forward_bf16_close(variant):
    """bf16, the serving dtype: by cosine per token >= 0.9999 (the int8
    path's bf16 bar, test_torch_quant.py)."""
    jcfg, tcfg = _cfgs(**INT8_VARIANTS[variant])
    qp = _jax_quant(_params(), jcfg, _images(2), jnp.bfloat16)
    img = _images(1, seed=4)
    ref = _jitted_quant_features(qp, jcfg, img, jnp.bfloat16)
    out = tq.vit_features_quant(from_jax_quant_params(qp, tcfg, torch.bfloat16),
                                torch.from_numpy(img), layer=1)
    assert out.dtype == torch.bfloat16
    assert _min_cos(out.float().numpy(), ref) >= 0.9999


@pytest.mark.parametrize("score,pool", [("relu", "none"), ("sqrelu", "none"),
                                        ("relu", "post_window"), ("relu", "pre")])
def test_collect_act_amax_through_the_scores_matches(score, pool):
    """Static calibration runs the score path at the compute dtype, so the
    proj input's scale sees the relu attention's output, and that maximum
    is another than softmax's.  f32, rtol 4e-6 (test_torch_quant's softmax
    calibration holds 1e-6): the relu scores' denominators are sums of
    unnormalized terms, and another summation order moved one of 256
    per-channel maxima by 1.05e-6 relative."""
    jcfg, tcfg = _cfgs(attn_score=score, quant_attn="nomax3", **POOLS[pool])
    params = _params()
    calib = _images(3)
    ref = jq._collect_act_amax(params, jcfg, jnp.asarray(calib), 1, jnp.float32)
    out = tq._collect_act_amax(_net(_cfgs()[1], params), tcfg, torch.from_numpy(calib), 1,
                               torch.float32)
    for o, r in zip(out, ref):
        assert o.shape == r.shape
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=4e-6)
    soft = tq._collect_act_amax(_net(_cfgs()[1], params), _cfgs(**POOLS[pool])[1],
                                torch.from_numpy(calib), 1, torch.float32)
    assert not torch.equal(out[2], soft[2])


# ---------------------------------------------------------------------------
# the servo step (tests/test_torch_pipeline.py's tiny setup)
# ---------------------------------------------------------------------------

STEP_CFG = dict(u_max=96, v_max=72, f_x=75.0, f_y=75.0, dino_input_size=84, num_pairs=12,
                lambda_=0.5, layer=1, model_name="tiny", use_feature_binning=True,
                pinv_mode="dls", subpixel_matching=True)
STEP_VIT = dict(patch_size=14, embed_dim=96, depth=2, num_heads=3, pos_grid=5, stride=14,
                model_name="tiny")


def _frames(shifts, seed=2, m=24):
    rs = np.random.default_rng(seed)
    h, w = STEP_CFG["v_max"] + 2 * m, STEP_CFG["u_max"] + 2 * m
    x = rs.standard_normal((h + 8, w + 8, 3))
    ker = np.ones(9) / 9
    for ax in (0, 1):
        x = np.apply_along_axis(lambda r: np.convolve(r, ker, mode="valid"), ax, x)
    big = (255 * (x - x.min()) / (x.max() - x.min())).astype(np.uint8)
    crop = lambda dy, dx: big[m + dy: m + dy + STEP_CFG["v_max"], m + dx: m + dx + STEP_CFG["u_max"]]
    return crop(0, 0), [crop(dy, dx) for dy, dx in shifts], np.full((72, 96), 0.6, np.float32)


def _step_models(score, pool, quantized):
    jv = jvit.ViTConfig(**STEP_VIT, attn_score=score, kv_pool=pool,
                        quant_attn="nomax3" if quantized else "none")
    tv = tvit.ViTConfig(**STEP_VIT, attn_score=score, kv_pool=pool,
                        quant_attn="nomax3" if quantized else "none")
    jm = jpipe.ServoModel(vit=jv, cfg=JVSConfig(**STEP_CFG), compute_dtype=jnp.float32,
                          quantized=quantized)
    tm = tpipe.ServoModel(vit=tv, cfg=TVSConfig(**STEP_CFG), compute_dtype=torch.float32,
                          device="cpu", quantized=quantized)
    return jm, tm


def _step_params():
    params = jax.tree.map(np.asarray, jvit.init_vit(jvit.ViTConfig(**STEP_VIT),
                                                    jax.random.PRNGKey(0)))
    params["pos_embed"] = np.zeros_like(params["pos_embed"])
    for name in ("ls1", "ls2"):
        params["blocks"][name] = np.ones_like(params["blocks"][name])
    return params


def _drive_both(params, jm, tm, jnet, tnet, goal, frames, depth, uv_tol=1e-3):
    """goal + a servo step per frame in both packages, JAX's pair scores
    injected into the port's: the same pairs, the current pixels within
    ``uv_tol``; the twists of each step (JAX, port)."""
    jg = jpipe.goal_descriptors(jnet, jm, jnp.asarray(goal))
    tg = tpipe.goal_descriptors(tnet, tm, goal)
    jema, jprev = JEma.init(), jnp.zeros(6)
    tema, tprev = TEma.init(device="cpu"), torch.zeros(6)
    t = tm.grid()[0] * tm.grid()[1]
    out = []
    for i, frame in enumerate(frames):
        key = jax.random.PRNGKey(60 + i)
        jr = jpipe.servo_step(jnet, jm, jg, jnp.asarray(frame), jnp.asarray(depth), jema, jprev,
                              key)
        tr = tpipe.servo_step(tnet, tm, tg, frame, depth, tema, tprev,
                              scores=torch.tensor(np.asarray(jax.random.uniform(key, (t,)))))
        np.testing.assert_array_equal(tr.valid.numpy(), np.asarray(jr.valid))
        np.testing.assert_array_equal(tr.s_uv_star.numpy(), np.asarray(jr.s_uv_star))
        np.testing.assert_allclose(tr.s_uv.numpy(), np.asarray(jr.s_uv), atol=uv_tol)
        out.append((np.asarray(jr.body_twist), tr.body_twist.numpy()))
        jema, jprev, tema, tprev = jr.ema, jr.v_c, tr.ema, tr.v_c
    return out


@pytest.mark.parametrize("score,pool", [("relu", 1), ("sqrelu", 1), ("relu", 2)])
def test_score_servo_step_matches_jitted_reference(score, pool):
    """goal + 2 f32 servo steps with the scores (6 x 6 grid, 2 x 2 pooling
    with edge windows of one row): the same pairs, twists within 1e-3
    (BASELINE.md's clause)."""
    params = _step_params()
    jm, tm = _step_models(score, pool, quantized=False)
    goal, frames, depth = _frames([(18, 20), (10, 15)])
    net = tm.load_vit(from_jax_params(params))
    for jt, tt in _drive_both(params, jm, tm, params, net, goal, frames, depth):
        np.testing.assert_allclose(tt, jt, atol=1e-3)
        assert np.abs(tt).max() > 1e-2


@pytest.mark.parametrize("pool", [1, 2])
def test_relu_int8_servo_step_matches_float_and_reference(pool):
    """The int8 serving step with relu scores (static scales calibrated
    through them, 'nomax3' superseded) against the reference's: the same
    pairs, twists within 1e-3, the subpixel current pixels within 0.1 px
    (the parabola's vertex through int8 similarities, whose last bits
    differ: measured up to 0.037 px on these frames); and against the
    port's float relu step on the same frames within 0.08 of the twist
    scale, the bar of
    tests/test_attn_variants.py::test_variant_serving_velocities_match_fp
    (measured 0.04% unpooled, 0.24% pooled).  The int8 relu step of this
    tiny seeded model depends on its calibration frames: calibrated on the
    goal and three frames, its unpooled step lay 15% from the float one, in
    both packages alike (they agreed within 2e-5)."""
    params = _step_params()
    jm, tm = _step_models("relu", pool, quantized=True)
    jfm, tfm = _step_models("relu", pool, quantized=False)
    goal, frames, depth = _frames([(18, 20), (10, 15)])
    calib = [goal, *frames]
    jcal = jnp.stack([jpipe.preprocess(jm, jnp.asarray(f)) for f in calib])
    jqp = jq.quantize_vit_params(params, cfg=jm.vit, calib_images=jcal, layer=1,
                                 compute_dtype=jnp.float32)
    fnet = tfm.load_vit(from_jax_params(params))
    qnet = tpipe.quantized_vit(fnet, tm, calib)
    int8 = _drive_both(params, jm, tm, jqp, qnet, goal, frames, depth, uv_tol=0.1)
    flt = _drive_both(params, jfm, tfm, params, fnet, goal, frames, depth)
    for (jt, tt), (_, ft) in zip(int8, flt):
        np.testing.assert_allclose(tt, jt, atol=1e-3)
        np.testing.assert_allclose(tt, ft, atol=0.08 * max(np.abs(ft).max(), 1e-6))


@pytest.mark.parametrize("name", sorted(RELU_CONFIGS))
def test_benchmark_builds_and_serves_the_relu_configs(name):
    """harness/benchmark.py's build_model and int8_serving with the relu
    configurations (at 56 px, a 4 x 4 grid, to stay small): the float and
    the int8 ViT carry the score, the int8 one 'nomax3' (which the score
    supersedes) with static scales calibrated through the relu attention
    (its proj-input scales differ from a softmax calibration's), and both
    serve goal descriptors on the CPU."""
    from vitvs_tpu_torch.harness import benchmark as tbench
    from vitvs_tpu_torch.harness.rollout import goal_pose
    from vitvs_tpu_torch.sim.env import observe
    from vitvs_tpu_torch.sim.scene import Scene, make_synthetic_poster

    cfg = TVSConfig(**dict(REAL_S518, **RELU_CONFIGS[name], dino_input_size=56))
    net, model = tbench.build_model(cfg, device="cpu")
    assert model.vit.attn_score == "relu" and net.cfg == model.vit
    scene = Scene.create(make_synthetic_poster(128, seed=3), device="cpu")
    p, q = goal_pose("cpu")
    poses = (np.stack([p.numpy(), p.numpy() + [0.02, -0.01, 0.03]]), np.stack([q.numpy()] * 2))
    f32 = copy.deepcopy(net).float()
    qnet, qmodel = tbench.int8_serving(f32, model, scene, calib_poses=poses)
    assert qmodel.quantized and qmodel.vit.quant_attn == "nomax3"
    assert qmodel.vit.attn_score == "relu" and qnet.cfg.attn_score == "relu"
    soft = dataclasses.replace(model, vit=dataclasses.replace(model.vit, attn_score="softmax"))
    sq, _ = tbench.int8_serving(f32, soft, scene, calib_poses=poses)
    assert not torch.equal(qnet.blocks[0].act_scales[2], sq.blocks[0].act_scales[2])
    goal_rgb = observe(scene, model.camera, p, q)[0]
    for n, m in ((net, model), (qnet, qmodel)):
        g = tpipe.goal_descriptors(n, m, goal_rgb)
        rows = g.q if m.quantized else g
        assert rows.shape[0] == 16 and torch.isfinite(rows.float()).all()
