"""Port parity: the plain versions behind the attention (exact and no-max),
fused int8 attention and matcher kernel wrappers of vitvs_tpu_torch, against
the Pallas kernels of vitvs_tpu run in interpret mode (as tests/test_ops.py
runs them).  Off the TPU without interpret mode the JAX functions return
exact softmax, which is not the kernels' arithmetic.  Also the f32 attention
kernel's split-precision TF32 arithmetic, emulated on the CPU: why it takes
three passes."""

import math
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import (ATTN_F32_TOL, LARGE_LOGIT, LARGE_LOGIT_F32_TOL, large_logit_qkv,
                        underflow_qkv)
from vitvs_tpu.ops.attention import mha_attention as j_mha
from vitvs_tpu.ops.attn_int8 import fused_int8_attention as j_int8
from vitvs_tpu.ops.matcher import dual_argmax_cosine as j_dual
from vitvs_tpu_torch.ops import attention as tattn
from vitvs_tpu_torch.ops import attn_int8 as tint8
from vitvs_tpu_torch.ops import matcher as tmatch

RNG = np.random.default_rng(31)


@pytest.mark.parametrize("shape", [(1, 65, 2, 32), (2, 139, 3, 64)])
def test_mha_attention_matches_pallas_interpret(shape):
    """T not a multiple of the kernel tile; f32 inputs."""
    q, k, v = (RNG.standard_normal(shape).astype(np.float32) for _ in range(3))
    ref = np.asarray(j_mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           q_tile=64, interpret=True))
    before = tattn.mha_attention.launches
    out = tattn.mha_attention(*(torch.from_numpy(x) for x in (q, k, v))).numpy()
    assert tattn.mha_attention.launches == before  # CPU tensors: plain version
    np.testing.assert_allclose(out, ref, atol=2e-5, rtol=1e-4)


def test_mha_attention_bf16_inputs_close():
    """bf16 inputs: probabilities round to bf16 before P.V in both."""
    shape = (1, 97, 2, 64)
    q, k, v = (RNG.standard_normal(shape).astype(np.float32) for _ in range(3))
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    ref = np.asarray(j_mha(jq, jk, jv, q_tile=64, interpret=True), dtype=np.float32)
    out = tattn.mha_attention(*(torch.from_numpy(x).bfloat16() for x in (q, k, v)))
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), ref, atol=2e-2)


TF32_MASK = -0x2000  # 0xffffe000 as an int32: sign, exponent and the top 10 mantissa bits


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """x as a TF32 operand: its low 13 mantissa bits cleared."""
    return (x.view(torch.int32) & TF32_MASK).view(torch.float32)


def _mm_tf32(a: torch.Tensor, b: torch.Tensor, passes: int) -> torch.Tensor:
    """a @ b from TF32 operands with f32 accumulation: one pass (hi.hi), or
    the f32 kernel's three (lo.hi + hi.lo + hi.hi, hi = _tf32(x), lo = x - hi,
    exact in f32 and itself read as TF32)."""
    ahi, bhi = _tf32(a), _tf32(b)
    if passes == 1:
        return ahi @ bhi
    return _tf32(a - ahi) @ bhi + ahi @ _tf32(b - bhi) + ahi @ bhi


def _split_tf32_attention(q, k, v, passes: int) -> torch.Tensor:
    """csrc/attention_f32.cu's arithmetic on (B, T, h, d) f32 CPU tensors:
    raw scores from TF32 products, exp2(s c - m c) with c = d^-0.5 log2(e)
    and m the row max, f32 row sums, P.V from TF32 products, then the
    division by the row sum."""
    c = torch.tensor(q.shape[-1] ** -0.5 * math.log2(math.e), dtype=torch.float32)
    qh, kh, vh = (x.transpose(1, 2) for x in (q, k, v))            # (B, h, T, d)
    s = _mm_tf32(qh, kh.transpose(-1, -2), passes)
    e = torch.exp2(s * c - s.amax(-1, keepdim=True) * c)
    return (_mm_tf32(e, vh, passes) / e.sum(-1, keepdim=True)).transpose(1, 2)


def test_split_tf32_emulation_masks_as_the_kernel():
    """The emulation's TF32 mask is the one csrc/sm90_ptx.cuh's tf32_hi
    applies, and lo = x - hi is exact: hi + lo gives x back bit for bit."""
    text = (Path(tattn.__file__).parent.parent / "csrc" / "sm90_ptx.cuh").read_text()
    mask = re.search(r"float tf32_hi\(float x\) \{\s*return __uint_as_float\("
                     r"__float_as_uint\(x\) & (0x[0-9a-f]+)u\);", text)
    assert mask and int(mask.group(1), 16) == TF32_MASK & 0xFFFFFFFF
    rs = np.random.default_rng(3)
    x = torch.from_numpy((rs.standard_normal(4096) * 10.0 ** rs.integers(-20, 20, 4096))
                         .astype(np.float32))
    hi = _tf32(x)
    assert not (hi.view(torch.int32) & 0x1FFF).any()
    assert torch.equal((hi + (x - hi)).view(torch.int32), x.view(torch.int32))


@pytest.mark.parametrize("ref", ["plain", "pallas-interpret"])
@pytest.mark.parametrize("case", ["normal-485", "logits-200"])
def test_split_tf32_attention_needs_three_passes(case, ref):
    """Why the f32 attention kernel takes three TF32 passes: emulated on the
    CPU, its arithmetic is within chip_smoke.py's f32 tolerances of the
    plain version and of vitvs_tpu's Pallas kernel (interpret mode, f32
    inputs) at the f32 step's shape and on rows whose scaled logits are
    about +-200, and one TF32 pass is outside them."""
    if case == "normal-485":
        rs = np.random.default_rng(0)
        q, k, v = (rs.standard_normal((1, 485, 6, 64)).astype(np.float32) for _ in range(3))
        tol = ATTN_F32_TOL
    else:
        q, k, v = large_logit_qkv((2, 130, 6, 64), LARGE_LOGIT, seed=12)
        tol = LARGE_LOGIT_F32_TOL
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    if ref == "plain":
        want = tattn.mha_attention_plain(tq, tk, tv)
    else:
        want = torch.from_numpy(np.array(j_mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                               q_tile=128, interpret=True)))
    err = {p: (_split_tf32_attention(tq, tk, tv, p) - want).abs().max().item() for p in (1, 3)}
    assert err[3] <= tol, err
    assert err[1] > tol, err


@pytest.mark.parametrize("shape", [(1, 65, 2, 32), (2, 139, 3, 64)])
def test_mha_attention_fast_matches_pallas_interpret(shape):
    """The no-max kernel's plain version: f32 inputs, T not a multiple of
    the kernel tile (padded columns engaged on the JAX side)."""
    q, k, v = (RNG.standard_normal(shape).astype(np.float32) for _ in range(3))
    ref = np.asarray(j_mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), q_tile=64,
                           interpret=True, fast=True))
    before = (tattn.mha_attention.launches, tattn.mha_attention_fast.launches)
    out = tattn.mha_attention(*(torch.from_numpy(x) for x in (q, k, v)), fast=True).numpy()
    assert (tattn.mha_attention.launches, tattn.mha_attention_fast.launches) == before
    # the same f32 arithmetic in another summation order
    np.testing.assert_allclose(out, ref, atol=2e-6, rtol=1e-5)
    np.testing.assert_array_equal(
        tattn.mha_attention_fast_plain(*(torch.from_numpy(x) for x in (q, k, v))).numpy(), out)


def test_mha_attention_fast_underflow_rows_match_pallas_interpret():
    """tests/test_ops.py's underflow case: every real logit of 4 rows is
    about -30; the rows stay finite and equal to the JAX kernel's."""
    q, k, v = underflow_qkv((1, 139, 2, 64), rows=4, c=30.0, seed=11)
    ref = np.asarray(j_mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), q_tile=64,
                           interpret=True, fast=True))
    out = tattn.mha_attention_fast(*(torch.from_numpy(x) for x in (q, k, v))).numpy()
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, atol=5e-6, rtol=1e-4)


def test_mha_attention_fast_bf16_scales_q_in_bf16():
    """bf16 inputs: Q times hd^-0.5 log2(e) rounds to bf16 (the constant
    too), and the numerators round to bf16 before P.V, in both."""
    shape = (1, 97, 2, 64)
    q, k, v = (RNG.standard_normal(shape).astype(np.float32) for _ in range(3))
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    ref = np.asarray(j_mha(jq, jk, jv, q_tile=64, interpret=True, fast=True), dtype=np.float32)
    tq = torch.from_numpy(q).bfloat16()
    scaled = tattn._fast_scaled_q(tq)
    np.testing.assert_array_equal(
        scaled.float().numpy(),
        np.asarray(jq * (64 ** -0.5 * math.log2(math.e)), dtype=np.float32))
    out = tattn.mha_attention_fast(tq, *(torch.from_numpy(x).bfloat16() for x in (k, v)))
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), ref, atol=2e-2)


@pytest.mark.parametrize("shape", [(1, 65, 2, 32), (2, 130, 3, 64)])
def test_fused_int8_attention_matches_pallas_interpret(shape):
    """The fused int8 kernel's plain version: the same int8 values (Q/K
    quantized per (token, head)), exact int32 scores, no-max exp2; f32."""
    B, T, H, D = shape
    rs = np.random.default_rng(7)
    q, k, v = (rs.standard_normal((B, T, H * D)).astype(np.float32) for _ in range(3))
    ref = np.asarray(j_int8(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), heads=H,
                            q_tile=64, interpret=True))
    before = tint8.fused_int8_attention.launches
    out = tint8.fused_int8_attention(*(torch.from_numpy(x) for x in (q, k, v)), heads=H).numpy()
    assert tint8.fused_int8_attention.launches == before
    np.testing.assert_allclose(out, ref, atol=2e-6, rtol=1e-5)


def test_fused_int8_attention_padded_columns_match_pallas_interpret():
    """tests/test_ops.py's padded-column case: T = 70 (58 padded columns on
    the TPU), 8 rows whose real logits are all about -25."""
    B, T, H, D = 1, 70, 2, 64
    q, k, v = underflow_qkv((B, T, H, D), rows=8, c=25.0, seed=11, k_noise=0.0)
    flat = lambda x: x.reshape(B, T, H * D)
    ref = np.asarray(j_int8(*(jnp.asarray(flat(x)) for x in (q, k, v)), heads=H,
                            q_tile=64, interpret=True))
    out = tint8.fused_int8_attention_plain(*(torch.from_numpy(flat(x)) for x in (q, k, v)),
                                           heads=H).numpy()
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, atol=5e-6, rtol=1e-4)


def test_quant_th_matches_jax():
    """Per-(token, head) quantization: the same int8 values and scales as
    the reference under jax.jit, where it runs (fault 3.5)."""
    from vitvs_tpu.ops.attn_int8 import _quant_th as j_quant_th

    x = (3 * RNG.standard_normal((2, 33, 4 * 16))).astype(np.float32)
    jq, js = jax.jit(lambda a: j_quant_th(a, 4, extra_scale=0.18))(jnp.asarray(x))
    tq, ts = tint8._quant_th(torch.from_numpy(x), 4, extra_scale=0.18)
    assert tq.dtype == torch.int8 and ts.shape == (2, 33, 4)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("t1,t2,d", [(100, 100, 96), (130, 70, 200)])
def test_dual_argmax_cosine_matches_pallas_interpret(t1, t2, d):
    a = RNG.standard_normal((t1, d)).astype(np.float32)
    b = RNG.standard_normal((t2, d)).astype(np.float32)
    ref = j_dual(jnp.asarray(a), jnp.asarray(b), tile=64, d_tile=128, interpret=True)
    before = tmatch.dual_argmax_cosine.launches
    out = tmatch.dual_argmax_cosine(torch.from_numpy(a), torch.from_numpy(b))
    assert tmatch.dual_argmax_cosine.launches == before
    for o, r in zip(out[::2], ref[::2]):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=1e-5)
    for o, r in zip(out[1::2], ref[1::2]):
        assert o.dtype == torch.int32
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))


def test_dual_argmax_cosine_exact_ties_take_first_index():
    """Duplicated rows give exactly equal similarities: both packages pick
    the first index, along rows and along columns."""
    base = RNG.standard_normal((6, 16)).astype(np.float32)
    a = base[[0, 1, 2, 3, 4, 5, 1, 3]]           # rows 6, 7 duplicate rows 1, 3
    b = base[[2, 0, 1, 5, 4, 3, 0, 2]] * 2.0     # columns 6, 7 duplicate 1, 0 (scaled)
    ref = j_dual(jnp.asarray(a), jnp.asarray(b), tile=8, d_tile=128, interpret=True)
    out = tmatch.dual_argmax_cosine(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_array_equal(out[1].numpy(), np.asarray(ref[1]))
    np.testing.assert_array_equal(out[3].numpy(), np.asarray(ref[3]))
    # rows 0 and 2 tie between columns (1, 6) and (0, 7); columns 2 and 5
    # tie between rows (1, 6) and (3, 7): the first of each pair wins
    assert out[1][[0, 2]].tolist() == [1, 0]
    assert out[3][[2, 5]].tolist() == [1, 3]


@pytest.mark.parametrize("t1,t2,d", [(100, 100, 96), (130, 70, 200)])
def test_dual_argmax_cosine_bf16_matches_reference_default(t1, t2, d):
    """The bf16 mode's plain version (what the wrapper takes on the CPU)
    against vitvs_tpu's default similarity on the same bf16 descriptors:
    rows normalized in bf16 by f32 norms, f32 accumulation.  Values within
    1e-6 (exact products summed in another order), the same argmaxes."""
    from vitvs_tpu.match.correspondence import cosine_similarity_matrix as j_sim

    ja, jb = (jnp.asarray(RNG.standard_normal((t, d)), jnp.bfloat16) for t in (t1, t2))
    ta, tb = (torch.from_numpy(np.asarray(x, np.float32)).bfloat16() for x in (ja, jb))
    sim = j_sim(ja, jb)
    before = tmatch.dual_argmax_cosine_bf16.launches
    out = tmatch.dual_argmax_cosine_bf16(ta, tb)
    assert tmatch.dual_argmax_cosine_bf16.launches == before
    for o, r in ((out[0], sim.max(1)), (out[2], sim.max(0))):
        assert o.dtype == torch.float32
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=0, atol=1e-6)
    for o, r in ((out[1], sim.argmax(1)), (out[3], sim.argmax(0))):
        assert o.dtype == torch.int32
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))
    # the unit rows are bf16, as the reference's
    np.testing.assert_array_equal(
        tmatch.unit_rows(ta).float().numpy(),
        np.asarray(ja * jax.lax.rsqrt(jnp.sum(jnp.square(ja.astype(jnp.float32)), -1,
                                                keepdims=True) + 1e-24).astype(jnp.bfloat16),
                   np.float32))


def test_dual_argmax_cosine_bf16_exact_ties_take_first_index():
    """Duplicated bf16 rows tie exactly: the first index wins on both axes."""
    base = torch.from_numpy(RNG.standard_normal((9, 40)).astype(np.float32)).bfloat16()
    twice = torch.cat([base, base])
    _, nn_1, _, nn_2 = tmatch.dual_argmax_cosine_bf16(twice, twice)
    assert nn_1.tolist() == list(range(9)) * 2 and nn_2.tolist() == list(range(9)) * 2


@pytest.mark.parametrize("seed", range(6))
def test_bf16_unit_rows_pad_depth_with_zeros(seed):
    """The bf16 kernel's operands: unit rows padded to a depth that is a
    multiple of 8 with zero columns, which leave every similarity as it is:
    the f32 product of the padded operands (what the kernel computes) equals
    the unit rows' product bit for bit, and its quartet is the plain
    version's.  (The padded rows are not fed to the plain version, which
    would normalize them a second time: bf16 unit rows are not unit to bf16
    precision.)  Each seed draws its own rows."""
    rs = np.random.default_rng(seed)
    a = torch.from_numpy(rs.standard_normal((12, 100)).astype(np.float32)).bfloat16()
    b = torch.from_numpy(rs.standard_normal((7, 100)).astype(np.float32)).bfloat16()
    ua, ub = tmatch.bf16_unit_rows(a), tmatch.bf16_unit_rows(b)
    assert ua.shape == (12, 104) and ua.dtype == torch.bfloat16 and ua.is_contiguous()
    assert not ua[:, 100:].any() and not ub[:, 100:].any()
    sim = ua.float() @ ub.float().T
    assert torch.equal(sim, tmatch.unit_rows(a).float() @ tmatch.unit_rows(b).float().T)
    for o, r in zip(tmatch._quartet(sim), tmatch.dual_argmax_cosine_bf16_plain(a, b)):
        assert torch.equal(o, r)


def test_wrappers_reject_bad_inputs_before_launch():
    """The wrappers' checks, which run before any launch on a CUDA tensor
    (here on CPU tensors, which the kernels refuse)."""
    q = torch.zeros(1, 5, 2, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        tattn._check(q, q, q)
    with pytest.raises(ValueError, match="CUDA"):
        tmatch._check(torch.zeros(4, 8), torch.zeros(4, 8))
    with pytest.raises(TypeError):
        tattn._check(q.float(), q, q)
    with pytest.raises(ValueError):
        tattn._check(q[:, :4], q, q)
    with pytest.raises(ValueError):
        tattn._check(q[..., :32], q[..., :32], q[..., :32])
    with pytest.raises(ValueError):
        tattn._check(q.transpose(1, 2), q.transpose(1, 2), q.transpose(1, 2))
    with pytest.raises(ValueError):
        tmatch._check(torch.zeros(4, 8), torch.zeros(4, 9))
    with pytest.raises(TypeError):
        tmatch._check(torch.zeros(4, 8, dtype=torch.int32), torch.zeros(4, 8, dtype=torch.int32))
    x = torch.zeros(1, 5, 128, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        tint8._check(x, x, x, heads=2)
