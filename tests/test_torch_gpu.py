"""The port's CUDA kernels on the card, against their plain versions.

CUDA kernels have no CPU mode, so these tests carry the ``gpu`` marker and
skip without a CUDA device.  The card's machine has no JAX, which the
repository's tests/conftest.py imports, so run them there with:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_gpu.py
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from chip_smoke import (ATTN_F32_T, ATTN_F32_TOL, ATTN_T, FAST_ATTN_T, LARGE_LOGIT,
                        LARGE_LOGIT_F32_TOL, MATCH_BF16_SHAPES, MATCH_F32_SHAPES, large_logit_qkv,
                        underflow_qkv)
from vitvs_tpu_torch.match.correspondence import cosine_similarity_matrix
from vitvs_tpu_torch.ops import _build, attention, attn_int8, matcher
from vitvs_tpu_torch.ops.int_mm import int8_bmm, int8_matmul_nt

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels run only on the card")
    return torch.device("cuda")


def _bf16(shape, seed):
    rs = np.random.default_rng(seed)
    return [torch.from_numpy(rs.standard_normal(shape).astype(np.float32))
            .cuda().to(torch.bfloat16) for _ in range(3)]


def test_kernels_build_into_package_build_dir(cuda):
    info = _build.build()
    assert Path(info["path"]).is_file()
    assert Path(info["path"]).parent == _build.BUILD_DIR
    assert _build.library().vitvs_error_string(0)


@pytest.mark.parametrize("shape", [(1, 485, 6, 64), (2, 64, 3, 64), (1, 1, 2, 64),
                                   (1, 1370, 12, 64), (3, 130, 1, 64)])
def test_attention_kernel_matches_plain(cuda, shape):
    q, k, v = _bf16(shape, sum(shape))
    before = attention.mha_attention.launches
    out = attention.mha_attention(q, k, v)
    torch.cuda.synchronize()
    assert attention.mha_attention.launches == before + 1
    ref = attention.mha_attention_plain(q, k, v)
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    # bf16 outputs of O(1); the kernel normalizes after P.V, the plain before
    assert (out.float() - ref.float()).abs().max().item() <= 2e-2


def test_attention_kernel_large_logits_stay_finite(cuda):
    q, k, v = _bf16((1, 300, 2, 64), 5)
    out = attention.mha_attention(q * 30, k * 30, v)
    ref = attention.mha_attention_plain(q * 30, k * 30, v)
    assert torch.isfinite(out.float()).all()
    assert (out.float() - ref.float()).abs().max().item() <= 2e-2


@pytest.mark.parametrize("T", ATTN_T)
def test_attention_kernel_matches_plain_at_block_edges(cuda, T):
    """B = 2, 6 heads: 64-key block edges, one and two 128-row blocks, and
    both work splits (64-row blocks with four key groups while 128-row
    blocks would not fill the SMs; T = 1370 fills them)."""
    q, k, v = _bf16((2, T, 6, 64), T + 7)
    out = attention.mha_attention(q, k, v)
    ref = attention.mha_attention_plain(q, k, v)
    assert torch.isfinite(out.float()).all()
    assert (out.float() - ref.float()).abs().max().item() <= 2e-2


def test_attention_kernel_logits_of_200_stay_finite(cuda):
    """Rows whose scaled logits are all about +200 or -200: the running max
    keeps exp finite, where the no-max arithmetic overflows."""
    q, k, v = (torch.from_numpy(x).cuda().to(torch.bfloat16)
               for x in large_logit_qkv((2, 130, 6, 64), LARGE_LOGIT, seed=12))
    out = attention.mha_attention(q, k, v)
    ref = attention.mha_attention_plain(q, k, v)
    assert torch.isfinite(out.float()).all()
    assert (out.float() - ref.float()).abs().max().item() <= 2e-2
    assert not torch.isfinite(attention.mha_attention_fast_plain(q, k, v).float()).all()


@pytest.mark.parametrize("t1,t2,d", [(484, 484, 3456), (100, 37, 96), (1, 5, 7), (1369, 700, 130)])
def test_matcher_kernel_matches_plain(cuda, t1, t2, d):
    rs = np.random.default_rng(t1 + t2 + d)
    a = torch.from_numpy(rs.standard_normal((t1, d)).astype(np.float32)).cuda()
    b = torch.from_numpy(rs.standard_normal((t2, d)).astype(np.float32)).cuda()
    got = matcher.dual_argmax_cosine(a, b)
    ref = matcher.dual_argmax_cosine_plain(a, b)
    sim = (a * matcher.inverse_norms(a)[:, None]) @ (b * matcher.inverse_norms(b)[:, None]).T
    for v, rv in ((got[0], ref[0]), (got[2], ref[2])):
        assert (v - rv).abs().max().item() <= 1e-4
    rows, cols = torch.arange(t1, device=cuda), torch.arange(t2, device=cuda)
    # an argmax may differ from the plain one only at a tie within 1e-5
    assert ((got[1] == ref[1]) | (sim[rows, got[1].long()] >= ref[0] - 1e-5)).all()
    assert ((got[3] == ref[3]) | (sim[got[3].long(), cols] >= ref[2] - 1e-5)).all()


def test_matcher_kernel_exact_ties_take_first_index(cuda):
    rs = np.random.default_rng(9)
    base = rs.standard_normal((70, 40)).astype(np.float32)
    a = torch.from_numpy(base).cuda()
    b = torch.from_numpy(np.concatenate([base, base])).cuda()   # every column duplicated
    _, nn_1, _, nn_2 = matcher.dual_argmax_cosine(a, b)
    assert nn_1.tolist() == list(range(70))
    assert nn_2.tolist() == list(range(70)) * 2


@pytest.mark.parametrize("t1,t2,d", MATCH_BF16_SHAPES)
def test_matcher_bf16_kernel_matches_plain(cuda, t1, t2, d):
    """bf16 mode on the tensor cores: maxima within 1e-4 of the plain
    version (f32 sums of exact products in another order); an argmax may
    differ from the plain one only at a tie within 1e-5."""
    rs = np.random.default_rng(t1 + t2 + d)
    a = torch.from_numpy(rs.standard_normal((t1, d)).astype(np.float32)).cuda().bfloat16()
    b = torch.from_numpy(rs.standard_normal((t2, d)).astype(np.float32)).cuda().bfloat16()
    before = (matcher.dual_argmax_cosine.launches, matcher.dual_argmax_cosine_bf16.launches)
    got = matcher.dual_argmax_cosine_bf16(a, b)
    torch.cuda.synchronize()
    assert (matcher.dual_argmax_cosine.launches,
            matcher.dual_argmax_cosine_bf16.launches) == (before[0], before[1] + 1)
    ref = matcher.dual_argmax_cosine_bf16_plain(a, b)
    sim = matcher.unit_rows(a).float() @ matcher.unit_rows(b).float().T
    for v, rv in ((got[0], ref[0]), (got[2], ref[2])):
        assert v.dtype == torch.float32 and (v - rv).abs().max().item() <= 1e-4
    rows, cols = torch.arange(t1, device=cuda), torch.arange(t2, device=cuda)
    assert got[1].dtype == torch.int32 and got[3].dtype == torch.int32
    assert ((got[1] == ref[1]) | (sim[rows, got[1].long()] >= ref[0] - 1e-5)).all()
    assert ((got[3] == ref[3]) | (sim[got[3].long(), cols] >= ref[2] - 1e-5)).all()


def test_matcher_bf16_kernel_exact_ties_take_first_index(cuda):
    """Row i + 300 repeats row i on both sides: exact ties across row and
    column blocks go to the first index, whatever order the blocks finish."""
    rs = np.random.default_rng(10)
    base = torch.from_numpy(rs.standard_normal((300, 3456)).astype(np.float32)).cuda().bfloat16()
    twice = torch.cat([base, base])
    for _ in range(3):
        _, nn_1, _, nn_2 = matcher.dual_argmax_cosine_bf16(twice, twice)
        assert nn_1.tolist() == list(range(300)) * 2
        assert nn_2.tolist() == list(range(300)) * 2


def test_matcher_bf16_kernel_refuses_other_dtypes(cuda):
    with pytest.raises(TypeError):
        matcher.dual_argmax_cosine_bf16(torch.zeros(4, 8, device=cuda), torch.zeros(4, 8, device=cuda))


def test_kernel_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    q, k, v = _bf16((1, 16, 2, 64), 1)
    with pytest.raises(TypeError):      # f32 has its own kernel; f16 has none
        attention.mha_attention(q.half(), k.half(), v.half())
    with pytest.raises(ValueError):
        attention.mha_attention(q[..., :32].contiguous(), k[..., :32].contiguous(),
                                v[..., :32].contiguous())
    with pytest.raises(ValueError):
        matcher.dual_argmax_cosine(torch.zeros(4, 8, device=cuda), torch.zeros(4, 9, device=cuda))


def _underflow(shape, rows, c, seed, k_noise=0.05):
    return [torch.from_numpy(x).cuda().to(torch.bfloat16)
            for x in underflow_qkv(shape, rows, c, seed, k_noise)]


@pytest.mark.parametrize("shape", [(1, 1370, 12, 64), (1, 485, 6, 64), (2, 64, 3, 64),
                                   (1, 1, 2, 64), (3, 130, 1, 64)]
                         + [(2, T, 12, 64) for T in FAST_ATTN_T])
def test_attention_fast_kernel_matches_plain(cuda, shape):
    q, k, v = _bf16(shape, sum(shape) + 1)
    before = (attention.mha_attention.launches, attention.mha_attention_fast.launches)
    out = attention.mha_attention(q, k, v, fast=True)
    torch.cuda.synchronize()
    assert (attention.mha_attention.launches,
            attention.mha_attention_fast.launches) == (before[0], before[1] + 1)
    ref = attention.mha_attention_fast_plain(q, k, v)
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    assert (out.float() - ref.float()).abs().max().item() <= 2e-2


def test_attention_fast_kernel_underflow_rows(cuda):
    """Every real logit of 4 rows about -30 (T = 139 pads the last tile)."""
    q, k, v = _underflow((1, 139, 2, 64), rows=4, c=30.0, seed=11)
    out = attention.mha_attention_fast(q, k, v)
    ref = attention.mha_attention_fast_plain(q, k, v)
    assert torch.isfinite(out.float()).all()
    assert (out.float() - ref.float()).abs().max().item() <= 2e-2


def _flat(shape, seed):
    B, T, H, D = shape
    return [x.reshape(B, T, H * D) for x in _bf16(shape, seed)]


@pytest.mark.parametrize("shape", [(1, 1370, 12, 64), (2, 130, 3, 64), (1, 1, 2, 64),
                                   (1, 64, 1, 64)])
def test_int8_attention_kernel_matches_plain(cuda, shape):
    q, k, v = _flat(shape, sum(shape) + 2)
    before = attn_int8.fused_int8_attention.launches
    out = attn_int8.fused_int8_attention(q, k, v, heads=shape[2])
    torch.cuda.synchronize()
    assert attn_int8.fused_int8_attention.launches == before + 1
    ref = attn_int8.fused_int8_attention_plain(q, k, v, heads=shape[2])
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    # the same int8 products; exp2 and sums in another order
    assert (out.float() - ref.float()).abs().max().item() <= 2e-2


@pytest.mark.parametrize("T", ATTN_T)
def test_int8_attention_kernel_matches_plain_at_block_edges(cuda, T):
    """B = 2, 12 heads, q, k, v column slices of one qkv output."""
    D = 12 * 64
    qkv = torch.from_numpy(np.random.default_rng(T).standard_normal((2, T, 3 * D))
                           .astype(np.float32)).cuda().to(torch.bfloat16)
    q, k, v = qkv[..., :D], qkv[..., D:2 * D], qkv[..., 2 * D:]
    out = attn_int8.fused_int8_attention(q, k, v, heads=12)
    ref = attn_int8.fused_int8_attention_plain(q, k, v, heads=12)
    assert torch.isfinite(out.float()).all()
    assert (out.float() - ref.float()).abs().max().item() <= 2e-2


@pytest.mark.parametrize("k_path", [False, True], ids=["Q", "K"])
def test_int8_kernel_quantization_is_quant_th(cuda, k_path):
    """The kernel's own quantizer against _quant_th on CPU tensors (the
    reference's arithmetic, a true division by 127): int8 values equal and
    scales equal bit for bit, zero, large and sub-1e-12 rows included."""
    D = 12 * 64
    qkv = torch.from_numpy(np.random.default_rng(8).standard_normal((2, 300, 3 * D))
                           .astype(np.float32)).cuda().to(torch.bfloat16)
    qkv[:, 0] = 0
    qkv[:, 1] *= 1000
    qkv[:, 2] *= 1e-20
    x = qkv[..., D:2 * D] if k_path else qkv[..., :D]
    extra = 1.0 if k_path else attn_int8._q_extra_scale(x, 12)
    q8, s = attn_int8.quant_th_probe(x, 12, extra, k_path=k_path)
    ref8, ref_s = attn_int8._quant_th(x.cpu(), 12, extra)
    assert torch.equal(q8.cpu(), ref8)
    assert torch.equal(s.cpu().view(torch.int32), ref_s.view(torch.int32))


def test_int8_attention_kernel_reads_qkv_column_slices(cuda):
    """q, k, v as column slices of one (B, T, 3D) qkv output, v read in place."""
    B, T, H = 2, 200, 4
    qkv = torch.from_numpy(np.random.default_rng(4).standard_normal((B, T, 3 * H * 64))
                           .astype(np.float32)).cuda().to(torch.bfloat16)
    D = H * 64
    q, k, v = qkv[..., :D], qkv[..., D:2 * D], qkv[..., 2 * D:]
    out = attn_int8.fused_int8_attention(q, k, v, heads=H)
    ref = attn_int8.fused_int8_attention_plain(q.contiguous(), k.contiguous(), v.contiguous(), H)
    assert (out.float() - ref.float()).abs().max().item() <= 2e-2


def test_int8_attention_kernel_padded_columns(cuda):
    """tests/test_ops.py's case: T = 70, 8 rows with real logits about -25."""
    q, k, v = (x.reshape(1, 70, 128)
               for x in _underflow((1, 70, 2, 64), rows=8, c=25.0, seed=11, k_noise=0.0))
    out = attn_int8.fused_int8_attention(q, k, v, heads=2)
    ref = attn_int8.fused_int8_attention_plain(q, k, v, heads=2)
    assert torch.isfinite(out.float()).all()
    assert (out.float() - ref.float()).abs().max().item() <= 2e-2


def test_new_kernel_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    q, k, v = _bf16((1, 16, 2, 64), 1)
    with pytest.raises(TypeError):
        attention.mha_attention_fast(q.float(), k.float(), v.float())
    with pytest.raises(ValueError):
        attention.mha_attention_fast(q[:, :8], k, v)
    with pytest.raises(ValueError):
        attention.mha_attention_fast(q, k, v.cpu())
    fq, fk, fv = (x.reshape(1, 16, 128) for x in (q, k, v))
    with pytest.raises(TypeError):
        attn_int8.fused_int8_attention(fq.float(), fk.float(), fv.float(), heads=2)
    with pytest.raises(ValueError):
        attn_int8.fused_int8_attention(fq, fk, fv, heads=4)        # hd = 32
    with pytest.raises(ValueError):
        attn_int8.fused_int8_attention(fq, fk, fv.cpu(), heads=2)
    with pytest.raises(ValueError):      # v columns not at unit stride
        attn_int8.fused_int8_attention(fq, fk, fv.transpose(1, 2).contiguous().transpose(1, 2),
                                       heads=2)


@pytest.mark.parametrize("m,k,n", [(1370, 768, 2304), (1369, 6912, 1369), (5, 20, 3),
                                   (2 * 1370, 96, 384), (2 * 1370, 384, 384), (10, 96, 1152)])
def test_int8_matmul_is_exact(cuda, m, k, n):
    """torch._int_mm on the card with the padding the wrapper adds (also at
    a tensor-parallel shard's products: ViT-S at tp = 4, proj input 96 wide,
    fc2 input 384; a 10-row batch)."""
    rs = np.random.default_rng(m + k + n)
    a = torch.from_numpy(rs.integers(-127, 128, (m, k), dtype=np.int8)).cuda()
    b = torch.from_numpy(rs.integers(-127, 128, (n, k), dtype=np.int8)).cuda()
    got = int8_matmul_nt(a, b)
    ref = a.cpu().long() @ b.cpu().long().T
    assert got.dtype == torch.int32 and torch.equal(got.cpu().long(), ref)


def test_int8_cosine_similarity_matches_cpu(cuda):
    rs = np.random.default_rng(3)
    a = torch.from_numpy(rs.standard_normal((300, 6912)).astype(np.float32))
    b = torch.from_numpy(rs.standard_normal((290, 6912)).astype(np.float32))
    got = cosine_similarity_matrix(a.cuda(), b.cuda(), int8=True).cpu()
    ref = cosine_similarity_matrix(a, b, int8=True)
    # an int8 value may round the other way where the f32 row norms differ
    # in the last bit; each such flip moves a similarity by about 5e-6
    assert (got - ref).abs().max().item() <= 1e-4


# ---------------------------------------------------------------------------
# the f32 step: f32 exact attention (fault 3.4) and the f32 matcher
# ---------------------------------------------------------------------------


def _f32(shape, seed):
    rs = np.random.default_rng(seed)
    return [torch.from_numpy(rs.standard_normal(shape).astype(np.float32)).cuda()
            for _ in range(3)]


# shapes whose grids leave the most SMs to split keys over: clusters of the
# largest size the entry point allows (4 blocks) and of 3
F32_CLUSTER_SHAPES = [(1, 485, 1, 64), (1, 320, 6, 64)]


@pytest.mark.parametrize("shape", [(1, 485, 6, 64), (1, 1370, 12, 64)] + F32_CLUSTER_SHAPES
                         + [(2, T, 6, 64) for T in ATTN_F32_T])
def test_attention_f32_kernel_matches_plain(cuda, shape):
    """f32 inputs launch the f32 kernel (its own count, not the bf16 one's):
    f32 out, within ATTN_F32_TOL of the plain version at 64-key chunk edges,
    ragged 8-key groups, an almost empty last chunk, T = 1, B = 2 and every
    cluster size from 1 to 4."""
    q, k, v = _f32(shape, sum(shape) + 3)
    before = (attention.mha_attention.launches, attention.mha_attention_f32.launches)
    out = attention.mha_attention(q, k, v)
    torch.cuda.synchronize()
    assert (attention.mha_attention.launches,
            attention.mha_attention_f32.launches) == (before[0], before[1] + 1)
    ref = attention.mha_attention_plain(q, k, v)
    assert out.dtype == torch.float32 and out.shape == q.shape
    assert (out - ref).abs().max().item() <= ATTN_F32_TOL


@pytest.mark.parametrize("shape", [(1, 485, 6, 64), (1, 1370, 12, 64)] + F32_CLUSTER_SHAPES)
def test_attention_f32_kernel_is_deterministic(cuda, shape):
    """No atomics, and a cluster's partials meet in rank order: three
    launches give the same bits (clusters of 4 blocks at the f32 step's
    shape, one block a cluster at T = 1370, 4 and 3 at the other two)."""
    q, k, v = _f32(shape, 41)
    first = attention.mha_attention(q, k, v)
    for _ in range(2):
        again = attention.mha_attention(q, k, v)
        assert torch.equal(first.view(torch.int32), again.view(torch.int32))


def test_attention_f32_kernel_logits_of_200(cuda):
    """Scaled logits of about +-200: the running max keeps exp finite; the
    f32 dot products of about 1600 carry 1.2e-4 ulps, hence the looser
    tolerance."""
    q, k, v = (torch.from_numpy(x).cuda()
               for x in large_logit_qkv((2, 130, 6, 64), LARGE_LOGIT, seed=12))
    out = attention.mha_attention(q, k, v)
    ref = attention.mha_attention_plain(q, k, v)
    assert torch.isfinite(out).all()
    assert (out - ref).abs().max().item() <= LARGE_LOGIT_F32_TOL


@pytest.mark.parametrize("t1,t2,d", MATCH_F32_SHAPES)
def test_matcher_f32_kernel_ragged_depths(cuda, t1, t2, d):
    """Depths of 1, 3, 97 and others that leave ragged chunks and empty
    slices of a cluster's CTAs: one launch, maxima within 1e-4, argmax equal
    or a tie within 1e-5."""
    rs = np.random.default_rng(t1 + t2 + d)
    a = torch.from_numpy(rs.standard_normal((t1, d)).astype(np.float32)).cuda()
    b = torch.from_numpy(rs.standard_normal((t2, d)).astype(np.float32)).cuda()
    before = (matcher.dual_argmax_cosine.launches, matcher.dual_argmax_cosine_bf16.launches)
    got = matcher.dual_argmax_cosine(a, b)
    torch.cuda.synchronize()
    assert (matcher.dual_argmax_cosine.launches,
            matcher.dual_argmax_cosine_bf16.launches) == (before[0] + 1, before[1])
    ref = matcher.dual_argmax_cosine_plain(a, b)
    sim = (a * matcher.inverse_norms(a)[:, None]) @ (b * matcher.inverse_norms(b)[:, None]).T
    for v, rv in ((got[0], ref[0]), (got[2], ref[2])):
        assert v.dtype == torch.float32 and (v - rv).abs().max().item() <= 1e-4
    rows, cols = torch.arange(t1, device=cuda), torch.arange(t2, device=cuda)
    assert ((got[1] == ref[1]) | (sim[rows, got[1].long()] >= ref[0] - 1e-5)).all()
    assert ((got[3] == ref[3]) | (sim[got[3].long(), cols] >= ref[2] - 1e-5)).all()


def test_matcher_f32_kernel_is_deterministic(cuda):
    """The partial sums of a cluster meet in rank order: two launches on the
    same inputs give the same bits."""
    rs = np.random.default_rng(21)
    a = torch.from_numpy(rs.standard_normal((484, 3456)).astype(np.float32)).cuda()
    b = torch.from_numpy(rs.standard_normal((484, 3456)).astype(np.float32)).cuda()
    first = matcher.dual_argmax_cosine(a, b)
    for _ in range(3):
        again = matcher.dual_argmax_cosine(a, b)
        assert torch.equal(first[0].view(torch.int32), again[0].view(torch.int32))
        assert torch.equal(first[2].view(torch.int32), again[2].view(torch.int32))
        assert torch.equal(first[1], again[1]) and torch.equal(first[3], again[3])


def test_matcher_f32_kernel_exact_ties_take_first_index(cuda):
    """Row i + 300 repeats row i on both sides: exact ties across row tiles,
    column tiles and clusters go to the first index."""
    rs = np.random.default_rng(11)
    base = torch.from_numpy(rs.standard_normal((300, 3456)).astype(np.float32)).cuda()
    twice = torch.cat([base, base])
    for _ in range(3):
        _, nn_1, _, nn_2 = matcher.dual_argmax_cosine(twice, twice)
        assert nn_1.tolist() == list(range(300)) * 2
        assert nn_2.tolist() == list(range(300)) * 2


def test_f32_servo_step_with_kernels_matches_plain(cuda):
    """The f32 step (ViT-S/14 @ 308, f32, exact GELU, seeded weights):
    goal_descriptors + 5 servo steps through the kernels against the plain
    run, at chip_smoke.py's f32 tolerances; 72 f32 attention and 5 f32
    matcher launches, no other kernel."""
    cfg = chip_smoke.reference_config()
    net, model = chip_smoke.f32_step(cfg, "cuda")
    summary = chip_smoke.run_main_path(net, cfg, model, tol=chip_smoke.F32_TOL)
    want = dict.fromkeys(summary["launches"], 0)
    want.update(attention_f32=12 * 6, matcher=5)
    assert summary["launches"] == want
    assert summary["steps_compared"] >= 1


@pytest.mark.parametrize("mode", ["f32", "bf16"])
def test_matcher_kernels_leave_their_scratch_zero(cuda, mode):
    """The last block zeroes the packed keys it decoded: a launch after one
    with larger similarities (identical rows) and more rows still gives the
    plain version's maxima, and the scratch is all zero afterwards."""
    fn, plain = ((matcher.dual_argmax_cosine, matcher.dual_argmax_cosine_plain) if mode == "f32"
                 else (matcher.dual_argmax_cosine_bf16, matcher.dual_argmax_cosine_bf16_plain))
    dtype = torch.float32 if mode == "f32" else torch.bfloat16
    rs = np.random.default_rng(31)
    same = torch.from_numpy(rs.standard_normal((400, 256)).astype(np.float32)).cuda().to(dtype)
    fn(same, same)                              # every maximum about 1
    a = torch.from_numpy(rs.standard_normal((150, 256)).astype(np.float32)).cuda().to(dtype)
    b = torch.from_numpy(rs.standard_normal((170, 256)).astype(np.float32)).cuda().to(dtype)
    got, ref = fn(a, b), plain(a, b)
    torch.cuda.synchronize()
    assert (got[0] - ref[0]).abs().max().item() <= 1e-4
    assert (got[2] - ref[2]).abs().max().item() <= 1e-4
    assert all(int(buf.abs().sum()) == 0 for buf in matcher._keys_scratch.values())


def test_attention_kernel_matches_plain_at_the_search_batch(cuda):
    """The rotation search's 4-view forward: (4, 485, 6, 64) bf16."""
    assert chip_smoke.check_attention("cuda", shape=chip_smoke.SEARCH_ATTN_SHAPE, ts=(),
                                      seed=14) <= chip_smoke.ATTN_TOL


def test_closed_loop_with_kernels_matches_plain(cuda, tmp_path):
    """run_benchmark on the card at ViT-S/14 @ 308 bf16 on the poster
    scene: episodes 0 and 1 (rotation search on) and 1 perturbed, one
    episode a chunk, 10 steps in segments of 5; launches as the executed
    chunk-steps give (one search match a chunk), every step of
    episode 0 teacher-forced through the plain step with its twist within
    1e-3 wherever no pair differs (compare_runs raises otherwise)."""
    from vitvs_tpu_torch.harness.pipeline import ServoModel
    from vitvs_tpu_torch.models.vit import init_vit
    from vitvs_tpu_torch.sim.scene import load_poster_scene

    cfg = chip_smoke.loop_config(chip_smoke.reference_config())
    model = ServoModel.create(cfg, device="cuda")
    net = init_vit(model.vit, torch.Generator().manual_seed(0), device="cuda",
                   layerscale=1.0).cast_blocks(model.compute_dtype).eval()
    s = chip_smoke.run_closed_loop(net, cfg, model, load_poster_scene(device="cuda"),
                                   str(tmp_path), num_steps=10, segment_steps=5)
    for name, got in s["launches"].items():
        want = dict.fromkeys(got, 0)
        want.update(chip_smoke.loop_launches(cfg.layer, s["episodes"][name],
                                             s["chunk_steps"][name]))
        assert got == want, name
    assert s["teacher_forced"]["steps"] == 10
    assert s["teacher_forced"]["twist_max_abs_err"] <= chip_smoke.TWIST_TOL


def test_trained_servo_step_with_kernels_matches_plain(cuda):
    """Phase 3e's step on the card: the exported trained ViT-S/14 @ 518
    (numpy, no JAX) at configs/real_s518.yaml's settings, goal + 5 bf16
    steps on rendered views near the goal, kernels against plain with the
    plain step teacher-forced: 12 exact-attention launches a forward at
    (1, 1370, 6, 64), one bf16-matcher launch a step at (1369, 3456), and
    the twists within 1e-3 wherever no pair differs (run_main_path raises
    otherwise)."""
    from vitvs_tpu_torch.harness.pipeline import ServoModel
    from vitvs_tpu_torch.sim.scene import load_poster_scene

    cfg = chip_smoke.trained_config()
    model = ServoModel.create(cfg, device="cuda")
    net32, info = chip_smoke.load_trained(model)
    assert info["config"]["embed_dim"] == 384 and info["config"]["pos_grid"] == 37
    net = net32.cast_blocks(model.compute_dtype)
    s = chip_smoke.run_trained_step(net, cfg, model, load_poster_scene(device="cuda"))
    steps = s.pop("steps")
    assert len(steps) == chip_smoke.N_STEPS and steps[0].valid.numel() == cfg.num_pairs
    want = dict.fromkeys(s["launches"], 0)
    want.update(attention=(cfg.layer + 1) * (1 + chip_smoke.N_STEPS),
                matcher_bf16=chip_smoke.N_STEPS)
    assert s["launches"] == want
    assert s["twist_max_abs_err"] <= chip_smoke.TWIST_TOL and s["steps_compared"] >= 1


@pytest.mark.parametrize("mode", ["bf16", "f32"])
@pytest.mark.parametrize("nb,t1,t2,d", [(1, 1369, 1369, 3456), (3, 484, 484, 3456),
                                        (8, 65, 130, 100), (32, 33, 97, 3456)])
def test_batched_matcher_equals_single_launches(cuda, mode, nb, t1, t2, d):
    """One goal (t1, d) against a batch of nb frames (nb, t2, d) in one
    launch: each item's quartet bit for bit that of a launch on it alone,
    within 1e-4 of the plain version, and the key scratch left zero."""
    fn, plain = ((matcher.dual_argmax_cosine_bf16, matcher.dual_argmax_cosine_bf16_plain)
                 if mode == "bf16" else
                 (matcher.dual_argmax_cosine, matcher.dual_argmax_cosine_plain))
    rs = np.random.default_rng(nb + t1 + d)
    a = torch.from_numpy(rs.standard_normal((t1, d)).astype(np.float32)).cuda().bfloat16()
    b = torch.from_numpy(rs.standard_normal((nb, t2, d)).astype(np.float32)).cuda().bfloat16()
    before = fn.launches
    got = fn(a, b)
    assert fn.launches == before + 1
    assert got[0].shape == (nb, t1) and got[3].shape == (nb, t2)
    bits = lambda x: x.view(torch.int32) if x.dtype == torch.float32 else x
    for i in range(nb):
        for x, y in zip(got, fn(a, b[i])):
            assert torch.equal(bits(x[i]), bits(y))
    ref = plain(a, b)
    assert (got[0] - ref[0]).abs().max().item() <= 1e-4
    assert (got[2] - ref[2]).abs().max().item() <= 1e-4
    torch.cuda.synchronize()
    assert all(int(buf.abs().sum()) == 0 for buf in matcher._keys_scratch.values())


def test_batched_matcher_refuses_what_it_does_not_take(cuda):
    a = torch.zeros(4, 8, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError):          # depths differ
        matcher.dual_argmax_cosine_bf16(a, torch.zeros(2, 4, 9, device=cuda, dtype=torch.bfloat16))
    with pytest.raises(ValueError):          # the frames on another device
        matcher.dual_argmax_cosine_bf16(a, torch.zeros(2, 4, 8, dtype=torch.bfloat16))
    with pytest.raises(ValueError):          # an empty batch
        matcher.dual_argmax_cosine(a.float(), torch.zeros(0, 4, 8, device=cuda))
    with pytest.raises(ValueError):          # the goal batched
        matcher.dual_argmax_cosine(torch.zeros(2, 4, 8, device=cuda),
                                   torch.zeros(2, 4, 8, device=cuda))


def test_chunk_servo_step_with_kernels_matches_plain(cuda):
    """A chunk of 3 episodes' frames through the bf16 step at ViT-S/14 @ 308
    (seeded weights): one ViT forward, one matcher launch, and each
    episode's twist within 1e-3 of the plain step wherever its pairs agree;
    each episode's pairs as the single-frame step's."""
    from vitvs_tpu_torch.control.ibvs import EmaState
    from vitvs_tpu_torch.harness.pipeline import ServoModel, goal_descriptors, servo_step
    from vitvs_tpu_torch.models.vit import init_vit

    cfg = chip_smoke.reference_config()
    model = ServoModel.create(cfg, device="cuda")
    plain = ServoModel.create(cfg, device="cuda", use_kernels=False)
    net = init_vit(model.vit, torch.Generator().manual_seed(0), device="cuda",
                   layerscale=1.0).cast_blocks(model.compute_dtype).eval()
    goal, frames, depth = chip_smoke.make_frames(cfg, seed=0)
    rgb = torch.from_numpy(np.stack(frames[:3])).cuda()
    depths = torch.from_numpy(np.stack([depth] * 3)).cuda()
    scores = torch.stack(chip_smoke.pair_scores(model, 3)).cuda()
    ema, prev = EmaState.init("cuda", (3,)), torch.zeros(3, 6, device="cuda")
    before = (attention.mha_attention.launches, matcher.dual_argmax_cosine_bf16.launches)
    ker = servo_step(net, model, goal_descriptors(net, model, goal), rgb, depths, ema, prev,
                     scores=scores)
    assert (attention.mha_attention.launches - before[0],
            matcher.dual_argmax_cosine_bf16.launches - before[1]) == (2 * 12, 1)
    ref = servo_step(net, plain, goal_descriptors(net, plain, goal), rgb, depths, ema, prev,
                     scores=scores)
    agree = chip_smoke.same_pairs(ref, ker).all(-1)
    assert bool(agree.any())
    assert (ref.body_twist - ker.body_twist).abs().amax(-1)[agree].max().item() <= 1e-3
    assert ker.body_twist.shape == (3, 6) and torch.isfinite(ker.body_twist).all()


def _ad_int8_on(device):
    """Run AD's int8 serving ViT and model (configs/real_s518_pool2mm.yaml,
    static scales of the stream's first views) of the exported trained
    ViT-S/14 @ 518, quantized on the CPU, then moved to ``device``."""
    import dataclasses

    from vitvs_tpu_torch.harness.pipeline import ServoModel
    from vitvs_tpu_torch.sim.scene import load_poster_scene

    model = ServoModel.create(chip_smoke.ad_config(), device="cpu")
    scene = load_poster_scene(device="cpu")
    qnet, qmodel = chip_smoke.int8_serving_of_stream(chip_smoke.load_trained(model)[0], model,
                                                     scene)
    return qnet.to(device), dataclasses.replace(qmodel, device=str(device)), scene


def test_int8_chunk_step_on_the_card_matches_the_cpu_step(cuda):
    """The int8 chunk step at run AD's settings on the card (no hand kernel:
    no counter moves) against the same step on CPU tensors, a chunk of 3
    views near the goal with the same int8 weights, EMA, commands and
    scores.  The card's products round otherwise than the CPU's, and an
    int8 activation near a rounding tie then moves its token (as against
    JAX on the CPU: tests/test_torch_trained_int8.py), so near the goal, where
    matches are near-ties, the eligible tokens differ by a few and the 24
    selected pairs shift slots (20, 23 and 2 slots apart on these views on
    an NVIDIA H100 80GB HBM3 at 700 W):
    the goal's source-quantized rows are held by their cosine (>= 0.99) and
    every episode's twist within BASELINE.md's 1e-3."""
    from vitvs_tpu_torch.control.ibvs import EmaState
    from vitvs_tpu_torch.harness.pipeline import goal_descriptors, servo_step

    qnet, qmodel, scene = _ad_int8_on(cuda)
    cpu_net, cpu_model = _ad_int8_on("cpu")[:2]
    goal, rgbs, depths = chip_smoke.render_views(cpu_model, scene,
                                                 chip_smoke.TRAINED_STEP_OFFSETS[:3])
    rgb, depth = torch.stack(rgbs), torch.stack(depths)
    ema, prev = EmaState.init(device="cpu", batch=(3,)), torch.zeros(3, 6)
    scores = torch.rand((3, 1369), generator=torch.Generator().manual_seed(5))
    counts = {k: fn.launches for k, fn in chip_smoke._counters().items()}
    goal_card = goal_descriptors(qnet, qmodel, goal.cuda())
    got = servo_step(qnet, qmodel, goal_card, rgb.cuda(), depth.cuda(),
                     EmaState(ema.value.cuda(), ema.initialized.cuda()), prev.cuda(),
                     scores=scores.cuda())
    torch.cuda.synchronize()
    assert counts == {k: fn.launches for k, fn in chip_smoke._counters().items()}
    goal_cpu = goal_descriptors(cpu_net, cpu_model, goal)
    ref = servo_step(cpu_net, cpu_model, goal_cpu, rgb, depth, ema, prev, scores=scores)
    cos = torch.nn.functional.cosine_similarity(chip_smoke._unit_rows(goal_card).cpu(),
                                                chip_smoke._unit_rows(goal_cpu), dim=-1)
    assert cos.min().item() >= 0.99
    got = chip_smoke._to_cpu(got)
    assert torch.isfinite(got.body_twist).all()
    flips = (~chip_smoke.same_pairs(ref, got)).sum(-1).tolist()
    err = (ref.body_twist - got.body_twist).abs().max().item()
    assert err <= chip_smoke.TWIST_TOL, (err, flips)


def test_batched_int8_match_is_one_product_of_single_calls(cuda):
    """int8 matching of a chunk of 4 frames on the card is one _int_mm of
    (4 t, d) against the goal: each item's match equal to its frame matched
    alone, for source-quantized and for int8 float rows, and the int32
    products exact (the CPU's)."""
    from vitvs_tpu_torch.core.batch import item
    from vitvs_tpu_torch.match import correspondence as corr
    from vitvs_tpu_torch.match.binned import quantize_binned_int8

    rs = np.random.default_rng(41)
    goal = torch.from_numpy(rs.standard_normal((1369, 384)).astype(np.float32))
    frames = goal + 0.5 * torch.from_numpy(rs.standard_normal((4, 1369, 384)).astype(np.float32))
    scores = torch.rand((4, 1369), generator=torch.Generator().manual_seed(2))
    grid = (37, 37)
    for g, f in ((quantize_binned_int8(goal.cuda().bfloat16(), grid),
                  quantize_binned_int8(frames.cuda().bfloat16(), grid)),
                 (goal.cuda().bfloat16(), frames.cuda().bfloat16())):
        m = corr.find_correspondences(g, f, grid, 24, scores.cuda(), use_kernel=False, int8=True)
        for i in range(4):
            one = corr.find_correspondences(g, item(f, i), grid, 24, scores[i].cuda(),
                                            use_kernel=False, int8=True)
            for name, a, b in zip(m._fields, item(m, i), one):
                assert torch.equal(a, b), (i, name)
    qg, qf = (quantize_binned_int8(x.bfloat16(), grid) for x in (goal, frames))
    prod = corr._int8_frames_by_goal(qg.q.cuda(), qf.q.cuda()).cpu()
    assert torch.equal(prod, corr._int8_frames_by_goal(qg.q, qf.q))


def test_default_preprocess_scopes_tf32_on_the_card(cuda):
    """'default' runs the resize's two products as one TF32 pass (so it
    differs from 'highest', by about TF32's 2^-11 of the values) and turns
    TF32 off again after; 'highest' is exact f32 (the CPU's up to summation
    order)."""
    from vitvs_tpu_torch.core import image

    image.set_f32_matmul_precision()
    rgb = torch.from_numpy(np.random.default_rng(3).integers(0, 256, (480, 640, 3),
                                                             dtype=np.uint8))
    exact = image.preprocess_frame(rgb.cuda(), 518)
    fast = image.preprocess_frame(rgb.cuda(), 518, precision="default")
    assert not torch.backends.cuda.matmul.allow_tf32
    gap = (fast - exact).abs().max().item()
    assert 0.0 < gap <= 2e-2, gap
    assert (exact.cpu() - image.preprocess_frame(rgb, 518)).abs().max().item() <= 1e-5


@pytest.mark.parametrize("method", ["sift", "orb", "akaze", "harris"])
def test_classical_chunk_on_the_card_matches_the_cpu_port(cuda, method, tmp_path):
    """Phase 3h at a 240 x 320 camera on the poster: a chunk of 3 for 8
    steps on the card, twice bit for bit, no hand kernel; chunk-steps 0 and
    4 against the port on the CPU (twists within 1e-4 where the pairs
    agree, Hamming distances bit for bit); each episode alone for 4 steps."""
    from vitvs_tpu_torch.io_bridge.config import VSConfig
    from vitvs_tpu_torch.sim.scene import load_poster_scene

    cfg = VSConfig(u_max=320, v_max=240, f_x=251.15, f_y=251.15, pinv_mode="dls",
                   num_samples=64)
    s = chip_smoke.run_classical_chunk(method, cfg, load_poster_scene(device="cuda"),
                                       str(tmp_path), episodes=[0, 1, 2], num_steps=8,
                                       compared=(0, 4), alone_steps=4, max_corners=256)
    assert all(v == 0 for v in s["launches"].values())
    assert s["cpu"]["frames"] == 6 and s["cpu"]["twist_max_abs_err"] <= 1e-4
    assert s["cpu"]["frames_with_same_pairs"] >= 3


def test_train_step_on_the_card_matches_the_cpu(cuda):
    """Phase 3i(a) at a tiny ViT at 56 px: the bf16 servo loss and its
    gradients on the card against the CPU (loss within 1e-2 relative, every
    gradient's cosine at least 0.99), no hand kernel launched."""
    from vitvs_tpu_torch.models.vit import ViTConfig

    vit = ViTConfig(patch_size=14, embed_dim=64, depth=2, num_heads=2, pos_grid=4,
                    model_name="tiny", gelu_approx=True)
    before = {k: fn.launches for k, fn in chip_smoke._counters().items()}
    g = chip_smoke.check_train_grads("cuda", size=56, vit=vit)
    assert g["loss_rel_err"] <= 1e-2 and g["grad_cos_min"] >= 0.99
    assert {k: fn.launches for k, fn in chip_smoke._counters().items()} == before


def test_kernel_entries_refuse_grad_on_the_card(cuda):
    """On CUDA tensors that require grad the kernel entries raise before any
    launch; under no_grad they launch."""
    q, k, v = (t.requires_grad_() for t in _bf16((1, 64, 2, 64), 31))
    n = attention.mha_attention.launches
    with pytest.raises(RuntimeError, match="no backward"):
        attention.mha_attention(q, k, v)
    assert attention.mha_attention.launches == n
    with torch.no_grad():
        attention.mha_attention(q, k, v)
    assert attention.mha_attention.launches == n + 1


@pytest.mark.parametrize("shape", [(1, 1370, 12, 64), (1, 1370, 6, 64), (2, 65, 3, 64)])
def test_int8_prob_products_are_exact(cuda, shape):
    """The int8 products of 'qk+pv' (Q K^T) and 'pv' (P V) on the card
    (ops/int_mm.int8_bmm) bit for bit against the int64 product
    (chip_smoke.check_int8_products: an exact f64 GEMM, itself held to an
    int64 sum on 16 rows); and one pair against the CPU's int64 matmul."""
    out = chip_smoke.check_int8_products(cuda, shape=shape, seed=sum(shape))
    assert out["pv"]["depth"] == shape[1] and out["qk"]["depth"] == shape[3]
    a, b = chip_smoke.int8_operands((1, 300, 2, 64), 3, cuda)["pv"]
    got = int8_bmm(a, b)
    assert torch.equal(got.cpu().long(), a.cpu().long() @ b.cpu().long())


@pytest.mark.parametrize("score", ["relu", "sqrelu"])
def test_score_step_with_kernels_matches_plain(cuda, score):
    """Phase 3j(a) on the card: relu / sqrelu at configs/real_s518_relu.yaml's
    settings on the trained ViT-S/14 @ 518: no attention kernel launches
    (the scores are plain PyTorch), one bf16-matcher launch a step, and the
    twists of kernels and plain within 1e-3 where no pair differs."""
    from vitvs_tpu_torch.sim.scene import load_poster_scene

    s, steps, _, model = chip_smoke.run_score_step(score, "cuda", load_poster_scene(device="cuda"))
    assert model.vit.attn_score == score and len(steps) == chip_smoke.N_STEPS
    assert s["launches"]["attention"] == 0 and s["launches"]["matcher_bf16"] == chip_smoke.N_STEPS
    assert s["twist_max_abs_err"] <= chip_smoke.TWIST_TOL and s["steps_compared"] >= 1


@pytest.mark.parametrize("mode", ["pv", "qk+pv"])
def test_int8_prob_block_on_the_card_matches_the_cpu(cuda, mode):
    """Block 0 of the int8 ViT-B/14 @ 518 (seeded, static scales) in 'pv' /
    'qk+pv' on the card against the card machine's CPU on the same input,
    within chip_smoke.INT8_BLOCK_TOL of the output scale."""
    from vitvs_tpu_torch.harness.pipeline import ServoModel, quantized_vit
    from vitvs_tpu_torch.models.vit import init_vit

    cfg = chip_smoke.serving_config()
    fnet = init_vit(ServoModel.create(cfg, device="cuda").vit, torch.Generator().manual_seed(0),
                    device="cuda", layerscale=1.0).eval()
    model = chip_smoke.serving_model(cfg, mode, "cuda")
    shifts = chip_smoke.SHIFTS + chip_smoke.CALIB_SHIFTS
    goal, frames, _ = chip_smoke.make_frames(cfg, shifts=shifts)
    qnet = quantized_vit(fnet, model, [goal, *frames[chip_smoke.N_STEPS:]])
    b = chip_smoke.check_int8_block(qnet, model, goal)
    assert b["rel_err"] <= chip_smoke.INT8_BLOCK_TOL


@pytest.mark.parametrize("hd", chip_smoke.PIXEL_HD)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_any_width_attention_kernel_matches_plain(cuda, hd, dtype):
    """Head widths other than 64 (the pixel baselines'): the any-width
    kernel against the plain version, B = 2 at T = 485 and 65, within the
    exact kernels' tolerances (bf16 2e-2, f32 2e-5), its own counter, two
    launches bit for bit."""
    counter = attention.mha_attention_hd if dtype == torch.bfloat16 else attention.mha_attention_hd_f32
    tol = 2e-2 if dtype == torch.bfloat16 else chip_smoke.ATTN_F32_TOL
    for T in (485, 65):
        rs = np.random.default_rng(hd + T)
        q, k, v = (torch.from_numpy(rs.standard_normal((2, T, 1, hd)).astype(np.float32))
                   .cuda().to(dtype) for _ in range(3))
        before = counter.launches
        out = attention.mha_attention(q, k, v)
        again = attention.mha_attention(q, k, v)
        torch.cuda.synchronize()
        assert counter.launches == before + 2 and torch.equal(out, again)
        ref = attention.mha_attention_plain(q, k, v)
        assert (out.float() - ref.float()).abs().max().item() <= tol


def test_any_width_attention_edges_on_the_card(cuda):
    """Phase 3l(a)'s edges: long T at pixel14 @ 518's and pixel4 @ 308's
    shapes, pixel14's unaligned qkv split, the C geometry equal to hd_plan."""
    out = chip_smoke.check_attention_hd_edges("cuda")
    assert out["plan_mismatches"] == 0 and out["qkv_split"]["bf16"]["copy"] == 8


def test_pixel_phase_on_the_card(cuda, tmp_path):
    """Phase 3l's kernel checks and the pixel8 episode on the card."""
    chip_smoke.check_attention_hd("cuda")
    chip_smoke.check_attention_hd("cuda", torch.float32)
    loop = chip_smoke.run_pixel_loop("cuda")
    assert loop["launches"] == loop["launches_on_the_card"]


@pytest.mark.parametrize("shape", [*chip_smoke.BF16L_SHAPES, (2, 65, 3, 64), (1, 1, 2, 64)])
def test_bf16_logits_attention_kernel_matches_plain(cuda, shape):
    """The exact kernel's bf16-logits variant (softmax_f32=False) against
    its plain version, its own counter, two launches bit for bit, and
    phase 3m(c)'s hold: its mean |diff| to the plain version at most half
    the f32-score kernel's (the roundings are in)."""
    q, k, v = _bf16(shape, sum(shape) + 1)
    before = attention.mha_attention_bf16l.launches
    out = attention.mha_attention(q, k, v, bf16_logits=True)
    again = attention.mha_attention(q, k, v, bf16_logits=True)
    torch.cuda.synchronize()
    assert attention.mha_attention_bf16l.launches == before + 2 and torch.equal(out, again)
    chip_smoke.check_bf16l("cuda", shapes=(shape,))


@pytest.mark.parametrize("tp", [2, 3])
def test_matmul_pooling_of_shard_heads_on_the_card(cuda, tp):
    """The K/V pooling product ('matmul', pool 2) of a tensor-parallel
    shard's heads equals the whole's for those heads to the bit on the card,
    where cuBLAS picks its GEMM by width (run AD's (8, 1370, 6, 64) K)."""
    from vitvs_tpu_torch.models.vit import pool_kv

    t = _bf16((8, 1370, 6, 64), 5)[0]
    whole = pool_kv(t, 2, "matmul")
    n = 6 // tp
    for s in range(tp):
        part = pool_kv(t[:, :, s * n:(s + 1) * n].contiguous(), 2, "matmul")
        assert torch.equal(part, whole[:, :, s * n:(s + 1) * n])


def test_int8_split_over_tp_on_the_card(cuda):
    """chip_smoke.py phase 3m(b)'s check on a small int8 ViT: 'fused' split
    over tp = 2 on the card equals the unsplit, each shard's kernel 4 output
    the unsplit kernel's heads to the bit."""
    from vitvs_tpu_torch.io_bridge.config import VSConfig
    from vitvs_tpu_torch.models import vit as tvit

    cfg = VSConfig(u_max=96, v_max=72, f_x=75.0, f_y=75.0, dino_input_size=84, num_pairs=12,
                   layer=1, model_name="tiny", pinv_mode="dls")
    vit = tvit.ViTConfig(patch_size=14, embed_dim=256, depth=2, num_heads=4, pos_grid=5,
                         gelu_approx=True, model_name="tiny")
    fnet = tvit.init_vit(vit, torch.Generator().manual_seed(1), device="cuda",
                         layerscale=1.0).eval()
    _, qnet, model = chip_smoke.run_serving_path(fnet, cfg, "F", "cuda", vit=vit)
    out = chip_smoke.run_int8_tp_serving({"fused": (qnet, model, "attn_int8")}, cfg)["fused"]
    assert out["launches"] == out["launches_on_the_card"]
    assert out["shard_kernels"]["bit_equal"] == [True, True]
