"""What the port's kernel wrappers hand the CUDA kernels, checked on the CPU
before any launch: which exact attention kernel a dtype goes to and what
both refuse, the f32 matcher's cluster grid and depth slices, the fused
int8 attention kernel's layout checks, the
shapes and strides it is given for the bf16 q, k, v column slices of the
qkv output, the arithmetic of its in-kernel Q/K quantization (a numpy model
of its quantizer held to ``_quant_th``), and the build's list of sources
against the C entry points the library binds."""

import ctypes
import re

import numpy as np
import pytest
import torch

from vitvs_tpu_torch.ops import _build, attention, attn_int8, matcher

RNG = np.random.default_rng(17)


@pytest.fixture
def no_library(monkeypatch):
    """Fail a test that reaches the kernel library (a launch or a build)."""
    def refuse():
        raise AssertionError("the kernel library was reached")
    monkeypatch.setattr(_build, "library", refuse)


def _qkv(B, T, heads, extra_cols=0, dtype=torch.bfloat16):
    D = heads * 64
    x = torch.from_numpy(RNG.standard_normal((B, T, 3 * D + extra_cols)).astype(np.float32))
    return x.to(dtype)


def test_int8_kernel_reads_qkv_column_slices_in_place(no_library):
    """Column slices of the qkv output pass as they are: each read at its
    own (batch, row) strides, with the Q scale factor hd^-0.5 log2(e)."""
    B, T, H = 2, 37, 3
    D = H * 64
    qkv = _qkv(B, T, H)
    q, k, v = qkv[..., :D], qkv[..., D:2 * D], qkv[..., 2 * D:]
    attn_int8._check_layout(q, k, v, H)
    args = attn_int8._kernel_args(q, k, v, H)
    assert args[:3] == (B, T, H)
    assert args[3:9] == (T * 3 * D, 3 * D) * 3
    assert args[9] == pytest.approx(np.log2(np.e) / 8, rel=1e-15)
    # separate contiguous tensors: their own strides
    qc, kc = q.contiguous(), k.contiguous()
    assert attn_int8._kernel_args(qc, kc, v, H)[3:9] == (T * D, D, T * D, D, T * 3 * D, 3 * D)


def _refused(case):
    """(q, k, v, heads, the error) of one input the kernel cannot read."""
    B, T, H = 2, 21, 2
    D = H * 64
    qkv = _qkv(B, T, H)
    q, k, v = qkv[..., :D], qkv[..., D:2 * D], qkv[..., 2 * D:]
    if case == "float32":
        return q.float(), k.float(), v.float(), H, TypeError
    if case == "head_dim_32":
        return q, k, v, 2 * H, ValueError
    if case == "shape_mismatch":
        return q, k, v[:, :-1], H, ValueError
    if case == "column_offset":           # starts 4 columns (8 bytes) in
        return q, k, qkv[..., 4:4 + D], H, ValueError
    if case == "row_stride":              # rows 3 D + 4 apart: not 16-byte aligned
        return q, k, _qkv(B, T, H, extra_cols=4)[..., 2 * D:3 * D], H, ValueError
    assert case == "column_stride"
    return q, k, v.transpose(1, 2).contiguous().transpose(1, 2), H, ValueError


@pytest.mark.parametrize("case", ["float32", "head_dim_32", "shape_mismatch", "column_offset",
                                  "row_stride", "column_stride"])
def test_int8_kernel_refuses_what_it_cannot_read(no_library, case):
    """Refused before any launch: another dtype, a head dim other than 64,
    mismatched shapes, rows not 16-byte aligned, columns not at unit
    stride."""
    q, k, v, heads, err = _refused(case)
    with pytest.raises(err):
        attn_int8._check_layout(q, k, v, heads)


def test_int8_wrapper_refuses_cpu_tensors_before_any_launch(no_library):
    B, T, H = 1, 9, 2
    D = H * 64
    qkv = _qkv(B, T, H)
    q, k, v = qkv[..., :D], qkv[..., D:2 * D], qkv[..., 2 * D:]
    before = attn_int8.fused_int8_attention.launches
    with pytest.raises(ValueError, match="CUDA"):
        attn_int8._check(q, k, v, H)
    # the public entry point takes the plain version for CPU tensors
    out = attn_int8.fused_int8_attention(q, k, v, heads=H)
    assert out.shape == (B, T, D) and out.dtype == torch.bfloat16
    assert attn_int8.fused_int8_attention.launches == before


def _bf16_rn(x: np.ndarray) -> np.ndarray:
    """float32 -> the nearest bfloat16 (ties to even), as float32."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32)
    u = (u + np.uint32(0x7FFF) + ((u >> 16) & np.uint32(1))) & np.uint32(0xFFFF0000)
    return u.view(np.float32)


def _kernel_quant_model(x: np.ndarray, heads: int, extra: float):
    """The kernel's quant_row in numpy, row by row: amax of the 64 values,
    s = max(amax, 1e-12) / 127 (a true f32 division), inv = bf16(f32 1 / s),
    q = clamp(rint(bf16(x * inv)), -127, 127); the scale times the f32
    rounding of ``extra``."""
    B, T, D = x.shape
    xh = x.reshape(B, T, heads, D // heads).astype(np.float32)
    amax = np.abs(xh).max(-1)
    s = (np.maximum(amax, np.float32(1e-12)) / np.float32(127)).astype(np.float32)
    inv = _bf16_rn((np.float32(1) / s).astype(np.float32))
    y = np.rint(_bf16_rn(xh * inv[..., None]))
    q = np.clip(y, -127, 127).astype(np.int8).reshape(B, T, D)
    return q, (s * np.float32(extra)).astype(np.float32)


@pytest.mark.parametrize("extra", [1.0, float(np.log2(np.e) / 8)], ids=["K", "Q"])
def test_quant_th_is_the_kernels_row_arithmetic(extra):
    """_quant_th (the plain version's quantizer, on the CPU the reference's
    arithmetic) equals the kernel's row arithmetic bit for bit: zero rows,
    rows of large values, rows below the 1e-12 floor and ties at .5 of the
    bf16 grid included."""
    B, T, H = 2, 50, 3
    x = RNG.standard_normal((B, T, H * 64)).astype(np.float32)
    x[:, 0] = 0
    x[:, 1] *= 1000
    x[:, 2] *= 1e-20
    xt = torch.from_numpy(x).to(torch.bfloat16)
    q, s = attn_int8._quant_th(xt, H, extra)
    mq, ms = _kernel_quant_model(xt.float().numpy(), H, extra)
    np.testing.assert_array_equal(q.numpy(), mq)
    np.testing.assert_array_equal(s.numpy().view(np.int32), ms.view(np.int32))
    assert (np.abs(q.numpy()) == 127).any() and (q.numpy() == 0).any()


def test_quant_th_probe_takes_quant_th_on_cpu(no_library):
    x = torch.from_numpy(RNG.standard_normal((1, 11, 128)).astype(np.float32)).bfloat16()
    for k_path in (False, True):
        q8, s = attn_int8.quant_th_probe(x, 2, 0.5, k_path=k_path)
        ref8, ref_s = attn_int8._quant_th(x, 2, 0.5)
        assert torch.equal(q8, ref8) and torch.equal(s, ref_s)


def _c_entry_points(text: str) -> dict:
    """name -> number of parameters of each extern "C" function."""
    out = {}
    for name, params in re.findall(r'extern "C"[^(]*?(\w+)\(([^)]*)\)', text, re.S):
        out[name] = 0 if not params.strip() else params.count(",") + 1
    return out


def test_build_sources_and_entry_points():
    """One object per csrc/*.cu; the header they share enters the build's
    hash; every C entry point the sources define is bound with its number of
    arguments, and nothing else is."""
    srcs, headers = _build.sources()
    assert [p.name for p in srcs] == ["attention.cu", "attention_f32.cu", "attention_fast.cu",
                                      "attn_int8.cu", "matcher.cu"]
    assert [p.name for p in headers] == ["sm90_ptx.cuh"]
    entries = {}
    for p in srcs:
        text = p.read_text()
        for inc in re.findall(r'#include "([^"]+)"', text):
            assert inc in [h.name for h in headers], (p.name, inc)
        entries.update(_c_entry_points(text))
    assert sorted(entries) == sorted(_build._SIGNATURES)
    for name, n in entries.items():
        assert len(_build._SIGNATURES[name][0]) == n, name


def test_int8_entry_point_takes_strides_and_q_scale():
    argtypes, restype = _build._SIGNATURES["vitvs_attn_int8_fwd"]
    assert restype is ctypes.c_int
    # q, k, v, o; B, T, H; six strides; the Q scale factor; the stream
    assert argtypes == ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_long] * 6
                        + [ctypes.c_float, ctypes.c_void_p])


def _heads(shape, dtype):
    return [torch.from_numpy(RNG.standard_normal(shape).astype(np.float32)).to(dtype)
            for _ in range(3)]


@pytest.mark.parametrize("dtype,entry", [(torch.bfloat16, "vitvs_attention_fwd"),
                                         (torch.float32, "vitvs_attention_f32_fwd")])
def test_exact_attention_routes_by_dtype(no_library, dtype, entry):
    """bf16 inputs go to the exact kernel, f32 ones to the f32 kernel (the
    f32 step's attention, fault 3.4), each with its own launch count."""
    q, k, v = _heads((2, 37, 3, 64), dtype)
    assert attention.exact_entry(q, k, v) == entry
    counters = (attention.mha_attention.launches, attention.mha_attention_f32.launches)
    out = attention.mha_attention(q, k, v)      # CPU tensors: the plain version
    assert out.dtype == dtype and out.shape == q.shape
    assert (attention.mha_attention.launches, attention.mha_attention_f32.launches) == counters


@pytest.mark.parametrize("case", ["float16", "float64", "mixed", "head_dim_32", "shape_mismatch",
                                  "not_contiguous", "unaligned"])
def test_exact_attention_refuses_what_neither_kernel_reads(no_library, case):
    """Refused before any launch: a dtype other than bf16 and f32, mixed
    dtypes, a head dim other than 64, mismatched shapes, strided or
    unaligned rows."""
    q, k, v = _heads((1, 20, 2, 64), torch.float32)
    err = ValueError
    if case in ("float16", "float64"):
        q, k, v = (x.to(getattr(torch, case)) for x in (q, k, v))
        err = TypeError
    elif case == "mixed":
        k, err = k.bfloat16(), TypeError
    elif case == "head_dim_32":
        q, k, v = _heads((1, 20, 4, 32), torch.float32)
    elif case == "shape_mismatch":
        v = v[:, :-1].contiguous()
    elif case == "not_contiguous":
        q = q.transpose(1, 2).contiguous().transpose(1, 2)
    else:                                       # one float (4 bytes) into a buffer
        buf = torch.zeros(20 * 2 * 64 + 1)
        q = buf[1:].view(1, 20, 2, 64)
    with pytest.raises(err):
        attention.exact_entry(q, k, v)
    with pytest.raises((TypeError, ValueError)):
        attention._check(q, k, v, q.dtype)      # and never a CPU tensor


@pytest.mark.parametrize("t1,t2,d,want", [
    (484, 484, 3456, (64, 8, 448)),             # the main path: 64 clusters, 512 CTAs
    (1, 1, 1, (8, 1, 32)),                      # one chunk: ranks 1-7 take none
    (33, 65, 3, (16, 1, 32)),
    (65, 33, 97, (8, 2, 32)),                   # four chunks, the last one ragged
    (100, 37, 100, (8, 2, 32)),
    (485, 485, 130, (64, 8, 32)),               # 5 chunks: 1 a rank, ranks 5-7 none
    (484, 484, 3460, (64, 8, 448)),             # 109 chunks: 14 a rank, 11 in the last
    (1369, 700, 6912, (88, 22, 864)),
])
def test_f32_matcher_launch_splits_depth_over_a_cluster(t1, t2, d, want):
    """One cluster of 8 CTAs per 64 x 64 tile along grid x; each CTA a
    slice of d in whole 32-deep chunks that together cover d with less
    than one chunk a rank to spare (the kernel zero-fills past d)."""
    gx, gy, d_slice = matcher.f32_launch(t1, t2, d)
    assert (gx, gy, d_slice) == want
    assert gx % matcher.F32_CLUSTER == 0
    tiles = gx // matcher.F32_CLUSTER
    assert tiles * matcher.F32_TILE >= t2 > (tiles - 1) * matcher.F32_TILE
    assert gy * matcher.F32_TILE >= t1 > (gy - 1) * matcher.F32_TILE
    assert d_slice % matcher.F32_CHUNK == 0
    assert matcher.F32_CLUSTER * d_slice >= d > matcher.F32_CLUSTER * (d_slice - matcher.F32_CHUNK)


def test_f32_matcher_kernel_constants_match_the_wrapper():
    """csrc/matcher.cu refuses launch arguments from other tile constants:
    the wrapper's must be the kernel's."""
    text = (_build.CSRC_DIR / "matcher.cu").read_text()
    consts = {k: int(v) for k, v in re.findall(r"constexpr int (F\w+) = (\d+);", text)}
    assert (consts["FT"], consts["FCL"], consts["FDK"]) == (
        matcher.F32_TILE, matcher.F32_CLUSTER, matcher.F32_CHUNK)


def test_f32_attention_kernel_constants_match_the_wrapper():
    """csrc/attention_f32.cu is built for one head dim, the one the wrapper
    lets through."""
    text = (_build.CSRC_DIR / "attention_f32.cu").read_text()
    consts = {k: int(v) for k, v in re.findall(r"constexpr int (\w+) = (\d+);", text)}
    assert consts["HD"] == attention.HEAD_DIM


def test_f32_matcher_takes_plain_version_on_cpu(no_library):
    """CPU tensors of any float dtype: the plain version, no launch."""
    a, b = (torch.from_numpy(RNG.standard_normal((9, 13)).astype(np.float32)) for _ in range(2))
    before = matcher.dual_argmax_cosine.launches
    for x, y in ((a, b), (a.bfloat16(), b.bfloat16())):
        got = matcher.dual_argmax_cosine(x, y)
        ref = matcher.dual_argmax_cosine_plain(x, y)
        assert all(torch.equal(g, r) for g, r in zip(got, ref))
    assert matcher.dual_argmax_cosine.launches == before


def test_matcher_key_scratch_is_kept_per_device_and_grown():
    """The kernels' key scratch: zero, reused while large enough, replaced by
    a larger zero buffer when a launch needs more."""
    matcher._keys_scratch.clear()
    cpu = torch.device("cpu")
    first = matcher._keys(cpu, 10)
    assert first.dtype == torch.int64 and first.numel() == 10 and not first.any()
    assert matcher._keys(cpu, 7) is first
    bigger = matcher._keys(cpu, 11)
    assert bigger is not first and bigger.numel() == 11 and not bigger.any()
    assert matcher._keys(cpu, 11) is bigger
    matcher._keys_scratch.clear()
