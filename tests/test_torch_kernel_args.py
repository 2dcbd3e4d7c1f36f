"""What the port's kernel wrappers hand the CUDA kernels, checked on the CPU
before any launch: the fused int8 attention kernel's layout checks, the
shapes and strides it is given for the bf16 q, k, v column slices of the
qkv output, the arithmetic of its in-kernel Q/K quantization (a numpy model
of its quantizer held to ``_quant_th``), and the build's list of sources
against the C entry points the library binds."""

import ctypes
import re

import numpy as np
import pytest
import torch

from vitvs_tpu_torch.ops import _build, attn_int8

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
    assert [p.name for p in srcs] == ["attention.cu", "attention_fast.cu", "attn_int8.cu",
                                      "matcher.cu"]
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
