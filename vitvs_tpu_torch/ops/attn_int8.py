"""Fused int8-QK^T attention for the int8 serving ViT, natural (B, T, H*hd)
layout.

Replaces ``vitvs_tpu/ops/attn_int8.py:fused_int8_attention``, whose Pallas
kernel ``_kernel`` runs int8 QK^T, a dequantizing FMA with a -1e30 pad bias,
a no-max exp2 softmax and bf16 P.V with the score tile resident in VMEM.
As there, Q and K are quantized per (token, head) outside the kernel
(:func:`_quant_th`, plain torch), with hd^-0.5 * log2(e) folded into the Q
scales.  On the card the kernel is ``csrc/attn_int8.cu``: heads are a grid
axis, K/V stream through shared memory in 64-row tiles, the score product
runs on the int8 tensor cores and P.V on the bf16 ones.  V is read in place
with its row stride (the qkv output's column slice, no copy).  Bound on the
H100 at (1, 1370, 12 * 64): operations, 2.9 G int8 operations at 1979 TOPS
plus 2.9 GFLOP of bf16 P.V at 989 TFLOP/s, 4.4 us.

``fused_int8_attention`` launches the kernel for CUDA tensors and takes the
plain version only for CPU tensors.  ``fused_int8_attention_plain`` is the
plain version: it computes the kernel's int8 arithmetic (not exact softmax,
which the JAX function returns off the TPU unless run in interpret mode).
"""

from __future__ import annotations

import math

import torch

from vitvs_tpu_torch.ops import _build

HEAD_DIM = 64  # the kernel's head dim


def _q_extra_scale(q: torch.Tensor, heads: int) -> float:
    """hd^-0.5 * log2(e), folded into the Q scales."""
    return math.log2(math.e) / math.sqrt(q.shape[-1] // heads)


def _quant_th(x: torch.Tensor, heads: int, extra_scale: float = 1.0):
    """(B, T, H*hd) -> int8 values (B, T, H*hd) + f32 scales (B, T, H).

    Symmetric per-(token, head) quantization; ``extra_scale`` goes into the
    returned scales, not the int8 values.  The rescale and round run in x's
    dtype; round is half to even, as in JAX."""
    B, T, D = x.shape
    xh = x.reshape(B, T, heads, D // heads)
    amax = xh.abs().amax(-1).float()                           # (B, T, H)
    s = torch.clamp(amax, min=1e-12) / 127.0
    inv = (1.0 / s).to(x.dtype)
    q = torch.clamp(torch.round(xh * inv[..., None]), -127, 127)
    return q.to(torch.int8).reshape(B, T, D), s * extra_scale


def _int8_attention_plain(q8, k8, v, qs, ks, heads: int, out_dtype) -> torch.Tensor:
    """The kernel's arithmetic on quantized inputs: qs, ks (B, T, H) f32."""
    B, T, D = q8.shape
    hd = D // heads
    split = lambda x: x.reshape(B, T, heads, hd).float()
    # int8 products summed over hd = 64 terms stay below 2^24: exact in f32
    acc = torch.einsum("bqhd,bkhd->bhqk", split(q8), split(k8))
    s = (acc * qs.transpose(1, 2)[..., None]) * ks.transpose(1, 2)[:, :, None, :]
    e = torch.exp2(s)
    denom = e.sum(-1)                                          # (B, H, T)
    num = torch.einsum("bhqk,bkhd->bqhd", e.to(v.dtype).float(), split(v))
    out = num * (1.0 / denom).transpose(1, 2)[..., None]
    return out.to(out_dtype).reshape(B, T, D)


def fused_int8_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                               heads: int) -> torch.Tensor:
    """softmax(Q K^T / sqrt(hd)) V with per-(token, head) int8 Q/K, no-max
    exp2 and P rounded to v's dtype: (B, T, H*hd) -> (B, T, H*hd) in q's dtype."""
    q8, qs = _quant_th(q, heads, _q_extra_scale(q, heads))
    k8, ks = _quant_th(k, heads)
    return _int8_attention_plain(q8, k8, v, qs, ks, heads, q.dtype)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int) -> None:
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError(f"int8 attention kernel runs on CUDA tensors; q, k, v are on "
                         f"{q.device}, {k.device}, {v.device}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"int8 attention kernel takes bfloat16, {name} is {t.dtype}")
        if t.shape != q.shape:
            raise ValueError(f"{name} shape {tuple(t.shape)} != q shape {tuple(q.shape)}")
    if q.dim() != 3 or q.shape[1] < 1 or q.shape[2] != heads * HEAD_DIM:
        raise ValueError(f"int8 attention kernel takes (B, T, {heads} * {HEAD_DIM}), "
                         f"got {tuple(q.shape)}")
    if v.stride(2) != 1 or v.stride(1) % 8 or v.stride(0) % 8 or v.data_ptr() % 16:
        raise ValueError(f"v rows must be 16-byte aligned with unit column stride, "
                         f"strides {v.stride()}")


def fused_int8_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         heads: int) -> torch.Tensor:
    """(B, T, H*hd) q, k, v (column slices of the qkv output may be passed
    as they are) -> (B, T, H*hd) attention output in q's dtype.

    CUDA tensors: quantize Q/K here, then the kernel (bf16, hd = 64), or an
    error.  CPU tensors: :func:`fused_int8_attention_plain`.
    """
    if q.device.type == "cpu":
        return fused_int8_attention_plain(q, k, v, heads)
    _check(q, k, v, heads)
    q8, qs = _quant_th(q, heads, _q_extra_scale(q, heads))
    k8, ks = _quant_th(k, heads)
    out = _launch(q8, k8, v, qs, ks.transpose(1, 2).contiguous(), heads)
    fused_int8_attention.launches += 1
    return out


def _launch(q8, k8, v, qs, ks_t, heads: int) -> torch.Tensor:
    """The kernel on quantized inputs: q8, k8 (B, T, D) int8 contiguous,
    v bf16 rows at unit column stride, qs (B, T, H) and ks_t (B, H, T) f32
    contiguous -> (B, T, D) bf16."""
    B, T, D = q8.shape
    out = torch.empty((B, T, D), dtype=v.dtype, device=v.device)
    lib = _build.library()
    with torch.cuda.device(v.device):
        err = lib.vitvs_attn_int8_fwd(
            q8.data_ptr(), k8.data_ptr(), v.data_ptr(), qs.data_ptr(), ks_t.data_ptr(),
            out.data_ptr(), B, T, heads, v.stride(0), v.stride(1),
            torch.cuda.current_stream(v.device).cuda_stream)
    _build.check(err, "int8 attention")
    return out


fused_int8_attention.launches = 0
