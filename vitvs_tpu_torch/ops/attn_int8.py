"""Fused int8-QK^T attention for the int8 serving ViT, natural (B, T, H*hd)
layout.

Replaces ``vitvs_tpu/ops/attn_int8.py:fused_int8_attention``, whose Pallas
kernel ``_kernel`` runs int8 QK^T, a dequantizing FMA with a -1e30 pad bias,
a no-max exp2 softmax and bf16 P.V with the score tile resident in VMEM,
after Q and K are quantized per (token, head) (:func:`_quant_th`, with
hd^-0.5 * log2(e) folded into the Q scales).  On the card one launch of
``csrc/attn_int8.cu`` does all of it: the kernel reads the bf16 q, k, v
column slices of the qkv output in place at their strides, quantizes Q and
K itself in ``_quant_th``'s arithmetic, runs the score product on the int8
tensor cores (wgmma s8) and P.V on the bf16 ones; heads are a grid axis and
K/V stream through shared memory.  Bound on the H100 at (1, 1370, 12 * 64):
operations, 2.9 G int8 operations at 1979 TOPS plus 2.9 GFLOP of bf16 P.V
at 989 TFLOP/s, 4.4 us.

``fused_int8_attention`` launches the kernel for CUDA tensors and takes the
plain version only for CPU tensors.  ``fused_int8_attention_plain`` is the
plain version: it computes the kernel's int8 arithmetic (not exact softmax,
which the JAX function returns off the TPU unless run in interpret mode).
``quant_th_probe`` runs the kernel's own quantization on a matrix, so that
it can be held to :func:`_quant_th` bit for bit.
"""

from __future__ import annotations

import math
import struct

import torch

from vitvs_tpu_torch.ops import _build

HEAD_DIM = 64  # the kernel's head dim
# f32(1/127): the jitted reference's quantizers divide by 127.0, which XLA
# rewrites as a multiply by this reciprocal (ROADMAP.md fault 3.5)
INV127 = 0.007874015718698502


def _q_extra_scale(q: torch.Tensor, heads: int) -> float:
    """hd^-0.5 * log2(e), folded into the Q scales."""
    return math.log2(math.e) / math.sqrt(q.shape[-1] // heads)


def _f32(x: float) -> float:
    """``x`` rounded to the nearest f32."""
    return struct.unpack("f", struct.pack("f", x))[0]


def _scale_factor(extra_scale: float) -> float:
    """f32(f32(1/127) * f32(extra_scale)): the factor of the clamped amax in
    :func:`_quant_th`'s returned scales (INV127 when ``extra_scale`` is 1)."""
    return _f32(INV127 * _f32(extra_scale))


def _quant_th(x: torch.Tensor, heads: int, extra_scale: float = 1.0):
    """(B, T, H*hd) -> int8 values (B, T, H*hd) + f32 scales (B, T, H).

    Symmetric per-(token, head) quantization; ``extra_scale`` goes into the
    returned scales, not the int8 values.  The arithmetic is the jitted
    reference's, on the CPU and on the card alike: s = amax * f32(1/127),
    and the returned scales amax * :func:`_scale_factor` (XLA folds the
    reference's (amax / 127) * extra_scale into one constant).  The rescale
    and round run in x's dtype; round is half to even, as in JAX."""
    B, T, D = x.shape
    xh = x.reshape(B, T, heads, D // heads)
    amax = torch.clamp(xh.abs().amax(-1).float(), min=1e-12)   # (B, T, H)
    inv = (1.0 / (amax * INV127)).to(x.dtype)
    q = torch.clamp(torch.round(xh * inv[..., None]), -127, 127)
    return q.to(torch.int8).reshape(B, T, D), amax * _scale_factor(extra_scale)


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


def _check_layout(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int) -> None:
    """What the kernel reads, on any device: bf16 (B, T, heads * 64) q, k, v
    of one shape, each at unit column stride with 16-byte aligned rows (a
    column slice of the qkv output is read in place)."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"int8 attention kernel takes bfloat16, {name} is {t.dtype}")
        if t.shape != q.shape:
            raise ValueError(f"{name} shape {tuple(t.shape)} != q shape {tuple(q.shape)}")
    if q.dim() != 3 or q.shape[1] < 1 or q.shape[2] != heads * HEAD_DIM:
        raise ValueError(f"int8 attention kernel takes (B, T, {heads} * {HEAD_DIM}), "
                         f"got {tuple(q.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if (t.stride(2) != 1 or t.data_ptr() % 16
                or any(t.stride(d) % 8 for d in (0, 1) if t.shape[d] > 1)):
            raise ValueError(f"{name} rows must be 16-byte aligned with unit column stride, "
                             f"strides {t.stride()}")


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int) -> None:
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError(f"int8 attention kernel runs on CUDA tensors; q, k, v are on "
                         f"{q.device}, {k.device}, {v.device}")
    _check_layout(q, k, v, heads)


def _kernel_args(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int) -> tuple:
    """The kernel's shape and stride arguments for inputs that passed
    :func:`_check_layout`: B, T, H, the (batch, row) strides of q, k and v
    in elements, and the factor of the Q scales, f32(1/127) hd^-0.5 log2(e)
    (:func:`_scale_factor`)."""
    B, T, _ = q.shape
    strides = [s for t in (q, k, v) for s in (t.stride(0), t.stride(1))]
    return (B, T, heads, *strides, _scale_factor(_q_extra_scale(q, heads)))


def fused_int8_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         heads: int) -> torch.Tensor:
    """(B, T, H*hd) q, k, v (column slices of the qkv output may be passed
    as they are) -> (B, T, H*hd) attention output in q's dtype.

    CUDA tensors: one launch of the kernel, which quantizes Q and K itself
    (bf16, hd = 64), or an error.  CPU tensors:
    :func:`fused_int8_attention_plain`.
    """
    _build.refuse_grad("fused_int8_attention", q, k, v)
    if q.device.type == "cpu":
        return fused_int8_attention_plain(q, k, v, heads)
    _check(q, k, v, heads)
    out = _launch(q, k, v, heads)
    fused_int8_attention.launches += 1
    return out


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int) -> torch.Tensor:
    """The kernel on bf16 q, k, v that passed :func:`_check` -> (B, T, D) bf16."""
    out = torch.empty(q.shape, dtype=torch.bfloat16, device=q.device)
    lib = _build.library()
    with torch.cuda.device(q.device):
        err = lib.vitvs_attn_int8_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            *_kernel_args(q, k, v, heads), torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "int8 attention")
    return out


def quant_th_probe(x: torch.Tensor, heads: int, extra_scale: float = 1.0,
                   k_path: bool = False):
    """:func:`_quant_th` computed by the attention kernel's own quantizer
    (its Q path, or with ``k_path`` its K path): (B, T, H*64) bf16 -> int8
    (B, T, H*64) and f32 scales (B, T, H), the scales times
    ``extra_scale``.  CPU tensors: :func:`_quant_th`."""
    if x.device.type == "cpu":
        return _quant_th(x, heads, extra_scale)
    _check(x, x, x, heads)
    B, T, D = x.shape
    if B > 1 and x.stride(0) != T * x.stride(1):
        raise ValueError(f"the probe takes rows at one stride, strides {x.stride()}")
    q8 = torch.empty((B, T, D), dtype=torch.int8, device=x.device)
    s = torch.empty((B, T, heads), dtype=torch.float32, device=x.device)
    lib = _build.library()
    with torch.cuda.device(x.device):
        err = lib.vitvs_quant_th_probe(x.data_ptr(), q8.data_ptr(), s.data_ptr(), B * T, heads,
                                       x.stride(1), _scale_factor(extra_scale), int(k_path),
                                       torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "quantization probe")
    return q8, s


fused_int8_attention.launches = 0
