"""Multi-head softmax attention for the ViT, (B, T, h, d) layout.

Replaces ``vitvs_tpu/ops/attention.py:mha_attention``.  fast=False: the
Pallas kernel ``_flash_kernel`` scores each Q tile against the whole K/V in
VMEM.  On the card the kernel is ``csrc/attention.cu``: wgmma on the bf16
tensor cores with the scores and P in registers, K/V in 128-byte-swizzled
shared memory (the whole K/V of a head at T <= 512, a cp.async ring beyond),
a running row max, and key groups of warpgroups merged at the end.  Bound on
the H100 at (1, 485, 6, 64): bytes, 4 x 372 KB in 0.44 us at 3.35 TB/s
(0.36 GFLOP take 0.37 us on the tensor cores).  f32 inputs (the f32 servo
step) go to ``csrc/attention_f32.cu`` (:func:`mha_attention_f32`, its own
launch count): the same softmax with f32-accurate products on the tensor
cores, split-precision TF32 (3 passes: each operand split into a TF32 hi
and an exact f32 lo = x - hi, products hi.hi + hi.lo + lo.hi on wgmma);
not the one-pass TF32 mode that ``ServoModel.create`` turns off for cuBLAS.
Raw K/V chunks stream through a cp.async ring and are split (V transposed)
in shared memory; clusters of blocks split the keys when 128-row blocks
alone would leave SMs idle.  Bound at (1, 485, 6, 64) f32: operations, 3 x
0.361 GFLOP in 2.19 us at the TF32 peak of 495 TFLOP/s (2.98 MB move in
0.9 us).

fast=True: the no-max, deferred-normalize serving kernel ``_fast_kernel``
(bounded logits).  Q is scaled by hd^-0.5 * log2(e) in Q's dtype before
the kernel, exactly as the JAX package does, and the kernel
(``csrc/attention_fast.cu``) applies exp2 to the scores without a row max,
zeroes padded columns and multiplies the output by 1/denom; its products
are wgmma on the bf16 tensor cores with the scores and P in registers, and
K/V stream through a cp.async ring.  Bound at (1, 1370, 12, 64):
operations, 5.77 GFLOP in 5.8 us on the tensor cores.  It keeps its own entry point and launch count
(``mha_attention_fast``).

Head widths other than 64 (the pixel baselines' one head of width 3 P^2)
go to ``csrc/attention_hd.cu`` (:func:`mha_attention_hd` for bf16,
:func:`mha_attention_hd_f32` for f32, each its own launch count): exact
softmax at any width from 1 to 1024 in f32 FMA on the CUDA cores, a grid
over (batch x head, 64-row Q tile, 64-wide slice of the output's head
dims), each block computing the full scores over every head dim and P.V
for its slice.  Bound at (1, 485, 1, 588) bf16 (pixel14 @ 308): bytes,
4 x 570 KB in 0.68 us.  The no-max kernel and the int8 kernel take 64 only
and refuse other widths (ValueError).

``mha_attention`` launches a kernel for CUDA tensors (bf16: the exact
kernel, f32: the f32 kernel, at head width 64; the any-width kernel at
other widths; any other dtype raises) and takes the plain version only for
CPU tensors; ``mha_attention_plain`` and ``mha_attention_fast_plain`` are
the plain versions, which the CPU tests and the card's reference pass call
directly.
"""

from __future__ import annotations

import math

import torch

from vitvs_tpu_torch.ops import _build

HEAD_DIM = 64  # the kernel's head dim (ViT-S/B/L/14 all use 64)
HD_MAX = 1024  # the widest head of the any-width kernel (csrc/attention_hd.cu)
LOG2E = math.log2(math.e)


def mha_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T * d^-0.5) v with f32 logits and softmax; the
    probabilities are rounded to v's dtype before P.V, as on the TPU."""
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.float(), v.float())
    return out.to(q.dtype)


def _fast_scaled_q(q: torch.Tensor) -> torch.Tensor:
    """Q * (hd^-0.5 log2 e), the constant rounded to Q's dtype first and
    the product rounded to it, as JAX multiplies by a weakly typed scalar
    (a Python number: no device copy)."""
    return q * torch.tensor(q.shape[-1] ** -0.5 * LOG2E, dtype=q.dtype).item()


def mha_attention_fast_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The no-max kernel's arithmetic: f32 scores of the pre-scaled Q,
    exp2 without a row max, f32 row sums, the numerators rounded to v's
    dtype before P.V, and 1/denom on the output."""
    s = torch.einsum("bqhd,bkhd->bhqk", _fast_scaled_q(q).float(), k.float())
    e = torch.exp2(s)
    denom = e.sum(-1)                                              # (B, h, T)
    num = torch.einsum("bhqk,bkhd->bqhd", e.to(v.dtype).float(), v.float())
    return (num * (1.0 / denom).transpose(1, 2)[..., None]).to(q.dtype)


def _check_layout(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  dtype: torch.dtype = torch.bfloat16, head_dim: int | None = HEAD_DIM) -> None:
    """What a kernel reads, on any device: (B, T, h, ``head_dim``) ``dtype``
    tensors of one shape on one device, contiguous, 16-byte aligned;
    ``head_dim`` None: any width from 1 to HD_MAX (the any-width kernel,
    which reads element by element and needs no more than the dtype's own
    alignment: the k and v of a qkv split start mid-row there)."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != dtype:
            raise TypeError(f"attention kernel takes {dtype}, {name} is {t.dtype}")
        if t.shape != q.shape:
            raise ValueError(f"{name} shape {tuple(t.shape)} != q shape {tuple(q.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if head_dim is not None and t.data_ptr() % 16:
            raise ValueError(f"{name} must start 16-byte aligned")
    if head_dim is None:
        if q.dim() != 4 or not 1 <= q.shape[-1] <= HD_MAX or q.shape[1] < 1:
            raise ValueError(f"attention kernel takes (B, T, h, d) with 1 <= d <= {HD_MAX}, "
                             f"got {tuple(q.shape)}")
    elif q.dim() != 4 or q.shape[-1] != head_dim or q.shape[1] < 1:
        raise ValueError(f"attention kernel takes (B, T, h, {head_dim}), got {tuple(q.shape)}")


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           dtype: torch.dtype = torch.bfloat16, head_dim: int | None = HEAD_DIM) -> None:
    _check_layout(q, k, v, dtype, head_dim)
    if q.device.type != "cuda":
        raise ValueError(f"attention kernel runs on CUDA tensors, q is on {q.device}")


# the exact kernels' C entry points by input dtype: at head width 64, and at any other
EXACT_ENTRIES = {torch.bfloat16: "vitvs_attention_fwd", torch.float32: "vitvs_attention_f32_fwd"}
HD_ENTRIES = {torch.bfloat16: "vitvs_attention_hd_fwd",
              torch.float32: "vitvs_attention_hd_f32_fwd"}


def exact_entry(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """The C entry point :func:`mha_attention` launches for these inputs
    (their layout checked, on any device), or an error: TypeError for a
    dtype no kernel takes, ValueError for a layout they cannot read."""
    if q.dtype not in EXACT_ENTRIES:
        raise TypeError(f"exact attention kernels take {list(EXACT_ENTRIES)}, q is {q.dtype}")
    if q.dim() == 4 and q.shape[-1] != HEAD_DIM:
        _check_layout(q, k, v, q.dtype, head_dim=None)
        return HD_ENTRIES[q.dtype]
    _check_layout(q, k, v, q.dtype)
    return EXACT_ENTRIES[q.dtype]


# the exact kernel's work splits (csrc/attention.cu), which vitvs_attention_fwd
# picks between by the grid's size; named to time each (chip_smoke.py)
EXACT_SPLITS = {"64-row": 1, "128-row": 2}


def _launch(entry: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            *extra) -> torch.Tensor:
    """One kernel launch on inputs that passed :func:`_check` (``extra``:
    the arguments after B, T, H: the work split of
    ``vitvs_attention_split_fwd``, the head width and scale of the any-width
    kernel)."""
    B, T, H, _ = q.shape
    out = torch.empty_like(q)
    lib = _build.library()
    with torch.cuda.device(q.device):
        err = getattr(lib, entry)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, T, H, *extra,
            torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, entry)
    return out


def mha_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  fast: bool = False) -> torch.Tensor:
    """(B, T, h, d) -> (B, T, h, d) softmax attention, scale d^-0.5.

    fast=True goes to :func:`mha_attention_fast`.  Otherwise CUDA tensors:
    the exact kernel (bf16, d = 64, contiguous), the f32 kernel for f32
    ones (:func:`mha_attention_f32`), the any-width kernel at d != 64
    (:func:`mha_attention_hd`, :func:`mha_attention_hd_f32`), or an error;
    CPU tensors: :func:`mha_attention_plain`.
    """
    _build.refuse_grad("mha_attention", q, k, v)
    if fast:
        return mha_attention_fast(q, k, v)
    if q.device.type == "cpu":
        return mha_attention_plain(q, k, v)
    entry = exact_entry(q, k, v)
    if entry == HD_ENTRIES[torch.bfloat16]:
        return mha_attention_hd(q, k, v)
    if entry in (EXACT_ENTRIES[torch.float32], HD_ENTRIES[torch.float32]):
        return mha_attention_f32(q, k, v)
    _check(q, k, v)
    out = _launch("vitvs_attention_fwd", q, k, v)
    mha_attention.launches += 1
    return out


def mha_attention_f32(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Exact attention in f32 (the f32 servo step).

    CUDA tensors: the f32 kernel (f32, d = 64, contiguous), the any-width
    kernel at d != 64 (:func:`mha_attention_hd_f32`), or an error; CPU
    tensors: :func:`mha_attention_plain`.
    """
    _build.refuse_grad("mha_attention_f32", q, k, v)
    if q.device.type == "cpu":
        return mha_attention_plain(q, k, v)
    if q.dim() == 4 and q.shape[-1] != HEAD_DIM:
        return mha_attention_hd_f32(q, k, v)
    _check(q, k, v, torch.float32)
    out = _launch("vitvs_attention_f32_fwd", q, k, v)
    mha_attention_f32.launches += 1
    return out


def _attention_hd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  dtype: torch.dtype) -> torch.Tensor:
    """One launch of the any-width kernel on ``dtype`` CUDA tensors (checked
    first), the scale d^-0.5 of the true head width as f32."""
    _check(q, k, v, dtype, head_dim=None)
    return _launch(HD_ENTRIES[dtype], q, k, v, q.shape[-1], q.shape[-1] ** -0.5)


def mha_attention_hd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Exact attention at any head width from 1 to 1024, bf16.

    CUDA tensors: the any-width kernel (bf16, contiguous), or an error; CPU
    tensors: :func:`mha_attention_plain`.
    """
    _build.refuse_grad("mha_attention_hd", q, k, v)
    if q.device.type == "cpu":
        return mha_attention_plain(q, k, v)
    out = _attention_hd(q, k, v, torch.bfloat16)
    mha_attention_hd.launches += 1
    return out


def mha_attention_hd_f32(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Exact attention at any head width from 1 to 1024, f32.

    CUDA tensors: the any-width kernel (f32, contiguous), or an error; CPU
    tensors: :func:`mha_attention_plain`.
    """
    _build.refuse_grad("mha_attention_hd_f32", q, k, v)
    if q.device.type == "cpu":
        return mha_attention_plain(q, k, v)
    out = _attention_hd(q, k, v, torch.float32)
    mha_attention_hd_f32.launches += 1
    return out


def mha_attention_fast(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """No-max, deferred-normalize attention (bounded logits).

    CUDA tensors: the no-max kernel on Q pre-scaled by d^-0.5 log2(e), or an
    error; CPU tensors: :func:`mha_attention_fast_plain`.
    """
    _build.refuse_grad("mha_attention_fast", q, k, v)
    if q.device.type == "cpu":
        return mha_attention_fast_plain(q, k, v)
    _check(q, k, v)
    out = _launch("vitvs_attention_fast_fwd", _fast_scaled_q(q), k, v)
    mha_attention_fast.launches += 1
    return out


mha_attention.launches = 0
mha_attention_f32.launches = 0
mha_attention_fast.launches = 0
mha_attention_hd.launches = 0
mha_attention_hd_f32.launches = 0
