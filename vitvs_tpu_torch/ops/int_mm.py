"""int8 x int8 -> int32 matrix products, the XLA int8 matmuls of the JAX
package (the W8A8 projections of ``models/quant.py`` and the int8 cosine
similarity of the matcher), outside any kernel of this repository.

``torch._int_mm`` runs them: oneDNN on the CPU, cuBLASLt on the card.  The
card's version takes M > 16 and K, N multiples of 8, so zero rows and
columns pad the operands there and the product is sliced back (zeros add
nothing to an integer sum).

The batched int8 products of the int8-probability attention modes ('pv',
'qk+pv': ``bhqd,bhkd`` and ``bhqk,bhkd`` with int32 accumulation) have no
batched int8 GEMM in PyTorch; :func:`int8_bmm` runs them as f32 batched
products over depth chunks short enough that every partial sum is an
integer f32 holds exactly, so the result equals the integer product on
either device, whatever order the GEMM sums in.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

# int8 products are at most 128 * 128 = 2^14 in magnitude, so a sum of 1024 of
# them stays within 2^24: every partial sum of an f32 product over that depth is
# an integer f32 represents exactly (the inputs too are exact in f32, TF32 and bf16)
EXACT_F32_DEPTH = 1024


def int8_matmul_nt(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 x (N, K) int8 -> (M, N) int32, a @ b^T, exact."""
    M, K = a.shape
    N = b.shape[0]
    if a.device.type == "cuda":
        pm, pk, pn = max(17 - M, 0), -K % 8, -N % 8
        a = F.pad(a, (0, pk, 0, pm)) if pm or pk else a
        b = F.pad(b, (0, pk, 0, pn)) if pk or pn else b
        return torch._int_mm(a.contiguous(), b.contiguous().t())[:M, :N]
    return torch._int_mm(a, b.t())


def int8_bmm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., M, K) int8 x (..., K, N) int8 -> (..., M, N) int32, a @ b,
    exact: f32 batched products over depth chunks of EXACT_F32_DEPTH, each
    converted to int32 and summed there."""
    out = None
    for k0 in range(0, a.shape[-1], EXACT_F32_DEPTH):
        part = torch.matmul(a[..., k0:k0 + EXACT_F32_DEPTH].float(),
                            b[..., k0:k0 + EXACT_F32_DEPTH, :].float()).to(torch.int32)
        out = part if out is None else out + part
    return out
