"""int8 x int8 -> int32 matrix products, the XLA int8 matmuls of the JAX
package (the W8A8 projections of ``models/quant.py`` and the int8 cosine
similarity of the matcher), outside any kernel of this repository.

``torch._int_mm`` runs them: oneDNN on the CPU, cuBLASLt on the card.  The
card's version takes M > 16 and K, N multiples of 8, so zero rows and
columns pad the operands there and the product is sliced back (zeros add
nothing to an integer sum).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


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
