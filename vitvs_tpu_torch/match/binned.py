"""int8 log-binned descriptors quantized at the source
(``vitvs_tpu/match/binned.py``).

The hierarchy-1 log-binned descriptor (``models/extractor.py:log_bin``) is
the concatenation of 9 edge-clamped spatial shifts of the base features, so
its per-row amax is the max of the 9 shifted base amaxes: the int8 binned
rows are written from the (t, D) base descriptors in one pass, and the
(t, 9D) binned tensor in the compute dtype never exists.  The quantized
values equal quantizing the materialized binned rows on the same grid.

``binned_cosine_similarity`` and ``fast_binned_match`` (the factorized
similarity) are not ported: the serving step does not run them (ROADMAP.md
queue 1, item 3).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from vitvs_tpu_torch.ops.attn_int8 import INV127


class QuantizedBinned(NamedTuple):
    """int8 hierarchy-1 log-binned descriptors: ``q`` holds
    ``round(binned_row * 127 / amax(binned_row))`` and ``nq`` the per-row
    sum of squares; every per-row scale cancels in the cosine."""

    q: torch.Tensor    # (t, 9D) int8
    nq: torch.Tensor   # (t,) float32


def _edge_pad(x: torch.Tensor) -> torch.Tensor:
    """Pad the two leading (grid) axes by one, repeating the edge."""
    x = torch.cat([x[:1], x, x[-1:]], dim=0)
    return torch.cat([x[:, :1], x, x[:, -1:]], dim=1)


def quantize_binned_int8(base: torch.Tensor, grid: tuple[int, int]) -> QuantizedBinned:
    """UNBINNED (t, D) descriptors -> int8 binned descriptors.

    Bin order (dy outer, dx inner over -1, 0, 1) and edge clamping match
    ``log_bin`` at hierarchy 1.  The inverse scale is rounded to the
    descriptors' dtype and the rescale runs in it, as in JAX."""
    t, D = base.shape
    gh, gw = grid
    if t != gh * gw:
        raise ValueError(f"{t} descriptors do not fit the {gh}x{gw} grid")
    x = base.reshape(gh, gw, D)
    a_p = _edge_pad(x.abs().amax(-1).float())                  # (gh + 2, gw + 2)
    amax9 = torch.zeros(gh, gw, dtype=torch.float32, device=base.device)
    for dy in (0, 1, 2):
        for dx in (0, 1, 2):
            amax9 = torch.maximum(amax9, a_p[dy:dy + gh, dx:dx + gw])
    inv = (127.0 / torch.clamp(amax9, min=1e-12)).to(base.dtype)[..., None]
    xp = _edge_pad(x)
    parts = [torch.clamp(torch.round(xp[dy:dy + gh, dx:dx + gw] * inv), -127, 127)
             .to(torch.int8) for dy in (0, 1, 2) for dx in (0, 1, 2)]
    q = torch.cat(parts, dim=-1).reshape(t, 9 * D)
    nq = torch.square(q.float()).sum(-1)
    return QuantizedBinned(q=q, nq=nq)


def _shift_maps(grid: tuple[int, int]) -> np.ndarray:
    """(9, t) int32: clamped raveled index of each patch shifted by each of
    the 3x3 offsets (row-major offset order, matching log_bin)."""
    gh, gw = grid
    rows, cols = np.meshgrid(np.arange(gh), np.arange(gw), indexing="ij")
    maps = []
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            r = np.clip(rows + dy, 0, gh - 1)
            c = np.clip(cols + dx, 0, gw - 1)
            maps.append((r * gw + c).reshape(-1))
    return np.stack(maps).astype(np.int32)


def quantize_rows_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8 quantization on the amax/127 grid -> (int8
    values, (rows, 1) f32 scales): amax times f32(1/127), as the jitted
    reference computes it; the inverse scale in x's dtype."""
    amax = x.abs().amax(-1, keepdim=True).float()
    scale = torch.clamp(amax, min=1e-12) * INV127
    q = torch.clamp(torch.round(x * (1.0 / scale).to(x.dtype)), -127, 127).to(torch.int8)
    return q, scale
