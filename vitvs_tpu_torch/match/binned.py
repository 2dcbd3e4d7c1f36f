"""Log-binned similarity without binned descriptors, and int8 log-binned
descriptors quantized at the source (``vitvs_tpu/match/binned.py``).

The hierarchy-1 log-binned descriptor (``models/extractor.py:log_bin``) is
the concatenation of 9 edge-clamped spatial shifts of the base features.
So its per-row amax is the max of the 9 shifted base amaxes: the int8
binned rows are written from the (t, D) base descriptors in one pass, and
the (t, 9D) binned tensor in the compute dtype never exists; the quantized
values equal quantizing the materialized binned rows on the same grid.

And its dot product factorizes over the shifts: the binned similarity of
patches p and q is the sum over the 9 shifts b of S0[sig_b(p), sig_b(q)],
S0 the unbinned product, and the binned squared norm the shift-sum of the
unbinned ones.  :func:`binned_cosine_similarity` (``ServoModel.fast_binned_match``)
takes one (t, d) x (d, t) product and 9 slices of its edge-padded
(gh, gw, gh, gw) view: 9x fewer multiply-adds than matching the 9d-wide
rows.  Equal to the materialized path up to float association.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from vitvs_tpu_torch.ops.attn_int8 import INV127
from vitvs_tpu_torch.ops.int_mm import int8_matmul_nt


class QuantizedBinned(NamedTuple):
    """int8 hierarchy-1 log-binned descriptors: ``q`` holds
    ``round(binned_row * 127 / amax(binned_row))`` and ``nq`` the per-row
    sum of squares; every per-row scale cancels in the cosine.  A chunk of
    B frames' has a leading B on both."""

    q: torch.Tensor    # (t, 9D) int8
    nq: torch.Tensor   # (t,) float32


def _edge_pad(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Pad the grid axes ``dim`` and ``dim + 1`` by one, repeating the edge."""
    for d in (dim, dim + 1):
        n = x.shape[d]
        x = torch.cat([x.narrow(d, 0, 1), x, x.narrow(d, n - 1, 1)], dim=d)
    return x


def quantize_binned_int8(base: torch.Tensor, grid: tuple[int, int]) -> QuantizedBinned:
    """UNBINNED (t, D) descriptors, or a chunk's (B, t, D) -> int8 binned
    descriptors (t, 9D), or (B, t, 9D); each item is its frame alone.

    Bin order (dy outer, dx inner over -1, 0, 1) and edge clamping match
    ``log_bin`` at hierarchy 1.  The inverse scale is rounded to the
    descriptors' dtype and the rescale runs in it, as in JAX."""
    *lead, t, D = base.shape
    gh, gw = grid
    if t != gh * gw:
        raise ValueError(f"{t} descriptors do not fit the {gh}x{gw} grid")
    x = base.reshape(*lead, gh, gw, D)
    a_p = _edge_pad(x.abs().amax(-1).float(), -2)             # (..., gh + 2, gw + 2)
    amax9 = torch.zeros(*lead, gh, gw, dtype=torch.float32, device=base.device)
    for dy in (0, 1, 2):
        for dx in (0, 1, 2):
            amax9 = torch.maximum(amax9, a_p[..., dy:dy + gh, dx:dx + gw])
    inv = (127.0 / torch.clamp(amax9, min=1e-12)).to(base.dtype)[..., None]
    xp = _edge_pad(x, -3)
    parts = [torch.clamp(torch.round(xp[..., dy:dy + gh, dx:dx + gw, :] * inv), -127, 127)
             .to(torch.int8) for dy in (0, 1, 2) for dx in (0, 1, 2)]
    q = torch.cat(parts, dim=-1).reshape(*lead, t, 9 * D)
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


def _product_f32(rows: torch.Tensor, goal: torch.Tensor) -> torch.Tensor:
    """(M, d) x (t, d) -> (M, t) f32 dot products, the reference's
    ``preferred_element_type=f32`` product: bf16 operands on the card through
    cuBLAS's bf16 GEMM with an f32 output (``torch.mm(..., out_dtype=)``),
    never a TF32 product of f32 copies; elsewhere (and for f32 operands) the
    f32 product of the exactly upcast operands."""
    if rows.is_cuda and rows.dtype in (torch.bfloat16, torch.float16):
        return torch.mm(rows, goal.T, out_dtype=torch.float32)
    return rows.float() @ goal.float().T


def binned_cosine_similarity(desc_a: torch.Tensor, desc_b: torch.Tensor,
                             grid: tuple[int, int], int8: bool = False) -> torch.Tensor:
    """Cosine similarity of hierarchy-1 log-binned descriptors from the
    UNBINNED ones: goal ``desc_a`` (t, d) against one frame's ``desc_b``
    (t, d) -> (t, t) f32, or a chunk's (B, t, d) -> (B, t, t) from one
    product, entry [.., i, j] goal patch i against frame patch j.

    Float: the f32 product of the rows (:func:`_product_f32`) and f32 norms.
    ``int8``: both sets quantized per row (``quantize_rows_int8``), the exact
    int32 product scaled by the goal's then the frame's row scales, norms of
    the dequantized rows.  The 9 edge-padded slices of the product and of
    the norms are summed from zeros in log_bin's order (dy outer, dx inner),
    then scaled by rsqrt(n + 1e-24), the goal's then the frame's
    (``vitvs_tpu/match/binned.py:117-170``)."""
    single = desc_b.dim() == 2
    frames = desc_b[None] if single else desc_b
    B, t, d = frames.shape
    gh, gw = grid
    if t != gh * gw or desc_a.shape[0] != t:
        raise ValueError(f"{desc_a.shape[0]} and {t} descriptors do not fit the {gh}x{gw} grid")
    rows = frames.reshape(B * t, d)
    if int8:
        qa, sa = quantize_rows_int8(desc_a)                          # (t, d), (t, 1)
        qb, sb = quantize_rows_int8(rows)                            # (B t, d), (B t, 1)
        s0 = int8_matmul_nt(qb, qa).float() * sa.reshape(1, -1) * sb
        n0a = torch.square(qa.float() * sa).sum(-1)
        n0b = torch.square(qb.float() * sb).sum(-1)
    else:
        s0 = _product_f32(rows, desc_a)                             # (B t, t)
        n0a = torch.square(desc_a.float()).sum(-1)
        n0b = torch.square(rows.float()).sum(-1)
    # frame patches on the first grid pair, goal patches on the second: the
    # shifts move both alike, so the sums are those of the (goal, frame) view
    s4p = _edge_pad(_edge_pad(s0.reshape(B, gh, gw, gh, gw), 1), 3)
    na4 = _edge_pad(n0a.reshape(gh, gw), 0)
    nb4 = _edge_pad(n0b.reshape(B, gh, gw), 1)
    s = torch.zeros(B, gh, gw, gh, gw, dtype=torch.float32, device=s0.device)
    na = torch.zeros(gh, gw, dtype=torch.float32, device=s0.device)
    nb = torch.zeros(B, gh, gw, dtype=torch.float32, device=s0.device)
    for dy in (0, 1, 2):
        for dx in (0, 1, 2):
            s = s + s4p[:, dy:dy + gh, dx:dx + gw, dy:dy + gh, dx:dx + gw]
            na = na + na4[dy:dy + gh, dx:dx + gw]
            nb = nb + nb4[:, dy:dy + gh, dx:dx + gw]
    sim_t = (s.reshape(B, t, t) * torch.rsqrt(na.reshape(1, 1, t) + 1e-24)
             * torch.rsqrt(nb.reshape(B, t, 1) + 1e-24))
    sim = sim_t.transpose(1, 2)
    return sim[0] if single else sim


def quantize_rows_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8 quantization on the amax/127 grid -> (int8
    values, (rows, 1) f32 scales): amax times f32(1/127), as the jitted
    reference computes it; the inverse scale in x's dtype."""
    amax = x.abs().amax(-1, keepdim=True).float()
    scale = torch.clamp(amax, min=1e-12) * INV127
    q = torch.clamp(torch.round(x * (1.0 / scale).to(x.dtype)), -127, 127).to(torch.int8)
    return q, scale
