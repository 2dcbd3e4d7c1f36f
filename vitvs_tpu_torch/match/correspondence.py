"""Dense patch correspondence with cyclical-consistency filtering
(``vitvs_tpu/match/correspondence.py``), fixed-size and branch-free.

The row/column nearest neighbours of float matching come from
``ops.matcher``, in the arithmetic ``use_match_kernel`` selects as the
reference's flag does: by default the reference's default (rows normalized
in their dtype, product with f32 accumulation: the bf16 mode), or with
``use_match_kernel=True`` the TPU kernel's (rows cast to f32 first: the f32
mode, which f32 descriptors take either way).  ``use_kernel`` picks the
CUDA kernel of that mode, or with ``use_kernel`` off its plain version;
CPU tensors always take the plain version.  int8 matching (``int8=True``, or
source-quantized :class:`QuantizedBinned` descriptors) takes its similarity
from :func:`cosine_similarity_matrix`, one int8 matmul of a chunk's B frames'
rows (B t, d) against the goal's, then each frame's row and column
max/argmax; it never goes through a matcher kernel.  A given similarity
(``sim_matrix``: the factorized binned path, ``match/binned.py``) is reduced
by plain max / argmax as the reference reduces it in XLA, and the subpixel
refinement then fits its parabola on that landscape.

Kept from the JAX package: first-index argmax ties; the float32
``(d - min) / (max(d - min) + 1e-8) >= threshold`` eligibility, plus perfect
cycles (d == 0) always eligible; the ``mean(sim_1) > 0.99`` same-image
shortcut as a select.  Pair sampling takes its random ``scores`` as an
input: JAX's ``jax.random.uniform(key, (t,))`` cannot be reproduced in
torch, so callers draw them (``torch.rand`` with an explicit generator) or
pass the JAX ones in a parity test.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from vitvs_tpu_torch.core.batch import item
from vitvs_tpu_torch.match.binned import QuantizedBinned, quantize_rows_int8
from vitvs_tpu_torch.ops.int_mm import int8_matmul_nt
from vitvs_tpu_torch.ops.matcher import (dual_argmax_cosine, dual_argmax_cosine_bf16,
                                         dual_argmax_cosine_bf16_plain,
                                         dual_argmax_cosine_plain, unit_rows)


class MatchResult(NamedTuple):
    """Fixed-size correspondence set; points are PATCH (row, col), f32, and
    slots with valid == False are padding (index 0's coordinates).  A chunk
    of B frames matched against one goal gives every field a leading B."""

    points1: torch.Tensor    # (k, 2) patch (row, col) in image 1 (goal)
    points2: torch.Tensor    # (k, 2) patch (row, col) in image 2 (current)
    sim: torch.Tensor        # (k,) cosine similarity of the selected pairs
    valid: torch.Tensor      # (k,) bool
    num_valid: torch.Tensor  # () int32
    same_image: torch.Tensor  # () bool


def _int8_frames_by_goal(goal_q: torch.Tensor, frames_q: torch.Tensor) -> torch.Tensor:
    """int8 goal rows (t1, d) and a chunk's frame rows (B, t2, d) -> the
    exact int32 products (B, t2, t1), as ONE (B t2, d) x (d, t1) product
    (``torch._int_mm`` is 2-D)."""
    B, t2, d = frames_q.shape
    return int8_matmul_nt(frames_q.reshape(B * t2, d), goal_q).reshape(B, t2, -1)


def cosine_similarity_matrix(desc1, desc2, int8: bool = False) -> torch.Tensor:
    """(t1, d) x (t2, d) -> (t1, t2) f32 cosine similarities.

    Rows are normalized in their dtype by f32 norms and multiplied with f32
    accumulation.  int8=True quantizes the normalized rows per row
    (``quantize_rows_int8``), multiplies in int8 and renormalizes by the
    quantized rows' norms.  :class:`QuantizedBinned` inputs: the int8
    matmul scaled by the rsqrt of the quantized rows' sums of squares (all
    per-row scales cancel)."""
    if int8 or isinstance(desc1, QuantizedBinned) or isinstance(desc2, QuantizedBinned):
        return _int8_similarity_t(desc1, item(desc2, None))[0].T
    return unit_rows(desc1).float() @ unit_rows(desc2).float().T


def _int8_similarity_t(desc1, desc2) -> torch.Tensor:
    """int8 cosine similarities of a chunk, transposed: goal (t1, d)
    against frames (B, t2, d), float rows quantized per row or
    :class:`QuantizedBinned` -> (B, t2, t1) f32, each frame's the same
    values in the same order of operations as the reference's (t1, t2)
    matrix of that frame alone."""
    if isinstance(desc1, QuantizedBinned) or isinstance(desc2, QuantizedBinned):
        if not (isinstance(desc1, QuantizedBinned) and isinstance(desc2, QuantizedBinned)):
            raise TypeError("both descriptor sets must be QuantizedBinned, or neither")
        acc = _int8_frames_by_goal(desc1.q, desc2.q).float()
        return (acc * torch.rsqrt(desc1.nq + 1e-12)[None, None, :]
                * torch.rsqrt(desc2.nq + 1e-12)[..., None])
    qa, sa = quantize_rows_int8(unit_rows(desc1))            # (t1, d), (t1, 1)
    qb, sb = quantize_rows_int8(unit_rows(desc2))            # (B, t2, d), (B, t2, 1)
    sim = _int8_frames_by_goal(qa, qb).float() * sa.reshape(1, 1, -1) * sb
    na = torch.square(qa.float() * sa).sum(-1)
    nb = torch.square(qb.float() * sb).sum(-1, keepdim=True)
    return sim * torch.rsqrt(na + 1e-24).reshape(1, 1, -1) * torch.rsqrt(nb + 1e-24)


def _to_cartesian(idx: torch.Tensor, width: int) -> torch.Tensor:
    """Raveled patch index -> (row, col)."""
    return torch.stack([idx // width, idx % width], dim=-1)


def find_correspondences(
    desc1: torch.Tensor,
    desc2: torch.Tensor,
    num_patches: tuple[int, int],
    num_pairs: int,
    scores: torch.Tensor,
    distance_threshold: float = 1.0,
    same_image_thresh: float = 0.99,
    use_kernel: bool = True,
    int8: bool = False,
    use_match_kernel: bool = False,
    sim_matrix: torch.Tensor | None = None,
) -> MatchResult:
    """Mutual-NN correspondences via cyclical consistency.

    desc1: (t, d) goal descriptors on the row-major grid ``num_patches``;
    desc2: one frame's (t, d), or a chunk's (B, t, d) against the same goal
    (one matcher launch, or one int8 product); :class:`QuantizedBinned`
    descriptors the same, with a (t, 9D) goal and (B, t, 9D) frames.
    scores: (t,) sampling scores, (B, t) for a chunk; the ``num_pairs``
    eligible tokens with the largest scores are taken (ties to the lower
    index, as ``lax.top_k``).
    use_kernel: float matching through the matcher kernel of the selected
    mode (else its plain version); it does not compose with int8 matching,
    which is an int8 matmul, as in the JAX package.
    use_match_kernel: the reference's flag: match in the TPU kernel's f32
    arithmetic instead of its default (see the module docstring).
    sim_matrix: the similarity to match on, (t, t) goal against frame, or
    (B, t, t) for a chunk; reduced by max / argmax (first index on ties),
    with no kernel (``use_kernel`` raises).
    A frame is the chunk of one: every reduction is per frame.
    """
    gh, gw = num_patches
    quantized = isinstance(desc1, QuantizedBinned)
    rows2 = desc2.q if isinstance(desc2, QuantizedBinned) else desc2
    single = rows2.dim() == 2
    rows = desc1.q if quantized else desc1
    t = rows.shape[0]
    nb = 1 if single else rows2.shape[0]
    if single:
        scores = scores[None]
    if t != gh * gw or scores.shape != (nb, t):
        raise ValueError(f"{t} descriptors / scores {tuple(scores.shape)} "
                         f"do not fit the {gh}x{gw} grid")
    dev = rows.device
    if sim_matrix is not None:
        if use_kernel:
            raise ValueError("use_kernel does not compose with a given sim_matrix: the matcher "
                             "kernels take descriptors")
        sim = (sim_matrix[None] if single else sim_matrix).float()     # (B, t1, t2)
        sim_1, nn_1, nn_2 = sim.amax(2), sim.argmax(2), sim.argmax(1)
    elif int8 or quantized:
        if use_kernel:
            raise ValueError("use_kernel does not compose with int8 matching: the "
                             "matcher kernels compute a float similarity")
        # (B, t2, t1): the row max/argmax of goal token i runs over t2
        sim_t = _int8_similarity_t(desc1, item(desc2, None) if single else desc2)
        sim_1, nn_1, nn_2 = sim_t.amax(1), sim_t.argmax(1), sim_t.argmax(2)
    else:
        if use_match_kernel or rows.dtype == torch.float32:
            match_fn = dual_argmax_cosine if use_kernel else dual_argmax_cosine_plain
        else:
            match_fn = dual_argmax_cosine_bf16 if use_kernel else dual_argmax_cosine_bf16_plain
        sim_1, nn_1, _, nn_2 = match_fn(desc1, desc2[None] if single else desc2)
    nn_1, nn_2 = nn_1.long(), nn_2.long()                   # (B, t)
    same_image = sim_1.mean(-1) > same_image_thresh         # (B,)

    cyc = torch.gather(nn_2, 1, nn_1)
    ij = _to_cartesian(torch.arange(t, device=dev), gw).float()
    cyc_ij = _to_cartesian(cyc, gw).float()
    d = -torch.sqrt(torch.sum(torch.square(cyc_ij - ij), dim=-1))
    dn = d - d.amin(-1, keepdim=True)
    dn = dn / (dn.amax(-1, keepdim=True) + 1e-8)
    eligible = (dn >= distance_threshold) | (d == 0.0)
    eligible = eligible | same_image[:, None]

    masked = torch.where(eligible, scores.to(device=dev, dtype=torch.float32),
                         torch.tensor(-torch.inf, device=dev))
    k_eff = min(num_pairs, t)
    selected = torch.sort(masked, dim=-1, descending=True, stable=True).indices[:, :k_eff]
    if k_eff < num_pairs:
        selected = torch.cat([selected, selected.new_zeros(nb, num_pairs - k_eff)], dim=-1)
    num_eligible = eligible.sum(-1, dtype=torch.int32)
    valid = (torch.arange(num_pairs, device=dev)
             < torch.clamp(num_eligible, max=k_eff)[:, None])
    selected = torch.where(valid, selected, 0)

    same = same_image[:, None]
    idx2 = torch.where(same, selected, torch.gather(nn_1, 1, selected))
    sim_sel = torch.where(same, torch.ones(num_pairs, device=dev),
                          torch.gather(sim_1, 1, selected))
    match = MatchResult(
        points1=_to_cartesian(selected, gw).float(),
        points2=_to_cartesian(idx2, gw).float(),
        sim=sim_sel,
        valid=valid,
        num_valid=torch.clamp(num_eligible, max=num_pairs),
        same_image=same_image,
    )
    return item(match, 0) if single else match


def refine_matches_subpixel(
    desc1: torch.Tensor,
    desc2: torch.Tensor,
    match: MatchResult,
    num_patches: tuple[int, int],
    sim_matrix: torch.Tensor | None = None,
) -> MatchResult:
    """Sub-patch refinement of the matched positions in image 2: a 1-D
    parabola peak fit per axis of the cosine similarity between each goal
    token and the 3x3 neighbourhood of its match, or, given the
    ``sim_matrix`` the match was made on ((t, t), or (B, t, t) for a chunk),
    of that similarity there.  Offsets are clipped to
    +-0.5 patch and zeroed on grid borders, for invalid slots and under the
    same-image shortcut; goal points stay at patch centres.  ``desc2`` and
    ``match``: one frame's, or a chunk's (B, t, d) and (B, k, ...).
    :class:`QuantizedBinned` inputs: the int8 rows are gathered (their
    per-row scales cancel in the unit normalization)."""
    gh, gw = num_patches
    if isinstance(desc1, QuantizedBinned):
        desc1, desc2 = desc1.q, desc2.q
    single = desc2.dim() == 2
    if single:
        desc2, match = desc2[None], item(match, None)
        sim_matrix = None if sim_matrix is None else sim_matrix[None]

    def unit_f32(x):
        x = x.float()
        return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=1e-12)

    r1, c1 = match.points1[..., 0].long(), match.points1[..., 1].long()   # (B, k)
    r2, c2 = match.points2[..., 0].long(), match.points2[..., 1].long()
    dr = torch.tensor([-1, 0, 1], device=match.points2.device)
    rr = (r2[..., None] + dr).clamp(0, gh - 1)                 # (B, k, 3)
    cc = (c2[..., None] + dr).clamp(0, gw - 1)
    nidx = rr[..., :, None] * gw + cc[..., None, :]            # (B, k, 3, 3)
    frame = torch.arange(desc2.shape[0], device=desc2.device)[:, None]
    if sim_matrix is not None:
        # the neighbourhood on the similarity the match was made on
        s = sim_matrix[frame[..., None, None], (r1 * gw + c1)[..., None, None], nidx].float()
    else:
        # gather first, normalize after: only k + 9k rows a frame are needed
        q = unit_f32(desc1[r1 * gw + c1])                      # (B, k, d)
        nb = unit_f32(desc2[frame, nidx.flatten(1)]).reshape(*nidx.shape, -1)
        s = torch.einsum("bkd,bkrcd->bkrc", q, nb)

    def axis_offset(s_m, s0, s_p, at_border):
        den = s_m + s_p - 2.0 * s0
        off = torch.where(den < -1e-6, (s_m - s_p) / (2.0 * den), torch.zeros_like(den))
        off = off.clamp(-0.5, 0.5)
        return torch.where(at_border, torch.zeros_like(off), off)

    off_r = axis_offset(s[..., 0, 1], s[..., 1, 1], s[..., 2, 1], (r2 == 0) | (r2 == gh - 1))
    off_c = axis_offset(s[..., 1, 0], s[..., 1, 1], s[..., 1, 2], (c2 == 0) | (c2 == gw - 1))
    offs = torch.stack([off_r, off_c], dim=-1)
    keep = match.valid & ~match.same_image[:, None]
    offs = torch.where(keep[..., None], offs, torch.zeros_like(offs))
    match = match._replace(points2=match.points2 + offs)
    return item(match, 0) if single else match


def match_points_to_pixels(
    points: torch.Tensor,
    num_patches_side: int,
    dino_input_size: int,
    image_size_uv: tuple[int, int],
    round_px: bool = True,
) -> torch.Tensor:
    """Patch (row, col) (..., 2) -> camera pixel (u, v) (..., 2): patch -> DINO-input pixel
    ``p * scale + scale / 2``, flip to (u, v), rescale to the camera
    resolution, round unless ``round_px`` is off (sub-patch positions)."""
    u_max, v_max = image_size_uv
    scale = dino_input_size / num_patches_side
    pix = points * scale + scale / 2.0
    uv = torch.stack([pix[..., 1], pix[..., 0]], dim=-1)
    factors = torch.tensor([u_max / dino_input_size, v_max / dino_input_size],
                           dtype=torch.float32, device=points.device)
    uv = uv * factors
    return torch.round(uv) if round_px else uv
