"""Row and column nearest neighbours of the cosine-similarity matrix.

Replaces ``vitvs_tpu/ops/matcher.py:dual_argmax_cosine``, whose Pallas
kernel ``_matcher_kernel`` reduces the tiled similarity to the quartet
(max_row, argmax_row, max_col, argmax_col) so that the (t1 x t2) matrix
never reaches HBM.  The JAX package matches in one of two arithmetics, and
so does the port, each with a kernel in ``csrc/matcher.cu``, its plain
version and its own launch count:

* **bf16 mode** (``dual_argmax_cosine_bf16``), the reference's default
  (``ServoModel.use_match_kernel=False``, ``cosine_similarity_matrix``):
  each row is normalized in its own dtype by its f32 norm
  (:func:`unit_rows`), then multiplied with f32 accumulation.  On the card
  the wrapper normalizes and the kernel multiplies the bf16 unit rows on
  the tensor cores and reduces in its epilogue, in one launch.  Bound on
  the H100 at (484, 3456): bytes, 6.7 MB of bf16 rows in 2.0 us (1.62 GFLOP
  take 1.6 us at 989 TFLOP/s).
* **f32 mode** (``dual_argmax_cosine``), the TPU kernel's arithmetic
  (``use_match_kernel=True``, and f32 descriptors): the descriptors are
  cast to f32, multiplied in f32, and the inverse row norms
  ``rsqrt(sum(x^2) + 1e-24)`` are folded in after the product.  On the card
  one launch does it all: clusters of 8 CTAs per 64 x 64 output tile, each
  CTA an eighth of d (:func:`f32_launch`), f32 FMA on the CUDA cores, the
  sums of squares taken from the staged rows, the partials summed in a
  fixed order through distributed shared memory.  Bound at (484, 3456): f32
  operations, 1.62 GFLOP in 24 us at 67 TFLOP/s outside the tensor cores.

Both take the goal's rows (t1, d) against one frame's (t2, d) or a
chunk's (B, t2, d): the reference vmaps its ``pallas_call`` over the chunk,
one launch with a batch axis in its grid, and so does the port (a grid z of
B; each item reduces into its own packed keys and its own finished-block
count, so an item's outputs are bit for bit those of a launch on it alone).
The goal's unit rows are made once a call.

Each wrapper launches its kernel for CUDA tensors and takes its plain
version only for CPU tensors.
"""

from __future__ import annotations

import torch

from vitvs_tpu_torch.ops import _build


# zeroed int64 scratch of the kernels' packed keys and finished-block counts
# (t1 + t2 + 1 entries a batch item), one per (device, stream); each launch
# leaves the entries it used zero again
_keys_scratch: dict[tuple[int | None, int], torch.Tensor] = {}


def _keys(device: torch.device, n: int) -> torch.Tensor:
    """At least ``n`` zero int64 entries for one kernel launch on the
    current stream of ``device``: the launch's last block zeroes what it
    used, so consecutive launches on a stream share the buffer without a
    clearing pass, and launches on other streams get their own."""
    stream = torch.cuda.current_stream(device).cuda_stream if device.type == "cuda" else 0
    key = (device.index, stream)
    buf = _keys_scratch.get(key)
    if buf is None or buf.numel() < n:
        buf = _keys_scratch[key] = torch.zeros(n, dtype=torch.int64, device=device)
    return buf


def inverse_norms(x: torch.Tensor) -> torch.Tensor:
    return torch.rsqrt(torch.sum(x * x, dim=-1) + 1e-24)


def unit_rows(x: torch.Tensor) -> torch.Tensor:
    """Rows scaled in x's dtype by their inverse f32 norms (the reference's
    ``cosine_similarity_matrix``): bf16 rows stay bf16, so they are not
    exactly unit and a similarity may slightly exceed 1."""
    sq = torch.square(x.float()).sum(-1, keepdim=True)
    return x * torch.rsqrt(sq + 1e-24).to(x.dtype)


def _quartet(sim: torch.Tensor):
    """(..., t1, t2) similarities -> (max, argmax) over t2 and over t1."""
    return (sim.amax(-1), sim.argmax(-1).to(torch.int32),
            sim.amax(-2), sim.argmax(-2).to(torch.int32))


def dual_argmax_cosine_plain(desc1: torch.Tensor, desc2: torch.Tensor):
    """f32 mode: (t1, d), (t2, d) or (B, t2, d) -> (sim_1 (..., t1), nn_1
    (..., t1) int32, sim_2 (..., t2), nn_2 (..., t2) int32) in f32; ties go
    to the first index."""
    a = desc1.float()
    b = desc2.float()
    return _quartet((a * inverse_norms(a)[:, None]) @ (b * inverse_norms(b)[..., None]).mT)


def dual_argmax_cosine_bf16_plain(desc1: torch.Tensor, desc2: torch.Tensor):
    """bf16 mode: the quartet of the unit rows' product, shapes as
    :func:`dual_argmax_cosine_plain`.  The rows are upcast before the
    product, which is exact (a bf16 x bf16 matmul would round every
    similarity to bf16); products of bf16 values are exact in f32, provided
    the card's f32 matmuls stay off TF32."""
    return _quartet(unit_rows(desc1).float() @ unit_rows(desc2).float().mT)


def _check(desc1: torch.Tensor, desc2: torch.Tensor) -> None:
    if desc1.dim() != 2 or desc2.dim() not in (2, 3) or desc1.shape[1] != desc2.shape[-1]:
        raise ValueError(f"matcher takes (t1, d) and (t2, d) or (B, t2, d), got "
                         f"{tuple(desc1.shape)} and {tuple(desc2.shape)}")
    if min(desc1.shape[0], desc1.shape[1], *desc2.shape[:-1]) < 1:
        raise ValueError("matcher takes non-empty descriptors")
    for t in (desc1, desc2):
        if not t.is_floating_point():
            raise TypeError(f"matcher takes float descriptors, got {t.dtype}")
    if desc1.device.type != "cuda" or desc2.device != desc1.device:
        raise ValueError(f"matcher kernel runs on CUDA tensors; desc1 is on "
                         f"{desc1.device}, desc2 on {desc2.device}")


# the f32-mode kernel's tiling (csrc/matcher.cu, which refuses other launch
# arguments): a cluster of F32_CLUSTER CTAs per F32_TILE x F32_TILE output
# tile, each CTA a slice of the depth in whole F32_CHUNK-deep chunks
F32_TILE, F32_CLUSTER, F32_CHUNK = 64, 8, 32


def f32_launch(t1: int, t2: int, d: int) -> tuple[int, int, int]:
    """(grid x, grid y, depth per CTA) of the f32-mode kernel: the clusters
    of a row of column tiles side by side along x, one row tile per y; the
    depth split into F32_CLUSTER slices of whole chunks (the last slices
    of a short d may be empty, and the kernel zero-fills past d).  A batch
    of frames is the grid's z."""
    chunks = -(-d // F32_CHUNK)
    return (F32_CLUSTER * -(-t2 // F32_TILE), -(-t1 // F32_TILE),
            F32_CHUNK * -(-chunks // F32_CLUSTER))


def _outputs(a: torch.Tensor, b: torch.Tensor):
    """The quartet's buffers for one launch on a (t1, d) and b (B, t2, d),
    and the launch's zero key scratch."""
    (t1, _), (nb, t2, _) = a.shape, b.shape
    f32 = dict(dtype=torch.float32, device=a.device)
    i32 = dict(dtype=torch.int32, device=a.device)
    return ((torch.empty(nb, t1, **f32), torch.empty(nb, t1, **i32),
             torch.empty(nb, t2, **f32), torch.empty(nb, t2, **i32)),
            _keys(a.device, nb * (t1 + t2 + 1)))


def _launch_f32(a: torch.Tensor, b: torch.Tensor):
    """One f32-mode kernel launch on f32 contiguous rows a (t1, d) and b
    (B, t2, d) -> the quartet, (B, t1) and (B, t2)."""
    (t1, d), (nb, t2, _) = a.shape, b.shape
    out, work = _outputs(a, b)
    lib = _build.library()
    with torch.cuda.device(a.device):
        err = lib.vitvs_dual_argmax_cosine(
            a.data_ptr(), b.data_ptr(), work.data_ptr(), *(x.data_ptr() for x in out),
            nb, t1, t2, d, *f32_launch(t1, t2, d), torch.cuda.current_stream(a.device).cuda_stream)
    _build.check(err, "matcher")
    return out


def _batched(fn, desc1: torch.Tensor, desc2: torch.Tensor):
    """``fn`` on (t1, d) and (B, t2, d); a single frame (t2, d) as B = 1,
    its quartet without the batch axis."""
    if desc2.dim() == 2:
        return tuple(x[0] for x in fn(desc1, desc2[None]))
    return fn(desc1, desc2)


def dual_argmax_cosine(desc1: torch.Tensor, desc2: torch.Tensor):
    """f32 mode: row and column max/argmax of cosine(desc1, desc2), computed
    in f32, of the goal's rows (t1, d) against one frame's (t2, d) or a
    chunk's (B, t2, d).

    Returns (sim_1 (..., t1), nn_1 (..., t1) int32, sim_2 (..., t2), nn_2
    (..., t2) int32), the ``sim.max(-1) / argmax(-1) / max(-2) /
    argmax(-2)`` quartet.  CUDA tensors: the kernel (one launch for the
    chunk; a cast first for other float dtypes), or an error.  CPU tensors:
    the plain version.
    """
    _build.refuse_grad("dual_argmax_cosine", desc1, desc2)
    if desc1.device.type == "cpu":
        return dual_argmax_cosine_plain(desc1, desc2)
    _check(desc1, desc2)
    out = _batched(_launch_f32, desc1.float().contiguous(), desc2.float().contiguous())
    dual_argmax_cosine.launches += 1
    return out


def bf16_unit_rows(desc: torch.Tensor) -> torch.Tensor:
    """The bf16 kernel's operand: unit rows, contiguous, the depth padded
    with zero columns to a multiple of 8 (16-byte row chunks)."""
    x = unit_rows(desc).contiguous()
    pad = -x.shape[-1] % 8
    return torch.nn.functional.pad(x, (0, pad)) if pad else x


def _launch_bf16(a: torch.Tensor, b: torch.Tensor):
    """One bf16-mode kernel launch on :func:`bf16_unit_rows` operands a
    (t1, d) and b (B, t2, d) -> the quartet, (B, t1) and (B, t2)."""
    (t1, d), (nb, t2, _) = a.shape, b.shape
    out, work = _outputs(a, b)
    lib = _build.library()
    with torch.cuda.device(a.device):
        err = lib.vitvs_dual_argmax_bf16(
            a.data_ptr(), b.data_ptr(), work.data_ptr(), *(x.data_ptr() for x in out),
            nb, t1, t2, d, torch.cuda.current_stream(a.device).cuda_stream)
    _build.check(err, "bf16 matcher")
    return out


def dual_argmax_cosine_bf16(desc1: torch.Tensor, desc2: torch.Tensor):
    """bf16 mode: the quartet of :func:`dual_argmax_cosine_bf16_plain`, of
    the goal's rows (t1, d) against (t2, d) or (B, t2, d).

    CUDA tensors: bf16 descriptors through the tensor-core kernel (one
    launch for the chunk), or an error.  CPU tensors: the plain version
    (any float dtype).
    """
    _build.refuse_grad("dual_argmax_cosine_bf16", desc1, desc2)
    if desc1.device.type == "cpu":
        return dual_argmax_cosine_bf16_plain(desc1, desc2)
    _check(desc1, desc2)
    if desc1.dtype != torch.bfloat16 or desc2.dtype != torch.bfloat16:
        raise TypeError(f"bf16 matcher kernel takes bfloat16 descriptors, got "
                        f"{desc1.dtype} and {desc2.dtype}")
    out = _batched(_launch_bf16, bf16_unit_rows(desc1), bf16_unit_rows(desc2))
    dual_argmax_cosine_bf16.launches += 1
    return out


dual_argmax_cosine.launches = 0
dual_argmax_cosine_bf16.launches = 0
