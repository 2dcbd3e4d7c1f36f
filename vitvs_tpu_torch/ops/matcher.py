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
  cast to f32 and the inverse row norms ``rsqrt(sum(x^2) + 1e-24)`` are
  computed here, outside the kernel, and folded in after the f32 product.
  On the card: a tile pass with per-tile partials and an in-order reduce
  pass.  Bound at (484, 3456): f32 operations, 1.62 GFLOP in 24 us at 67
  TFLOP/s outside the tensor cores.

Each wrapper launches its kernel for CUDA tensors and takes its plain
version only for CPU tensors.
"""

from __future__ import annotations

import torch

from vitvs_tpu_torch.ops import _build


def inverse_norms(x: torch.Tensor) -> torch.Tensor:
    return torch.rsqrt(torch.sum(x * x, dim=-1) + 1e-24)


def unit_rows(x: torch.Tensor) -> torch.Tensor:
    """Rows scaled in x's dtype by their inverse f32 norms (the reference's
    ``cosine_similarity_matrix``): bf16 rows stay bf16, so they are not
    exactly unit and a similarity may slightly exceed 1."""
    sq = torch.square(x.float()).sum(-1, keepdim=True)
    return x * torch.rsqrt(sq + 1e-24).to(x.dtype)


def _quartet(sim: torch.Tensor):
    return (sim.amax(1), sim.argmax(1).to(torch.int32),
            sim.amax(0), sim.argmax(0).to(torch.int32))


def dual_argmax_cosine_plain(desc1: torch.Tensor, desc2: torch.Tensor):
    """f32 mode: (t1, d), (t2, d) -> (sim_1 (t1,), nn_1 (t1,) int32,
    sim_2 (t2,), nn_2 (t2,) int32) in f32; ties go to the first index."""
    a = desc1.float()
    b = desc2.float()
    return _quartet((a * inverse_norms(a)[:, None]) @ (b * inverse_norms(b)[:, None]).T)


def dual_argmax_cosine_bf16_plain(desc1: torch.Tensor, desc2: torch.Tensor):
    """bf16 mode: the quartet of the unit rows' product.  The rows are
    upcast before the product, which is exact (a bf16 x bf16 matmul would
    round every similarity to bf16); products of bf16 values are exact in
    f32, provided the card's f32 matmuls stay off TF32."""
    return _quartet(unit_rows(desc1).float() @ unit_rows(desc2).float().T)


def _check(desc1: torch.Tensor, desc2: torch.Tensor) -> None:
    if desc1.dim() != 2 or desc2.dim() != 2 or desc1.shape[1] != desc2.shape[1]:
        raise ValueError(f"matcher takes (t1, d) and (t2, d), got "
                         f"{tuple(desc1.shape)} and {tuple(desc2.shape)}")
    if min(desc1.shape[0], desc2.shape[0], desc1.shape[1]) < 1:
        raise ValueError("matcher takes non-empty descriptors")
    for t in (desc1, desc2):
        if not t.is_floating_point():
            raise TypeError(f"matcher takes float descriptors, got {t.dtype}")
    if desc1.device.type != "cuda" or desc2.device != desc1.device:
        raise ValueError(f"matcher kernel runs on CUDA tensors; desc1 is on "
                         f"{desc1.device}, desc2 on {desc2.device}")


def dual_argmax_cosine(desc1: torch.Tensor, desc2: torch.Tensor):
    """f32 mode: row and column max/argmax of cosine(desc1, desc2), computed
    in f32.

    Returns (sim_1 (t1,), nn_1 (t1,) int32, sim_2 (t2,), nn_2 (t2,) int32),
    the ``sim.max(-1) / argmax(-1) / max(-2) / argmax(-2)`` quartet.
    CUDA tensors: the kernel, or an error.  CPU tensors: the plain version.
    """
    if desc1.device.type == "cpu":
        return dual_argmax_cosine_plain(desc1, desc2)
    _check(desc1, desc2)
    a = desc1.float().contiguous()
    b = desc2.float().contiguous()
    (t1, d), t2 = a.shape, b.shape[0]
    ainv = inverse_norms(a)
    binv = inverse_norms(b)
    lib = _build.library()
    tr, tc = lib.vitvs_matcher_row_tile(), lib.vitvs_matcher_col_tile()
    n_rt, n_ct = -(-t1 // tr), -(-t2 // tc)
    f32 = dict(dtype=torch.float32, device=a.device)
    i32 = dict(dtype=torch.int32, device=a.device)
    rmax, rarg = torch.empty(t1, **f32), torch.empty(t1, **i32)
    cmax, carg = torch.empty(t2, **f32), torch.empty(t2, **i32)
    rpart_val, rpart_idx = torch.empty(n_ct, t1, **f32), torch.empty(n_ct, t1, **i32)
    cpart_val, cpart_idx = torch.empty(n_rt, t2, **f32), torch.empty(n_rt, t2, **i32)
    with torch.cuda.device(a.device):
        err = lib.vitvs_dual_argmax_cosine(
            a.data_ptr(), b.data_ptr(), ainv.data_ptr(), binv.data_ptr(),
            rmax.data_ptr(), rarg.data_ptr(), cmax.data_ptr(), carg.data_ptr(),
            rpart_val.data_ptr(), rpart_idx.data_ptr(),
            cpart_val.data_ptr(), cpart_idx.data_ptr(), t1, t2, d,
            torch.cuda.current_stream(a.device).cuda_stream)
    _build.check(err, "matcher")
    dual_argmax_cosine.launches += 1
    return rmax, rarg, cmax, carg


def bf16_unit_rows(desc: torch.Tensor) -> torch.Tensor:
    """The bf16 kernel's operand: unit rows, contiguous, the depth padded
    with zero columns to a multiple of 8 (16-byte row chunks)."""
    x = unit_rows(desc).contiguous()
    pad = -x.shape[1] % 8
    return torch.nn.functional.pad(x, (0, pad)) if pad else x


def _launch_bf16(a: torch.Tensor, b: torch.Tensor):
    """One bf16-mode kernel launch on :func:`bf16_unit_rows` operands."""
    (t1, d), t2 = a.shape, b.shape[0]
    f32 = dict(dtype=torch.float32, device=a.device)
    i32 = dict(dtype=torch.int32, device=a.device)
    rmax, rarg = torch.empty(t1, **f32), torch.empty(t1, **i32)
    cmax, carg = torch.empty(t2, **f32), torch.empty(t2, **i32)
    work = torch.empty(t1 + t2 + 1, dtype=torch.int64, device=a.device)
    lib = _build.library()
    with torch.cuda.device(a.device):
        err = lib.vitvs_dual_argmax_bf16(
            a.data_ptr(), b.data_ptr(), work.data_ptr(), rmax.data_ptr(), rarg.data_ptr(),
            cmax.data_ptr(), carg.data_ptr(), t1, t2, d,
            torch.cuda.current_stream(a.device).cuda_stream)
    _build.check(err, "bf16 matcher")
    return rmax, rarg, cmax, carg


def dual_argmax_cosine_bf16(desc1: torch.Tensor, desc2: torch.Tensor):
    """bf16 mode: the quartet of :func:`dual_argmax_cosine_bf16_plain`.

    CUDA tensors: bf16 descriptors through the tensor-core kernel, or an
    error.  CPU tensors: the plain version (any float dtype).
    """
    if desc1.device.type == "cpu":
        return dual_argmax_cosine_bf16_plain(desc1, desc2)
    _check(desc1, desc2)
    if desc1.dtype != torch.bfloat16 or desc2.dtype != torch.bfloat16:
        raise TypeError(f"bf16 matcher kernel takes bfloat16 descriptors, got "
                        f"{desc1.dtype} and {desc2.dtype}")
    out = _launch_bf16(bf16_unit_rows(desc1), bf16_unit_rows(desc2))
    dual_argmax_cosine_bf16.launches += 1
    return out


dual_argmax_cosine.launches = 0
dual_argmax_cosine_bf16.launches = 0
