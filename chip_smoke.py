#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (vitvs_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py              # the smoke run below
    python3 chip_smoke.py --profile [bf16|f32|F|N] [--trace trace.json]
                                       # only: device-time breakdown of servo steps
                                       # of the bf16 or f32 path or an int8 serving variant

Phases, each announced with a flushed, timestamped start/done line:

1. card and build: the card's name and power limit (nvidia-smi), then the
   kernels' build, one nvcc per csrc/*.cu started together and one link
   (build seconds and -Xptxas -v lines);
2. kernels vs plain versions at the main paths' shapes: exact attention at
   (1, 485, 6, 64) bf16, at B = 2, 6 heads with T in {1, 63, 64, 65, 127,
   129, 485, 1370}, and rows whose scaled logits are about +-200; the f32
   exact attention likewise in f32 (T in {1, 7, 9, 63, 64, 65, 129, 485,
   1370}), two launches bit for bit; the
   matcher's bf16 mode at (484, 3456) bf16 and at ragged sizes, plus
   first-index ties across blocks; its f32 mode at (484, 3456) f32, at
   ragged sizes and depths (d of 1, 3, 97 and not a multiple of 256), two
   launches bit for bit, plus an exact-index case; no-max attention at (1,
   1370, 12, 64) bf16, at B = 2 with T in {1, 63, 64, 65, 70, 1370}, and
   rows whose logits are all about -30; fused int8 attention at (1, 1370,
   768) (column slices of a qkv output), at B = 2 with the exact kernel's T
   list, plus 58 padded columns;
   the int8 kernel's Q and K quantization against _quant_th, bit for bit;
3. the bf16 main path: goal_descriptors + 5 servo_steps of the DINO servo
   step at ViT-S/14 @ 308 (configs/config.yaml's settings, seeded weights,
   seeded 640x480 frames), once through the kernels and once through the
   plain versions; launch counts (exact attention and the bf16-mode
   matcher), finiteness and agreement are checked;
3b. the int8 W8A8 serving step at ViT-B/14 @ 518
   (configs/config_vitb_518.yaml's settings, seeded weights, static scales
   calibrated on the goal frame and 7 shifted frames, source-quantized
   bins), variants F (fused int8 attention) and N (no-max attention), each
   calibration + goal_descriptors + 5 servo_steps, through the kernels and
   through the plain versions, checked as phase 3 with the plain run handed
   the kernel run's EMA and command at each step, so that every step whose
   pairs agree compares its twist; the bf16 ViT-B step on the same frames
   is logged beside it (twist scale, int8 vs float);
3c. the f32 step: phase 3's path with compute_dtype float32 and exact GELU
   (the reference's strict-parity numerics): f32 exact attention and the
   f32-mode matcher on the main path, checked as phase 3 at f32
   tolerances;
4. times on the card (CUDA events / synchronized host clock) beside each
   kernel's bound and the PyTorch library call for the same function (the
   exact kernels at T = 485 and T = 1370; the int8 kernel from the bf16
   slices, its quantization included), and the servo steps' medians.  The
   f32 attention kernel is held to the tensor-core bound of f32-accurate
   work (three TF32 passes), its f32 FMA bound logged beside it.

The last three lines of standard output are the kernel JSON line, the card
line and {"ok": true, "device": {...}}.  Any failed check raises, so the
script exits non-zero and prints no result; it also exits non-zero without a
CUDA device or outside a checkout of the repository.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import statistics
import subprocess
import sys
import time
from contextlib import contextmanager
from pathlib import Path

import numpy as np
import torch

from vitvs_tpu_torch.control.ibvs import EmaState
from vitvs_tpu_torch.harness.pipeline import (ServoModel, goal_descriptors, quantized_vit,
                                              servo_step)
from vitvs_tpu_torch.io_bridge.config import VSConfig
from vitvs_tpu_torch.match.binned import QuantizedBinned
from vitvs_tpu_torch.models.vit import init_vit
from vitvs_tpu_torch.ops import _build, attention, attn_int8, matcher

T0 = time.perf_counter()

# H100 SXM published peaks (NVIDIA data sheet, dense)
PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
PEAK_F32_FLOPS = 67e12     # outside the tensor cores
PEAK_TF32_FLOPS = 495e12
TF32_PASSES = 3            # split-precision TF32: hi.hi + hi.lo + lo.hi, f32 accurate
PEAK_BYTES = 3.35e12

ATTN_SHAPE = (1, 485, 6, 64)       # (B, T, h, hd) of ViT-S/14 @ 308
MATCH_SHAPE = (484, 3456)          # (t, 384 * 9) binned descriptors
SERVE_ATTN_SHAPE = (1, 1370, 12, 64)   # (B, T, h, hd) of ViT-B/14 @ 518
ATTN_TOL = 2e-2                    # bf16 outputs of O(1): a few bf16 ulps
# f32 outputs of O(1): sums of up to 1370 f32 terms in another order (the plain
# version is within 5e-7 of f64 at T = 485)
ATTN_F32_TOL = 2e-5
# f32 rows whose scaled logits are about +-200: the raw dot products are about
# 1600, one f32 ulp there is 1.2e-4, so two summation orders move the
# probabilities by about 1e-4 relative (the plain version is 4.0e-5 from f64)
LARGE_LOGIT_F32_TOL = 5e-4
# f32 exact attention at B = 2, 6 heads: a ragged 8-key group (7, 9), 64-key
# chunk edges, an almost empty last chunk (65, 129), one and two 128-row blocks,
# clusters of 1 to 4 blocks splitting the keys
ATTN_F32_T = [1, 7, 9, 63, 64, 65, 129, 485, 1370]
MATCH_VAL_TOL = 1e-4               # f32 dot products of 3456 terms, other order
MATCH_TIE_TOL = 1e-5
# f32-mode matcher shapes (t1, t2, d): ragged tiles, and depths of 1, 3, 97 and
# others not a multiple of 8 x 32 (the 32-deep chunks a cluster's eight CTAs split)
MATCH_F32_SHAPES = [(1, 1, 1), (33, 65, 3), (65, 33, 97), (100, 37, 100), (485, 485, 130),
                    (484, 484, 3460)]
# bf16-mode matcher shapes (t1, t2, d): the main path's, then ragged tiles and depths
MATCH_BF16_SHAPES = [(484, 484, 3456), (1, 1, 3456), (33, 33, 3456), (65, 65, 3456),
                     (485, 485, 3456), (33, 485, 100)]
FAST_ATTN_T = [1, 63, 64, 65, 70, 1370]   # no-max attention at B = 2, 12 heads
# exact attention (B = 2, 6 heads) and int8 attention (B = 2, 12 heads): 64-key
# block edges, one and two 128-row blocks, both work splits of the exact kernel
ATTN_T = [1, 63, 64, 65, 127, 129, 485, 1370]
LARGE_LOGIT = 200.0                # |scaled logit| of the exact kernel's large-logit rows
# bf16 descriptors after 12 blocks, max |diff| / max |ref| (int8 rows: of unit rows,
# where one int8 step is 1/127 of a row's largest entry)
DESC_REL_TOL = 5e-2
DESC_COS_MIN = 0.99                # the least cosine of a goal descriptor row, kernel vs plain
TWIST_TOL = 1e-3                   # BASELINE.md velocity parity clause
# the f32 step, kernels vs plain (compare_runs' tol): f32 descriptors from sums
# in other orders (on the CPU the port's f32 descriptors are within 1.2e-6
# relative of vitvs_tpu's at full size), twists 10x outside the CPU parity
# test's 1e-5 and 10x inside BASELINE.md's 1e-3
F32_TOL = (1e-4, 0.9999, 1e-4)
N_STEPS = 5
SHIFTS = [(3, 4), (6, 8), (9, 12), (12, 16), (15, 20)]   # (dy, dx) px of each frame
# the 7 start views the static activation scales are calibrated on, beside the goal
CALIB_SHIFTS = [(-8, 5), (4, -10), (11, 3), (-5, -6), (7, 14), (-12, -2), (2, 9)]
# int8 serving variants: (quant_attn, attn_impl) and the kernel the path launches
VARIANTS = {"F": ("fused", "xla", "attn_int8"), "N": ("none", "fast", "attention_fast")}


def log(msg: str) -> None:
    print(f"[t={time.perf_counter() - T0:.1f}s] {msg}", flush=True)


@contextmanager
def phase(name: str):
    log(f"phase {name} start")
    yield
    log(f"phase {name} done")


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()
    return out[0]


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def large_logit_qkv(shape, c, seed, k_noise=0.05):
    """(B, T, H, hd) f32 q, k, v: keys clustered around a unit direction u
    and query rows at +-c sqrt(hd) u (even rows +, odd rows -), so the scaled
    logits of a row are all about +c or -c: exp of them overflows f32 unless
    the row max is subtracted first."""
    B, T, H, D = shape
    rs = np.random.default_rng(seed)
    u = rs.standard_normal(D).astype(np.float32)
    u /= np.linalg.norm(u)
    k = (u + k_noise * rs.standard_normal(shape)).astype(np.float32)
    sign = np.where(np.arange(T) % 2 == 0, 1.0, -1.0).astype(np.float32)[None, :, None, None]
    q = np.ascontiguousarray(np.broadcast_to(sign * c * np.sqrt(D) * u, shape), np.float32)
    v = rs.standard_normal(shape).astype(np.float32)
    return q, k, v


def check_attention(device, shape=ATTN_SHAPE, ts=ATTN_T, seed=0, dtype=torch.bfloat16,
                    tol=ATTN_TOL, large_tol=ATTN_TOL) -> float:
    """Exact kernel of ``dtype`` (bf16, or f32: fault 3.4's kernel) vs its
    plain version on random inputs at ``shape``, at B = 2 for each T of
    ``ts`` (``shape``'s heads), within ``tol``, and on rows whose scaled
    logits are about +-LARGE_LOGIT (T = 130), within ``large_tol``.  Both
    kernels merge key groups without atomics, so a second launch at
    ``shape`` gives the same bits.  Returns the max abs error at ``shape``."""
    rs = np.random.default_rng(seed)
    what = f"exact attention ({dtype})"
    q, k, v = (_normal(device, shape, rs, dtype) for _ in range(3))
    out = attention.mha_attention(q, k, v)
    err = _max_err(out, attention.mha_attention_plain(q, k, v), what, tol)
    if not torch.equal(out.view(torch.uint8), attention.mha_attention(q, k, v).view(torch.uint8)):
        raise AssertionError(f"{what}: two launches on the same inputs differ")
    for T in ts:
        q, k, v = (_normal(device, (2, T, shape[2], shape[3]), rs, dtype) for _ in range(3))
        _max_err(attention.mha_attention(q, k, v), attention.mha_attention_plain(q, k, v),
                 f"{what}, B = 2, T = {T}", tol)
    q, k, v = (torch.from_numpy(x).to(device, dtype)
               for x in large_logit_qkv((2, 130, shape[2], shape[3]), LARGE_LOGIT, seed=12))
    _max_err(attention.mha_attention(q, k, v), attention.mha_attention_plain(q, k, v),
             f"{what}, logits of about +-{LARGE_LOGIT}", large_tol)
    return err


def _hold_matcher(got, ref, sim, what: str) -> float:
    """Max values within MATCH_VAL_TOL of the plain ones; each argmax equal
    to the plain one or pointing at a value within MATCH_TIE_TOL of the
    plain max.  Returns the max abs error of the maxima."""
    err = max((got[0] - ref[0]).abs().max().item(), (got[2] - ref[2]).abs().max().item())
    if not err <= MATCH_VAL_TOL:
        raise AssertionError(f"{what} max values: max abs err {err} > {MATCH_VAL_TOL}")
    for axis, (idx, ref_idx, ref_max) in enumerate([(got[1], ref[1], ref[0]),
                                                    (got[3], ref[3], ref[2])]):
        idx, ref_idx = idx.long(), ref_idx.long()
        lane = torch.arange(idx.shape[0], device=idx.device)
        at = sim[lane, idx] if axis == 0 else sim[idx, lane]
        ok = (idx == ref_idx) | (at >= ref_max - MATCH_TIE_TOL)
        if not bool(ok.all()):
            raise AssertionError(f"{what} argmax (axis {axis}) disagrees at "
                                 f"{int((~ok).sum())} places beyond ties")
    return err


def _normal(device, shape, rs, dtype=torch.float32) -> torch.Tensor:
    return torch.from_numpy(rs.standard_normal(shape).astype(np.float32)).to(device, dtype)


def check_matcher(device, shape=MATCH_SHAPE, shapes=MATCH_F32_SHAPES, seed=1) -> float:
    """f32 mode: kernel wrapper vs plain version on f32 descriptors
    (:func:`_hold_matcher`) at ``shape`` and at each (t1, t2, d) of
    ``shapes``; two launches at ``shape`` give bit-identical outputs (the
    partial sums meet in a fixed order).  Returns the max abs error at
    ``shape``."""
    t, d = shape
    rs = np.random.default_rng(seed)
    f32_sim = lambda a, b: ((a * matcher.inverse_norms(a)[:, None])
                            @ (b * matcher.inverse_norms(b)[:, None]).T)
    a, b = _normal(device, (t, d), rs), _normal(device, (t, d), rs)
    got = matcher.dual_argmax_cosine(a, b)
    err = _hold_matcher(got, matcher.dual_argmax_cosine_plain(a, b), f32_sim(a, b), "matcher")
    again = matcher.dual_argmax_cosine(a, b)
    bits = lambda x: x.view(torch.int32) if x.dtype == torch.float32 else x
    if not all(torch.equal(bits(x), bits(y)) for x, y in zip(got, again)):
        raise AssertionError("matcher: two launches on the same inputs differ")
    for t1, t2, d in shapes:
        a, b = _normal(device, (t1, d), rs), _normal(device, (t2, d), rs)
        _hold_matcher(matcher.dual_argmax_cosine(a, b), matcher.dual_argmax_cosine_plain(a, b),
                      f32_sim(a, b), f"matcher {(t1, t2, d)}")
    return err


def check_matcher_bf16(device, shapes=MATCH_BF16_SHAPES, seed=6) -> float:
    """bf16 mode: kernel wrapper vs plain version on bf16 descriptors at each
    (t1, t2, d) of ``shapes`` (:func:`_hold_matcher`), then duplicated rows
    and columns, whose exact ties must go to the first index across blocks.
    Returns the max abs error at the first shape."""
    rs = np.random.default_rng(seed)
    errs = []
    for t1, t2, d in shapes:
        a = _normal(device, (t1, d), rs, torch.bfloat16)
        b = _normal(device, (t2, d), rs, torch.bfloat16)
        sim = matcher.unit_rows(a).float() @ matcher.unit_rows(b).float().T
        errs.append(_hold_matcher(matcher.dual_argmax_cosine_bf16(a, b),
                                  matcher.dual_argmax_cosine_bf16_plain(a, b), sim,
                                  f"bf16 matcher {(t1, t2, d)}"))
    t, d = shapes[0][0] // 2 + 1, shapes[0][2]
    base = _normal(device, (t, d), rs, torch.bfloat16)
    twice = torch.cat([base, base])                      # row i + t repeats row i
    _, nn_1, _, nn_2 = matcher.dual_argmax_cosine_bf16(twice, twice)
    first = torch.arange(2 * t, device=nn_1.device) % t
    if not (torch.equal(nn_1.long(), first) and torch.equal(nn_2.long(), first)):
        raise AssertionError("bf16 matcher: exact ties do not go to the first index")
    return errs[0]


def check_matcher_exact(device, t=300, d=3456, seed=2) -> None:
    """Well-separated maxima: desc2 is a permutation of desc1 plus small
    noise, so every row and column argmax is one exact index."""
    rs = np.random.default_rng(seed)
    a = rs.standard_normal((t, d)).astype(np.float32)
    perm = rs.permutation(t)
    b = a[perm] + 0.05 * rs.standard_normal((t, d)).astype(np.float32)
    _, nn_1, _, nn_2 = matcher.dual_argmax_cosine(torch.from_numpy(a).to(device),
                                                 torch.from_numpy(b).to(device))
    inv = np.argsort(perm)
    if not (np.array_equal(nn_1.cpu().numpy(), inv) and np.array_equal(nn_2.cpu().numpy(), perm)):
        raise AssertionError("matcher exact-index case: argmax differs from the permutation")


def underflow_qkv(shape, rows, c, seed, k_noise=0.05):
    """(B, T, H, hd) f32 q, k, v: keys clustered around a unit direction u
    (noise ``k_noise``) and the first ``rows`` query rows at -c sqrt(hd) u,
    so every real logit of those rows is about -c (tests/test_ops.py's
    underflow and padded-column cases)."""
    B, T, H, D = shape
    rs = np.random.default_rng(seed)
    u = rs.standard_normal(D).astype(np.float32)
    u /= np.linalg.norm(u)
    k = (u + k_noise * rs.standard_normal(shape)).astype(np.float32)
    q = 0.3 * rs.standard_normal(shape).astype(np.float32)
    q[:, :rows] = -c * np.sqrt(D) * u
    v = rs.standard_normal(shape).astype(np.float32)
    return q, k, v


def _max_err(out: torch.Tensor, ref: torch.Tensor, what: str, tol: float = ATTN_TOL) -> float:
    if not bool(torch.isfinite(out.float()).all()):
        raise AssertionError(f"{what}: kernel output is not finite")
    err = (out.float() - ref.float()).abs().max().item()
    if not err <= tol:
        raise AssertionError(f"{what} kernel vs plain: max abs err {err} > {tol}")
    return err


def check_attention_fast(device, shape=SERVE_ATTN_SHAPE, seed=4) -> float:
    """No-max kernel vs its plain version on random bf16 inputs at ``shape``
    and at B = 2 for each T of FAST_ATTN_T (``shape``'s heads), and on rows
    whose real logits are all about -30 (T = 139 pads the last tile).
    Returns the max abs error at ``shape``."""
    rs = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rs.standard_normal(shape).astype(np.float32))
               .to(device, torch.bfloat16) for _ in range(3))
    err = _max_err(attention.mha_attention_fast(q, k, v),
                   attention.mha_attention_fast_plain(q, k, v), "no-max attention")
    for T in FAST_ATTN_T:
        q, k, v = (_normal(device, (2, T, shape[2], shape[3]), rs, torch.bfloat16)
                   for _ in range(3))
        _max_err(attention.mha_attention_fast(q, k, v),
                 attention.mha_attention_fast_plain(q, k, v), f"no-max attention, B = 2, T = {T}")
    q, k, v = (torch.from_numpy(x).to(device, torch.bfloat16)
               for x in underflow_qkv((1, 139, 2, 64), rows=4, c=30.0, seed=11))
    _max_err(attention.mha_attention_fast(q, k, v), attention.mha_attention_fast_plain(q, k, v),
             "no-max attention, underflow rows")
    return err


def _qkv_slices(device, B, T, D, rs):
    """q, k, v as the column slices of one seeded (B, T, 3 D) bf16 qkv output."""
    qkv = _normal(device, (B, T, 3 * D), rs, torch.bfloat16)
    return qkv[..., :D], qkv[..., D:2 * D], qkv[..., 2 * D:]


def check_int8_attention(device, shape=SERVE_ATTN_SHAPE, ts=ATTN_T, seed=5) -> float:
    """Fused int8 kernel vs its plain version: q, k, v are column slices of
    one (B, T, 3 H hd) bf16 qkv output, as the main path hands them over, at
    ``shape`` and at B = 2 for each T of ``ts``; then rows with real logits
    about -25 and 58 padded columns (T = 70).  Returns the max abs error at
    ``shape``."""
    B, T, H, hd = shape
    rs = np.random.default_rng(seed)
    q, k, v = _qkv_slices(device, B, T, H * hd, rs)
    err = _max_err(attn_int8.fused_int8_attention(q, k, v, heads=H),
                   attn_int8.fused_int8_attention_plain(q, k, v, heads=H), "int8 attention")
    for t in ts:
        q, k, v = _qkv_slices(device, 2, t, H * hd, rs)
        _max_err(attn_int8.fused_int8_attention(q, k, v, heads=H),
                 attn_int8.fused_int8_attention_plain(q, k, v, heads=H),
                 f"int8 attention, B = 2, T = {t}")
    q, k, v = (torch.from_numpy(x.reshape(1, 70, 128)).to(device, torch.bfloat16)
               for x in underflow_qkv((1, 70, 2, 64), rows=8, c=25.0, seed=11, k_noise=0.0))
    _max_err(attn_int8.fused_int8_attention(q, k, v, heads=2),
             attn_int8.fused_int8_attention_plain(q, k, v, heads=2),
             "int8 attention, padded columns")
    return err


def check_quant_probe(device, shape=SERVE_ATTN_SHAPE, seed=7) -> dict:
    """The int8 kernel's own quantization (its Q path with the Q scale factor,
    its K path) against _quant_th on CPU tensors, the reference's arithmetic
    (a true division by 127, as in JAX): int8 values equal and scales equal
    bit for bit, on column slices of a seeded qkv output whose first token
    is 0, second 1000x and third 1e-20x (amax below the 1e-12 floor).
    Returns the number of rows compared and the number of scales in which
    _quant_th run on the card's own tensors differs from the reference
    (PyTorch's CUDA division by a Python number multiplies by its
    reciprocal)."""
    B, T, H, hd = shape
    D = H * hd
    qkv = _normal(device, (B, T, 3 * D), np.random.default_rng(seed), torch.bfloat16)
    qkv[:, 0] = 0
    qkv[:, 1] *= 1000
    qkv[:, 2] *= 1e-20
    q, k = qkv[..., :D], qkv[..., D:2 * D]
    card_diffs = 0
    for x, extra, k_path in ((q, attn_int8._q_extra_scale(q, H), False), (k, 1.0, True)):
        what = "K" if k_path else "Q"
        q8, sc = attn_int8.quant_th_probe(x, H, extra, k_path=k_path)
        ref8, ref_s = attn_int8._quant_th(x.cpu(), H, extra)
        if not torch.equal(q8.cpu(), ref8):
            raise AssertionError(f"int8 kernel's {what} quantization: "
                                 f"{int((q8.cpu() != ref8).sum())} int8 values differ")
        bits = lambda t: t.cpu().contiguous().view(torch.int32)
        if not torch.equal(bits(sc), bits(ref_s)):
            raise AssertionError(f"int8 kernel's {what} quantization: "
                                 f"{int((bits(sc) != bits(ref_s)).sum())} scales differ")
        card_diffs += int((bits(attn_int8._quant_th(x, H, extra)[1]) != bits(ref_s)).sum())
    return {"rows": 2 * B * T * H, "card_quant_th_scale_diffs": card_diffs}


# ---------------------------------------------------------------------------
# phase 3: the main path
# ---------------------------------------------------------------------------


def reference_config() -> VSConfig:
    """configs/config.yaml's settings (built in code: the card's machine has
    no promise of pyyaml): the defaults with the dls solve."""
    return VSConfig(pinv_mode="dls")


def texture(h: int, w: int, seed: int, radius: int = 6) -> np.ndarray:
    """Seeded noise smoothed by two box blurs, uint8 (h, w, 3)."""
    x = np.random.default_rng(seed).standard_normal((h, w, 3))
    for _ in range(2):
        for ax in (0, 1):
            c = np.cumsum(np.pad(x, [(radius + 1, radius) if a == ax else (0, 0)
                                     for a in range(3)], mode="reflect"), axis=ax)
            n = x.shape[ax]
            x = (np.take(c, np.arange(2 * radius + 1, n + 2 * radius + 1), axis=ax)
                 - np.take(c, np.arange(0, n), axis=ax)) / (2 * radius + 1)
    x = (x - x.min()) / (x.max() - x.min())
    return (255 * x).astype(np.uint8)


def serving_config() -> VSConfig:
    """configs/config_vitb_518.yaml's settings, built in code: ViT-B/14 at
    518, the dls solve."""
    return VSConfig(pinv_mode="dls", dino_input_size=518, model_name="dinov2_vitb14")


def make_frames(cfg: VSConfig, seed=0, shifts=SHIFTS):
    """Goal frame, current frames (the texture shifted by a few pixels) and a
    constant 0.6 m depth map, all at the camera's resolution."""
    m = 1 + max(max(abs(dy), abs(dx)) for dy, dx in shifts)
    big = texture(cfg.v_max + 2 * m, cfg.u_max + 2 * m, seed)
    crop = lambda dy, dx: np.ascontiguousarray(big[m + dy: m + dy + cfg.v_max,
                                                   m + dx: m + dx + cfg.u_max])
    depth = np.full((cfg.v_max, cfg.u_max), 0.6, np.float32)
    return crop(0, 0), [crop(dy, dx) for dy, dx in shifts], depth


def drive(net, model: ServoModel, goal, frames, depth, scores, states=None):
    """goal_descriptors, then one servo_step per frame, carrying the EMA and
    the previous command, or taking them from ``states`` (one (ema, prev) per
    step).  Returns (goal descriptors, step results)."""
    goal_desc = goal_descriptors(net, model, goal)
    ema = EmaState.init(device=model.device)
    prev = torch.zeros(6, device=model.device)
    results = []
    for i, (frame, s) in enumerate(zip(frames, scores)):
        if states is not None:
            ema, prev = states[i]
        r = servo_step(net, model, goal_desc, frame, depth, ema, prev, scores=s)
        ema, prev = r.ema, r.v_c
        results.append(r)
    if model.device != "cpu":
        torch.cuda.synchronize()
    return goal_desc, results


def _unit_rows(desc) -> torch.Tensor:
    """Descriptors as f32 unit rows (int8 binned rows by their norms)."""
    if isinstance(desc, QuantizedBinned):
        return desc.q.float() * torch.rsqrt(desc.nq + 1e-12)[:, None]
    d = desc.float()
    return d * torch.rsqrt(torch.square(d).sum(-1, keepdim=True) + 1e-24)


def check_outputs(model: ServoModel, goal_desc, results) -> None:
    t = model.grid()[0] * model.grid()[1]
    rows = goal_desc.q if isinstance(goal_desc, QuantizedBinned) else goal_desc
    if tuple(rows.shape) != (t, model.desc_dim()):
        raise AssertionError(f"goal descriptors {tuple(rows.shape)} != {(t, model.desc_dim())}")
    if not bool(torch.isfinite(_unit_rows(goal_desc)).all()):
        raise AssertionError("goal descriptors are not finite")
    k = model.cfg.num_pairs
    for i, r in enumerate(results):
        if r.body_twist.shape != (6,) or r.s_uv.shape != (k, 2):
            raise AssertionError(f"step {i}: shapes {tuple(r.body_twist.shape)}, {tuple(r.s_uv.shape)}")
        for name in ("v_c", "body_twist", "s_uv", "s_uv_star"):
            if not bool(torch.isfinite(getattr(r, name)).all()):
                raise AssertionError(f"step {i}: {name} is not finite")


def compare_runs(ref, ker, every_step: bool = False,
                 tol=(DESC_REL_TOL, DESC_COS_MIN, TWIST_TOL)) -> dict:
    """Hold the kernel run against the plain run.  Pairs are the same when
    goal pixels agree exactly and current pixels within 1 px; twists are
    compared at the steps up to the first one whose pairs differ (the EMA
    carries a difference forward), or, with ``every_step`` (the plain run
    was handed the kernel run's EMA and command at each step), at every step
    whose pairs agree.  ``tol``: the goal descriptors' max |diff| / max
    |ref|, the least cosine of a goal descriptor row, the twists' max abs
    difference."""
    desc_rel_tol, desc_cos_min, twist_tol = tol
    (ref_goal, ref_steps), (ker_goal, ker_steps) = ref, ker
    if isinstance(ref_goal, QuantizedBinned):
        g_ref, g_ker = _unit_rows(ref_goal), _unit_rows(ker_goal)
    else:
        g_ref, g_ker = ref_goal.float(), ker_goal.float()
    desc_rel = ((g_ker - g_ref).abs().max() / g_ref.abs().max()).item()
    if not desc_rel <= desc_rel_tol:
        raise AssertionError(f"goal descriptors: max |diff| / max |ref| = {desc_rel} > {desc_rel_tol}")
    row_cos = torch.nn.functional.cosine_similarity(g_ker, g_ref, dim=-1).min().item()
    if not row_cos >= desc_cos_min:
        raise AssertionError(f"goal descriptors: a row's cosine {row_cos} < {desc_cos_min}")
    differing, twist_err, compared = [], 0.0, 0
    for r, k in zip(ref_steps, ker_steps):
        same = ((r.s_uv_star == k.s_uv_star).all(-1) & ((r.s_uv - k.s_uv).abs() <= 1.0).all(-1)
                & (r.valid == k.valid))
        differing.append(int((~same).sum()))
        if differing[-1] if every_step else any(differing):
            continue
        compared += 1
        twist_err = max(twist_err, (r.body_twist - k.body_twist).abs().max().item())
    if not twist_err <= twist_tol:
        raise AssertionError(f"body twists differ by {twist_err} > {twist_tol}")
    return {"desc_rel_err": desc_rel, "desc_row_cos_min": row_cos,
            "differing_pairs": differing, "twist_max_abs_err": twist_err,
            "steps_compared": compared,
            "twist_max_abs": max(k.body_twist.abs().max().item() for k in ker_steps)}


def pair_scores(model: ServoModel, n: int, seed=0) -> list:
    """The pair-sampling scores of ``n`` steps, from a seeded generator."""
    t = model.grid()[0] * model.grid()[1]
    gen = torch.Generator().manual_seed(seed + 1)
    return [torch.rand(t, generator=gen) for _ in range(n)]


def float_twists(fnet, cfg: VSConfig, device, seed=0) -> list:
    """Body twists of the bf16 (not quantized) servo step of ``fnet`` on the
    serving phase's frames and scores, kernels on."""
    model = ServoModel.create(cfg, device=device)
    net = copy.deepcopy(fnet).cast_blocks(model.compute_dtype)
    goal, frames, depth = make_frames(cfg, seed, shifts=SHIFTS + CALIB_SHIFTS)
    _, results = drive(net, model, goal, frames[:N_STEPS], depth,
                       pair_scores(model, N_STEPS, seed))
    return [r.body_twist.tolist() for r in results]


def _counters():
    return {"attention": attention.mha_attention, "attention_f32": attention.mha_attention_f32,
            "attention_fast": attention.mha_attention_fast,
            "attn_int8": attn_int8.fused_int8_attention, "matcher": matcher.dual_argmax_cosine,
            "matcher_bf16": matcher.dual_argmax_cosine_bf16}


def run_main_path(net, cfg: VSConfig, model_kernels: ServoModel, seed=0, frames=None,
                  every_step: bool = False, tol=(DESC_REL_TOL, DESC_COS_MIN, TWIST_TOL)) -> dict:
    """Both runs of the main path and their checks; the launch counters are
    zeroed just before the kernel run and read just after it.  ``frames``:
    (goal, current frames, depth), by default :func:`make_frames`'.
    ``every_step``: the plain run takes the kernel run's EMA and command at
    each step, and twists are compared at every step whose pairs agree.
    ``tol``: :func:`compare_runs`'."""
    goal, frames, depth = frames or make_frames(cfg, seed)
    scores = pair_scores(model_kernels, len(frames), seed)
    model_plain = dataclasses.replace(model_kernels, use_kernels=False)

    for fn in _counters().values():
        fn.launches = 0
    ker = drive(net, model_kernels, goal, frames, depth, scores)
    launches = {name: fn.launches for name, fn in _counters().items()}
    states = None
    if every_step:
        states = [(EmaState.init(device=model_kernels.device),
                   torch.zeros(6, device=model_kernels.device))]
        states += [(r.ema, r.v_c) for r in ker[1][:-1]]
    ref = drive(net, model_plain, goal, frames, depth, scores, states)
    for run in (ker, ref):
        check_outputs(model_kernels, *run)
    summary = compare_runs(ref, ker, every_step, tol)
    summary["launches"] = launches
    summary["num_valid"] = [int(r.num_valid) for r in ker[1]]
    summary["body_twists"] = [r.body_twist.tolist() for r in ker[1]]
    summary["body_twist_last"] = summary["body_twists"][-1]
    return summary


def f32_step(cfg: VSConfig, device):
    """The f32 step of ``cfg`` (f32 compute, exact GELU: the reference's
    strict-parity numerics), kernels on, and its seeded ViT (phase 3's
    seed).  Returns (net, model)."""
    model = ServoModel.create(cfg, compute_dtype=torch.float32, gelu_approx=False,
                              device=device)
    net = init_vit(model.vit, torch.Generator().manual_seed(0), device=device,
                   layerscale=1.0).cast_blocks(model.compute_dtype).eval()
    return net, model


def serving_model(cfg: VSConfig, variant: str, device, vit=None) -> ServoModel:
    """The int8 serving model of a variant (F or N), kernels on; ``vit``
    replaces the configuration's ViT (a tiny one in the CPU tests)."""
    quant_attn, attn_impl, _ = VARIANTS[variant]
    if vit is None:
        return ServoModel.create(cfg, device=device, quantized=True, attn_impl=attn_impl,
                                 quant_attn=quant_attn)
    return ServoModel(vit=dataclasses.replace(vit, attn_impl=attn_impl, quant_attn=quant_attn),
                      cfg=cfg, device=device, quantized=True)


def run_serving_path(fnet, cfg: VSConfig, variant: str, device, seed=0, vit=None):
    """Calibrate the int8 ViT of ``fnet`` (static scales, goal + 7 shifted
    frames), then both runs of the serving step as :func:`run_main_path`.
    Returns (summary, the quantized ViT, the model)."""
    model = serving_model(cfg, variant, device, vit)
    goal, frames, depth = make_frames(cfg, seed, shifts=SHIFTS + CALIB_SHIFTS)
    t0 = time.perf_counter()
    qnet = quantized_vit(fnet, model, [goal, *frames[N_STEPS:]])
    if model.device != "cpu":
        torch.cuda.synchronize()
    calib_s = time.perf_counter() - t0
    summary = run_main_path(qnet, cfg, model, seed, frames=(goal, frames[:N_STEPS], depth),
                            every_step=True)
    summary["calibration_s"] = calib_s
    return summary, qnet, model


# ---------------------------------------------------------------------------
# phase 4: times and bounds
# ---------------------------------------------------------------------------


def attention_bound_ms(shape=ATTN_SHAPE, f32: bool = False,
                       tensor_cores: bool = False) -> tuple[float, str]:
    """Exact or no-max attention: QK^T and P.V on the bf16 tensor cores, or
    (``f32``) in f32 FMA outside them, or (``f32`` and ``tensor_cores``) f32
    accurate on the TF32 tensor cores, each product taken TF32_PASSES times
    (split precision)."""
    B, T, H, hd = shape
    flops = 4.0 * B * H * T * T * hd
    nbytes = 4.0 * B * T * H * hd * (4 if f32 else 2)   # q, k, v read, o written
    if f32 and tensor_cores:
        return _bound(TF32_PASSES * flops / PEAK_TF32_FLOPS, nbytes / PEAK_BYTES)
    return _bound(flops / (PEAK_F32_FLOPS if f32 else PEAK_BF16_FLOPS), nbytes / PEAK_BYTES)


def int8_attention_bound_ms(shape=SERVE_ATTN_SHAPE) -> tuple[float, str]:
    """Fused int8 attention: QK^T at the int8 peak plus P.V at the bf16 peak
    (the Q/K quantization, a few operations an element, is left out)."""
    B, T, H, hd = shape
    mm = 2.0 * B * H * T * T * hd
    nbytes = B * T * H * hd * (2 + 2 + 2 + 2)    # bf16 q, k, v read, o written
    return _bound(mm / PEAK_INT8_OPS + mm / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES)


def matcher_bound_ms(shape=MATCH_SHAPE, bf16: bool = False) -> tuple[float, str]:
    """f32 mode: f32 rows, products outside the tensor cores; bf16 mode: bf16
    rows on the bf16 tensor cores."""
    t, d = shape
    flops = 2.0 * t * t * d
    nbytes = 2.0 * t * d * (2 if bf16 else 4) + 2.0 * t * 8   # rows read, quartet written
    return _bound(flops / (PEAK_BF16_FLOPS if bf16 else PEAK_F32_FLOPS), nbytes / PEAK_BYTES)


def _bound(t_ops: float, t_bytes: float) -> tuple[float, str]:
    return (max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes")


def cuda_ms(fn, iters=200, warmup=10, sleep_cycles=50_000_000, tries=4) -> float:
    """Mean device milliseconds per call by CUDA events around ``iters``
    calls.  A device sleep ahead of the first timed call lets the host queue
    every call before the device starts them, so the events read the
    device's time and not the host's launch rate.  If the start event has
    already run when the last call is queued, the sleep was too short: it
    doubles and the measurement repeats (at most ``tries`` times)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(sleep_cycles)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        queued_in_time = not start.query()
        torch.cuda.synchronize()
        if queued_in_time:
            break
        sleep_cycles *= 2
    return start.elapsed_time(end) / iters


def time_kernels(device) -> dict:
    """Each kernel alone (its launch on the inputs it is handed, after the
    wrapper's checks and, for the no-max kernel, the Q scaling; the int8
    kernel quantizes Q and K itself), its plain version on the same inputs
    and one PyTorch call computing the same function where there is one."""
    rs = np.random.default_rng(3)
    bf16 = lambda shape: (torch.from_numpy(rs.standard_normal(shape).astype(np.float32))
                          .to(device, torch.bfloat16))
    heads_first = lambda *xs: [x.transpose(1, 2).contiguous() for x in xs]   # (B, h, T, hd)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    q, k, v = (bf16(ATTN_SHAPE) for _ in range(3))
    qh, kh, vh = heads_first(q, k, v)
    f32 = lambda shape: torch.from_numpy(rs.standard_normal(shape).astype(np.float32)).to(device)
    q32, k32, v32 = (f32(ATTN_SHAPE) for _ in range(3))
    q32h, k32h, v32h = heads_first(q32, k32, v32)
    fq32, fk32, fv32 = (f32(SERVE_ATTN_SHAPE) for _ in range(3))
    fq32h, fk32h, fv32h = heads_first(fq32, fk32, fv32)
    t, d = MATCH_SHAPE
    a = torch.from_numpy(rs.standard_normal((t, d)).astype(np.float32)).to(device)
    b = torch.from_numpy(rs.standard_normal((t, d)).astype(np.float32)).to(device)
    an = a * matcher.inverse_norms(a)[:, None]
    bn = b * matcher.inverse_norms(b)[:, None]

    def library_match():
        sim = an @ bn.T
        return sim.max(1), sim.max(0)

    a16, b16 = a.to(torch.bfloat16), b.to(torch.bfloat16)
    ua, ub = matcher.bf16_unit_rows(a16), matcher.bf16_unit_rows(b16)

    def library_match_bf16():       # cuBLAS bf16 with a bf16 output: the similarities rounded
        sim = ua @ ub.T
        return sim.max(1), sim.max(0)

    B, T, H, hd = SERVE_ATTN_SHAPE
    fq, fk, fv = (bf16(SERVE_ATTN_SHAPE) for _ in range(3))
    fqs = attention._fast_scaled_q(fq)
    fqh, fkh, fvh = heads_first(fq, fk, fv)
    qkv = bf16((B, T, 3 * H * hd))
    D = H * hd
    iq, ik, iv = qkv[..., :D], qkv[..., D:2 * D], qkv[..., 2 * D:]
    split = lambda name, *qkv: cuda_ms(lambda: attention._launch(
        "vitvs_attention_split_fwd", *qkv, attention.EXACT_SPLITS[name]))
    return {
        "attention": {"ms": cuda_ms(lambda: attention.mha_attention(q, k, v)),
                      "plain_ms": cuda_ms(lambda: attention.mha_attention_plain(q, k, v)),
                      "library_ms": cuda_ms(lambda: sdpa(qh, kh, vh)),
                      "ms_t1370": cuda_ms(lambda: attention.mha_attention(fq, fk, fv)),
                      "library_ms_t1370": cuda_ms(lambda: sdpa(fqh, fkh, fvh)),
                      # the exact kernel's two work splits at both shapes
                      **{f"{name}_ms{sfx}": split(name, *x) for name in ("64-row", "128-row")
                         for sfx, x in (("", (q, k, v)), ("_t1370", (fq, fk, fv)))}},
        # f32 SDPA with TF32 off (ServoModel sets it): the same function in f32
        "attention_f32": {
            "ms": cuda_ms(lambda: attention._launch("vitvs_attention_f32_fwd", q32, k32, v32)),
            "plain_ms": cuda_ms(lambda: attention.mha_attention_plain(q32, k32, v32), iters=50),
            "library_ms": cuda_ms(lambda: sdpa(q32h, k32h, v32h)),
            "ms_t1370": cuda_ms(lambda: attention.mha_attention(fq32, fk32, fv32)),
            "plain_ms_t1370": cuda_ms(lambda: attention.mha_attention_plain(fq32, fk32, fv32),
                                      iters=20),
            "library_ms_t1370": cuda_ms(lambda: sdpa(fq32h, fk32h, fv32h))},
        "matcher": {"ms": cuda_ms(lambda: matcher._launch_f32(a, b)),
                    "plain_ms": cuda_ms(lambda: matcher.dual_argmax_cosine_plain(a, b), iters=50),
                    "library_ms": cuda_ms(library_match, iters=50)},
        "matcher_bf16": {
            "ms": cuda_ms(lambda: matcher._launch_bf16(ua, ub)),
            "plain_ms": cuda_ms(lambda: matcher.dual_argmax_cosine_bf16_plain(a16, b16), iters=50),
            "library_ms": cuda_ms(library_match_bf16),
            "wrapper_ms": cuda_ms(lambda: matcher.dual_argmax_cosine_bf16(a16, b16))},
        "attention_fast": {
            "ms": cuda_ms(lambda: attention._launch("vitvs_attention_fast_fwd", fqs, fk, fv)),
            "plain_ms": cuda_ms(lambda: attention.mha_attention_fast_plain(fq, fk, fv), iters=50),
            "library_ms": cuda_ms(lambda: sdpa(fqh, fkh, fvh)),
            "wrapper_ms": cuda_ms(lambda: attention.mha_attention_fast(fq, fk, fv))},
        "attn_int8": {       # from the bf16 slices: the Q/K quantization included
            "ms": cuda_ms(lambda: attn_int8._launch(iq, ik, iv, H)),
            "plain_ms": cuda_ms(lambda: attn_int8.fused_int8_attention_plain(iq, ik, iv, H),
                                iters=50),
            # no PyTorch call computes int8-QK^T no-max attention: library_ms is
            # null; SDPA on bf16 at the same shape is logged as a reference point
            "library_ms": None,
            "sdpa_bf16_ms": cuda_ms(lambda: sdpa(fqh, fkh, fvh)),
            "wrapper_ms": cuda_ms(lambda: attn_int8.fused_int8_attention(iq, ik, iv, heads=H))},
    }


def time_step(net, model: ServoModel, iters=20) -> float:
    """Median host milliseconds of one servo_step from a host (numpy) frame
    and depth map to the twist on the card, synchronized."""
    goal, frames, depth = make_frames(model.cfg, seed=0)
    goal_desc = goal_descriptors(net, model, goal)
    ema, prev = EmaState.init(device=model.device), torch.zeros(6, device=model.device)
    gen = torch.Generator().manual_seed(7)
    times = []
    for i in range(iters + 3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        servo_step(net, model, goal_desc, frames[0], depth, ema, prev, generator=gen)
        torch.cuda.synchronize()
        if i >= 3:
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def profile_steps(net, model: ServoModel, steps=10, top=25,
                  trace_path: Path | None = None) -> None:
    """Device time by kernel over ``steps`` servo steps (torch.profiler), the
    device's busy share of that window, and the host's waits on the device."""
    from torch.profiler import ProfilerActivity, profile

    goal, frames, depth = make_frames(model.cfg, seed=0)
    goal_desc = goal_descriptors(net, model, goal)
    ema, prev = EmaState.init(device=model.device), torch.zeros(6, device=model.device)
    gen = torch.Generator().manual_seed(7)
    run = lambda: servo_step(net, model, goal_desc, frames[0], depth, ema, prev, generator=gen)
    for _ in range(3):
        run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = prof.key_averages()
    # kernels and copies are the rows on the device; operator rows repeat their time
    on_device = [e for e in rows if str(e.device_type).endswith("CUDA")]
    dev_us = lambda e: e.self_device_time_total
    device_ms = sum(dev_us(e) for e in on_device) / 1e3
    log(f"profile: {steps} steps, wall {wall_ms / steps:.3f} ms/step (profiled), device busy "
        f"{device_ms / steps:.3f} ms/step = {100 * device_ms / wall_ms:.1f}% of the window, "
        f"{sum(e.count for e in on_device) / steps:.0f} device activities/step")
    for e in sorted(on_device, key=dev_us, reverse=True)[:top]:
        log(f"profile: device {dev_us(e) / 1e3 / steps:8.4f} ms/step  "
            f"calls {e.count / steps:6.1f}/step  {e.key[:90]}")
    for e in sorted(rows, key=lambda e: e.cpu_time_total, reverse=True):
        if e.key.startswith("cu") and any(w in e.key for w in ("Synchronize", "Memcpy", "Launch")):
            log(f"profile: host {e.cpu_time_total / 1e3 / steps:8.4f} ms/step  "
                f"calls {e.count / steps:6.1f}/step  {e.key[:90]}")
    if trace_path is not None:
        trace_path.parent.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(trace_path))
        log(f"profile: trace written to {trace_path}")


# ---------------------------------------------------------------------------


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", nargs="?", const="bf16", choices=["bf16", "f32", *VARIANTS],
                    help="build, then only profile servo steps of the bf16 path (default), "
                         "the f32 path or an int8 serving variant (no checks, no result line)")
    ap.add_argument("--trace", type=Path, default=None,
                    help="with --profile: write the profiler's chrome trace here")
    args = ap.parse_args()
    import vitvs_tpu_torch

    here = Path(__file__).resolve().parent
    if Path(vitvs_tpu_torch.__file__).resolve().parent != here / "vitvs_tpu_torch":
        print(f"vitvs_tpu_torch is not this checkout's ({vitvs_tpu_torch.__file__})",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke.py runs the port on the card", file=sys.stderr)
        return 2
    device = "cuda"
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, cuda {torch.version.cuda}")

    with phase("1 card+build"):
        card = card_line()
        log(f"card: {card}")
        info = _build.build()
        _build.library()
        log(f"kernels built in {info['seconds']:.2f} s (compiled={info['compiled']}): {info['path']}")
        for line in info["log"].splitlines():
            if any(w in line for w in ("registers", "Compiling entry", "spill", "wgmma",
                                       "warning")):
                log(f"ptxas: {line.strip()}")

    with phase("2 kernels-vs-plain"):
        errs = {"attention": check_attention(device)}
        log(f"attention {ATTN_SHAPE} bf16: max abs err {errs['attention']:.3e} (tol {ATTN_TOL}); "
            f"B = 2 at T = {ATTN_T} and logits of about +-{LARGE_LOGIT} ok")
        errs["attention_f32"] = check_attention(device, ts=ATTN_F32_T, seed=13,
                                                dtype=torch.float32, tol=ATTN_F32_TOL,
                                                large_tol=LARGE_LOGIT_F32_TOL)
        log(f"f32 attention {ATTN_SHAPE} f32: max abs err {errs['attention_f32']:.3e} "
            f"(tol {ATTN_F32_TOL}), two launches bit for bit; B = 2 at T = {ATTN_F32_T} ok, "
            f"and logits of about +-{LARGE_LOGIT} within {LARGE_LOGIT_F32_TOL}")
        errs["matcher_bf16"] = check_matcher_bf16(device)
        log(f"bf16 matcher {MATCH_SHAPE} bf16: max abs err {errs['matcher_bf16']:.3e} "
            f"(tol {MATCH_VAL_TOL}), argmax ok; ragged shapes and first-index ties ok")
        errs["matcher"] = check_matcher(device)
        log(f"matcher {MATCH_SHAPE} f32: max abs err {errs['matcher']:.3e} "
            f"(tol {MATCH_VAL_TOL}), argmax ok; two launches bit for bit; (t1, t2, d) = "
            f"{MATCH_F32_SHAPES} ok")
        check_matcher_exact(device)
        log("matcher exact-index case ok")
        errs["attention_fast"] = check_attention_fast(device)
        log(f"no-max attention {SERVE_ATTN_SHAPE} bf16: max abs err "
            f"{errs['attention_fast']:.3e} (tol {ATTN_TOL}); B = 2 at T = {FAST_ATTN_T} "
            f"and underflow rows ok")
        errs["attn_int8"] = check_int8_attention(device)
        log(f"int8 attention {SERVE_ATTN_SHAPE} int8/bf16: max abs err "
            f"{errs['attn_int8']:.3e} (tol {ATTN_TOL}); B = 2 at T = {ATTN_T} and padded "
            f"columns ok")
        probe = check_quant_probe(device)
        log(f"int8 kernel's Q/K quantization equals _quant_th bit for bit on "
            f"{probe['rows']} rows; _quant_th on the card's tensors differs from it in "
            f"{probe['card_quant_th_scale_diffs']} scales")

    cfg = reference_config()
    model = ServoModel.create(cfg, use_kernels=True, device=device)
    net = init_vit(model.vit, torch.Generator().manual_seed(0), device=device,
                   layerscale=1.0).cast_blocks(model.compute_dtype).eval()
    scfg = serving_config()
    fnet = init_vit(ServoModel.create(scfg, device=device).vit, torch.Generator().manual_seed(0),
                    device=device, layerscale=1.0).eval()    # f32, quantized per variant
    net32, model32 = f32_step(cfg, device)
    if args.profile:
        with phase("profile"):
            if args.profile == "bf16":
                profile_steps(net, model, trace_path=args.trace)
            elif args.profile == "f32":
                profile_steps(net32, model32, trace_path=args.trace)
            else:
                smodel = serving_model(scfg, args.profile, device)
                goal, frames, _ = make_frames(scfg, 0, shifts=SHIFTS + CALIB_SHIFTS)
                qnet = quantized_vit(fnet, smodel, [goal, *frames[N_STEPS:]])
                profile_steps(qnet, smodel, trace_path=args.trace)
        return 0
    with phase("3 main-path"):
        summary = run_main_path(net, cfg, model)
        log(f"main path: {json.dumps(summary)}")
        want = {name: 0 for name in _counters()}
        want.update(attention=(cfg.layer + 1) * (1 + N_STEPS), matcher_bf16=N_STEPS)
        if summary["launches"] != want:
            raise AssertionError(f"launch counts {summary['launches']} != {want}")
    launches = dict(summary["launches"])

    serving = {}
    with phase("3b int8-serving"):
        ftw = np.array(float_twists(fnet, scfg, device))
        log(f"bf16 ViT-B/14 @ 518 step, same frames: max |twist| {np.abs(ftw).max():.4e}, "
            f"twists {ftw.tolist()}")
        for variant, (_, _, kernel) in VARIANTS.items():
            ssum, qnet, smodel = run_serving_path(fnet, scfg, variant, device)
            log(f"int8 serving {variant}: {json.dumps(ssum)}")
            log(f"int8 serving {variant} vs bf16 step: max |twist diff| "
                f"{np.abs(np.array(ssum['body_twists']) - ftw).max():.4e}")
            want = {name: 0 for name in _counters()}
            want[kernel] = (scfg.layer + 1) * (1 + N_STEPS)
            if ssum["launches"] != want:
                raise AssertionError(f"variant {variant}: launch counts {ssum['launches']} != {want}")
            launches[kernel] = ssum["launches"][kernel]
            serving[variant] = (qnet, smodel)

    with phase("3c f32-step"):
        fsum = run_main_path(net32, cfg, model32, tol=F32_TOL)
        log(f"f32 step (tol: desc rel, row cos, twist {F32_TOL}): {json.dumps(fsum)}")
        want = {name: 0 for name in _counters()}
        want.update(attention_f32=(cfg.layer + 1) * (1 + N_STEPS), matcher=N_STEPS)
        if fsum["launches"] != want:
            raise AssertionError(f"f32 step: launch counts {fsum['launches']} != {want}")
        launches.update(attention_f32=want["attention_f32"], matcher=want["matcher"])

    with phase("4 times"):
        step_ms = time_step(net, model)
        log(f"[{card}] servo_step median {step_ms:.3f} ms (ViT-S/14 @ 308, bf16, kernels)")
        ms = time_step(net32, model32)
        log(f"[{card}] servo_step median {ms:.3f} ms (ViT-S/14 @ 308, f32, exact GELU, kernels)")
        for variant, (qnet, smodel) in serving.items():
            ms = time_step(qnet, smodel)
            log(f"[{card}] servo_step median {ms:.3f} ms (ViT-B/14 @ 518, int8 W8A8, "
                f"variant {variant}, kernels)")
        times = time_kernels(device)
        bounds = {"attention": attention_bound_ms(),
                  "attention_f32": attention_bound_ms(f32=True, tensor_cores=True),
                  "matcher": matcher_bound_ms(),
                  "matcher_bf16": matcher_bound_ms(bf16=True),
                  "attention_fast": attention_bound_ms(SERVE_ATTN_SHAPE),
                  "attn_int8": int8_attention_bound_ms()}
        for name, tm in times.items():
            extra = {k: v for k, v in tm.items() if k not in ("ms", "plain_ms", "library_ms")}
            lib_ms = "none" if tm["library_ms"] is None else f"{tm['library_ms']:.4f} ms"
            log(f"[{card}] {name}: kernel {tm['ms']:.4f} ms, plain {tm['plain_ms']:.4f} ms, "
                f"library {lib_ms}, bound {bounds[name][0]:.5f} ms ({bounds[name][1]}) "
                + " ".join(f"{k} {v:.4f} ms" for k, v in extra.items()))
        f32_bounds = [attention_bound_ms(shape, f32=True, tensor_cores=tc)[0]
                      for tc in (True, False) for shape in (ATTN_SHAPE, SERVE_ATTN_SHAPE)]
        log(f"[{card}] attention_f32 bounds at T = 485 and 1370: tensor cores "
            f"({TF32_PASSES} TF32 passes) {f32_bounds[0]:.5f} and {f32_bounds[1]:.5f} ms; "
            f"f32 FMA {f32_bounds[2]:.5f} and {f32_bounds[3]:.5f} ms")

    sources = {"attention": ("vitvs_tpu_torch/csrc/attention.cu", "vitvs_tpu/ops/attention.py:42"),
               "attention_f32": ("vitvs_tpu_torch/csrc/attention_f32.cu",
                                 "vitvs_tpu/ops/attention.py:42"),
               "matcher": ("vitvs_tpu_torch/csrc/matcher.cu", "vitvs_tpu/ops/matcher.py:39"),
               "matcher_bf16": ("vitvs_tpu_torch/csrc/matcher.cu", "vitvs_tpu/ops/matcher.py:39"),
               "attention_fast": ("vitvs_tpu_torch/csrc/attention_fast.cu",
                                  "vitvs_tpu/ops/attention.py:65"),
               "attn_int8": ("vitvs_tpu_torch/csrc/attn_int8.cu", "vitvs_tpu/ops/attn_int8.py:80")}
    kernels = [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], "max_abs_err": errs[name],
         "ms": times[name]["ms"], "plain_ms": times[name]["plain_ms"],
         "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
         "library_ms": times[name]["library_ms"]}
        for name, (src, rep) in sources.items()]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
