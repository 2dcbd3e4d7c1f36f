#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (vitvs_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py              # the smoke run below
    python3 chip_smoke.py --profile [bf16|f32|F|N|none|nomax3|pv|qk+pv|relu|loop|loop518|int8loop|sift|orb|akaze|harris|train|vitg|fastbin]
                          [--trace trace.json]
                          [--chunk B]  # only: device-time breakdown of servo steps
                                       # of the bf16 or f32 path or an int8 serving variant
                                       # (F, N; static: none, nomax3, pv, qk+pv), or of
                                       # relu at 518 (trained),
                                       # or of closed-loop steps (at 308, or on the trained
                                       # ViT-S/14 @ 518 in bf16 or, int8loop, at run AD's
                                       # int8 settings; or a classical method's closed
                                       # loop), a chunk of B episodes a step; or (train)
                                       # train steps of ViT-S/14 @ 308 at batch 8; or (vitg,
                                       # fastbin) the seeded ViT-g/14 @ 518 bf16 step (or
                                       # chunk-step) with materialized or factorized bins
    python3 chip_smoke.py --train N [--size S] [--poster synthetic|real] [--resume P] [--budget-s T]
                                       # only: python -m vitvs_tpu_torch.train.train_servo
                                       # for N steps at S (308) with the JAX run's arguments
                                       # (batch 8, lr 3e-4, warm-up 100, seed 0, its synthetic
                                       # poster; --poster real the real one), from random
                                       # init or P; its files under
                                       # .train/ (a budget stop leaves the part checkpoint,
                                       # and the same command continues it); prints the loss
                                       # windows beside the JAX run's and the matching
                                       # quality, writes chiprun_out/train_sS_N.json and the
                                       # weights (bf16 blocks) beside it; --train 3000 at 308
                                       # is held to steps 2976-3000 <= 2.2, patch-acc >= 0.70
    python3 chip_smoke.py --cotrain relu|sqrelu [--budget-s T]
                                       # only: the campaign's co-train of the score
                                       # (train_servo --resume ckpt_real518 --size 518
                                       # --steps 2000 --attn-score S, the real poster; files
                                       # under .train/), the co-trained weights' matching
                                       # quality, then episodes 0 to 63 of the 500-episode
                                       # stream at chunk 8 with them (.replay/replay_s518_S_0_64.*),
                                       # held to at least 62 converged; T (1500 s) bounds it
                                       # all; writes chiprun_out/
                                       # train_s518_2000_real_resumed_S.json,
                                       # the weights (bf16 blocks) and replay_s518_S_0_64.json
    python3 chip_smoke.py --replay A:B [--method M] [--int8] [--fast-binned] [--perturbed]
                          [--chunk C] [--checkpoint F] [--budget-s S]
                                       # only: episodes [A, B) of the 500-episode seed-41
                                       # stream on the trained ViT-S/14 @ 518 (bf16; --int8:
                                       # run AD's int8 configuration; --fast-binned: match
                                       # by the factorized binned similarity, files
                                       # replay_s518_fast_A_B.*; --perturbed: each
                                       # episode's perturbed texture), C (8) a chunk,
                                       # resumable: an unfinished run leaves its checkpoint
                                       # (.replay/replay_s518[_int8][_pert]_A_B.ckpt) in
                                       # chiprun_out/ too; copy it back into .replay/ and
                                       # run again to go on; prints the converged count and
                                       # writes chiprun_out/replay_s518[_int8][_pert]_A_B.json;
                                       # --method sift|orb|akaze|harris: that classical
                                       # baseline on the 64-episode stream of
                                       # configs/real64.yaml (files replay_M[_pert]_A_B.*)

Phases, each announced with a flushed, timestamped start/done line:

1. card and build: the card's name and power limit (nvidia-smi), then the
   kernels' build, one nvcc per csrc/*.cu started together and one link
   (build seconds and -Xptxas -v lines);
2. kernels vs plain versions at the main paths' shapes (ViT-g's since
   phase 3k: exact attention at (1 and 8, 1370, 24, 64), the bf16 matcher at
   (1369, 13824) and batched at B = 8, int8 attention at D = 1536): exact attention at
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
   the int8 kernel's Q and K quantization and _quant_th on the card against
   _quant_th on the CPU, bit for bit (the jitted reference's arithmetic);
   the exact attention at the rotation search's batch, (4, 485, 6, 64); the
   trained ViT-S/14 @ 518's shapes: exact attention at (1, 1370, 6, 64) and
   (4, 1370, 6, 64), the bf16 matcher at (1369, 1369, 3456), no-max and
   fused int8 attention at 6 heads (1, 1370, 6 x 64); the batched chunk's:
   both matcher modes with a batch of B frames against one goal at (8,
   1369, 1369, 3456) bf16 and at B in {1, 3, 32} at 518's and 308's
   shapes, each item bit for bit a launch on it alone, two launches bit for
   bit, the key scratch left zero; exact attention at the chunk's (8, 1370,
   6, 64) and its search's (32, 1370, 6, 64);
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
3d. the closed loop: run_benchmark (harness/benchmark.py) at phase
   3's settings on the poster scene (the port's npz copy of the texture),
   ViT cast whole to bf16 as the benchmark casts it, cut to episodes 0 and 1
   of the seed-41 stream (rotation search on), one episode a chunk, for 40
   steps in segments of 20 with the ladder's minimum and maximum cut to 10
   and 30, then episode 1 on its perturbed texture; the launch counters
   must rise by exactly what the executed steps give (12 exact-attention
   launches for the goal, 12 for each chunk's search, 12 a chunk-step; 1
   bf16-matcher launch for each chunk's search and 1 a chunk-step); every
   step of episode 0 is teacher-forced through
   the plain step (its frame, EMA, command and scores), twists held within
   1e-3 wherever no pair differs; episode 0 runs again plain and where the
   trajectories part is reported; the npz's 22 arrays and finite poses are
   checked; then the closed-loop step's median ms beside the bare step's,
   timed in alternating rounds, and its device busy share (``--profile
   loop`` profiles it alone);
3e. the trained weights: vitvs_tpu_torch/assets/ckpt_real518.npz (the
   JAX package's artifacts/ckpt_real518, exported by
   scripts/export_port_weights.py) loaded with numpy, no JAX; ViT-S/14 @ 518
   at configs/real_s518.yaml's settings: goal_descriptors + 5 bf16
   servo_steps on views the port renders of the poster scene near the goal,
   through the kernels and plain, the plain step teacher-forced (twists held
   within 1e-3 where no pair flips; flips counted); the int8 variants F and
   N of the same ViT (static scales on 7 start views) on the same views,
   logged kernels against plain and against the bf16 step; then
   run_benchmark on episode 0 of the 500-episode seed-41 stream (runs Z and
   AA's) at the full ladder (300 to 1500 iterations, rotation search on),
   its first 40 steps teacher-forced through the plain step, which must
   converge by the ladder's own test;
3f. the chunk on the trained weights: run_benchmark on episodes 0 to 7 of
   the 500-episode stream as one chunk of 8 (rotation search on) for 60
   steps in segments of 20: launches exactly 12 exact attention for the
   goal, 12 for the chunk's search and 12 a chunk-step, 1 bf16 matcher for
   the search and 1 a chunk-step; every chunk-step teacher-forced through
   the plain batched step (twists within 1e-3 where no pair differs, flips
   counted per episode); the same 8 episodes at chunk 1 for 20 steps
   against the chunk (twists within 1e-3 up to each episode's first pair
   flip: the card's GEMMs at M = 8 x 1370 may round otherwise than at
   1370); finite poses and the npz's 22 arrays;
3g. the int8 closed loop at run AD's settings (configs/real_s518_pool2mm.yaml
   served by run_benchmark(quantized=True, int8_static=True): W8A8 from the
   f32 trained weights, static scales on the goal view and the stream's
   first 7 start views, 'nomax3' attention, 2 x 2 K/V pooling by the
   matrix, the conv patch embedding, the 'default' preprocess as one TF32
   pass, source-quantized bins): phase 3f's chunk of 8 for 60 steps; no hand
   kernel may launch (the JAX package routes this path outside every Pallas
   kernel); its first 10 chunk-steps teacher-forced through the same step
   on CPU tensors (twists within 1e-3 where no pair differs, flips counted);
   the same episodes at chunk 1 against the chunk up to each one's first
   flip; finite poses and the npz's 22 arrays; then bench.py's graph (K/V
   pooled before the projection, reshape embed) beside it on goal + 5 steps
   near the goal, and the 'default' preprocess against 'highest' on one
   frame, logged;
3h. the classical baselines (vitvs_tpu_torch/classical/) at configs/real64.yaml's
   settings (runs J, K and AN's) on the poster at 640x480: for each of sift,
   orb, akaze and harris with its default keypoints (1152, 1000, 512, 512),
   run_classical_benchmark on episodes 0 to 7 of the 64-episode stream as one
   chunk for 30 steps, twice (the twists equal bit for bit); no hand kernel
   may launch (the reference runs this path in plain XLA); every 6th
   chunk-step held against the port on the CPU on the same frames (keypoint
   and pair sets compared, twists within 1e-4 where the pairs agree; the
   Hamming distances of the int8 product on the card against the CPU's bit
   for bit); each episode alone for 20 steps against the chunk, twists held
   up to its first pair flip; the npz's 22 arrays;
3i. descriptor training at full width (vitvs_tpu_torch/train/; the training
   forward is plain PyTorch with autograd and may launch no hand kernel):
   (a) one bf16 loss and its gradients of a seeded ViT-S/14 @ 308 on a servo
   pair batch of 2 built on the CPU, on the card against the card machine's
   CPU (loss within 1e-2 relative, every parameter's gradient cosine at
   least 0.99); (b) 100 steps from scratch with the JAX run's arguments
   (batch 8, lr 3e-4, warm-up 100 of a 3000-step schedule, seed 0, its
   synthetic poster): every
   loss finite, steps 76-100 at most 6.0 and 0.8 below steps 1-25; (c) the
   trained ViT-S/14 @ 518: matching_quality on 8 views before any update
   with kernels (24 exact-attention and 1 batched bf16-matcher launches) and
   plain, each at least (0.95, 0.90), then 25 steps at most 1.9; (d) save,
   load and one servo step on the trained weights, kernels on; ms a train
   step, busy share, device activities a step and peak memory at 308 and 518;
3j. the relu / sqrelu attention scores and the int8-probability modes (plain
   PyTorch, as the reference's are plain XLA: no attention kernel): (a) relu
   and sqrelu at configs/real_s518_relu.yaml's settings on ckpt_real518's
   weights, goal + 5 bf16 steps through the kernels and plain as 3e (no
   attention launch, the bf16 matcher a launch a step), and relu with 2 x 2
   K/V pooling (real_s518_relupool.yaml) on seeded weights; (b) the int8
   products of 'qk+pv' and 'pv' at (1, 1370, 12, 64) and (1, 1370, 6, 64)
   bit for bit against the int64 product; the int8 serving step in 'none',
   'nomax3', 'pv' and 'qk+pv' at ViT-B/14 @ 518 (seeded) as phase 3b and at
   the trained ViT-S/14 @ 518 as 3e, twists beside each other logged, and
   block 0 of 'pv' and 'qk+pv' on the card against the CPU on the same input
   (max |diff| / max |ref| within 1e-2); (c) relu on the int8 static path
   (calibrated through the scores), logged beside the float relu step; (d)
   the zero-shot fidelity of relu and sqrelu on ckpt_real518 against softmax
   (patch IoU, relative velocity change; informative); (e) one relu train
   step at 308 from ckpt_real518's weights, card against the card machine's
   CPU: in f32 as 3i(a) holds bf16 (loss within 1e-2 relative, every
   gradient's cosine at least 0.99), in bf16 the loss likewise and every
   gradient finite, each gradient's cosine to the f64 one logged for both;
3k. DINOv2 ViT-g/14 @ 518 (dinov2_vitg14: 1536 wide, 40 blocks of 24 heads,
   the SwiGLU FFN), seeded on the card from a generator of the card (init_vit,
   LayerScale 1.0) at full width and built through build_model: (a) bf16,
   goal + 5 steps and a chunk of 8 for 5 chunk-steps through the kernels and
   plain, teacher-forced (twists within 1e-3 where pairs agree), 12
   exact-attention launches a forward and one matcher launch a step at
   (1369, 13824); (b) vit_forward, all 40 blocks and the final norm, kernels
   vs plain (5e-2 relative) and its peak memory; (c) the int8 ViT-g
   (SwiGLU through the W8A8 products, static scales) in 'fused' (kernel 4 at
   24 heads) and 'none', block 0 card vs CPU (two int8 steps, 2/127; the
   qkv product's int8 codes within one step), its attention output kernels
   vs plain on the card (2e-2), three planted faults each rejected, and the
   step's twists kernels vs plain; (d) fast_binned_match against the
   materialized step on the trained ViT-S/14 @ 518 and on ViT-g, float and
   int8, one frame and a chunk of 8, teacher-forced: pairs flipped counted,
   twists within 1e-3 where they agree (seeded ViT-g float: the
   similarities only), no matcher launch, the similarity within 1e-2 (int8
   5e-2) of the materialized path's and, float, within 1e-4 of log_bin's
   f32 cosine; (e) the 'attn' facet of both, float and int8, and the float
   ones' saliency, card vs the card machine's CPU (ATTN_FACET_TOL), rows
   summing to 1;
3l. the last modules: (a) exact attention at other head widths than 64
   (csrc/attention_hd.cu, bf16 and f32) against the plain versions at head
   widths 1, 27, 48, 147, 192, 588, 768 and 1024 (one head, T = 485, two
   launches bit for bit), B = 2 at T in {1, 63, 65, 485} and rows of logits
   of about +-200; at (1, 1370, 1, 588) and (1, 5930, 1, 48) (pixel14 @ 518,
   pixel4 @ 308), two launches bit for bit; pixel14's unaligned qkv split
   (k and v 8 bytes off: 8-byte copies) on the card; the launch geometry of
   the kernel's C side equal to ops/attention.py:hd_plan at every width and
   pointer offset; and f32 at pixel8's (1, 197, 1, 192), B = 1 and 2, whose
   error its row reports; (b) the
   pixel baseline pixel14 @ 308 (configs/config.yaml's settings with
   model_name pixel14, layer 0, bf16, build_model's pixel weights): goal + 5
   servo steps through the kernels and plain, teacher-forced, 6 any-width
   attention and 5 bf16-matcher launches, and its step's median ms; (c)
   tests/test_baselines.py's pixel8 @ 112 episode in f32 (any-width f32
   attention, the f32 matcher; 121 and 120 launches), ending below half its
   start error; (d) run_benchmark on the trained ViT-S/14 @ 518, episodes 0
   to 7 as one chunk for 60 steps on a (dp, tp) = (2, 2) mesh of the one
   card (3 heads a shard; launches 2 x 12 x (1 + 2 + 2 a chunk-step) exact
   attention, 2 x (1 + 1 a chunk-step) bf16 matcher), every dp row's
   chunk-step teacher-forced through the unsplit ViT's plain step as in 3f
   (twists within 1e-3 where pairs agree, on at least a quarter of the
   episode-steps; the split's goal descriptors against the plain ones), then
   held against the run without a mesh up to each episode's first pair flip;
   (e) render_ir and organized_point_cloud at 640 x 480 from the goal pose,
   the card against the card machine's CPU, and the IR noise's spread; (f)
   the live channel on episodes 0 and 1, two segments: its PNGs (Pillow),
   latest.png, and flags and final poses equal to a run without it; (g) the
   native sensor bridge built from native/sensor_bridge.cpp into
   vitvs_tpu_torch/_build/: a 640 x 480 four-sensor frame round-trips its
   buffer, and ServoLoop over it drives 5 steps with the viz hook on; (h)
   StageTimer over a servo step's stages and a trace_to trace holding the
   annotated ranges and the card's kernels;
3m. the int8 serving ViT split over tensor parallelism (parallel/mesh.py's
   TPQuantViT), the bf16-logits attention and scripts/port_measure.py: (a)
   run_benchmark at run AD's int8 settings (phase 3g's int8 ViT), episodes
   0 to 7 as one chunk for 60 steps on a (dp, tp) = (2, 2) grid of the one
   card, every dp row's chunk-step teacher-forced through the unsplit int8
   ViT and equal to it bit for bit (pairs and twists on every episode-step,
   the goal descriptors), no hand kernel launched and the shards' attention
   run tp x blocks x forwards times; the same check fails on a planted
   fault (two shards' proj columns swapped, 4 chunk-steps);
   (b) the ViT-B/14 @ 518 int8 ViTs of
   3b's 'fused' and 3j's 'none' split over a (1, 2) grid, goal + 5 steps
   held against the unsplit (launches tp x blocks x forwards of kernel 4 and
   of kernel 1), and each shard's kernel 4 output on its [q | k | v] column
   slices equal to the unsplit kernel's heads to the bit and held against
   fused_int8_attention_plain; (c) the exact kernel's bf16-logits variant
   against its plain version at (1, 485, 6, 64), (1, 1370, 12, 64) and
   (8, 1370, 6, 64), two launches bit for bit, its mean |diff| at most half
   the exact kernel's (f32 scores) to the same plain version; (d) scripts/port_measure.py's
   step, desc, match and attn at ViT-B/14 @ 518, float and --quant
   --static-scales --fast-math --attn xla (whose int8 'none' attention is
   the bf16-logits variant), short chains, their lines logged and their
   launches held;
4. times on the card (CUDA events / synchronized host clock) beside each
   kernel's bound and the PyTorch library call for the same function (the
   exact kernels at T = 485 and T = 1370; the int8 kernel from the bf16
   slices, its quantization included), and the servo steps' medians; the
   kernels phase 3e launches at its shapes (ViT-S/14 @ 518); the batched
   matcher at B = 8 against 8 single launches and cuBLAS bmm + max/argmax,
   exact attention at B = 8 and 32 against SDPA, and the closed-loop chunk
   step on the trained weights at B in {1, 8, 16}, bf16 and int8 at run
   AD's settings (ms a chunk-step, episode-steps a second, card-seconds an
   episode at the 1500 cap), and the int8 chunk's pooled 'nomax3'
   attention at (8, 1370, 362 keys, 6 heads) beside SDPA; the classical
   chunk-step of each method at B = 1 and 8; the relu and sqrelu bf16 steps
   at 518 beside softmax's, the int8 steps in 'none', 'nomax3', 'pv' and
   'qk+pv' at ViT-B/14 @ 518, the int8 products' ms beside their bound, the
   relu closed-loop chunk step at B = 1 and 8 beside softmax's, and relu
   train steps at 518 (batch 8) with their peak memory; kernels 1, 2a and 4
   at ViT-g's shapes beside their bounds, plain versions and library calls,
   with the factorized path's product (cuBLAS bf16, f32 output) and whole
   similarity beside 2a, and the ViT-g step and chunk-step of 8,
   materialized against factorized, in 7 alternating rounds; the
   any-width attention at pixel14's (1, 485, 1, 588) bf16 and pixel8's
   (1, 197, 1, 192) f32 beside its plain version and SDPA; the bf16-logits
   variant at 3m(c)'s shapes beside the exact kernel (f32 scores), its plain
   version and SDPA.  The
   f32 attention kernel is held to the tensor-core bound of f32-accurate
   work (three TF32 passes), its f32 FMA bound logged beside it.

The last three lines of standard output are the kernel JSON line (with the
trained weights' file, size and config under "weights"), the card line and
{"ok": true, "device": {...}}.  Any failed check raises, so the
script exits non-zero and prints no result; it also exits non-zero without a
CUDA device or outside a checkout of the repository.
"""

from __future__ import annotations

import argparse
import copy
import ctypes
import dataclasses
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from contextlib import contextmanager
from pathlib import Path

import numpy as np
import torch

from vitvs_tpu_torch.classical.benchmark import classical_model, run_classical_benchmark
from vitvs_tpu_torch.classical.features import _hamming_d2, grayscale
from vitvs_tpu_torch.classical.pipeline import (DEFAULT_MAX_CORNERS, METHOD_NORMS,
                                                classical_servo_step, extract_features,
                                                extract_goal_features)
from vitvs_tpu_torch.control.ibvs import EmaState
from vitvs_tpu_torch.core.batch import item
from vitvs_tpu_torch.harness.benchmark import (build_model, cast_for_benchmark, int8_serving,
                                               run_benchmark)
from vitvs_tpu_torch.harness.chunks import load_episodes
from vitvs_tpu_torch.harness.evals import convergence_stats
from vitvs_tpu_torch.harness.pipeline import (ServoModel, batch_descriptors, goal_descriptors,
                                              match_frames,
                                              preprocess, quantized_vit, servo_step)
from vitvs_tpu_torch.harness.rollout import (episode_init, goal_pose, rollout_episode,
                                             rollout_segment)
from vitvs_tpu_torch.harness.samplers import (DESIRED_ORIENTATION, DESIRED_POSITION,
                                              generate_episode_starts)
from vitvs_tpu_torch.io_bridge import native
from vitvs_tpu_torch.io_bridge.config import VSConfig
from vitvs_tpu_torch.io_bridge.host_loop import ServoLoop
from vitvs_tpu_torch.match.binned import (QuantizedBinned, binned_cosine_similarity,
                                          quantize_binned_int8)
from vitvs_tpu_torch.match.correspondence import cosine_similarity_matrix
from vitvs_tpu_torch.models.baselines import init_pixel_params
from vitvs_tpu_torch.models.convert import TRAINED_S518, load_exported, save_exported
from vitvs_tpu_torch.models.extractor import (extract_descriptors, extract_saliency_maps, log_bin,
                                              saliency_from_attention)
from vitvs_tpu_torch.models.quant import (QuantViT, _block_q, _nomax_attention, static_quant_act,
                                          vit_features_quant)
from vitvs_tpu_torch.models.vit import ViT, init_vit, vit_features, vit_forward
from vitvs_tpu_torch.ops import _build, attention, attn_int8, matcher
from vitvs_tpu_torch.ops.int_mm import int8_bmm
from vitvs_tpu_torch.parallel import make_mesh
from vitvs_tpu_torch.parallel.mesh import QuantBlockShard, TPQuantBlock, TPQuantViT
from vitvs_tpu_torch.sim.env import observe
from vitvs_tpu_torch.sim.pointcloud import organized_point_cloud
from vitvs_tpu_torch.sim.scene import Scene, load_poster_scene, make_synthetic_poster, render_ir
from vitvs_tpu_torch.train import train_servo
from vitvs_tpu_torch.train.finetune import (_servo_batch_loss, init_train_state,
                                            make_servo_pair_batch, make_servo_train_epoch,
                                            matching_quality, warmup_cosine_decay_schedule)
from vitvs_tpu_torch.utils.profiling import TRACE_FILE, StageTimer, annotate, trace_to

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
# phase 3d, the closed loop, cut from the config's 500 episodes of up to 1500 steps
# (at least 300): episodes 0 and 1 of the seed-41 stream (episode 1 also on its
# perturbed texture) for 40 steps in segments of 20, the ladder's minimum cut to 10
# and its maximum to 30, so that it stops an episode inside the run
LOOP_EPISODES = [0, 1]
LOOP_PERTURBED = [1]
LOOP_STEPS = 40
LOOP_SEGMENT = 20
LOOP_MIN_ITERATIONS = 10
LOOP_MAX_ITERATIONS = 30
SEARCH_ATTN_SHAPE = (4, 485, 6, 64)   # the rotation search's 4-view forward
# phase 3e, the trained ViT-S/14 @ 518 (vitvs_tpu_torch/assets/ckpt_real518.npz)
TRAINED_ATTN_SHAPE = (1, 1370, 6, 64)          # one frame
TRAINED_SEARCH_ATTN_SHAPE = (4, 1370, 6, 64)   # the rotation search's 4 views
TRAINED_MATCH_SHAPE = (1369, 3456)
# the step's 5 views approach the goal; the int8 calibration's 7 start views
# (offsets of the camera from the goal pose, m)
TRAINED_STEP_OFFSETS = [(0.03, -0.02, 0.04), (0.024, -0.016, 0.032), (0.018, -0.012, 0.024),
                        (0.012, -0.008, 0.016), (0.006, -0.004, 0.008)]
TRAINED_CALIB_OFFSETS = [(0.06, 0.02, 0.05), (-0.05, 0.04, 0.08), (0.04, -0.06, 0.1),
                         (-0.03, -0.02, 0.06), (0.08, 0.05, 0.12), (-0.07, 0.01, 0.04),
                         (0.02, 0.07, 0.09)]
TRAINED_STREAM = 500          # the seed-41 stream of runs Z and AA (the benchmark's 500)
TRAINED_LOOP_EPISODE = 0      # converged in the JAX package's runs L, Z and AA
TRAINED_LOOP_FORCED = 40      # its first steps teacher-forced through the plain step
# the batched chunk (phase 3f): the benchmark's default chunk of 8, its search's
# 4 x 8 views, and the ragged batches the matcher is held at
CHUNK = 8
CHUNK_ATTN_SHAPE = (CHUNK, 1370, 6, 64)
CHUNK_SEARCH_ATTN_SHAPE = (4 * CHUNK, 1370, 6, 64)
MATCH_BATCHES = [1, 3, 4 * CHUNK]
CHUNK_EPISODES = list(range(CHUNK))   # episodes 0 to 7 of the 500-episode stream
CHUNK_STEPS = 60
CHUNK_SEGMENT = 20
CHUNK_ALONE_STEPS = 20                # the same episodes at chunk 1, against the chunk
LOOP_CHUNKS = [1, CHUNK, 2 * CHUNK]   # phase 4's closed-loop chunk steps
# phase 3g, the int8 closed loop: phase 3f's chunk at run AD's settings, its first
# chunk-steps teacher-forced through the same step on CPU tensors
INT8_FORCED = 10
POOLED_KEYS = 1 + 19 * 19             # 2 x 2 pooling of the 37 x 37 grid: CLS + 19 x 19
POOLED_ATTN_SHAPE = (CHUNK, 1370, POOLED_KEYS, 6, 64)   # (B, T, keys, h, hd) of the int8 chunk
# phase 3h, the classical baselines: runs J, K and AN's configuration, episodes 0 to 7
CLASSICAL = ("sift", "orb", "akaze", "harris")
CLASSICAL_STREAM = 64                 # configs/real64.yaml's 64-episode stream
# cut from 60 to keep the smoke inside its limit: the checks are as before,
# on half as many chunk-steps (5 compared with the CPU, not 10)
CLASSICAL_STEPS = 30
# chunk-steps held against the CPU
CLASSICAL_COMPARED = tuple(range(0, CLASSICAL_STEPS, 6))
CLASSICAL_ALONE_STEPS = 20
CLASSICAL_TWIST_TOL = 1e-4
# phase 3i, training at full width: the JAX run held to (artifacts/ckpt_vits308.trainlog.json:
# ViT-S/14 @ 308 from random init, seed 0, batch 8, lr 3e-4, warm-up 100, 3000 steps,
# perturbed with probability 0.5, on the synthetic poster: its log says poster None, which
# scripts/train_servo.py read as make_synthetic_poster(512, seed=0) when the log was
# committed, before the real poster became the default) and its loss means over 25-step
# windows
TRAIN_STEPS, TRAIN_BATCH, TRAIN_LR, TRAIN_WARMUP, TRAIN_SEED = 3000, 8, 3e-4, 100, 0
TRAIN_POSTER = "synthetic"
TRAIN_CHAIN = 25                      # train_servo's steps between host syncs
JAX_LOSS_WINDOWS = {(1, 25): 6.969, (76, 100): 5.390, (176, 200): 4.694, (476, 500): 3.676,
                    (976, 1000): 2.776, (2976, 3000): 1.656}
JAX_FINAL_MATCHING = (0.875, 0.812)   # valid-frac, patch-acc after its 3000 steps
# bounds, written before the first run on the card: (a) one step, card against CPU
TRAIN_LOSS_RTOL = 1e-2
TRAIN_GRAD_COS_MIN = 0.99
# (b) 100 steps from scratch: steps 76-100 at most 6.0 and 0.8 below steps 1-25
TRAIN_SMOKE_STEPS = 100
TRAIN_EARLY_MAX = 6.0
TRAIN_EARLY_DROP = 0.8
# (c) the trained ViT-S/14 @ 518 (ckpt_real518: JAX final 1.0, 0.975; its last window
# 1.468): matching quality before any update, then 25 steps on train_servo --resume's
# schedule (the reference's 2000 steps, warm-up restarted)
TRAIN_QUALITY_MIN = (0.95, 0.90)
TRAIN_RESUME_STEPS = 25
TRAIN_RESUME_SCHEDULE = 2000
TRAIN_RESUME_MAX = 1.9
TRAIN_EVAL_VIEWS = 8
# --train 3000 at 308 from scratch: steps 2976-3000 at most 2.2, patch-acc at least 0.70
TRAIN_FINAL_MAX = 2.2
TRAIN_PATCH_ACC_MIN = 0.70
# phase 3j, the relu / sqrelu scores (configs/real_s518_relu.yaml, real_s518_relupool.yaml)
# and the int8-probability modes; the int8 serving variants beside them: (quant_attn,
# attn_impl) and the kernel the path launches ('none' exact attention; the others none)
SCORES = ("relu", "sqrelu")
PROB_VARIANTS = {"none": ("none", "xla", "attention"), "nomax3": ("nomax3", "xla", None),
                 "pv": ("pv", "xla", None), "qk+pv": ("qk+pv", "xla", None)}
# one int8 block, card against the card machine's CPU on the same bf16 input: max |diff|
# / max |ref| within about one int8 step of a token's largest output (1/127); the int8
# products are exact on both, the bf16 GEMMs and exp round otherwise and may flip an
# int8 probability or activation by one step
INT8_BLOCK_TOL = 1e-2
# the zero-shot fidelity of the scores on the softmax-trained ckpt_real518 (the campaign's
# diagnostic, scripts/diag_attn_variant.py: 4 seed-41 start views, patch-grid pair IoU
# and relative velocity change against softmax), logged beside its CPU JAX numbers
# (artifacts/attn_variant_fid.json; informative, not a gate)
FID_VIEWS = 4
JAX_FIDELITY = {"relu": (0.016, 0.93), "sqrelu": (0.017, 0.66)}
# --cotrain: the campaign's co-train and gate (docs/CAMPAIGN_ATTN_REDESIGN.md:41-47):
# 2000 steps at 518 resumed from ckpt_real518 (train_servo's defaults: batch 8, lr 3e-4,
# warm-up 100, seed 0, the real poster), then episodes 0 to 63 of the seed-41
# 500-episode stream, chunk 8, bf16 with kernels; bound, written before the run: at
# least 62 of 64 converged (the softmax ckpt_real518 converged 64 of 64 there, run Z)
COTRAIN_STEPS = 2000
COTRAIN_EPISODES = (0, 64)
COTRAIN_MIN_CONVERGED = 62
SOFTMAX_PATCH_ACC = 0.975             # ckpt_real518's final matching quality (JAX)
COTRAIN_BUDGET_S = 1500.0             # --cotrain's default budget, training and replay
COTRAIN_TRAIN_SHARE = 0.65            # the part of it training may take
EPISODE_CAP = 1500                    # the ladder's max_iterations: card-seconds an episode
TIMING_ROUNDS = 7                     # alternating rounds, closed-loop step and bare step
# phase 3k, DINOv2 ViT-g/14 (dinov2_vitg14: 1536 wide, 40 blocks of 24 heads, the SwiGLU
# FFN) at 518, seeded on the card at full width, and factorized binned matching; the
# kernels at its shapes: exact attention (B, 1370, 24, 64), the bf16 matcher on 9 x 1536
# binned rows, int8 attention from (1, 1370, 3 x 1536) slices
VITG_MODEL = "dinov2_vitg14"
VITG_ATTN_SHAPE = (1, 1370, 24, 64)
VITG_CHUNK_ATTN_SHAPE = (CHUNK, 1370, 24, 64)
VITG_MATCH_SHAPE = (1369, 9 * 1536)
VITG_FAST_SHAPE = (1369, 1536)        # the factorized path's unbinned rows
VITG_INT8_VARIANTS = ("F", "none")    # 'fused' (kernel 4) and 'none' (kernel 1), static scales
VITG_TIMING_ITERS = 10                # calls a runner in each of phase 4's ViT-g rounds
# the chunk's 8 episodes: camera offsets from the goal pose (m), each approaching it
VITG_CHUNK_OFFSETS = [TRAINED_STEP_OFFSETS[0], *TRAINED_CALIB_OFFSETS]
# the 'attn' facet card vs CPU: f32 probabilities from bf16 logits (a bf16 ulp of a logit
# of 10 moves its probability by 6%: the peak of a row, at most about 0.5 here, by 0.03),
# rows summing to 1 in f32, and the min-max normalized saliency map
ATTN_FACET_TOL = (5e-2, 1e-4, 1e-1)
# ViT-g's int8 block 0 card vs CPU: two int8 steps of the block's largest output (3j's
# 1e-2 is about one): on an H100 the card's plain block lies as far from the CPU's as its
# kernels' (1.3e-2 on the seeded ViT-g), the gap is the two libraries' bf16 rounding
# moving static int8 activations, two of which can land on one output of the 4096-deep
# w3 product
VITG_INT8_BLOCK_TOL = 2.0 / 127.0
# the factorized binned similarity against the materialized one on the same unbinned
# descriptors: float (the materialized arithmetic normalizes the binned rows in bf16:
# a few bf16 ulps of a cosine), int8 (other rows quantized: a few int8 steps)
FAST_SIM_TOL = {"float": 1e-2, "int8": 5e-2}
# and against log_bin's rows' cosine in f32: the same sums in another order. f32
# association over 13824 products of unit rows moves a cosine by about
# sqrt(13824) * 2^-24 = 7e-6 (at most 13824 * 2^-24 = 8.2e-4); the nearest other
# arithmetic, the materialized path's bf16-normalized rows, lies 6e-3 away. The
# rows' argmaxes equal but where two candidates lie that close
FAST_SIM_F32_TOL = 1e-4
FAST_ARGMAX_F32_MIN = 0.99
# phase 3l: the pixel baselines (one head of width 3 P^2), the mesh, the sensors,
# the live channel, the native bridge and stage profiling
PIXEL_MODEL = "pixel14"
# pixel4, 8, 14 and 16's head widths, pixel3's and 7's odd ones (bf16: scalar
# loads), and the range's ends
PIXEL_HD = (1, 27, 48, 147, 192, 588, 768, 1024)
PIXEL_T = (1, 63, 65, 485)
# long T at the widths that give it: pixel14 @ 518, pixel4 @ 308
PIXEL_HD_LONG = ((1, 1370, 1, 588), (1, 5930, 1, 48))
PIXEL_ATTN_SHAPE = (1, 485, 1, 588)            # pixel14 @ 308: 22 x 22 patches + CLS
PIXEL_F32_ATTN_SHAPE = (1, 197, 1, 192)        # pixel8 @ 112 in f32: 14 x 14 + CLS
MESH_SHAPE = (2, 2)                            # (dp, tp) cells, all on the one card
# the least share of the mesh's episode-steps whose pairs agree with the unsplit
# plain step's, teacher-forced (phase 3f's chunk: 323 of 480 on kernels alone);
# a split that scrambled heads would leave next to none
MESH_MIN_COMPARED = 0.25
# render_ir on the card against the CPU: the bilinear texture reads and the luma
# round in the last bits on either side, so a value within that of a level's
# midpoint lands on the other level: at most this share of the pixels, one level
IR_LEVEL_SHARE = 1e-3
IR_NOISE_BAND = (0.045, 0.055)                 # std of the noise (0.05) after 8-bit levels
LIVE_STEPS = 20
LIVE_SEGMENT = 10

# phase 3m: the int8 ViT under tensor parallelism, the bf16-logits attention,
# scripts/port_measure.py
INT8_TP_MESH = (2, 2)               # (a) (dp, tp) cells at run AD's settings, the one card
INT8_TP_PLANT_STEPS = 4             # (a) chunk-steps of the planted fault's run
INT8_TP_SERVE = 2                   # (b) tp of the (1, 2) grid at config_vitb_518.yaml
# (c) the bf16-logits variant's shapes: ViT-S/14 @ 308, ViT-B/14 @ 518 (the int8
# 'none' step's), the trained chunk's
BF16L_SHAPES = ((1, 485, 6, 64), (1, 1370, 12, 64), (8, 1370, 6, 64))
# (c) the variant's mean |diff| to its plain version at most this share of the exact
# kernel's (f32 scores) mean |diff| to that plain version, at each shape: the largest
# |diff| cannot tell them apart (one bf16 ulp of the largest outputs for either)
BF16L_MEAN_SHARE = 0.5
# (d) scripts/port_measure.py at ViT-B/14 @ 518, short chains: the modes, the two
# configurations and the chain arguments
MEASURE_MODES = ("step", "desc", "match", "attn")
MEASURE_RUNS = {"float": (), "int8 fast-math": ("--quant", "--static-scales", "--fast-math",
                                                "--attn", "xla")}
MEASURE_CHAIN = ("--chain", "10", "--chain-short", "2", "--reps", "2")
# the reference's npz: its 22 arrays and the run time
NPZ_KEYS = ("initial_positions", "initial_orientations", "final_positions",
            "final_quaternions", "convergence_flags", "position_errors", "orientation_errors",
            "best_poses", "all_position_histories", "all_orientation_histories",
            "all_iteration_histories", "lowest_position_errors", "lowest_orientation_errors",
            "all_average_velocities", "all_velocity_mean_100", "all_velocity_mean_10",
            "all_applied_velocity_x", "all_applied_velocity_y", "all_applied_velocity_z",
            "all_applied_velocity_roll", "all_applied_velocity_pitch",
            "all_applied_velocity_yaw", "total_execution_time")


def log(msg: str) -> None:
    print(f"[t={time.perf_counter() - T0:.1f}s] {msg}", flush=True)


@contextmanager
def phase(name: str):
    log(f"phase {name} start")
    yield
    log(f"phase {name} done")


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


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


def check_matcher_batched(device, t: int, d: int, batches, seed: int) -> dict:
    """Both matcher modes on one goal's bf16 rows (t, d) against a batch of B
    frames (B, t, d) for each B of ``batches``: each item bit for bit a
    launch on it alone, two batched launches bit for bit, each item held to
    the plain version (:func:`_hold_matcher`), and the key scratch left all
    zero.  Returns the max abs error against plain at each B, per mode."""
    rs = np.random.default_rng(seed)
    bits = lambda x: x.view(torch.int32) if x.dtype == torch.float32 else x
    same = lambda x, y: all(torch.equal(bits(u), bits(v)) for u, v in zip(x, y))
    modes = {"bf16": (matcher.dual_argmax_cosine_bf16, matcher.dual_argmax_cosine_bf16_plain),
             "f32": (matcher.dual_argmax_cosine, matcher.dual_argmax_cosine_plain)}
    errs = {}
    a = _normal(device, (t, d), rs, torch.bfloat16)
    for nb in batches:
        b = _normal(device, (nb, t, d), rs, torch.bfloat16)
        for mode, (fn, plain) in modes.items():
            what = f"{mode} matcher, a batch of {nb} at {(t, t, d)}"
            got = fn(a, b)
            if not same(got, fn(a, b)):
                raise AssertionError(f"{what}: two launches on the same inputs differ")
            alone = [fn(a, b[i]) for i in range(nb)]
            if not all(same([x[i] for x in got], one) for i, one in enumerate(alone)):
                raise AssertionError(f"{what}: an item differs from a launch on it alone")
            ref = plain(a, b)
            unit = (lambda x: matcher.unit_rows(x).float()) if mode == "bf16" else (
                lambda x: x.float() * matcher.inverse_norms(x.float())[..., None])
            errs[f"{mode}_b{nb}"] = max(
                _hold_matcher([x[i] for x in got], [x[i] for x in ref],
                              unit(a) @ unit(b[i]).T, f"{what}, item {i}") for i in range(nb))
    torch.cuda.synchronize()
    if any(int(buf.abs().sum()) for buf in matcher._keys_scratch.values()):
        raise AssertionError("matcher: the key scratch is not zero after the batched launches")
    return errs


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
    its K path), _quant_th run on the card's tensors and _quant_th on CPU
    tensors, all three the jitted reference's arithmetic (a multiply by
    f32(1/127), ROADMAP.md fault 3.5): int8 values equal and scales equal
    bit for bit, on column slices of a seeded qkv output whose first token
    is 0, second 1000x and third 1e-20x (amax below the 1e-12 floor).
    Returns the number of rows compared."""
    B, T, H, hd = shape
    D = H * hd
    qkv = _normal(device, (B, T, 3 * D), np.random.default_rng(seed), torch.bfloat16)
    qkv[:, 0] = 0
    qkv[:, 1] *= 1000
    qkv[:, 2] *= 1e-20
    q, k = qkv[..., :D], qkv[..., D:2 * D]
    bits = lambda t: t.cpu().contiguous().view(torch.int32)
    for x, extra, k_path in ((q, attn_int8._q_extra_scale(q, H), False), (k, 1.0, True)):
        ref8, ref_s = attn_int8._quant_th(x.cpu(), H, extra)
        for who, (q8, sc) in (("the int8 kernel's", attn_int8.quant_th_probe(x, H, extra,
                                                                              k_path=k_path)),
                              ("_quant_th on the card's tensors,",
                               attn_int8._quant_th(x, H, extra))):
            what = f"{who} {'K' if k_path else 'Q'} quantization"
            if not torch.equal(q8.cpu(), ref8):
                raise AssertionError(f"{what}: {int((q8.cpu() != ref8).sum())} int8 values "
                                     f"differ from _quant_th on CPU tensors")
            if not torch.equal(bits(sc), bits(ref_s)):
                raise AssertionError(f"{what}: {int((bits(sc) != bits(ref_s)).sum())} scales "
                                     f"differ from _quant_th on CPU tensors")
    return {"rows": 2 * B * T * H}


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
    """goal_descriptors, then one servo_step per frame (or per chunk of B
    frames (B, H, W, 3), with (B, t) scores), carrying the EMA and the
    previous command, or taking them from ``states`` (one (ema, prev) per
    step).  ``depth``: one depth map, or a list of one per frame.  Returns
    (goal descriptors, step results)."""
    goal_desc = goal_descriptors(net, model, goal)
    batch = tuple(frames[0].shape[:-3])
    ema = EmaState.init(device=model.device, batch=batch)
    prev = torch.zeros(*batch, 6, device=model.device)
    depths = depth if isinstance(depth, list) else [depth] * len(frames)
    results = []
    for i, (frame, s) in enumerate(zip(frames, scores)):
        if states is not None:
            ema, prev = states[i]
        r = servo_step(net, model, goal_desc, frame, depths[i], ema, prev, scores=s)
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
        if r.body_twist.shape[-1:] != (6,) or r.s_uv.shape[-2:] != (k, 2):
            raise AssertionError(f"step {i}: shapes {tuple(r.body_twist.shape)}, {tuple(r.s_uv.shape)}")
        for name in ("v_c", "body_twist", "s_uv", "s_uv_star"):
            if not bool(torch.isfinite(getattr(r, name)).all()):
                raise AssertionError(f"step {i}: {name} is not finite")


def same_pairs(r, k) -> torch.Tensor:
    """(pairs,) bool: the two steps' pair is the same (goal pixels equal,
    current pixels within 1 px, validity equal)."""
    return ((r.s_uv_star == k.s_uv_star).all(-1) & ((r.s_uv - k.s_uv).abs() <= 1.0).all(-1)
            & (r.valid == k.valid))


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
    return {"desc_rel_err": desc_rel, "desc_row_cos_min": row_cos,
            **compare_steps(ref_steps, ker_steps, every_step, twist_tol)}


def compare_steps(ref_steps, ker_steps, every_step: bool, twist_tol: float) -> dict:
    """:func:`compare_runs`' steps: pairs that differ a step, and the twists
    held within ``twist_tol`` up to the first step whose pairs differ, or
    (``every_step``) at every step, or every episode of a chunk-step, whose
    pairs agree."""
    differing, twist_err, compared = [], 0.0, 0
    for r, k in zip(ref_steps, ker_steps):
        same = same_pairs(r, k)                                   # (..., pairs)
        differing.append(int((~same).sum()))
        if not every_step and any(differing):
            continue
        agree = same.all(-1) if every_step else torch.ones_like(same[..., 0])
        if bool(agree.any()):
            gap = (r.body_twist - k.body_twist).abs().amax(-1)[agree].max().item()
            twist_err = max(twist_err, gap)
        compared += int(agree.sum())
    if not twist_err <= twist_tol:
        raise AssertionError(f"body twists differ by {twist_err} > {twist_tol}")
    return {"differing_pairs": differing, "twist_max_abs_err": twist_err,
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
            "attention_hd": attention.mha_attention_hd,
            "attention_hd_f32": attention.mha_attention_hd_f32,
            "attention_fast": attention.mha_attention_fast,
            "attn_int8": attn_int8.fused_int8_attention, "matcher": matcher.dual_argmax_cosine,
            "matcher_bf16": matcher.dual_argmax_cosine_bf16}


def run_main_path(net, cfg: VSConfig, model_kernels: ServoModel, seed=0, frames=None,
                  every_step: bool = False, tol=(DESC_REL_TOL, DESC_COS_MIN, TWIST_TOL),
                  keep_steps: bool = False, scores=None) -> dict:
    """Both runs of the main path and their checks; the launch counters are
    zeroed just before the kernel run and read just after it.  ``frames``:
    (goal, current frames, depth or depths), by default :func:`make_frames`'.
    ``every_step``: the plain run takes the kernel run's EMA and command at
    each step, and twists are compared at every step whose pairs agree.
    ``tol``: :func:`compare_runs`'.  ``keep_steps``: the kernel run's step
    results under "steps" (not JSON).  ``scores``: each step's pair scores
    ((B, t) a chunk-step), by default :func:`pair_scores`'."""
    goal, frames, depth = frames or make_frames(cfg, seed)
    if scores is None:
        scores = pair_scores(model_kernels, len(frames), seed)
    model_plain = dataclasses.replace(model_kernels, use_kernels=False)

    for fn in _counters().values():
        fn.launches = 0
    ker = drive(net, model_kernels, goal, frames, depth, scores)
    launches = {name: fn.launches for name, fn in _counters().items()}
    states = None
    if every_step:
        states = [(EmaState.init(device=model_kernels.device, batch=ker[1][0].v_c.shape[:-1]),
                   torch.zeros_like(ker[1][0].v_c))]
        states += [(r.ema, r.v_c) for r in ker[1][:-1]]
    ref = drive(net, model_plain, goal, frames, depth, scores, states)
    for run in (ker, ref):
        check_outputs(model_kernels, *run)
    summary = compare_runs(ref, ker, every_step, tol)
    summary["launches"] = launches
    summary["num_valid"] = [r.num_valid.tolist() for r in ker[1]]
    summary["body_twists"] = [r.body_twist.tolist() for r in ker[1]]
    summary["body_twist_last"] = summary["body_twists"][-1]
    if keep_steps:
        summary["steps"] = ker[1]
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
    """The int8 serving model of a variant (F or N, or one of
    PROB_VARIANTS), kernels on; ``vit`` replaces the configuration's ViT (a
    tiny one in the CPU tests)."""
    quant_attn, attn_impl, _ = {**VARIANTS, **PROB_VARIANTS}[variant]
    if vit is None:
        return ServoModel.create(cfg, device=device, quantized=True, attn_impl=attn_impl,
                                 quant_attn=quant_attn)
    return ServoModel(vit=dataclasses.replace(vit, attn_impl=attn_impl, quant_attn=quant_attn),
                      cfg=cfg, device=device, quantized=True)


def run_serving_path(fnet, cfg: VSConfig, variant: str, device, seed=0, vit=None,
                     frames=None, keep_steps: bool = False,
                     tol=(DESC_REL_TOL, DESC_COS_MIN, TWIST_TOL)):
    """Calibrate the int8 ViT of ``fnet`` (static scales, goal + 7 start
    views), then both runs of the serving step as :func:`run_main_path`.
    ``frames``: (goal, step frames, calibration frames, depth or depths),
    by default the goal and 5 + 7 shifted frames of :func:`make_frames`.
    ``tol``: :func:`compare_runs`'.  Returns (summary, the quantized ViT,
    the model)."""
    model = serving_model(cfg, variant, device, vit)
    if frames is None:
        goal, shifted, depth = make_frames(cfg, seed, shifts=SHIFTS + CALIB_SHIFTS)
        frames = (goal, shifted[:N_STEPS], shifted[N_STEPS:], depth)
    goal, steps, calib, depth = frames
    t0 = time.perf_counter()
    qnet = quantized_vit(fnet, model, [goal, *calib])
    if model.device != "cpu":
        torch.cuda.synchronize()
    calib_s = time.perf_counter() - t0
    summary = run_main_path(qnet, cfg, model, seed, frames=(goal, steps, depth),
                            every_step=True, keep_steps=keep_steps, tol=tol)
    summary["calibration_s"] = calib_s
    return summary, qnet, model


# ---------------------------------------------------------------------------
# phase 3d: the closed loop
# ---------------------------------------------------------------------------


def loop_config(cfg: VSConfig) -> VSConfig:
    """``cfg`` with the ladder's iteration bounds cut for phase 3d."""
    return cfg.replace(min_iterations=LOOP_MIN_ITERATIONS, max_iterations=LOOP_MAX_ITERATIONS)


def loop_launches(layer: int, chunks: int, chunk_steps: int) -> dict:
    """Launches of one benchmark run: the goal's forward, each chunk's
    search (one forward over its 4 B views, one match) and each chunk-step
    run on the device (one forward, one match)."""
    return {"attention": (layer + 1) * (1 + chunks + chunk_steps),
            "matcher_bf16": chunks + chunk_steps}


def check_npz(path: str, n: int) -> None:
    """The reference's 22 arrays with their shapes, finite poses."""
    d = np.load(path, allow_pickle=True)
    if sorted(d.files) != sorted(NPZ_KEYS):
        raise AssertionError(f"npz keys {sorted(d.files)} != {sorted(NPZ_KEYS)}")
    fixed = {"initial_positions": (n, 3), "initial_orientations": (n, 4),
             "final_positions": (n, 3), "final_quaternions": (n, 4)}
    for k in NPZ_KEYS[:-1]:
        a = np.asarray(d[k]) if k not in fixed else np.stack(list(d[k]))
        if len(a) != n or (k in fixed and a.shape != fixed[k]):
            raise AssertionError(f"npz {k}: shape {a.shape}, {n} episodes")
    for i in range(n):
        it = int(d["all_iteration_histories"][i])
        for k, tail in (("all_position_histories", (3,)), ("all_orientation_histories", (4,)),
                        ("all_average_velocities", ()), ("all_applied_velocity_yaw", ())):
            if np.asarray(d[k][i]).shape != (it,) + tail:
                raise AssertionError(f"npz {k}[{i}]: shape {np.asarray(d[k][i]).shape}, "
                                     f"{it} iterations")
        for k in ("final_positions", "final_quaternions", "all_position_histories",
                  "all_orientation_histories"):
            if not np.isfinite(np.asarray(d[k][i], np.float64)).all():
                raise AssertionError(f"npz {k}[{i}] is not finite")


def run_closed_loop(net, cfg: VSConfig, model: ServoModel, scene: Scene, out_dir: str,
                    episodes=LOOP_EPISODES, perturbed=LOOP_PERTURBED, num_steps=LOOP_STEPS,
                    segment_steps=LOOP_SEGMENT) -> dict:
    """run_benchmark through the kernels on ``episodes`` (rotation
    search on), one episode a chunk, then on ``perturbed`` with perturbed
    textures, the launch counters zeroed before and read after each run;
    then every step of the first episode teacher-forced through the plain
    step (the kernel run's frame, EMA, command and scores; the plain goal
    descriptors), and the whole episode again plain, reporting where the
    trajectories part."""
    model_plain = dataclasses.replace(model, use_kernels=False)
    common = dict(rotation_search=True, num_steps=num_steps, segment_steps=segment_steps,
                  verbose=False, out_dir=out_dir, device=model.device, chunk=1)
    record = []

    def on_step(abs_ids, inputs, result):
        if abs_ids[0] == episodes[0]:
            record.append((inputs, result))

    runs, launches = {}, {}
    for name, kw in (("standard", dict(episode_indices=episodes, on_step=on_step)),
                     ("perturbed", dict(episode_indices=perturbed, perturbation=True))):
        for fn in _counters().values():
            fn.launches = 0
        runs[name] = run_benchmark(cfg, net=net, model=model, scene=scene,
                                   config_name="loop", **common, **kw)
        launches[name] = {k: fn.launches for k, fn in _counters().items()}
        check_npz(runs[name].path, len(kw["episode_indices"]))

    cast = cast_for_benchmark(net, model.compute_dtype)
    goal_rgb, _ = observe(scene, model.camera, *goal_pose(model.device))
    goal_ker = goal_descriptors(cast, model, goal_rgb)
    goal_plain = goal_descriptors(cast, model_plain, goal_rgb)
    ref_steps = [servo_step(cast, model_plain, goal_plain, x.rgb, x.depth, x.ema, x.prev_v_c,
                            scores=x.scores) for x, _ in record]
    forced = compare_runs((goal_plain, ref_steps), (goal_ker, [r for _, r in record]),
                          every_step=True)

    plain = run_benchmark(cfg, net=net, model=model_plain, scene=scene, save=False,
                          episode_indices=episodes[:1], **common)
    pk = np.asarray(runs["standard"].summaries["all_position_histories"][0], np.float64)
    pp = np.asarray(plain.summaries["all_position_histories"][0], np.float64)
    m = min(len(pk), len(pp))
    apart = np.nonzero(np.abs(pk[:m] - pp[:m]).max(-1) > 1e-4)[0]
    return {"device_steps": {k: r.device_steps for k, r in runs.items()},
            "chunk_steps": {k: r.chunk_steps for k, r in runs.items()},
            "episodes": {"standard": len(episodes), "perturbed": len(perturbed)},
            "launches": launches,
            "iterations": {k: [int(i) for i in r.summaries["all_iteration_histories"]]
                           for k, r in runs.items()},
            "converged": {k: [bool(c) for c in r.summaries["convergence_flags"]]
                          for k, r in runs.items()},
            "final_pos_err_cm": {k: [float(e) for e in r.summaries["position_errors"]]
                                 for k, r in runs.items()},
            "teacher_forced": {"steps": len(record),
                               "steps_with_flips": sum(1 for f in forced["differing_pairs"] if f),
                               "flipped_pairs": sum(forced["differing_pairs"]),
                               "twist_max_abs_err": forced["twist_max_abs_err"],
                               "steps_compared": forced["steps_compared"],
                               "goal_desc_rel_err": forced["desc_rel_err"]},
            "plain_episode": {"iterations": int(plain.summaries["all_iteration_histories"][0]),
                              "parts_at_step": int(apart[0]) if len(apart) else None,
                              "max_pos_diff_m": float(np.abs(pk[:m] - pp[:m]).max())}}


def loop_runner(net, model: ServoModel, scene: Scene, start_p, start_q, generator):
    """One closed-loop step a call (render, servo step, integrate, ladder)
    from a start pose, or a chunk-step from a chunk's (B, 3) / (B, 4)
    starts with B generators, on the benchmark's cast ViT (an int8 one as
    it is), carrying its state."""
    cast = net if model.quantized else cast_for_benchmark(net, model.compute_dtype)
    desired = goal_pose(model.device)
    goal = goal_descriptors(cast, model, observe(scene, model.camera, *desired)[0])
    state = {"carry": episode_init(start_p, start_q, *desired)}

    def run():
        state["carry"], _ = rollout_segment(cast, model, scene, goal, state["carry"], 1,
                                            *desired, generator=generator)
    return run


def loop_start(cfg: VSConfig, chunk: int | None = None):
    """Episode 0's start pose of the seed-41 stream, or with ``chunk`` the
    start poses of its first ``chunk`` episodes."""
    positions, quats, _ = generate_episode_starts(cfg)
    if chunk is None:
        return positions[0], quats[0]
    return positions[:chunk], quats[:chunk]


def chunk_runner(net, model: ServoModel, scene: Scene, chunk: int):
    """:func:`loop_runner` on the first ``chunk`` episodes of the stream of
    ``model.cfg``, each drawing its scores from a generator of its own."""
    return loop_runner(net, model, scene, *loop_start(model.cfg, chunk),
                       [torch.Generator(model.device).manual_seed(i) for i in range(chunk)])


def time_run(run, iters=20) -> float:
    """Median host milliseconds of one call of ``run`` after 3 warm-up
    calls, synchronized before and after."""
    times = []
    for i in range(iters + 3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        if i >= 3:
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


# ---------------------------------------------------------------------------
# phase 3e: the trained ViT-S/14 @ 518
# ---------------------------------------------------------------------------


def trained_config() -> VSConfig:
    """configs/real_s518.yaml's settings, built in code: ViT-S/14 at 518
    (37 x 37 patches, T = 1370), the dls solve, the ladder's 300 to 1500
    iterations; but the 500-episode stream (TRAINED_STREAM) where the file
    says 64, since the start poses depend on the stream's length and runs Z
    and AA replayed the 500-episode one."""
    return VSConfig(pinv_mode="dls", dino_input_size=518, num_samples=TRAINED_STREAM)


def load_trained(model: ServoModel, path: Path = TRAINED_S518):
    """The exported trained weights (numpy, no JAX) as an f32 ViT of
    ``model``'s configuration (the blocks hold the file's bf16 values: a
    cast to bf16 gives them back exactly), on its device, and what to log of
    the file.  A missing or unreadable file, or weights of another
    architecture than the model's, raise."""
    sd, vcfg = load_exported(path)
    run_fields = {k: getattr(model.vit, k) for k in (
        "gelu_approx", "attn_impl", "quant_attn", "nomax_clamp", "kv_pool", "kv_pool_impl",
        "kv_pool_where", "patch_embed_impl", "attn_score")}
    if dataclasses.replace(vcfg, **run_fields) != model.vit:
        raise ValueError(f"{path} holds a {vcfg}, the model runs a {model.vit}")
    net = ViT.from_state_dict(model.vit, sd)
    here, where = Path(__file__).resolve().parent, Path(path).resolve()
    info = {"file": str(where.relative_to(here) if where.is_relative_to(here) else where),
            "bytes": Path(path).stat().st_size, "parameters": sum(v.numel() for v in sd.values()),
            "config": {k: getattr(vcfg, k) for k in ("model_name", "patch_size", "stride",
                                                     "embed_dim", "depth", "num_heads",
                                                     "pos_grid", "use_layerscale")}}
    return net.to(model.device).eval(), info


def render_views(model: ServoModel, scene: Scene, offsets):
    """The goal view and the views from the goal pose moved by each offset
    (m), rendered on the model's device: (goal rgb, [rgb], [depth])."""
    p0, q0 = goal_pose(model.device)
    goal, _ = observe(scene, model.camera, p0, q0)
    views = [observe(scene, model.camera, p0 + torch.tensor(o, device=model.device), q0)
             for o in offsets]
    return goal, [v[0] for v in views], [v[1] for v in views]


def run_trained_step(net, cfg: VSConfig, model: ServoModel, scene: Scene,
                     offsets=TRAINED_STEP_OFFSETS) -> dict:
    """goal_descriptors + one bf16 servo_step per view of ``offsets``
    through the kernels and through the plain versions, the plain step
    teacher-forced (the kernel run's EMA and command), as
    :func:`run_main_path`; the kernel run's steps under "steps"."""
    goal, rgbs, depths = render_views(model, scene, offsets)
    return run_main_path(net, cfg, model, frames=(goal, rgbs, depths), every_step=True,
                         keep_steps=True)


def run_trained_int8(fnet, cfg: VSConfig, device, scene: Scene, bf16_steps, vit=None,
                     offsets=TRAINED_STEP_OFFSETS, calib_offsets=TRAINED_CALIB_OFFSETS,
                     variants=tuple(VARIANTS)) -> dict:
    """The int8 serving ``variants`` (F and N) of the trained ViT (static scales
    calibrated on the goal view and the views of ``calib_offsets``, as
    phase 3b) on phase 3e's views, kernels against plain, and beside the
    bf16 step's kernel run: pairs that agree and the largest twist
    difference.  All of it is logged, not held (the trained int8 ViT
    amplifies the kernels' bf16 ulps through its static activation scales;
    phase 2 holds the kernels themselves at these shapes); the launch
    counts are held by the caller."""
    out = {}
    for variant in variants:
        model = serving_model(cfg, variant, device, vit)
        goal, rgbs, depths = render_views(model, scene, offsets)
        _, calib, _ = render_views(model, scene, calib_offsets)
        summary, _, _ = run_serving_path(fnet, cfg, variant, device, vit=vit,
                                         frames=(goal, rgbs, calib, depths), keep_steps=True,
                                         tol=(math.inf, -math.inf, math.inf))
        steps = summary.pop("steps")
        agree = [int(same_pairs(a, b).sum()) for a, b in zip(bf16_steps, steps)]
        gap = max((a.body_twist - b.body_twist).abs().max().item()
                  for a, b in zip(bf16_steps, steps))
        out[variant] = {"summary": summary, "pairs_agreeing_with_bf16": agree,
                        "pairs": int(steps[0].valid.numel()), "twist_gap_to_bf16": gap}
    return out


def run_trained_loop(net, cfg: VSConfig, model: ServoModel, scene: Scene, out_dir: str,
                     episode: int = TRAINED_LOOP_EPISODE, forced: int = TRAINED_LOOP_FORCED,
                     num_steps: int | None = None, segment_steps: int | None = 250) -> dict:
    """run_benchmark through the kernels on one episode of the seed-41
    stream at ``cfg``'s full ladder (rotation search on), the launch
    counters zeroed before and read after; its first ``forced`` steps are
    teacher-forced through the plain step (their frame, EMA, command and
    scores; the plain goal descriptors).  The episode must converge by the
    ladder's own test: if it does not, the episode runs again plain, and
    the error names its final errors and where the two runs part."""
    model_plain = dataclasses.replace(model, use_kernels=False)
    common = dict(rotation_search=True, num_steps=num_steps, segment_steps=segment_steps,
                  verbose=False, device=model.device, episode_indices=[episode], chunk=1)
    record = []

    def on_step(abs_ids, inputs, result):
        if len(record) < forced:
            record.append((inputs, result))

    for fn in _counters().values():
        fn.launches = 0
    sync(model.device)
    t0 = time.perf_counter()
    run = run_benchmark(cfg, net=net, model=model, scene=scene, out_dir=out_dir,
                        config_name="trained", on_step=on_step, **common)
    sync(model.device)
    wall_s = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in _counters().items()}
    check_npz(run.path, 1)

    cast = cast_for_benchmark(net, model.compute_dtype)
    goal_rgb, _ = observe(scene, model.camera, *goal_pose(model.device))
    goal_ker = goal_descriptors(cast, model, goal_rgb)
    goal_plain = goal_descriptors(cast, model_plain, goal_rgb)
    ref_steps = [servo_step(cast, model_plain, goal_plain, x.rgb, x.depth, x.ema, x.prev_v_c,
                            scores=x.scores) for x, _ in record]
    forced_cmp = compare_runs((goal_plain, ref_steps), (goal_ker, [r for _, r in record]),
                              every_step=True)
    sm = run.summaries
    out = {"episode": episode, "device_steps": run.device_steps,
           "chunk_steps": run.chunk_steps, "wall_s": wall_s,
           "launches": launches, "iterations": int(sm["all_iteration_histories"][0]),
           "converged": bool(sm["convergence_flags"][0]),
           "final_pos_err_cm": float(sm["position_errors"][0]),
           "final_rot_err_deg": float(sm["orientation_errors"][0]),
           "lowest_pos_err_cm": float(sm["lowest_position_errors"][0]),
           "lowest_rot_err_deg": float(sm["lowest_orientation_errors"][0]),
           "teacher_forced": {"steps": len(record),
                              "steps_with_flips": sum(1 for f in forced_cmp["differing_pairs"] if f),
                              "flipped_pairs": sum(forced_cmp["differing_pairs"]),
                              "twist_max_abs_err": forced_cmp["twist_max_abs_err"],
                              "steps_compared": forced_cmp["steps_compared"],
                              "goal_desc_rel_err": forced_cmp["desc_rel_err"]}}
    if not out["converged"]:
        plain = run_benchmark(cfg, net=net, model=model_plain, scene=scene, save=False, **common)
        pk = np.asarray(sm["all_position_histories"][0], np.float64)
        pp = np.asarray(plain.summaries["all_position_histories"][0], np.float64)
        m = min(len(pk), len(pp))
        apart = np.nonzero(np.abs(pk[:m] - pp[:m]).max(-1) > 1e-4)[0]
        raise AssertionError(
            f"trained episode {episode} did not converge: {json.dumps(out)}; the plain run "
            f"converged={bool(plain.summaries['convergence_flags'][0])} at final error "
            f"{float(plain.summaries['position_errors'][0]):.3f} cm, the runs part at step "
            f"{int(apart[0]) if len(apart) else None}")
    return out


def teacher_forcer(net, model: ServoModel, scene: Scene, episodes):
    """An ``on_step`` hook that hands every chunk-step (or a mesh's dp row's
    share of it) to the plain batched step of the unsplit ``net``, cast as
    the benchmark casts it, with the plain goal descriptors: the same frames,
    EMA, commands and pair scores.  Per episode (its place in ``episodes``)
    it counts the pairs that differ, and holds the twists within TWIST_TOL
    where an episode's pairs agree (the caller holds the tally's error to
    TWIST_TOL).  Returns (the tally, the hook, the plain goal descriptors)."""
    model_plain = dataclasses.replace(model, use_kernels=False)
    cast = cast_for_benchmark(net, model.compute_dtype)
    goal_plain = goal_descriptors(cast, model_plain,
                                  observe(scene, model.camera, *goal_pose(model.device))[0])
    place = {int(e): j for j, e in enumerate(episodes)}
    forced = {"flips": [0] * len(episodes), "steps_with_flips": [0] * len(episodes),
              "twist_max_abs_err": 0.0, "episode_steps_compared": 0}

    def on_step(abs_ids, inputs, result):
        ref = servo_step(cast, model_plain, goal_plain, inputs.rgb, inputs.depth, inputs.ema,
                         inputs.prev_v_c, scores=inputs.scores)
        diff = (~same_pairs(ref, result)).sum(-1).tolist()
        for ep, f in zip(np.asarray(abs_ids).tolist(), diff):
            forced["flips"][place[int(ep)]] += f
            forced["steps_with_flips"][place[int(ep)]] += int(f > 0)
        agree = torch.tensor([f == 0 for f in diff], device=result.body_twist.device)
        if bool(agree.any()):
            err = (ref.body_twist - result.body_twist).abs().amax(-1)[agree].max().item()
            forced["twist_max_abs_err"] = max(forced["twist_max_abs_err"], err)
            forced["episode_steps_compared"] += int(agree.sum())

    return forced, on_step, goal_plain


def run_trained_chunk(net, cfg: VSConfig, model: ServoModel, scene: Scene, out_dir: str,
                      episodes=CHUNK_EPISODES, num_steps: int = CHUNK_STEPS,
                      segment_steps: int = CHUNK_SEGMENT,
                      alone_steps: int = CHUNK_ALONE_STEPS) -> dict:
    """run_benchmark through the kernels on ``episodes`` as one chunk
    (rotation search on) for ``num_steps`` steps, the launch counters zeroed
    before and read after; every chunk-step teacher-forced through the plain
    batched step (its frames, EMA, commands and scores; the plain goal
    descriptors), twists held within TWIST_TOL where an episode's pairs
    agree, flips counted per episode.  Then the same episodes one a chunk
    for ``alone_steps`` steps, each held against its item of the chunk up to
    its first step whose pairs differ (the trajectories part there)."""
    nb = len(episodes)
    common = dict(rotation_search=True, segment_steps=segment_steps, verbose=False,
                  device=model.device, episode_indices=episodes)
    forced, force, _ = teacher_forcer(net, model, scene, episodes)
    kept = []

    def on_step(abs_ids, inputs, result):
        force(abs_ids, inputs, result)
        if len(kept) < alone_steps:
            kept.append(result)

    for fn in _counters().values():
        fn.launches = 0
    sync(model.device)
    t0 = time.perf_counter()
    run = run_benchmark(cfg, net=net, model=model, scene=scene, out_dir=out_dir,
                        config_name="chunk", chunk=nb, num_steps=num_steps, on_step=on_step,
                        **common)
    sync(model.device)
    wall_s = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in _counters().items()}
    check_npz(run.path, nb)
    if not forced["twist_max_abs_err"] <= TWIST_TOL:
        raise AssertionError(f"chunk, teacher-forced: twists differ by "
                             f"{forced['twist_max_abs_err']} > {TWIST_TOL}")

    alone = {int(e): [] for e in episodes}

    def on_alone(abs_ids, inputs, result):
        alone[int(abs_ids[0])].append(result)

    solo = run_benchmark(cfg, net=net, model=model, scene=scene, save=False, chunk=1,
                         num_steps=alone_steps, on_step=on_alone, **common)
    first_flip, flips, twist_err, compared = [], [], 0.0, 0
    for j, ep in enumerate(episodes):
        parted = None
        flips.append(0)
        for step, (c, a) in enumerate(zip(kept, alone[int(ep)])):
            same = bool(((c.s_uv_star[j] == a.s_uv_star[0]).all(-1)
                         & ((c.s_uv[j] - a.s_uv[0]).abs() <= 1.0).all(-1)
                         & (c.valid[j] == a.valid[0])).all())
            flips[-1] += int(not same)
            parted = step if parted is None and not same else parted
            if parted is None:
                twist_err = max(twist_err, (c.body_twist[j] - a.body_twist[0]).abs().max().item())
                compared += 1
        first_flip.append(parted)
    if not twist_err <= TWIST_TOL:
        raise AssertionError(f"chunk against alone: twists differ by {twist_err} > {TWIST_TOL} "
                             f"before the first pair flip")
    quat_gap = max(float(np.abs(np.asarray(c[1], np.float64) - np.asarray(a[1], np.float64)).max())
                   for c, a in zip(run.summaries["best_poses"], solo.summaries["best_poses"]))
    return {"episodes": [int(e) for e in episodes], "device_steps": run.device_steps,
            "chunk_steps": run.chunk_steps, "wall_s": wall_s, "launches": launches,
            "teacher_forced": forced,
            "alone": {"steps": alone_steps, "first_flip_step": first_flip,
                      "steps_with_flips": flips, "twist_max_abs_err": twist_err,
                      "episode_steps_compared": compared,
                      "search_quat_max_abs_diff": quat_gap}}


# ---------------------------------------------------------------------------
# phase 3g: the int8 closed loop at run AD's settings
# ---------------------------------------------------------------------------


def ad_config() -> VSConfig:
    """configs/real_s518_pool2mm.yaml's settings, built in code (run AD's:
    ViT-S/14 at 518 with 2 x 2 K/V pooling by the matrix after the
    projection), on the 500-episode stream as trained_config."""
    return trained_config().replace(kv_pool=2, kv_pool_impl="matmul")


def int8_model(model: ServoModel, patch_embed_impl: str = "conv",
               kv_pool_where: str | None = None) -> ServoModel:
    """The int8 serving model of the float ``model`` as
    run_benchmark(quantized=True) builds it ('nomax3', 'default' resize,
    source-quantized bins), with the conv patch embedding or bench.py's
    reshape, K/V pooled where ``kv_pool_where`` says (default: as
    ``model``)."""
    where = kv_pool_where or model.vit.kv_pool_where
    return dataclasses.replace(
        model, quantized=True, pp_precision="default", cfg=model.cfg.replace(kv_pool_where=where),
        vit=dataclasses.replace(model.vit, quant_attn="nomax3", patch_embed_impl=patch_embed_impl,
                                kv_pool_where=where))


def int8_serving_of_stream(fnet, model: ServoModel, scene: Scene):
    """The int8 ViT and model run_benchmark(quantized=True, int8_static=True)
    serves on the seed-41 stream of ``model.cfg`` (static scales on the goal
    view and the stream's first 7 start views)."""
    positions, quats, _ = generate_episode_starts(model.cfg)
    k = min(7, len(positions))
    calib = (np.concatenate([[DESIRED_POSITION], positions[:k]]),
             np.concatenate([[DESIRED_ORIENTATION], quats[:k]]))
    return int8_serving(fnet, model, scene, calib)


def _to_cpu(nest):
    if isinstance(nest, tuple):
        return type(nest)(*(_to_cpu(x) for x in nest))
    return None if nest is None else nest.cpu()


def run_int8_chunk(fnet, cfg: VSConfig, model: ServoModel, scene: Scene, out_dir: str,
                   episodes=CHUNK_EPISODES, num_steps: int = CHUNK_STEPS,
                   segment_steps: int = CHUNK_SEGMENT, forced: int = INT8_FORCED,
                   alone_steps: int = CHUNK_ALONE_STEPS) -> dict:
    """run_benchmark(quantized=True, int8_static=True) on ``episodes`` as one
    chunk (rotation search on) for ``num_steps`` steps, from the f32
    ``fnet``, the launch counters zeroed before and read after (the int8
    closed loop launches no hand kernel: the JAX package sends it through
    no Pallas kernel); its first ``forced`` chunk-steps teacher-forced
    through the same step on CPU tensors (the int8 ViT the run served,
    copied to the CPU, its goal descriptors, the chunk-step's frames, EMA,
    commands and scores; the arithmetic the CPU tests hold against JAX),
    twists held within TWIST_TOL where an episode's pairs agree, flips
    counted per episode.  Then the same episodes one a chunk for
    ``alone_steps`` steps, each held against its item of the chunk up to
    its first step whose pairs differ."""
    nb = len(episodes)
    common = dict(rotation_search=True, segment_steps=segment_steps, verbose=False,
                  device=model.device, episode_indices=episodes, quantized=True,
                  int8_static=True)
    record, kept = [], []

    def on_step(abs_ids, inputs, result):
        if len(record) < forced:
            record.append((_to_cpu(inputs), _to_cpu(result)))
        if len(kept) < alone_steps:
            kept.append(result)

    for fn in _counters().values():
        fn.launches = 0
    sync(model.device)
    t0 = time.perf_counter()
    run = run_benchmark(cfg, net=fnet, model=model, scene=scene, out_dir=out_dir,
                        config_name="int8_chunk", chunk=nb, num_steps=num_steps,
                        on_step=on_step, **common)
    sync(model.device)
    wall_s = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in _counters().items()}
    check_npz(run.path, nb)

    t0 = time.perf_counter()
    cpu_model = dataclasses.replace(run.model, device="cpu")
    cpu_net = copy.deepcopy(run.net).to("cpu")
    goal_rgb, _ = observe(scene, model.camera, *goal_pose(model.device))
    cpu_goal = goal_descriptors(cpu_net, cpu_model, goal_rgb.cpu())
    forced_out = {"steps": len(record), "flips": [0] * nb, "steps_with_flips": [0] * nb,
                  "twist_max_abs_err": 0.0, "episode_steps_compared": 0}
    for x, result in record:
        ref = servo_step(cpu_net, cpu_model, cpu_goal, x.rgb, x.depth, x.ema, x.prev_v_c,
                         scores=x.scores)
        diff = (~same_pairs(ref, result)).sum(-1).tolist()
        for j, f in enumerate(diff):
            forced_out["flips"][j] += f
            forced_out["steps_with_flips"][j] += int(f > 0)
        agree = torch.tensor([f == 0 for f in diff])
        if bool(agree.any()):
            err = (ref.body_twist - result.body_twist).abs().amax(-1)[agree].max().item()
            forced_out["twist_max_abs_err"] = max(forced_out["twist_max_abs_err"], err)
            forced_out["episode_steps_compared"] += int(agree.sum())
    forced_out["cpu_s"] = time.perf_counter() - t0
    if not forced_out["twist_max_abs_err"] <= TWIST_TOL:
        raise AssertionError(f"int8 chunk against the CPU step: twists differ by "
                             f"{forced_out['twist_max_abs_err']} > {TWIST_TOL}")

    alone = {int(e): [] for e in episodes}

    def on_alone(abs_ids, inputs, result):
        alone[int(abs_ids[0])].append(result)

    solo = run_benchmark(cfg, net=fnet, model=model, scene=scene, save=False, chunk=1,
                         num_steps=alone_steps, on_step=on_alone, **common)
    first_flip, twist_err, compared = [], 0.0, 0
    for j, ep in enumerate(episodes):
        parted = None
        for step, (c, a) in enumerate(zip(kept, alone[int(ep)])):
            same = bool(same_pairs(item(a, 0), item(c, j)).all())
            parted = step if parted is None and not same else parted
            if parted is None:
                twist_err = max(twist_err, (c.body_twist[j] - a.body_twist[0]).abs().max().item())
                compared += 1
        first_flip.append(parted)
    if not twist_err <= TWIST_TOL:
        raise AssertionError(f"int8 chunk against alone: twists differ by {twist_err} > "
                             f"{TWIST_TOL} before the first pair flip")
    sm = run.summaries
    for k in ("final_positions", "final_quaternions"):
        if not np.isfinite(np.stack([np.asarray(p, np.float64) for p in sm[k]])).all():
            raise AssertionError(f"int8 chunk: {k} not finite")
    return {"episodes": [int(e) for e in episodes], "device_steps": run.device_steps,
            "chunk_steps": run.chunk_steps, "wall_s": wall_s, "launches": launches,
            "quant_attn": run.model.vit.quant_attn, "kv_pool": run.model.vit.kv_pool,
            "pp_precision": run.model.pp_precision,
            "iterations": [int(i) for i in sm["all_iteration_histories"]],
            "lowest_pos_err_cm": [float(e) for e in sm["lowest_position_errors"]],
            "teacher_forced": forced_out,
            "alone": {"steps": alone_steps, "first_flip_step": first_flip,
                      "twist_max_abs_err": twist_err, "episode_steps_compared": compared},
            "run": run}


def compare_bench_graph(fnet, model: ServoModel, scene: Scene, offsets=TRAINED_STEP_OFFSETS,
                        calib_offsets=TRAINED_CALIB_OFFSETS) -> dict:
    """bench.py's graph (K/V pooled before the projection, the reshape patch
    embedding) beside run AD's (pooled after, conv) of the float ``model``,
    each calibrated on the goal view and the views of ``calib_offsets``:
    goal + one step per view of ``offsets`` on the same frames and scores;
    pairs agreeing and the largest twist gap, logged."""
    steps = {}
    for name, qmodel in (("pool2mm", int8_model(model, "conv")),
                         ("pool2mmpre", int8_model(model, "reshape", "pre"))):
        goal, rgbs, depths = render_views(qmodel, scene, offsets)
        _, calib, _ = render_views(qmodel, scene, calib_offsets)
        qnet = quantized_vit(fnet, qmodel, [goal, *calib])
        goal_desc, steps[name] = drive(qnet, qmodel, goal, rgbs, depths,
                                       pair_scores(qmodel, len(rgbs)))
        check_outputs(qmodel, goal_desc, steps[name])
    a, b = steps["pool2mm"], steps["pool2mmpre"]
    return {"pairs_agreeing": [int(same_pairs(x, y).sum()) for x, y in zip(a, b)],
            "pairs": int(a[0].valid.numel()),
            "twist_gap": max((x.body_twist - y.body_twist).abs().max().item()
                             for x, y in zip(a, b)),
            "twist_max_abs": max(x.body_twist.abs().max().item() for x in a)}


def preprocess_gap(model: ServoModel, scene: Scene) -> dict:
    """The 'default' preprocess (one TF32 pass on the card) against
    'highest' on the goal view: the largest gap; TF32 is off again after."""
    rgb, _ = observe(scene, model.camera, *goal_pose(model.device))
    fast = preprocess(dataclasses.replace(model, pp_precision="default"), rgb)
    exact = preprocess(dataclasses.replace(model, pp_precision="highest"), rgb)
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("the 'default' preprocess left TF32 on")
    return {"max_abs_gap": (fast - exact).abs().max().item(),
            "share_apart": (fast != exact).float().mean().item()}


# ---------------------------------------------------------------------------
# phase 3h: the classical baselines (SIFT, ORB, AKAZE, Harris)
# ---------------------------------------------------------------------------


def real64_config() -> VSConfig:
    """configs/real64.yaml's settings, built in code: the defaults with the
    dls solve on the 64-episode stream (runs J, K and AN's)."""
    return VSConfig(pinv_mode="dls", num_samples=CLASSICAL_STREAM)


def _same_pairs(a, b) -> torch.Tensor:
    """(B,) bool: the two chunk-steps selected the same pairs."""
    return ((a.valid == b.valid).all(-1) & (a.s_uv == b.s_uv).flatten(-2).all(-1)
            & (a.s_uv_star == b.s_uv_star).flatten(-2).all(-1))


def _same_keypoints(a, b) -> torch.Tensor:
    """(B,) bool: two frames' feature sets hold the same valid keypoints."""
    return (a.valid == b.valid).all(-1) & ((a.uv == b.uv).all(-1) | ~a.valid).all(-1)


def run_classical_chunk(method: str, cfg: VSConfig, scene: Scene, out_dir: str,
                        episodes=CHUNK_EPISODES, num_steps=CLASSICAL_STEPS,
                        compared=CLASSICAL_COMPARED, alone_steps=CLASSICAL_ALONE_STEPS,
                        max_corners: int | None = None) -> dict:
    """run_classical_benchmark on ``episodes`` as one chunk for
    ``num_steps`` steps on the scene's device (``max_corners`` the method's
    default when None), twice: the two runs' twists must be equal bit for
    bit and no hand kernel may launch.  The ``compared`` chunk-steps are
    held against the port on the CPU on the same frames (the goal's and the
    frames' keypoint sets and pair sets compared, twists within
    CLASSICAL_TWIST_TOL where the pairs agree), with the Hamming distances
    of the int8 product on the device against the CPU's bit for bit; then
    each episode alone for ``alone_steps`` steps against the chunk, twists
    held up to its first pair flip."""
    dev = scene.texture.device
    k = max_corners or DEFAULT_MAX_CORNERS[method]
    common = dict(method=method, episode_indices=episodes, num_steps=num_steps, chunk=len(episodes),
                  max_corners=k, verbose=False, device=dev)
    record, steps = {}, [[], []]

    def on_step_of(run):
        def on_step(abs_ids, inputs, res):
            i = len(steps[run])
            steps[run].append(res)
            if run == 0 and i in compared:
                record[i] = (_to_cpu(inputs), _to_cpu(res))
        return on_step

    for fn in _counters().values():
        fn.launches = 0
    sync(dev)
    t0 = time.perf_counter()
    run = run_classical_benchmark(cfg, scene=scene, out_dir=out_dir, config_name="classical",
                                  on_step=on_step_of(0), **common)
    sync(dev)
    wall_s = time.perf_counter() - t0
    again = run_classical_benchmark(cfg, scene=scene, save=False, on_step=on_step_of(1), **common)
    check_npz(run.path, len(episodes))
    twists = [torch.stack([s.body_twist for s in st]) for st in steps]
    if not torch.equal(twists[0], twists[1]):
        raise AssertionError(f"{method}: two runs of the chunk differ by "
                             f"{(twists[0] - twists[1]).abs().max().item():.3e}")
    if not torch.isfinite(twists[0]).all():
        raise AssertionError(f"{method}: non-finite twists")

    # the CPU port on the same frames
    model = run.model
    cpu = dataclasses.replace(model, device="cpu")
    goal_rgb, _ = observe(scene, model.camera, *goal_pose(dev))
    goal = extract_goal_features(model, goal_rgb, k, method)
    goal_cpu = extract_goal_features(cpu, goal_rgb.cpu(), k, method)
    t_cpu = time.perf_counter()
    frames_same = pairs_same = compared_steps = 0
    twist_err, hamming_checked = 0.0, 0
    for i, (inputs, res) in sorted(record.items()):
        gray = grayscale(inputs.rgb.float())
        feats_dev = extract_features(gray.to(dev), k, method)
        feats_cpu = extract_features(gray, k, method)
        frames_same += int(_same_keypoints(_to_cpu(feats_dev), feats_cpu).sum())
        ref = classical_servo_step(cpu, goal_cpu, inputs.rgb, inputs.depth, inputs.ema,
                                   inputs.prev_v_c, k, method)
        same = _same_pairs(res, ref)
        pairs_same += int(same.sum())
        compared_steps += len(same)
        if same.any():
            twist_err = max(twist_err, (res.body_twist - ref.body_twist)[same].abs().max().item())
        if METHOD_NORMS[method] == "hamming":
            d_dev = _hamming_d2(goal.desc, feats_dev.desc).cpu()
            d_cpu = _hamming_d2(goal.desc.cpu(), feats_dev.desc.cpu())
            if not torch.equal(d_dev, d_cpu):
                raise AssertionError(f"{method}: Hamming distances on the device differ from "
                                     f"the CPU's at chunk-step {i}")
            hamming_checked += d_cpu.numel()
    cpu_s = time.perf_counter() - t_cpu
    if twist_err > CLASSICAL_TWIST_TOL:
        raise AssertionError(f"{method}: twists {twist_err:.3e} from the CPU port's where the "
                             f"pairs agree (tol {CLASSICAL_TWIST_TOL})")

    # each episode alone against the chunk
    first_flip, alone_err = [], 0.0
    for b, e in enumerate(episodes):
        solo = []
        run_classical_benchmark(cfg, scene=scene, save=False,
                                on_step=lambda ids, x, r: solo.append(r),
                                **{**common, "episode_indices": [e], "chunk": 1,
                                   "num_steps": alone_steps})
        flip = None
        for i, r in enumerate(solo):
            if not bool(_same_pairs(item(steps[0][i], b), item(r, 0))):
                flip = i
                break
            alone_err = max(alone_err, (steps[0][i].body_twist[b] - r.body_twist[0])
                            .abs().max().item())
        first_flip.append(flip)
    if alone_err > CLASSICAL_TWIST_TOL:
        raise AssertionError(f"{method}: a chunk's twists {alone_err:.3e} from its episodes "
                             f"alone before their first flip (tol {CLASSICAL_TWIST_TOL})")
    launches = {name: fn.launches for name, fn in _counters().items()}
    return {"method": method, "max_corners": k, "episodes": list(episodes),
            "device_steps": run.device_steps, "chunk_steps": run.chunk_steps,
            "chunk_steps_again": again.chunk_steps, "wall_s": wall_s,
            "launches": launches, "goal_keypoints": int(goal.valid.sum()),
            "goal_keypoints_same_on_cpu": bool(_same_keypoints(_to_cpu(goal), goal_cpu)),
            "iterations": [int(i) for i in run.summaries["all_iteration_histories"]],
            "final_pos_err_cm": [float(x) for x in run.summaries["position_errors"]],
            "pairs_per_step": float(torch.stack([s.num_valid for s in steps[0]]).float().mean()),
            "cpu": {"chunk_steps": sorted(record), "frames": compared_steps,
                    "frames_with_same_keypoints": frames_same,
                    "frames_with_same_pairs": pairs_same, "twist_max_abs_err": twist_err,
                    "hamming_distances_bit_for_bit": hamming_checked, "cpu_s": cpu_s},
            "alone": {"first_flip_step": first_flip, "twist_max_abs_err": alone_err}}


def classical_runner(method: str, scene: Scene, chunk: int):
    """One classical closed-loop chunk-step a call (render, features,
    matching, solve, integrate, ladder) of the first ``chunk`` episodes of
    the 64-episode stream, the method's default keypoints, carrying its
    state."""
    model = classical_model(real64_config(), scene.texture.device)
    k = DEFAULT_MAX_CORNERS[method]
    desired = goal_pose(model.device)
    goal = extract_goal_features(model, observe(scene, model.camera, *desired)[0], k, method)
    state = {"carry": episode_init(*loop_start(model.cfg, chunk), *desired)}

    def step_fn(rgb, depth, ema, prev_v_c, scores):
        return classical_servo_step(model, goal, rgb, depth, ema, prev_v_c, k, method)

    def run():
        state["carry"], _ = rollout_segment(None, model, scene, None, state["carry"], 1,
                                            *desired, step_fn=step_fn, draw_scores=False)
    return run


# ---------------------------------------------------------------------------
# phase 3i: descriptor training at full width
# ---------------------------------------------------------------------------


def train_model(size: int, device, vit=None) -> ServoModel:
    """The trainer's model (train/train_servo.py's defaults): ViT-S/14 at
    ``size``, layer 11, bf16 blocks over f32 weights, tanh GELU; ``vit``
    replaces the ViT (a tiny one in the CPU tests, its last block the
    layer)."""
    if vit is None:
        return ServoModel.create(VSConfig(dino_input_size=size), compute_dtype=torch.bfloat16,
                                 device=device)
    return ServoModel(vit=vit, cfg=VSConfig(dino_input_size=size, layer=vit.depth - 1),
                      compute_dtype=torch.bfloat16, device=device)


def train_schedule(steps: int = TRAIN_STEPS, lr: float = TRAIN_LR, warmup: int = TRAIN_WARMUP):
    """train_servo's schedule for a run of ``steps``."""
    return warmup_cosine_decay_schedule(0.0, lr, warmup, max(steps, warmup + 1), lr * 0.05)


def check_train_grads(device, size: int = 308, seed: int = 0, batch: int = 2, vit=None) -> dict:
    """3i(a): one bf16 loss and its gradients on the card and on the card
    machine's CPU, from one seeded ViT and one servo pair batch built on the
    CPU from a seeded generator (the real poster)."""
    cpu_model = train_model(size, "cpu", vit=vit)
    net_cpu = init_vit(cpu_model.vit, torch.Generator().manual_seed(seed), device="cpu")
    goal, data = make_servo_pair_batch(cpu_model, load_poster_scene(device="cpu"),
                                       torch.Generator().manual_seed(seed + 1), batch)
    t0 = time.perf_counter()
    loss_cpu = _servo_batch_loss(net_cpu, cpu_model, goal, data)
    loss_cpu.backward()
    cpu_s = time.perf_counter() - t0
    card_model = dataclasses.replace(cpu_model, device=device)
    net = copy.deepcopy(net_cpu).to(device)
    net.zero_grad(set_to_none=True)
    loss = _servo_batch_loss(net, card_model, goal.to(device),
                             {k: v.to(device) for k, v in data.items()})
    loss.backward()
    rel = abs(loss.item() - loss_cpu.item()) / abs(loss_cpu.item())
    if not rel <= TRAIN_LOSS_RTOL:
        raise AssertionError(f"train loss card {loss.item()} vs CPU {loss_cpu.item()}: "
                             f"relative {rel} > {TRAIN_LOSS_RTOL}")
    cos = {}
    for (name, p), q in zip(net.named_parameters(), net_cpu.parameters()):
        if name.startswith("norm."):
            # the final norm is off the loss's path: no gradient on either device
            if p.grad is not None or q.grad is not None:
                raise AssertionError(f"{name} has a gradient: the loss reached the final norm")
            continue
        a, b = p.grad.double().cpu().flatten(), q.grad.double().flatten()
        na, nb = a.norm().item(), b.norm().item()
        cos[name] = 1.0 if na == nb == 0.0 else (a @ b).item() / max(na * nb, 1e-300)
    worst = min(cos, key=cos.get)
    if not cos[worst] >= TRAIN_GRAD_COS_MIN:
        raise AssertionError(f"gradient of {worst}: cosine card vs CPU {cos[worst]} < "
                             f"{TRAIN_GRAD_COS_MIN}")
    return {"loss_card": loss.item(), "loss_cpu": loss_cpu.item(), "loss_rel_err": rel,
            "grad_cos_min": cos[worst], "grad_cos_min_param": worst, "params": len(cos),
            "cpu_s": cpu_s}


def check_score_train_grads(device, state_dict, score: str = "relu", size: int = 308,
                            batch: int = 2, vit=None) -> dict:
    """3j(e): one train step with the ``score`` attention from
    ``state_dict``'s weights on one servo pair batch built on the CPU, on
    the card and on the card machine's CPU.  In f32 as 3i(a) holds bf16:
    loss within TRAIN_LOSS_RTOL relative, every gradient's cosine card
    against CPU at least TRAIN_GRAD_COS_MIN.  In bf16, the step co-training
    runs: the loss likewise and every gradient finite; each gradient's
    cosine to the f64 one (the CPU's) is logged for the card and the CPU,
    not held: at ckpt_real518's weights the relu gradients of the q and k
    columns are noise-dominated in bf16 on some batches in any
    implementation (scripts/port_score_grad_noise.py reads them over
    several batches; PERF.md).  ``vit`` replaces the ViT (the CPU tests'
    tiny one)."""
    vit = dataclasses.replace(vit or train_model(size, "cpu").vit, attn_score=score)
    base = train_model(size, "cpu", vit=vit)
    goal, data = make_servo_pair_batch(base, load_poster_scene(device="cpu"),
                                       torch.Generator().manual_seed(1), batch)

    def step(dtype, dev):
        wdt = torch.float64 if dtype == torch.float64 else torch.float32
        net = ViT.from_state_dict(vit, state_dict).to(dev, wdt)
        cast = lambda t: t.to(dev, wdt) if t.is_floating_point() else t.to(dev)
        loss = _servo_batch_loss(net, dataclasses.replace(base, compute_dtype=dtype, device=dev),
                                 cast(goal), {k: cast(v) for k, v in data.items()})
        loss.backward()
        # the final norm is off the loss's path and has no gradient
        return loss.item(), {n: p.grad.double().cpu().flatten() for n, p in net.named_parameters()
                             if not n.startswith("norm.")}

    def cos(a, b):
        na, nb = a.norm().item(), b.norm().item()
        return 1.0 if na == nb == 0.0 else (a @ b).item() / max(na * nb, 1e-300)

    out = {}
    _, g64 = step(torch.float64, "cpu")
    for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        (lc, gc), (lp, gp) = step(dtype, device), step(dtype, "cpu")
        rel = abs(lc - lp) / abs(lp)
        if not rel <= TRAIN_LOSS_RTOL:
            raise AssertionError(f"{score} {name} train loss card {lc} vs CPU {lp}: relative "
                                 f"{rel} > {TRAIN_LOSS_RTOL}")
        bad = [n for n in gc if not bool(torch.isfinite(gc[n]).all())]
        if bad:
            raise AssertionError(f"{score} {name}: non-finite gradients on the card: {bad}")
        pair = {n: cos(gc[n], gp[n]) for n in gc}
        card64 = {n: cos(gc[n], g64[n]) for n in gc}
        cpu64 = {n: cos(gp[n], g64[n]) for n in gc}
        gap = {n: cpu64[n] - card64[n] for n in gc}
        worst, wcard, wcpu = (min(d, key=d.get) for d in (pair, card64, cpu64))
        wgap = max(gap, key=gap.get)
        out[name] = {"loss_card": lc, "loss_cpu": lp, "loss_rel_err": rel,
                     "grad_cos_min": pair[worst], "grad_cos_min_param": worst,
                     "f64_cos_min_card": card64[wcard], "f64_cos_min_card_param": wcard,
                     "f64_cos_min_cpu": cpu64[wcpu], "f64_cos_min_cpu_param": wcpu,
                     "f64_cos_gap_max": gap[wgap], "f64_cos_gap_max_param": wgap}
        if name == "f32" and not pair[worst] >= TRAIN_GRAD_COS_MIN:
            raise AssertionError(f"{score} f32 gradient of {worst}: cosine card vs CPU "
                                 f"{pair[worst]} < {TRAIN_GRAD_COS_MIN}")
    out["params"] = len(g64)
    return out


def run_train_steps(state, model: ServoModel, scene: Scene, steps: int, generator,
                    batch: int = TRAIN_BATCH, chain: int = TRAIN_CHAIN) -> tuple:
    """``steps`` servo train steps in chains of ``chain``, the launch
    counters zeroed before and read after (the training forward is plain by
    construction: no hand kernel may launch).  Returns (state, losses,
    ms a step, peak bytes allocated)."""
    epoch = make_servo_train_epoch(model, batch, chain)
    for fn in _counters().values():
        fn.launches = 0
    cuda = torch.device(model.device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    sync(model.device)
    t0 = time.perf_counter()
    losses = []
    for _ in range(steps // chain):
        state, got = epoch(state, scene, generator)
        losses.append(got)
    losses = torch.cat(losses).tolist()
    sync(model.device)
    ms = 1e3 * (time.perf_counter() - t0) / steps
    launched = {name: fn.launches for name, fn in _counters().items() if fn.launches}
    if launched:
        raise AssertionError(f"training launched hand kernels {launched}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"a training loss is not finite: {losses}")
    return state, losses, ms, torch.cuda.max_memory_allocated() if cuda else 0


def window(losses, lo: int, hi: int) -> float:
    """Mean loss of steps lo..hi (1-based, inclusive)."""
    return statistics.fmean(losses[lo - 1:hi])


def quality_both(net, model: ServoModel, scene: Scene, views: int = TRAIN_EVAL_VIEWS) -> dict:
    """matching_quality with kernels (counters zeroed before, read after)
    and with their plain versions, on the same draws."""
    for fn in _counters().values():
        fn.launches = 0
    ker = matching_quality(net, model, scene, torch.Generator().manual_seed(123), views)
    launches = {name: fn.launches for name, fn in _counters().items()}
    plain = matching_quality(net, dataclasses.replace(model, use_kernels=False), scene,
                             torch.Generator().manual_seed(123), views)
    return {"kernels": ker, "plain": plain, "launches": launches}


def train_step_runner(net, model: ServoModel, scene: Scene, batch: int = TRAIN_BATCH):
    """One train step a call on a copy of ``net`` (its own optimizer)."""
    state = init_train_state(copy.deepcopy(net), train_schedule())
    epoch = make_servo_train_epoch(model, batch, 1)
    gen = torch.Generator().manual_seed(0)
    holder = [state]

    def run():
        holder[0], _ = epoch(holder[0], scene, gen)

    return run


def run_training(device, scene: Scene, steps: int = TRAIN_SMOKE_STEPS,
                 resume_steps: int = TRAIN_RESUME_STEPS, path: Path = TRAINED_S518,
                 size: int = 308, resume_size: int = 518, batch: int = TRAIN_BATCH,
                 chain: int = TRAIN_CHAIN, views: int = TRAIN_EVAL_VIEWS, profile: bool = True,
                 vit=None, early=(TRAIN_EARLY_MAX, TRAIN_EARLY_DROP),
                 quality_min=TRAIN_QUALITY_MIN, resume_max: float = TRAIN_RESUME_MAX) -> dict:
    """3i(b)-(d): ``steps`` steps from scratch at ``size`` with the JAX run's
    arguments (its 3000-step schedule and poster, train_servo's seeds: these
    are the first steps of ``--train 3000``); the trained weights of
    ``path`` at ``resume_size`` on ``scene`` (the real poster they were
    trained on): matching quality before any update, with kernels and
    plain, then ``resume_steps`` steps (train_servo --resume's schedule);
    then save, load and one servo step with kernels.  ``vit`` replaces
    the ViT (the CPU tests' tiny one, with its own bounds ``early``,
    ``quality_min`` and ``resume_max``)."""
    out = {}
    model = train_model(size, device, vit=vit)
    net = init_vit(model.vit, torch.Generator().manual_seed(TRAIN_SEED), device=device)
    state = init_train_state(net, train_schedule())
    gen = torch.Generator().manual_seed(TRAIN_SEED + 1)
    jax_scene = train_servo.scene_of(TRAIN_POSTER, device)
    state, losses, ms, peak = run_train_steps(state, model, jax_scene, steps, gen, batch, chain)
    first, last = window(losses, 1, chain), window(losses, steps - chain + 1, steps)
    out["scratch"] = {"size": size, "steps": steps, "poster": TRAIN_POSTER,
                      "first_window": first, "last_window": last,
                      "ms_per_step": ms, "peak_bytes": peak, "losses": losses}
    if not (last <= early[0] and first - last >= early[1]):
        raise AssertionError(f"from scratch: mean loss {first:.4f} over steps 1-{chain}, "
                             f"{last:.4f} over steps {steps - chain + 1}-{steps} (bounds: at "
                             f"most {early[0]}, at least {early[1]} below)")
    if profile:
        out["scratch"]["profile"] = profile_run(train_step_runner(net, model, jax_scene, batch),
                                                steps=5, top=8)

    rmodel = train_model(resume_size, device, vit=vit)
    rnet = load_trained(rmodel, path)[0]
    q = quality_both(rnet, rmodel, scene, views)
    out["resume"] = {"size": resume_size, "quality": q}
    for kind in ("kernels", "plain"):
        frac, acc = q[kind]
        if not (frac >= quality_min[0] and acc >= quality_min[1]):
            raise AssertionError(f"trained weights at {resume_size}, {kind}: valid-frac {frac}, "
                                 f"patch-acc {acc} (bounds {quality_min})")
    rstate = init_train_state(rnet, train_schedule(steps=TRAIN_RESUME_SCHEDULE))
    rstate, rlosses, rms, rpeak = run_train_steps(rstate, rmodel, scene, resume_steps,
                                                  torch.Generator().manual_seed(TRAIN_SEED + 1),
                                                  batch, chain)
    out["resume"].update(mean_loss=statistics.fmean(rlosses), ms_per_step=rms, peak_bytes=rpeak,
                         losses=rlosses)
    if not out["resume"]["mean_loss"] <= resume_max:
        raise AssertionError(f"resumed at {resume_size}: mean loss {out['resume']['mean_loss']} "
                             f"over {resume_steps} steps > {resume_max}")
    if profile:
        out["resume"]["profile"] = profile_run(train_step_runner(rnet, rmodel, scene, batch),
                                               steps=5, top=8)

    # 3i(d): save, load and serve the trained weights
    with tempfile.TemporaryDirectory() as tmp:
        wpath = Path(tmp) / "trained.npz"
        save_exported(wpath, rstate.net.state_dict(), rstate.net.cfg, "float32")
        sd, _ = load_exported(wpath)
    for k, v in rstate.net.state_dict().items():
        if not torch.equal(sd[k], v.cpu()):
            raise AssertionError(f"save_exported / load_exported changed {k}")
    serve = rmodel.load_vit(sd)
    goal, rgbs, depths = render_views(rmodel, scene, TRAINED_STEP_OFFSETS[:1])
    for fn in _counters().values():
        fn.launches = 0
    gd = goal_descriptors(serve, rmodel, goal)
    r = servo_step(serve, rmodel, gd, rgbs[0], depths[0], EmaState.init(device=device),
                   torch.zeros(6, device=device), generator=torch.Generator(device).manual_seed(0))
    sync(device)
    step_launches = {name: fn.launches for name, fn in _counters().items()}
    check_outputs(rmodel, gd, [r])
    out["served"] = {"num_valid": int(r.num_valid), "body_twist": r.body_twist.tolist(),
                     "launches": step_launches}
    return out


def run_train_command(steps: int, size: int, resume: Path | None, budget_s: float | None,
                      here: Path, device, poster: str = TRAIN_POSTER, extra_argv=(),
                      attn_score: str = "softmax") -> dict:
    """--train: ``python -m vitvs_tpu_torch.train.train_servo`` with the JAX
    run's arguments (its defaults and ``poster``, by default the synthetic
    one the JAX run trained on, 'real' for the real one; ``steps`` steps at
    ``size``, from random init or ``resume``), its files under .train/ (a run stopped by
    ``budget_s`` leaves its part there and the same command continues it).
    Writes chiprun_out/train_s<size>_<steps>.json (every loss, the loss
    windows beside the JAX run's, the matching quality) and the trained
    weights with bf16 blocks beside it.  For the JAX run itself (3000 steps
    at 308 from scratch on the synthetic poster) it holds the last window and the final patch-acc
    to TRAIN_FINAL_MAX and TRAIN_PATCH_ACC_MIN.  ``extra_argv``: more
    train_servo flags (the CPU tests' short chains); ``attn_score``: the
    score to co-train (train_servo --attn-score).  Every run's summary has
    its 25-step loss means; the JAX run's windows stand beside them only for
    runs from scratch, the runs they describe."""
    name = (f"train_s{size}_{steps}" + ("" if poster == TRAIN_POSTER else f"_{poster}")
            + ("_resumed" if resume else "")
            + ("" if attn_score == "softmax" else f"_{attn_score}"))
    out = here / ".train" / f"{name}.npz"
    out.parent.mkdir(parents=True, exist_ok=True)
    argv = ["--out", str(out), "--steps", str(steps), "--size", str(size), "--device", str(device)]
    if poster != "real":
        argv += ["--poster", poster]
    if resume is not None:
        argv += ["--resume", str(resume)]
    if attn_score != "softmax":
        argv += ["--attn-score", attn_score]
    argv += list(extra_argv)
    res = train_servo.train(train_servo.parse_args(argv), budget_s=budget_s, log=log)
    loss = res["loss"]
    summary = {"name": name, "steps": steps, "size": size, "poster": poster,
               "resume": None if resume is None else str(resume), "attn_score": attn_score,
               "finished": res["finished"], "done": res["done"],
               "windows": {f"{lo}-{hi}": {"port": window(loss, lo, hi),
                                          "jax": jax if resume is None else None}
                           for (lo, hi), jax in JAX_LOSS_WINDOWS.items() if hi <= len(loss)},
               "windows_25": [window(loss, lo + 1, lo + TRAIN_CHAIN)
                              for lo in range(0, len(loss) - TRAIN_CHAIN + 1, TRAIN_CHAIN)],
               "init_matching": res["init_matching"], "final_matching": res["final_matching"],
               "jax_final_matching": JAX_FINAL_MATCHING, "ms_per_step": res["ms_per_step"]}
    if (steps, size, resume, poster) == (TRAIN_STEPS, 308, None, TRAIN_POSTER) and res["finished"]:
        last, acc = window(loss, TRAIN_STEPS - 24, TRAIN_STEPS), res["final_matching"][1]
        summary["bounds"] = {"last_window": [last, TRAIN_FINAL_MAX],
                             "patch_acc": [acc, TRAIN_PATCH_ACC_MIN]}
        summary["bounds_met"] = last <= TRAIN_FINAL_MAX and acc >= TRAIN_PATCH_ACC_MIN
    out_dir = here / "chiprun_out"
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / f"{name}.json").write_text(json.dumps({**summary, "loss": loss}))
    if res["finished"]:
        sd, vcfg = load_exported(out)
        save_exported(out_dir / f"{name}_bf16.npz", sd, vcfg, "bfloat16", source=name)
    return summary


# ---------------------------------------------------------------------------
# phase 3j: the relu / sqrelu scores and the int8-probability modes
# ---------------------------------------------------------------------------


def score_config(score: str, kv_pool: int = 1) -> VSConfig:
    """configs/real_s518_relu.yaml's settings (with ``kv_pool`` 2
    real_s518_relupool.yaml's), built in code, on the 500-episode stream as
    :func:`trained_config`."""
    return dataclasses.replace(trained_config(), attn_score=score, kv_pool=kv_pool)


def run_score_step(score: str, device, scene: Scene, kv_pool: int = 1, seeded: bool = False):
    """3j(a): goal_descriptors + 5 bf16 servo_steps at ViT-S/14 @ 518 with
    the ``score`` attention, on ckpt_real518's weights (or seeded ones),
    through the kernels and plain, the plain step teacher-forced, as phase
    3e.  No attention kernel may launch (the scores are plain PyTorch, as
    the reference's are plain XLA), the bf16 matcher a launch a step.
    Returns (summary, the kernel run's steps, the ViT, the model)."""
    cfg = score_config(score, kv_pool)
    model = ServoModel.create(cfg, device=device)
    if seeded:
        net = init_vit(model.vit, torch.Generator().manual_seed(0), device=device,
                       layerscale=1.0).cast_blocks(model.compute_dtype).eval()
    else:
        net = load_trained(model)[0].cast_blocks(model.compute_dtype)
    summary = run_trained_step(net, cfg, model, scene)
    steps = summary.pop("steps")
    want = {name: 0 for name in _counters()}
    want["matcher_bf16"] = N_STEPS
    if summary["launches"] != want:
        raise AssertionError(f"{score} step (kv_pool {kv_pool}): launch counts "
                             f"{summary['launches']} != {want}")
    return summary, steps, net, model


def int8_operands(shape, seed: int, device) -> dict:
    """int8 operands of the 'pv' / 'qk+pv' products at ``shape`` (B, T, h,
    hd): Q (B, h, T, hd) against K^T, and the probabilities (B, h, T, T) in
    [0, 127] against V (B, h, T, hd); seeded, with -127 / 127 in every row."""
    B, T, H, hd = shape
    g = torch.Generator(device=device).manual_seed(seed)
    rnd = lambda lo, hi, sz: torch.randint(lo, hi, sz, generator=g, device=device,
                                           dtype=torch.int8)
    q, k, v = (rnd(-127, 128, sz) for sz in ((B, H, T, hd), (B, H, hd, T), (B, H, T, hd)))
    p = rnd(0, 128, (B, H, T, T))
    q[..., 0], k[..., 0, :], p[..., 0], v[..., 0, :] = 127, -127, 127, -127
    return {"qk": (q, k), "pv": (p, v)}


def check_int8_products(device, shape=SERVE_ATTN_SHAPE, seed: int = 31, rows: int = 16) -> dict:
    """3j(b): the int8 batched products of 'qk+pv' (Q K^T) and 'pv' (P V)
    at ``shape`` on the card (ops/int_mm.int8_bmm: f32 products over
    1024-deep chunks) bit for bit against the int64 product: an f64 GEMM on
    the card, exact (every partial sum an integer below 2^53), itself held
    bit for bit against an int64 broadcast sum on ``rows`` rows."""
    out = {}
    for name, (a, b) in int8_operands(shape, seed, device).items():
        got = int8_bmm(a, b)
        want = torch.matmul(a.double(), b.double()).to(torch.int64)
        sub = (a[..., :rows, :, None].long() * b[..., None, :, :].long()).sum(-2)
        if not torch.equal(want[..., :rows, :], sub):
            raise AssertionError(f"{name}: the f64 product is not the int64 product")
        if got.dtype != torch.int32 or not torch.equal(got.long(), want):
            bad = int((got.long() != want).sum())
            raise AssertionError(f"{name}: {bad} int32 products differ from the int64 product")
        out[name] = {"shape": [tuple(a.shape), tuple(b.shape)], "depth": a.shape[-1],
                     "max_abs": int(want.abs().max())}
    return out


def check_int8_block(qnet, model: ServoModel, frame, tol: float = INT8_BLOCK_TOL) -> dict:
    """3j(b), 3k(c): block 0 of the int8 ViT on the card and on the card
    machine's CPU (a copy of the block), on the same bf16 input (the card's
    embedding of ``frame``): max |diff| / max |ref| within ``tol``; the least
    cosine of a token, the mean |diff| / max |ref| and the card's plain
    block against both (where the gap comes from) logged."""
    with torch.inference_mode():
        x = qnet.embed(preprocess(model, frame)[None])
        blk = qnet.blocks[0]
        out = _block_q(x, blk, model.vit, True).float().cpu()
        plain = _block_q(x, blk, model.vit, False).float().cpu()
        ref = _block_q(x.cpu(), copy.deepcopy(blk).cpu(), model.vit, True).float()
    scale = ref.abs().max()
    rel = ((out - ref).abs().max() / scale).item()
    cos = torch.nn.functional.cosine_similarity(out[0], ref[0], dim=-1).min().item()
    if not rel <= tol:
        raise AssertionError(f"int8 block ({model.vit.quant_attn}) card vs CPU: max |diff| / "
                             f"max |ref| {rel} > {tol}")
    return {"rel_err": rel, "mean_rel_err": ((out - ref).abs().mean() / scale).item(),
            "token_cos_min": cos, "shape": list(out.shape),
            "plain_on_card_rel_err": ((plain - ref).abs().max() / scale).item(),
            "kernels_vs_plain_on_card_rel_err": ((out - plain).abs().max() / scale).item()}


# the static int8 products of an int8 block and the activation scale each quantizes by
STATIC_PRODUCTS = {"qkv": 0, "fc1": 1, "proj": 2, "fc2": 3}


def _plant_low(blk, cfg):
    """The attention output 5% low (a lost key tile's share of the weights)."""
    return blk.proj.register_forward_pre_hook(lambda m, a: (a[0] * 0.95, a[1]))


def _plant_heads(blk, cfg):
    """The last third of the heads given the first third's attention output
    (a head-offset fault; at 24 heads, heads 16-23 read heads 0-7)."""
    n = cfg.num_heads // 3 * cfg.head_dim

    def hook(m, a):
        x = a[0].clone()
        x[..., -n:] = a[0][..., :n]
        return x, a[1]
    return blk.proj.register_forward_pre_hook(hook)


def _plant_swiglu(blk, cfg):
    """The SwiGLU halves swapped: silu(x2) * x1."""
    return blk.fc1.register_forward_hook(lambda m, a, y: torch.cat(y.chunk(2, -1)[::-1], -1))


# faults planted by hooks in the card's int8 block 0 (removed after), and the
# check of check_int8_parts that must reject each: 'cpu' the block's output against the
# CPU (tol), 'attn' its attention output against the card's plain block
INT8_PLANTS = {"attention output 5% low": (_plant_low, "attn"),
               "last third of the heads given the first third's": (_plant_heads, "attn"),
               "SwiGLU halves swapped": (_plant_swiglu, "cpu")}
# block 0's attention output (the proj product's input), kernels vs plain on the
# card from the same qkv product: a few bf16 ulps (2^-8 relative each) of its largest
INT8_ATTN_OUT_TOL = 2e-2


def _int8_block_run(blk, x, cfg, use_kernels: bool, plant=None) -> dict:
    """Block 0 of an int8 ViT on ``x``: its output, the int8 activation
    codes of its static products and its attention output, on the CPU;
    ``plant`` (a hook maker) alters the block first."""
    got, handles = {}, [plant(blk, cfg)] if plant is not None else []
    for name, i in STATIC_PRODUCTS.items():
        def hook(m, a, name=name):
            got[name] = static_quant_act(a[0], a[1])[0].cpu()
            if name == "proj":
                got["attn"] = a[0].float().cpu()
        handles.append(getattr(blk, name).register_forward_pre_hook(hook))
    try:
        got["out"] = _block_q(x, blk, cfg, use_kernels).float().cpu()
    finally:
        for h in handles:
            h.remove()
    return got


def check_int8_parts(qnet, model: ServoModel, frame, tol: float = VITG_INT8_BLOCK_TOL) -> dict:
    """3k(c): block 0 of the int8 ViT through the kernels and plain on the
    card and on the card machine's CPU, on the same bf16 input (the card's
    embedding of ``frame``).  Held: the output card vs CPU within ``tol`` of
    its largest (check_int8_block's); the qkv product's int8 codes card vs
    CPU within one step (the same input: LayerNorm's last bit); kernels vs
    plain on the card, the qkv codes equal and the attention output within
    INT8_ATTN_OUT_TOL of its largest, which holds the attention kernel apart
    from the two libraries' rounding; and every fault of INT8_PLANTS,
    planted in the kernel run, rejected by its check.  Logged: the codes of
    the four products moved card vs CPU (share and largest step) and each
    plant's readings."""
    cfg, blk = model.vit, qnet.blocks[0]
    with torch.inference_mode():
        x = qnet.embed(preprocess(model, frame)[None])
        ref = _int8_block_run(copy.deepcopy(blk).cpu(), x.cpu(), cfg, True)
        ker = _int8_block_run(blk, x, cfg, True)
        plain = _int8_block_run(blk, x, cfg, False)
        plants = {k: _int8_block_run(blk, x, cfg, True, fn) for k, (fn, _) in INT8_PLANTS.items()}
    scale, ascale = ref["out"].abs().max(), plain["attn"].abs().max()

    def steps(a, b, name):
        return (a[name].int() - b[name].int()).abs().max().item()

    def readings(run) -> dict:
        return {"rel_err": ((run["out"] - ref["out"]).abs().max() / scale).item(),
                "attn_rel_err": ((run["attn"] - plain["attn"]).abs().max() / ascale).item(),
                "qkv_code_steps_vs_plain": steps(run, plain, "qkv")}

    out = {**readings(ker), "shape": list(ker["out"].shape),
           "mean_rel_err": ((ker["out"] - ref["out"]).abs().mean() / scale).item(),
           "plain_on_card_rel_err": ((plain["out"] - ref["out"]).abs().max() / scale).item(),
           "code_steps_vs_cpu": {k: steps(ker, ref, k) for k in STATIC_PRODUCTS},
           "codes_moved_vs_cpu": {k: (ker[k] != ref[k]).float().mean().item()
                                  for k in STATIC_PRODUCTS}}
    if not (out["rel_err"] <= tol and out["code_steps_vs_cpu"]["qkv"] <= 1
            and out["qkv_code_steps_vs_plain"] == 0 and out["attn_rel_err"] <= INT8_ATTN_OUT_TOL):
        raise AssertionError(f"int8 block ({cfg.quant_attn}) (tol {tol}, attention output "
                             f"{INT8_ATTN_OUT_TOL}): {json.dumps(out)}")
    out["plants"] = {}
    for name, (_, check) in INT8_PLANTS.items():
        r = readings(plants[name])
        r["rejected"] = r["rel_err"] > tol if check == "cpu" else r["attn_rel_err"] > INT8_ATTN_OUT_TOL
        out["plants"][name] = r
        if not r["rejected"]:
            raise AssertionError(f"int8 block ({cfg.quant_attn}): the planted fault '{name}' "
                                 f"passed its check ({check}): {json.dumps(r)}")
    return out


def twist_gaps(summaries: dict, against=("none", "nomax3")) -> dict:
    """The largest twist difference of each variant's steps from those of
    ``against``'s variants (their kernel runs)."""
    tw = {k: np.array(v["body_twists"]) for k, v in summaries.items()}
    return {f"{a}-{b}": float(np.abs(tw[a] - tw[b]).max())
            for a in tw for b in against if b in tw and a != b}


def run_prob_variants(fnet, cfg: VSConfig, device) -> dict:
    """3j(b) at ViT-B/14 @ 518 (seeded): the int8 serving step in each of
    PROB_VARIANTS (static scales on the goal and 7 shifted frames), through
    the kernels and plain as phase 3b, the launches held (exact attention
    for 'none', no hand kernel for the others); 'pv' and 'qk+pv' block 0
    held card against CPU.  Returns {variant: (summary, ViT, model)}."""
    out = {}
    for variant, (_, _, kernel) in PROB_VARIANTS.items():
        ssum, qnet, smodel = run_serving_path(fnet, cfg, variant, device)
        want = {name: 0 for name in _counters()}
        if kernel is not None:
            want[kernel] = (cfg.layer + 1) * (1 + N_STEPS)
        if ssum["launches"] != want:
            raise AssertionError(f"int8 {variant}: launch counts {ssum['launches']} != {want}")
        if variant in ("pv", "qk+pv"):
            goal, _, _ = make_frames(cfg)
            ssum["block_card_vs_cpu"] = check_int8_block(qnet, smodel, goal)
        out[variant] = (ssum, qnet, smodel)
    return out


def score_fidelity(net32, device, scene: Scene, views: int = FID_VIEWS) -> dict:
    """3j(d): the campaign's zero-shot diagnostic on the softmax-trained
    weights ``net32`` (f32, served in bf16 with kernels): for each of the
    first ``views`` start views of the seed-41 stream, one servo_step from
    rest with each score and with softmax on the same pair scores; the
    patch-grid IoU of their valid pairs (pixels rounded to 14 px) and
    |v - v_softmax| / |v_softmax|, averaged over the views."""
    positions, quats, _ = generate_episode_starts(trained_config())
    models = {s: ServoModel.create(score_config(s), device=device) for s in ("softmax", *SCORES)}
    nets = {s: m.load_vit(net32.state_dict()) for s, m in models.items()}
    base = models["softmax"]
    goal_rgb = observe(scene, base.camera, *goal_pose(device))[0]
    goals = {s: goal_descriptors(nets[s], m, goal_rgb) for s, m in models.items()}
    t = base.grid()[0] * base.grid()[1]

    def pairs(r):
        return {(tuple(torch.round(u / 14.0).long().tolist()),
                 tuple(torch.round(g / 14.0).long().tolist()))
                for u, g, v in zip(r.s_uv.cpu(), r.s_uv_star.cpu(), r.valid.cpu()) if v}

    sums = {s: {"patch_iou": 0.0, "vel_rel": 0.0} for s in SCORES}
    for i in range(views):
        p = torch.tensor(positions[i], dtype=torch.float32, device=device)
        q = torch.tensor(quats[i], dtype=torch.float32, device=device)
        rgb, depth = observe(scene, base.camera, p, q)
        scores = torch.rand(t, generator=torch.Generator().manual_seed(1000 + i)).to(device)
        res = {s: servo_step(nets[s], m, goals[s], rgb, depth, EmaState.init(device=device),
                             torch.zeros(6, device=device), scores=scores)
               for s, m in models.items()}
        pb, vb = pairs(res["softmax"]), res["softmax"].v_c
        for s in SCORES:
            pa = pairs(res[s])
            sums[s]["patch_iou"] += len(pb & pa) / max(len(pb | pa), 1) / views
            vel = (res[s].v_c - vb).norm() / vb.norm().clamp(min=1e-9)
            sums[s]["vel_rel"] += vel.item() / views
    return {s: {**v, "jax_cpu": dict(zip(("patch_iou", "vel_rel"), JAX_FIDELITY[s]))}
            for s, v in sums.items()}


def int8_product_times(device, shape=SERVE_ATTN_SHAPE, seed: int = 32) -> dict:
    """Phase 4: int8_bmm's two products at ``shape`` (ms by CUDA events),
    beside the bound of the same work at the int8 tensor-core peak."""
    B, T, H, hd = shape
    out = {}
    for name, (a, b) in int8_operands(shape, seed, device).items():
        ops = 2.0 * a.numel() * b.shape[-1]
        nbytes = a.numel() + b.numel() + 4.0 * a.numel() // a.shape[-1] * b.shape[-1]
        bound, by = _bound(ops / PEAK_INT8_OPS, nbytes / PEAK_BYTES)
        out[name] = {"ms": cuda_ms(lambda: int8_bmm(a, b), iters=50), "bound_ms": bound,
                     "bound_by": by}
    return out


def score_train_step(net32, device, scene: Scene, score: str = "relu", steps: int = 10,
                     chain: int = 5) -> dict:
    """Phase 4: ``steps`` train steps (batch 8, bf16 over f32 weights) at
    518 with the ``score`` attention from ``net32``'s weights: ms a step and
    the peak memory allocated."""
    model = ServoModel.create(VSConfig(dino_input_size=518, attn_score=score),
                              compute_dtype=torch.bfloat16, device=device)
    net = ViT.from_state_dict(model.vit, net32.state_dict())
    state = init_train_state(net.to(device), train_schedule(steps=TRAIN_RESUME_SCHEDULE))
    _, losses, ms, peak = run_train_steps(state, model, scene, steps,
                                          torch.Generator().manual_seed(TRAIN_SEED + 1),
                                          TRAIN_BATCH, chain)
    return {"ms_per_step": ms, "peak_bytes": peak, "losses": losses}


def run_cotrain(score: str, here: Path, device, budget_s: float | None) -> dict:
    """--cotrain: the campaign's co-train (train_servo --resume ckpt_real518
    --size 518 --steps 2000 --attn-score ``score``, the real poster) within
    COTRAIN_TRAIN_SHARE of ``budget_s``, the matching quality of the
    co-trained weights (with kernels and plain), then episodes 0 to 63 of
    the 500-episode stream at chunk 8 with them in the rest of the budget,
    held to COTRAIN_MIN_CONVERGED.  Writes chiprun_out/<the trainer's
    name>.json and the replay's JSON."""
    budget = COTRAIN_BUDGET_S if budget_s is None else budget_s
    t0 = time.perf_counter()
    train = run_train_command(COTRAIN_STEPS, 518, TRAINED_S518, budget * COTRAIN_TRAIN_SHARE,
                              here, device, poster="real", attn_score=score)
    out = {"score": score, "train": train, "bound": COTRAIN_MIN_CONVERGED,
           "episodes": list(COTRAIN_EPISODES)}
    if not train["finished"]:
        out["bound_met"] = False
        out["why"] = f"training stopped by its budget at step {train['done']}"
        return out
    weights = here / ".train" / f"{train['name']}.npz"
    qmodel = ServoModel.create(VSConfig(dino_input_size=518, attn_score=score), device=device)
    out["quality"] = quality_both(load_trained(qmodel, weights)[0], qmodel,
                                  load_poster_scene(device=device))
    out["softmax_patch_acc"] = SOFTMAX_PATCH_ACC
    lo, hi = COTRAIN_EPISODES
    name = replay_name(lo, hi, attn_score=score)
    ckpt = here / ".replay" / f"{name}.ckpt"
    rep = run_replay(lo, hi, ckpt, budget - (time.perf_counter() - t0), ckpt.parent, device,
                     chunk=CHUNK, path=weights, attn_score=score)
    out_dir = here / "chiprun_out"
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / f"{name}.json").write_text(json.dumps(rep))
    out["replay"] = {k: v for k, v in rep.items() if not isinstance(v, list)
                     or k == "not_converged"}
    out["converged"] = rep["converged"]
    out["bound_met"] = rep["finished"] and rep["converged"] >= COTRAIN_MIN_CONVERGED
    out["wall_s"] = time.perf_counter() - t0
    return out


# ---------------------------------------------------------------------------
# phase 3k: DINOv2 ViT-g/14 at full width, the 'attn' facet, factorized binning
# ---------------------------------------------------------------------------


def vitg_config() -> VSConfig:
    """phase 3e's settings (configs/real_s518.yaml's, the 500-episode
    stream) with DINOv2-giant's preset: 1536 wide, 40 blocks of 24 heads,
    the SwiGLU FFN; the step runs blocks 0 to 11."""
    return dataclasses.replace(trained_config(), model_name=VITG_MODEL)


def seeded_vitg(cfg: VSConfig, device, seed: int = 0) -> tuple[ViT, float]:
    """ViT-g's seeded f32 weights drawn on the card from a generator of the
    card (init_vit's distribution; LayerScale 1.0, so that every block's
    attention and FFN move the descriptors), and the seconds the draw
    took."""
    vit = ServoModel.create(cfg, device=device).vit
    sync(device)
    t0 = time.perf_counter()
    net = init_vit(vit, torch.Generator(device).manual_seed(seed), device=device,
                   layerscale=1.0).eval()
    sync(device)
    return net, time.perf_counter() - t0


def chunk_views(model: ServoModel, scene: Scene, steps: int = N_STEPS, chunk: int = CHUNK):
    """The goal view and ``steps`` chunk-steps of ``chunk`` views each:
    episode j's camera at VITG_CHUNK_OFFSETS[j] from the goal pose, moving
    toward it by a tenth of that a step.  Returns (goal rgb, [(B, H, W, 3)],
    [(B, H, W)])."""
    goal, _, _ = render_views(model, scene, [])
    frames, depths = [], []
    for s in range(steps):
        _, rgbs, ds = render_views(model, scene, [tuple((1.0 - 0.1 * s) * np.asarray(o))
                                                  for o in VITG_CHUNK_OFFSETS[:chunk]])
        frames.append(torch.stack(rgbs))
        depths.append(torch.stack(ds))
    return goal, frames, depths


def chunk_scores(model: ServoModel, steps: int, chunk: int, seed: int = 0) -> list:
    """(chunk, t) pair scores of each chunk-step, from a seeded generator."""
    t = model.grid()[0] * model.grid()[1]
    gen = torch.Generator().manual_seed(seed + 1)
    return [torch.rand((chunk, t), generator=gen) for _ in range(steps)]


def run_vit_forward(net, model: ServoModel, frame, tol: float = DESC_REL_TOL) -> dict:
    """3k(b): vit_forward (every block and the final LayerNorm) of one view
    through the kernels and plain: max |diff| / max |ref| within ``tol``,
    every token's cosine at least DESC_COS_MIN; the launches and the peak
    memory of the kernel run."""
    with torch.inference_mode():
        x = preprocess(model, frame)[None]
        for fn in _counters().values():
            fn.launches = 0
        if model.device != "cpu":
            torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated() if model.device != "cpu" else 0
        out = vit_forward(net, x, use_kernels=True)
        sync(model.device)
        launches = {k: fn.launches for k, fn in _counters().items()}
        peak = torch.cuda.max_memory_allocated() - base if model.device != "cpu" else 0
        ref = vit_forward(net, x, use_kernels=False).float()
    out = out.float()
    rel = ((out - ref).abs().max() / ref.abs().max()).item()
    cos = torch.nn.functional.cosine_similarity(out[0], ref[0], dim=-1).min().item()
    if not (rel <= tol and cos >= DESC_COS_MIN and bool(torch.isfinite(out).all())):
        raise AssertionError(f"vit_forward kernels vs plain: max |diff| / max |ref| {rel} "
                             f"(tol {tol}), least token cosine {cos} (min {DESC_COS_MIN})")
    return {"shape": list(out.shape), "rel_err": rel, "token_cos_min": cos,
            "launches": launches, "peak_bytes_over_weights": peak}


def check_attn_facet(net, model: ServoModel, frame, tol=ATTN_FACET_TOL) -> dict:
    """3k(e): the 'attn' facet of block ``cfg.layer`` (blocks before it
    through the kernels on the card, plain on the CPU), on the card against
    the port on the card machine's CPU on the same image: probabilities
    within ``tol[0]``, every row summing to 1 within ``tol[1]``; for a float
    ViT also the default saliency map within ``tol[2]``."""
    quantized = isinstance(net, QuantViT)
    facet = vit_features_quant if quantized else vit_features
    layer = model.cfg.layer
    cpu_net = copy.deepcopy(net).cpu()          # the card's weights, bit for bit
    with torch.inference_mode():
        x = preprocess(model, frame)[None]
        probs = facet(net, x, layer, "attn", True).cpu()
        t0 = time.perf_counter()
        ref = facet(cpu_net, x.cpu(), layer, "attn", True)
        cpu_s = time.perf_counter() - t0
        sal = sal_ref = None
        if not quantized:
            sal = extract_saliency_maps(net, x, layer).cpu()
            sal_ref = saliency_from_attention(ref)        # the CPU's, from its facet
    out = {"shape": list(probs.shape), "max_abs_err": (probs - ref).abs().max().item(),
           "row_sum_err": (probs.sum(-1) - 1.0).abs().max().item(),
           "row_sum_err_cpu": (ref.sum(-1) - 1.0).abs().max().item(),
           "max_prob": probs.max().item(), "cpu_s": cpu_s}
    ok = out["max_abs_err"] <= tol[0] and max(out["row_sum_err"], out["row_sum_err_cpu"]) <= tol[1]
    if sal is not None:
        out["saliency_max_abs_err"] = (sal - sal_ref).abs().max().item()
        out["saliency_range"] = [sal.min().item(), sal.max().item()]
        ok = ok and out["saliency_max_abs_err"] <= tol[2] and out["saliency_range"] == [0.0, 1.0]
    if not ok:
        raise AssertionError(f"'attn' facet card vs CPU (tol {tol}): {json.dumps(out)}")
    return out


def run_fast_binned(net, model: ServoModel, views, scores, twists: bool = True) -> dict:
    """3k(d): the step on ``views`` (goal, frames or chunks, depths) with
    materialized bins, then with fast_binned_match on the same frames and
    scores, teacher-forced (the materialized run's EMA and command): pairs
    that differ a step, twists within TWIST_TOL where an episode's pairs
    agree, and with ``twists`` at least one such step (else the leg only
    holds the similarities); the launch counters of the factorized run (no
    matcher).  Then the two similarities on the first step's descriptors:
    within FAST_SIM_TOL of the materialized path's, and for a float model
    within FAST_SIM_F32_TOL of log_bin's rows' cosine in f32 with at least
    FAST_ARGMAX_F32_MIN of the rows' argmaxes equal."""
    fast = dataclasses.replace(model, fast_binned_match=True)
    goal, frames, depths = views
    _, mat = drive(net, model, goal, frames, depths, scores)
    for fn in _counters().values():
        fn.launches = 0
    states = [(EmaState.init(device=model.device, batch=mat[0].v_c.shape[:-1]),
               torch.zeros_like(mat[0].v_c))] + [(r.ema, r.v_c) for r in mat[:-1]]
    fgoal, fst = drive(net, fast, goal, frames, depths, scores, states)
    launches = {k: fn.launches for k, fn in _counters().items()}
    check_outputs(fast, fgoal, fst)
    out = compare_steps(mat, fst, True, TWIST_TOL)
    if twists and not out["steps_compared"]:
        raise AssertionError(f"factorized vs materialized: no step's pairs agree, so no twist "
                             f"was held (pairs differing a step: {out['differing_pairs']})")
    out["launches"] = launches
    out["pairs"] = sum(int(r.valid.numel()) for r in fst)
    if launches["matcher"] or launches["matcher_bf16"]:
        raise AssertionError(f"the factorized path launched a matcher kernel: {launches}")
    # the two similarities on the first step's unbinned descriptors
    first = frames[0] if torch.as_tensor(frames[0]).dim() == 4 else frames[0][None]
    fd = batch_descriptors(net, fast, first)                         # (A, t, D)
    with torch.inference_mode():
        sim_fast = binned_cosine_similarity(fgoal, fd, fast.grid(), int8=fast.quantized)
        sim_mat = materialized_similarity(fast, fgoal, fd)
        sim_f32 = None if fast.quantized else materialized_similarity(fast, fgoal, fd, f32=True)
    kind = "int8" if fast.quantized else "float"
    out["sim_max_abs_diff"] = (sim_fast - sim_mat).abs().max().item()
    out["row_argmax_agree"] = (sim_fast.argmax(-1) == sim_mat.argmax(-1)).float().mean().item()
    ok = out["sim_max_abs_diff"] <= FAST_SIM_TOL[kind]
    if sim_f32 is not None:
        out["sim_f32_max_abs_diff"] = (sim_fast - sim_f32).abs().max().item()
        out["row_argmax_agree_f32"] = (sim_fast.argmax(-1) ==
                                       sim_f32.argmax(-1)).float().mean().item()
        ok = ok and (out["sim_f32_max_abs_diff"] <= FAST_SIM_F32_TOL
                     and out["row_argmax_agree_f32"] >= FAST_ARGMAX_F32_MIN)
    if not ok:
        raise AssertionError(f"factorized vs materialized {kind} similarity (tol "
                             f"{FAST_SIM_TOL[kind]}; f32 {FAST_SIM_F32_TOL}, argmaxes "
                             f"{FAST_ARGMAX_F32_MIN}): {json.dumps(out)}")
    return out


def materialized_similarity(model: ServoModel, goal, frames, f32: bool = False) -> torch.Tensor:
    """The materialized binned path's similarity of unbinned goal (t, D)
    and frame (A, t, D) descriptors -> (A, t, t): log_bin and the bf16 mode's
    cosine, or, on the int8 path, the source-quantized bins' int8 cosine;
    ``f32``: log_bin of the descriptors upcast to f32 and the f32 cosine
    (the same similarity as the factorized one up to f32 association)."""
    grid = model.grid()
    if model.quantized:
        gq, fq = quantize_binned_int8(goal, grid), quantize_binned_int8(frames, grid)
        return torch.stack([cosine_similarity_matrix(gq, item(fq, i)) for i in range(len(frames))])
    if f32:
        goal, frames = goal.float(), frames.float()
    g9, f9 = log_bin(goal[None], grid)[0], log_bin(frames, grid)
    return torch.stack([cosine_similarity_matrix(g9, f9[i]) for i in range(len(frames))])


def run_vitg_phase(device, scene: Scene, tnet, tnet32, tmodel: ServoModel) -> dict:
    """Phase 3k, every part held (a failed check raises): (a) ViT-g/14 @
    518 bf16 (seeded on the card, built through build_model): goal + 5
    steps and a chunk of 8 for 5 chunk-steps through the kernels and
    plain, teacher-forced, the launches held; (b) vit_forward of all 40
    blocks, kernels vs plain; (c) the int8 ViT-g ('fused', kernel 4, and
    'none', kernel 1; static scales), block 0 card vs CPU and its step
    kernels vs plain; (d) fast_binned_match against the materialized path
    on the trained ViT-S/14 and ViT-g, float and int8, one frame and a
    chunk of 8, no matcher launched; (e) the 'attn' facet (and the
    saliency of the float ViTs) card vs CPU, at block ``cfg.layer``.
    Returns the launches at ViT-g's shapes and the nets phase 4 times."""
    gcfg = vitg_config()
    gnet32, draw_s = seeded_vitg(gcfg, device)
    gnet, gmodel = build_model(gcfg, net=copy.deepcopy(gnet32).cast_blocks(torch.bfloat16),
                               device=device)
    n_params = sum(p.numel() for p in gnet32.parameters())
    log(f"(a) ViT-g/14 @ 518 ({gcfg.model_name}: {n_params} parameters, hidden "
        f"{gmodel.vit.hidden_dim}, SwiGLU), seeded on the card in {draw_s:.2f} s, "
        f"bf16 blocks")
    out = {"launches": {"attention": 0, "matcher_bf16": 0, "attn_int8": 0}, "gnet": gnet,
           "gmodel": gmodel}
    want = {name: 0 for name in _counters()}
    want.update(attention=(gcfg.layer + 1) * (1 + N_STEPS), matcher_bf16=N_STEPS)
    torch.cuda.reset_peak_memory_stats()
    gsum = run_trained_step(gnet, gcfg, gmodel, scene)
    gsum.pop("steps")
    log(f"(a) ViT-g step, goal + {N_STEPS} steps, kernels vs plain (teacher-forced): "
        f"{json.dumps(gsum)}; peak {torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB")
    if gsum["launches"] != want:
        raise AssertionError(f"ViT-g step: launch counts {gsum['launches']} != {want}")
    views = chunk_views(gmodel, scene)
    torch.cuda.reset_peak_memory_stats()
    csum = run_main_path(gnet, gcfg, gmodel, frames=views, every_step=True,
                         scores=chunk_scores(gmodel, N_STEPS, CHUNK))
    log(f"(a) ViT-g chunk of {CHUNK}, goal + {N_STEPS} chunk-steps, kernels vs plain "
        f"(teacher-forced): {json.dumps({k: v for k, v in csum.items() if k != 'body_twists'})}; "
        f"peak {torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB")
    if csum["launches"] != want:
        raise AssertionError(f"ViT-g chunk: launch counts {csum['launches']} != {want}")
    for k in ("attention", "matcher_bf16"):
        out["launches"][k] += gsum["launches"][k] + csum["launches"][k]

    goal, rgbs, depths = render_views(gmodel, scene, TRAINED_STEP_OFFSETS)
    fwd = run_vit_forward(gnet, gmodel, goal)
    log(f"(b) vit_forward of ViT-g, {gcfg.model_name} all {gmodel.vit.depth} blocks and the "
        f"final norm at 518, kernels vs plain (tol {DESC_REL_TOL}): {json.dumps(fwd)}")
    if fwd["launches"]["attention"] != gmodel.vit.depth or sum(fwd["launches"].values()) != \
            gmodel.vit.depth:
        raise AssertionError(f"vit_forward: launch counts {fwd['launches']}")
    out["launches"]["attention"] += fwd["launches"]["attention"]

    _, calib, _ = render_views(gmodel, scene, TRAINED_CALIB_OFFSETS)
    qnets = {}
    for variant in VITG_INT8_VARIANTS:
        # the descriptors are logged: static int8 activations amplify the
        # kernels' bf16 ulps through 12 blocks (block 0 is held card vs CPU)
        ssum, qnet, smodel = run_serving_path(gnet32, gcfg, variant, device,
                                              frames=(goal, rgbs, calib, depths),
                                              tol=(math.inf, -math.inf, TWIST_TOL))
        kernel = {**VARIANTS, **PROB_VARIANTS}[variant][2]
        want = {name: 0 for name in _counters()}
        want[kernel] = (gcfg.layer + 1) * (1 + N_STEPS)
        if ssum["launches"] != want:
            raise AssertionError(f"ViT-g int8 {variant}: launch counts {ssum['launches']} != {want}")
        blk = check_int8_parts(qnet, smodel, goal)
        log(f"(c) ViT-g int8 {variant} ({smodel.vit.quant_attn}), static scales: "
            f"{json.dumps(ssum)}; block 0 card vs CPU and kernels vs plain, with planted "
            f"faults {json.dumps(blk)} (tol {VITG_INT8_BLOCK_TOL}, attention output "
            f"{INT8_ATTN_OUT_TOL})")
        out["launches"][kernel] += want[kernel]
        qnets[variant] = (qnet, smodel)

    _, tcalib, _ = render_views(tmodel, scene, TRAINED_CALIB_OFFSETS)
    tgoal, _, _ = render_views(tmodel, scene, [])
    tq_model = serving_model(tmodel.cfg, "none", device)
    tq = quantized_vit(tnet32, tq_model, [tgoal, *tcalib])
    cases = [("ViT-S/14 float", tnet, tmodel), ("ViT-S/14 int8", tq, tq_model),
             ("ViT-g/14 float", gnet, gmodel), ("ViT-g/14 int8", *qnets["none"])]
    for name, net, model in cases:
        single = render_views(model, scene, TRAINED_STEP_OFFSETS)
        for shape, views, scores in (
                ("one frame", single, pair_scores(model, N_STEPS)),
                (f"chunk of {CHUNK}", chunk_views(model, scene),
                 chunk_scores(model, N_STEPS, CHUNK))):
            # seeded ViT-g's float similarities are flat: the materialized path's
            # bf16-normalized rows move a pair on every step, so that leg holds
            # the similarities (f32 and bf16) and no twist
            twists = name != "ViT-g/14 float"
            r = run_fast_binned(net, model, views, scores, twists=twists)
            log(f"(d) fast_binned_match vs materialized, {name}, {shape} (teacher-forced"
                f"{'' if twists else '; similarities only'}): {json.dumps(r)}")

    for name, net, model in cases:
        f = check_attn_facet(net, model, goal if "ViT-g" in name else tgoal)
        log(f"(e) 'attn' facet{' and saliency' if 'float' in name else ''}, {name}, block "
            f"{model.cfg.layer}, card vs CPU (tol {ATTN_FACET_TOL}): {json.dumps(f)}")
    return out


# ---------------------------------------------------------------------------
# phase 3l: pixel baselines (any head width), the mesh, sensors, the live
# channel, the native bridge and stage profiling
# ---------------------------------------------------------------------------


def pixel_config(name: str = PIXEL_MODEL) -> VSConfig:
    """configs/config.yaml's settings with a pixel baseline (its one block:
    layer 0)."""
    return reference_config().replace(model_name=name, layer=0)


def pixel_loop_config() -> VSConfig:
    """tests/test_baselines.py's pixel8 episode: 128 x 128 at 112, 120 steps."""
    return VSConfig(u_max=128, v_max=128, f_x=100.5, f_y=100.5, dino_input_size=112,
                    num_pairs=16, lambda_=0.5, control_dt=0.1, ema_alpha=0.8,
                    model_name="pixel8", layer=0, pinv_mode="dls", max_iterations=120)


def check_attention_hd(device, dtype=torch.bfloat16) -> dict:
    """The any-width kernel of ``dtype`` against the plain version at each
    head width of PIXEL_HD (one head, T = 485, two launches bit for bit; B =
    2 at each T of PIXEL_T; rows whose scaled logits are about +-200).
    Returns the max abs error at each width's (1, 485, 1, d)."""
    f32 = dtype == torch.float32
    tol, large = (ATTN_F32_TOL, LARGE_LOGIT_F32_TOL) if f32 else (ATTN_TOL, ATTN_TOL)
    return {d: check_attention(device, shape=(1, 485, 1, d), ts=PIXEL_T, seed=60 + i,
                               dtype=dtype, tol=tol, large_tol=large)
            for i, d in enumerate(PIXEL_HD)}


def check_attention_hd_edges(device, long_shapes=PIXEL_HD_LONG,
                             split_shape=PIXEL_ATTN_SHAPE) -> dict:
    """The any-width kernel's edges, bf16 and f32: each shape of
    ``long_shapes`` against plain and two launches bit for bit; q, k, v
    sliced from one (3, B, T, 1, D) tensor (pixel14's qkv split: k and v
    start mid-row) against plain; and, on the card, the C side's launch
    geometry (vitvs_attention_hd_plan) equal to ops/attention.py:hd_plan at
    every width and pointer offset.  Returns the errors, the split's copy
    widths and the geometry's mismatches."""
    rs = np.random.default_rng(80)
    out = {"long": {}, "qkv_split": {}}
    for dtype in (torch.bfloat16, torch.float32):
        f32 = dtype == torch.float32
        tol = ATTN_F32_TOL if f32 else ATTN_TOL
        for shape in long_shapes:
            what = f"any-width attention ({dtype}) at {shape}"
            q, k, v = (_normal(device, shape, rs, dtype) for _ in range(3))
            got = attention.mha_attention(q, k, v)
            out["long"][f"{'f32' if f32 else 'bf16'} {shape}"] = _max_err(
                got, attention.mha_attention_plain(q, k, v), what, tol)
            if not torch.equal(got.view(torch.uint8),
                               attention.mha_attention(q, k, v).view(torch.uint8)):
                raise AssertionError(f"{what}: two launches on the same inputs differ")
        qkv = _normal(device, (3, *split_shape), rs, dtype)
        q, k, v = qkv.unbind(0)
        plan = attention.hd_plan(split_shape[-1], dtype, q.data_ptr(), k.data_ptr(), v.data_ptr())
        err = _max_err(attention.mha_attention(q, k, v), attention.mha_attention_plain(q, k, v),
                       f"any-width attention ({dtype}), the qkv split", tol)
        out["qkv_split"]["f32" if f32 else "bf16"] = {"k_offset_mod_16": k.data_ptr() % 16,
                                                      "copy": plan["copy"], "max_abs_err": err}
    if torch.device(device).type == "cuda":
        lib, got = _build.library(), (ctypes.c_int * 6)()
        keys = ("cluster", "slice", "stages", "pbufs", "copy", "smem")
        bad = []
        for d in range(1, attention.HD_MAX + 1):
            for dtype, es in ((torch.bfloat16, 2), (torch.float32, 4)):
                for off in (0, 2, 4, 8):
                    if off % es:
                        continue
                    _build.check(lib.vitvs_attention_hd_plan(d, es, off, got), "hd plan")
                    want = attention.hd_plan(d, dtype, off)
                    if list(got) != [want[x] for x in keys]:
                        bad.append((d, es, off, list(got)))
        if bad:
            raise AssertionError(f"any-width kernel: C geometry differs from hd_plan at "
                                 f"{len(bad)} points, first {bad[:3]}")
        out["plan_mismatches"] = 0
    return out


def run_pixel_loop(device) -> dict:
    """tests/test_baselines.py:38-54's episode on the card in f32 through the
    any-width f32 kernel and the f32 matcher: pixel8 from goal + (0.10,
    -0.08, 0.15), 120 steps; its error must fall below half the start's."""
    cfg = pixel_loop_config()
    model = ServoModel.create(cfg, compute_dtype=torch.float32, device=device)
    net = init_pixel_params(model.vit, device=device).eval()
    scene = Scene.create(make_synthetic_poster(256, seed=3), device=device)
    gp, gq = goal_pose(device)
    for fn in _counters().values():
        fn.launches = 0
    t0 = time.perf_counter()
    goal = goal_descriptors(net, model, observe(scene, model.camera, gp, gq)[0])
    start = gp + torch.tensor([0.10, -0.08, 0.15], device=device)
    res = rollout_episode(net, model, scene, goal, start, gq,
                          generator=torch.Generator(device).manual_seed(0),
                          num_steps=cfg.max_iterations)
    sync(device)
    wall_s = time.perf_counter() - t0
    e0 = float(torch.linalg.vector_norm(start - gp)) * 100.0
    et = float(res.error_history[-1, 0])
    launches = {k: fn.launches for k, fn in _counters().items()}
    want = {k: 0 for k in _counters()}
    want.update(attention_hd_f32=1 + cfg.max_iterations, matcher=cfg.max_iterations)
    if not et < 0.5 * e0:
        raise AssertionError(f"pixel8 loop: error {et} cm not below half the start's {e0} cm")
    return {"start_err_cm": e0, "final_err_cm": et, "converged": bool(res.converged),
            "iterations": int(res.iterations), "wall_s": wall_s, "launches": launches,
            "launches_on_the_card": want}


def run_mesh(net, cfg: VSConfig, model: ServoModel, scene: Scene, episodes=CHUNK_EPISODES,
             num_steps: int = CHUNK_STEPS, segment_steps: int = CHUNK_SEGMENT,
             min_compared: float = MESH_MIN_COMPARED) -> dict:
    """run_benchmark on ``episodes`` as one chunk with rotation search on a
    (dp, tp) = MESH_SHAPE mesh of the one card.  Every dp row's chunk-step
    is teacher-forced through the unsplit ViT's plain step on the same
    inputs (:func:`teacher_forcer`, as phase 3f): twists within TWIST_TOL
    where an episode's pairs agree, on at least ``min_compared`` of the
    episode-steps; the split's goal descriptors within DESC_REL_TOL and
    DESC_COS_MIN of the plain unsplit ones.  Then the same run without a
    mesh: twists within TWIST_TOL up to each episode's first pair flip (the
    free runs part there, so the flags and final poses are logged, not
    held).  Returns the launches beside those the split gives on the card
    (each row's forward runs its tp shards' heads, the goal on row 0, a
    matcher launch a row)."""
    dp, tp = MESH_SHAPE
    mesh = make_mesh(devices=[torch.device(model.device)] * (dp * tp), tp=tp)
    common = dict(rotation_search=True, segment_steps=segment_steps, verbose=False,
                  device=model.device, episode_indices=episodes, chunk=len(episodes),
                  num_steps=num_steps, save=False)
    forced, force, goal_plain = teacher_forcer(net, model, scene, episodes)
    seen = {"mesh": {}, "one": {}}

    def collect(name):
        def on_step(abs_ids, inputs, result):
            if name == "mesh":
                force(abs_ids, inputs, result)
            for j, ep in enumerate(abs_ids.tolist()):
                seen[name].setdefault(int(ep), []).append(item(result, j))
        return on_step

    for fn in _counters().values():
        fn.launches = 0
    sync(model.device)
    t0 = time.perf_counter()
    run = run_benchmark(cfg, net=net, model=model, scene=scene, mesh=mesh,
                        on_step=collect("mesh"), **common)
    sync(model.device)
    wall_s = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in _counters().items()}
    heads = {sh.heads for blk in run.net.blocks for sh in blk.shards}
    if heads != {model.vit.num_heads // tp}:
        raise AssertionError(f"mesh: shards hold {heads} heads")
    blocks = cfg.layer + 1
    want = {k: 0 for k in _counters()}
    want.update(attention=tp * blocks * (1 + dp + dp * run.chunk_steps),
                matcher_bf16=dp * (1 + run.chunk_steps))
    episode_steps = len(episodes) * run.chunk_steps
    if not forced["twist_max_abs_err"] <= TWIST_TOL:
        raise AssertionError(f"mesh, teacher-forced: twists differ by "
                             f"{forced['twist_max_abs_err']} > {TWIST_TOL}")
    if not forced["episode_steps_compared"] >= min_compared * episode_steps:
        raise AssertionError(f"mesh, teacher-forced: pairs agree on "
                             f"{forced['episode_steps_compared']} of {episode_steps} "
                             f"episode-steps, fewer than {min_compared:.0%}")
    goal_rgb = observe(scene, model.camera, *goal_pose(model.device))[0]
    goal_split = goal_descriptors(run.net, run.model, goal_rgb).float()
    goal_ref = goal_plain.float()
    desc_rel = ((goal_split - goal_ref).abs().max() / goal_ref.abs().max()).item()
    row_cos = torch.nn.functional.cosine_similarity(goal_split, goal_ref, dim=-1).min().item()
    if not (desc_rel <= DESC_REL_TOL and row_cos >= DESC_COS_MIN):
        raise AssertionError(f"mesh goal descriptors against the unsplit plain ones: max "
                             f"|diff| / max |ref| {desc_rel}, least row cosine {row_cos}")
    one = run_benchmark(cfg, net=net, model=model, scene=scene, on_step=collect("one"), **common)
    first_flip, twist_err, compared = [], 0.0, 0
    for ep in episodes:
        parted = None
        for step, (a, b) in enumerate(zip(seen["mesh"][ep], seen["one"][ep])):
            if not bool(same_pairs(a, b).all()):
                parted = step
                break
            twist_err = max(twist_err, (a.body_twist - b.body_twist).abs().max().item())
            compared += 1
        first_flip.append(parted)
    if not twist_err <= TWIST_TOL:
        raise AssertionError(f"mesh against one device: twists differ by {twist_err} > "
                             f"{TWIST_TOL} before the first pair flip")
    flags_equal = bool(np.array_equal(run.summaries["convergence_flags"],
                                      one.summaries["convergence_flags"]))
    return {"mesh": {"dp": dp, "tp": tp, "devices": str(model.device)},
            "episodes": [int(e) for e in episodes], "chunk_steps": run.chunk_steps,
            "wall_s": wall_s, "launches": launches, "launches_on_the_card": want,
            "shard_heads": sorted(heads),
            "teacher_forced": {**forced, "episode_steps": episode_steps,
                               "goal_desc_rel_err": desc_rel, "goal_desc_row_cos_min": row_cos},
            "free_run": {"first_flip_step": first_flip, "twist_max_abs_err": twist_err,
                         "episode_steps_compared": compared,
                         "convergence_flags_equal": flags_equal,
                         "final_position_max_abs_diff": float(np.abs(
                             np.asarray(run.summaries["final_positions"], np.float64)
                             - np.asarray(one.summaries["final_positions"], np.float64)).max())}}


def check_sensors(device) -> dict:
    """render_ir and organized_point_cloud at 640 x 480 from the goal pose,
    the card against the same functions on the card machine's CPU: IR
    levels within one 8-bit level at no more than IR_LEVEL_SHARE of the
    pixels, the cloud within 1e-6 (the same depth input) with the same NaN
    positions; the noise's spread on the card (std within IR_NOISE_BAND)
    and a generator that gates it."""
    out = {}
    views = {}
    for dev in (device, "cpu"):
        scene = load_poster_scene(device=dev)
        cam = ServoModel.create(reference_config(), device=dev).camera
        gp, gq = goal_pose(dev)
        rgb, depth = observe(scene, cam, gp, gq)
        views[dev] = (scene, cam, gp, gq, rgb, depth, render_ir(scene, cam, gp, gq))
    (scene, cam, gp, gq, rgb, depth, ir), cpu = views[device], views["cpu"]
    for name, a, b in (("ir1", ir[0], cpu[6][0]), ("ir2", ir[1], cpu[6][1])):
        diff = (a.cpu() - b).abs()
        share = float((diff > 0).float().mean())
        if not (float(diff.max()) <= 1.0 / 255.0 + 1e-6 and share <= IR_LEVEL_SHARE):
            raise AssertionError(f"{name}: card vs CPU max |diff| {float(diff.max())}, "
                                 f"share {share}")
        out[f"{name}_pixels_differing"] = int((diff > 0).sum())
    cloud = organized_point_cloud(cpu[5].to(device), cpu[4].to(device))
    ref = organized_point_cloud(cpu[5], cpu[4])
    nan_same = bool(torch.equal(torch.isnan(cloud.cpu()), torch.isnan(ref)))
    err = float(torch.nan_to_num(cloud.cpu() - ref).abs().max())
    if not (nan_same and err <= 1e-6 and tuple(cloud.shape) == (480, 640, 6)):
        raise AssertionError(f"point cloud: card vs CPU max |diff| {err}, NaN same {nan_same}")
    noisy, again, other = (render_ir(scene, cam, gp, gq,
                                     generator=torch.Generator(device).manual_seed(s))
                           for s in (5, 5, 6))
    mid = (ir[0] > 0.2) & (ir[0] < 0.8)
    std = float((noisy[0] - ir[0])[mid].std())
    if not (IR_NOISE_BAND[0] <= std <= IR_NOISE_BAND[1] and torch.equal(noisy[0], again[0])
            and not torch.equal(noisy[0], other[0])):
        raise AssertionError(f"IR noise: std {std}, or the generator does not gate it")
    out.update(cloud_max_abs_err=err, cloud_nan_points=int(torch.isnan(ref[..., 0]).sum()),
               ir_noise_std=std, ir_shape=list(ir[0].shape))
    return out


def run_live(net, cfg: VSConfig, model: ServoModel, scene: Scene, out_dir: Path,
             episodes=(0, 1), num_steps: int = LIVE_STEPS, segment_steps: int = LIVE_SEGMENT
             ) -> dict:
    """run_benchmark with the live channel on ``episodes`` (one chunk, no
    rotation search) for ``num_steps`` in segments of ``segment_steps``:
    one snapshot a segment, ``latest.png`` linking the last, and the flags
    and final poses equal to a run without it."""
    common = dict(rotation_search=False, segment_steps=segment_steps, verbose=False,
                  device=model.device, episode_indices=list(episodes), chunk=len(episodes),
                  num_steps=num_steps, save=False)
    live = out_dir / "live"
    with_live = run_benchmark(cfg, net=net, model=model, scene=scene, live_dir=str(live),
                              **common)
    plain = run_benchmark(cfg, net=net, model=model, scene=scene, **common)
    files = sorted(p.name for p in live.glob("ep*.png"))
    want = [f"ep{episodes[0]:04d}_step{t:05d}.png"
            for t in range(segment_steps, num_steps + 1, segment_steps)]
    if files != want or os.readlink(live / "latest.png") != want[-1]:
        raise AssertionError(f"live channel: files {files}, latest "
                             f"{os.readlink(live / 'latest.png')}; want {want}")
    for k in ("convergence_flags", "final_positions", "final_quaternions"):
        if not np.array_equal(np.asarray(with_live.summaries[k], np.float64),
                              np.asarray(plain.summaries[k], np.float64)):
            raise AssertionError(f"live channel: {k} differs from the run without it")
    return {"files": files, "latest": os.readlink(live / "latest.png"),
            "bytes": [(live / f).stat().st_size for f in files]}


class _Twists:
    """A TwistSink that keeps what it is sent."""

    def __init__(self):
        self.sent = []

    def send_twist(self, twist) -> None:
        self.sent.append(np.asarray(twist))


def run_native(net, model: ServoModel, scene: Scene, steps: int = N_STEPS) -> dict:
    """The native sensor bridge built from native/sensor_bridge.cpp into the
    build directory: a 640 x 480 four-sensor frame round-trips its seqlock'd
    buffer, then ServoLoop reads its frames from it for ``steps`` steps on
    the card (views near the goal published before each), the viz hook
    taking every frame."""
    if not native.native_available():
        raise AssertionError("the native sensor bridge did not build")
    cam = model.camera
    fb = native.NativeFrameBuffer(cam.width, cam.height, with_ir=True)
    to_u8 = lambda x: (x.clamp(0, 1) * 255).round().to(torch.uint8).cpu().numpy()  # noqa: E731
    gp, gq = goal_pose(model.device)
    rgb, depth = observe(scene, cam, gp, gq)
    ir = render_ir(scene, cam, gp, gq)
    frame = (to_u8(rgb), depth.cpu().numpy(), to_u8(ir[0]), to_u8(ir[1]))
    fb.publish(*frame)
    stamp, r, d, i1, i2 = fb.latest_ir()
    mm = native.depth_m_to_u16mm(frame[1])
    if not (stamp == 1 and np.array_equal(r, frame[0]) and np.array_equal(i1, frame[2])
            and np.array_equal(i2, frame[3]) and np.array_equal(d, native.depth_u16mm_to_m(mm))):
        raise AssertionError("native frame buffer: the frame did not round-trip")
    sink, shown = _Twists(), []
    loop = ServoLoop(net, model, frame[0], fb, sink, viz_every=1, viz_sink=shown.append)
    _, rgbs, depths = render_views(model, scene, TRAINED_STEP_OFFSETS[:steps])
    for rgb_i, depth_i in zip(rgbs, depths):
        fb.publish(to_u8(rgb_i), depth_i.cpu().numpy())
        loop.iterate()
    fb.close()
    twists = np.stack(sink.sent)
    if twists.shape != (steps, 6) or not np.isfinite(twists).all() or len(shown) != steps:
        raise AssertionError(f"ServoLoop over the native buffer: twists {twists.shape}, "
                             f"{len(shown)} viz frames")
    return {"library": str(native.build_library().name), "round_trip": True,
            "steps": steps, "twist_max_abs": float(np.abs(twists).max()),
            "viz_frames": len(shown)}


def run_stages(net, model: ServoModel, scene: Scene, trace_dir: Path, iters: int = 10) -> dict:
    """StageTimer over a servo step's stages (render, preprocess, the ViT
    and binning, the match, the rest of the step) against the whole step,
    then trace_to around one step whose stages are annotated: the trace
    file must hold the annotated ranges and, on the card, its kernels."""
    gp, gq = goal_pose(model.device)
    goal = goal_descriptors(net, model, observe(scene, model.camera, gp, gq)[0])
    start = gp + torch.tensor(TRAINED_STEP_OFFSETS[0], device=model.device)
    ema, prev = EmaState.init(device=model.device), torch.zeros(6, device=model.device)
    t = model.grid()[0] * model.grid()[1]
    scores = torch.rand(t, generator=torch.Generator(model.device).manual_seed(3),
                        device=model.device)
    timer = StageTimer()

    @torch.inference_mode()
    def staged():
        with timer.stage("render") as h:
            rgb, depth = h["result"] = observe(scene, model.camera, start, gq)
        with timer.stage("preprocess") as h:
            x = h["result"] = preprocess(model, rgb)
        with annotate("vit+bin"), timer.stage("vit+bin") as h:
            desc = h["result"] = extract_descriptors(
                net, x[None], layer=model.cfg.layer, facet=model.cfg.facet, bin=True,
                use_kernels=True)[:, 0]
        with timer.stage("match") as h:
            h["result"] = match_frames(model, goal, desc, model.cfg.num_pairs, scores[None])[0].sim
        with annotate("servo_step"), timer.stage("servo_step (whole)") as h:
            h["result"] = servo_step(net, model, goal, rgb, depth, ema, prev,
                                     scores=scores).body_twist

    for _ in range(3):
        staged()
    timer = StageTimer()
    for _ in range(iters):
        staged()
    summary, report = timer.summary(), timer.report().splitlines()
    with trace_to(str(trace_dir)):
        staged()
    events = json.loads((trace_dir / TRACE_FILE).read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    kernels = sum(1 for e in events if e.get("cat") == "kernel")
    on_card = torch.device(model.device).type == "cuda"
    if not ({"vit+bin", "servo_step"} <= names and (kernels > 0 or not on_card)):
        raise AssertionError(f"trace: annotated ranges {({'vit+bin', 'servo_step'} & names)}, "
                             f"{kernels} device kernels")
    return {"stages_mean_ms": {k: v["mean_ms"] for k, v in summary.items()},
            "iters": iters, "report": report,
            "trace_events": len(events), "trace_kernels": kernels}


def time_pixel_kernels(device) -> dict:
    """The any-width kernel at pixel14's (1, 485, 1, 588) bf16 and pixel8's
    (1, 197, 1, 192) f32, and bf16 at pixel14 @ 518's (1, 1370, 1, 588):
    its launch, the plain version and SDPA at the shape (whatever backend it
    picks), with the bound."""
    rs = np.random.default_rng(9)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    out = {}
    for name, shape, dtype in (("attention_hd", PIXEL_ATTN_SHAPE, torch.bfloat16),
                               ("attention_hd_f32", PIXEL_F32_ATTN_SHAPE, torch.float32),
                               ("attention_hd_1370", PIXEL_HD_LONG[0], torch.bfloat16)):
        q, k, v = (_normal(device, shape, rs, dtype) for _ in range(3))
        qh, kh, vh = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        entry = attention.HD_ENTRIES[dtype]
        f32 = dtype == torch.float32
        # f32-accurate work is least on the TF32 tensor cores (TF32_PASSES
        # passes), as row 1b's bound; the FMA bound is logged beside it
        bound = attention_bound_ms(shape, f32=f32, tensor_cores=f32)
        out[name] = {"shape": list(shape),
                     "ms": cuda_ms(lambda: attention._launch(entry, q, k, v, shape[-1],
                                                             shape[-1] ** -0.5)),
                     "plain_ms": cuda_ms(lambda: attention.mha_attention_plain(q, k, v)),
                     "library_ms": cuda_ms(lambda: sdpa(qh, kh, vh)),
                     "bound_ms": bound[0], "bound_by": bound[1]}
        if f32:
            out[name]["fma_bound_ms"] = attention_bound_ms(shape, f32=True)[0]
    return out


def run_pixel_phase(device, scene: Scene, tnet, tcfg: VSConfig, tmodel: ServoModel,
                    out_dir: Path) -> dict:
    """Phase 3l, every part held (a failed check raises): (a) the any-width
    kernel against plain, bf16 and f32; (b) pixel14 @ 308 bf16, goal + 5
    steps through the kernels and plain (teacher-forced), its launches and
    step ms; (c) the pixel8 episode in f32; (d) the mesh; (e) the sensors;
    (f) the live channel; (g) the native bridge; (h) stage profiling.
    Returns what the kernels line and phase 4 need."""
    t0 = time.perf_counter()
    errs = {"attention_hd": check_attention_hd(device),
            "attention_hd_f32": check_attention_hd(device, torch.float32)}
    # the f32 kernel at the shape the pixel8 episode gives it (B = 2 there too)
    pixel8_err = check_attention(device, shape=PIXEL_F32_ATTN_SHAPE,
                                 ts=(PIXEL_F32_ATTN_SHAPE[1],), seed=70, dtype=torch.float32,
                                 tol=ATTN_F32_TOL, large_tol=LARGE_LOGIT_F32_TOL)
    edges = check_attention_hd_edges(device)
    log(f"3l(a) any-width attention vs plain at (1, 485, 1, d) for d in {PIXEL_HD}, B = 2 at "
        f"T = {PIXEL_T}, logits of about +-{LARGE_LOGIT}, two launches bit for bit: max abs "
        f"err bf16 {json.dumps(errs['attention_hd'])} (tol {ATTN_TOL}), f32 "
        f"{json.dumps(errs['attention_hd_f32'])} (tol {ATTN_F32_TOL}); f32 at pixel8's "
        f"{PIXEL_F32_ATTN_SHAPE} {pixel8_err}; long T, the qkv split and the C geometry: "
        f"{json.dumps(edges)}")
    pcfg = pixel_config()
    pnet, pmodel = build_model(pcfg, device=device)
    summ = run_main_path(pnet, pcfg, pmodel, every_step=True)
    want = {name: 0 for name in _counters()}
    want.update(attention_hd=1 + N_STEPS, matcher_bf16=N_STEPS)
    if summ["launches"] != want:
        raise AssertionError(f"pixel14 step: launch counts {summ['launches']} != {want}")
    step_ms = time_run(step_runner(pnet, pmodel))
    log(f"3l(b) pixel14 @ 308 bf16 (one head of 588, binned rows {9 * 588} deep), goal + "
        f"{N_STEPS} steps, kernels vs plain, teacher-forced: {json.dumps(summ)}")
    loop = run_pixel_loop(device)
    log(f"3l(c) pixel8 @ 112 f32 episode of tests/test_baselines.py (kernels 1b any-width and "
        f"2b): {json.dumps(loop)}")
    mesh = run_mesh(tnet, tcfg, tmodel, scene)
    log(f"3l(d) run_benchmark on a (dp, tp) = {MESH_SHAPE} mesh of the one card, trained "
        f"ViT-S/14 @ 518, against no mesh: {json.dumps(mesh)}")
    for what, got in (("pixel8 loop", loop), ("mesh", mesh)):
        if got["launches"] != got["launches_on_the_card"]:
            raise AssertionError(f"{what}: launch counts {got['launches']} != "
                                 f"{got['launches_on_the_card']}")
    sensors = check_sensors(device)
    log(f"3l(e) render_ir and organized_point_cloud at 640 x 480, card vs CPU: "
        f"{json.dumps(sensors)}")
    live = run_live(tnet, tcfg, tmodel, scene, out_dir)
    log(f"3l(f) live channel, episodes 0 and 1: {json.dumps(live)}")
    nat = run_native(tnet, tmodel, scene)
    log(f"3l(g) native sensor bridge: {json.dumps(nat)}")
    stages = run_stages(tnet, tmodel, scene, out_dir / "trace")
    log(f"3l(h) StageTimer and trace_to, trained ViT-S/14 @ 518: {json.dumps(stages)}")
    log(f"phase 3l took {time.perf_counter() - t0:.1f} s")
    return {"errs": {"attention_hd": errs["attention_hd"][PIXEL_ATTN_SHAPE[-1]],
                     "attention_hd_f32": pixel8_err},
            "launches": {"attention_hd": summ["launches"]["attention_hd"],
                         "attention_hd_f32": loop["launches"]["attention_hd_f32"]},
            "pixel14_step_ms": step_ms, "pixel": (pnet, pmodel)}


# ---------------------------------------------------------------------------
# phase 3m: the int8 ViT under tensor parallelism, the bf16-logits attention,
# scripts/port_measure.py
# ---------------------------------------------------------------------------


@contextmanager
def shard_attention_calls():
    """Counts the int8 shards' attention runs (QuantBlockShard.attention)
    while the block is open: a list of one int."""
    calls, orig = [0], QuantBlockShard.attention

    def counted(self, *args, **kw):
        calls[0] += 1
        return orig(self, *args, **kw)

    QuantBlockShard.attention = counted
    try:
        yield calls
    finally:
        QuantBlockShard.attention = orig


def run_int8_tp(qnet, cfg: VSConfig, qmodel: ServoModel, scene: Scene,
                episodes=CHUNK_EPISODES, num_steps: int = CHUNK_STEPS,
                segment_steps: int = CHUNK_SEGMENT, hold: bool = True) -> dict:
    """3m(a): run_benchmark on ``episodes`` as one chunk (rotation search on)
    with the int8 ``qnet`` (quantized and calibrated unsplit) split over an
    INT8_TP_MESH grid of the one card.  Every dp row's chunk-step is
    teacher-forced through the unsplit ``qnet`` on the same inputs (frames,
    EMA, commands, scores; its own goal descriptors) and held to it bit for
    bit: the same pairs and twists on every episode-step, and the split's
    goal descriptors equal to the unsplit's.  The int32 sums and maxima are
    exact, and so are a shard's K/V pooling product (``pool_kv``) and its
    'nomax3' denominators (f64 sums): ``scripts/port_int8_tp_gap.py``.  The
    hand-kernel counters are zeroed before and held to the path's (none at
    run AD's settings: 'nomax3' with pooled K/V), the shards' attention runs
    to tp x blocks x forwards (the goal on row 0, a search and the
    chunk-steps a row).  The clauses that fail are listed under "failed";
    ``hold`` raises if any does."""
    dp, tp = INT8_TP_MESH
    mesh = make_mesh(devices=[torch.device(qmodel.device)] * (dp * tp), tp=tp)
    goal_rgb = observe(scene, qmodel.camera, *goal_pose(qmodel.device))[0]
    goal_ref = goal_descriptors(qnet, qmodel, goal_rgb)
    place = {int(e): j for j, e in enumerate(episodes)}
    forced = {"flips": [0] * len(episodes), "twist_max_abs_err": 0.0,
              "episode_steps_compared": 0, "episode_steps_bit_equal": 0}

    def on_step(abs_ids, inputs, result):
        ref = servo_step(qnet, qmodel, goal_ref, inputs.rgb, inputs.depth, inputs.ema,
                         inputs.prev_v_c, scores=inputs.scores)
        diff = (~same_pairs(ref, result)).sum(-1).tolist()
        for ep, f in zip(np.asarray(abs_ids).tolist(), diff):
            forced["flips"][place[int(ep)]] += f
        forced["episode_steps_bit_equal"] += int(
            (ref.body_twist == result.body_twist).all(-1).sum())
        agree = torch.tensor([f == 0 for f in diff], device=result.body_twist.device)
        if bool(agree.any()):
            err = (ref.body_twist - result.body_twist).abs().amax(-1)[agree].max().item()
            forced["twist_max_abs_err"] = max(forced["twist_max_abs_err"], err)
            forced["episode_steps_compared"] += int(agree.sum())

    for fn in _counters().values():
        fn.launches = 0
    sync(qmodel.device)
    t0 = time.perf_counter()
    with shard_attention_calls() as calls:
        run = run_benchmark(cfg, net=qnet, model=qmodel, scene=scene, mesh=mesh,
                            on_step=on_step, rotation_search=True, segment_steps=segment_steps,
                            verbose=False, device=qmodel.device, episode_indices=episodes,
                            chunk=len(episodes), num_steps=num_steps, save=False)
    sync(qmodel.device)
    wall_s = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in _counters().items()}
    if not isinstance(run.net, TPQuantViT):
        raise AssertionError(f"int8 tp: the run served a {type(run.net).__name__}")
    blocks = cfg.layer + 1
    want_calls = tp * blocks * (1 + dp + dp * run.chunk_steps)
    episode_steps = len(episodes) * run.chunk_steps
    goal_split = goal_descriptors(run.net, run.model, goal_rgb)
    goal_equal = bool(torch.equal(goal_split.q, goal_ref.q) and torch.equal(goal_split.nq,
                                                                            goal_ref.nq))
    g_split, g_ref = _unit_rows(goal_split), _unit_rows(goal_ref)
    out = {"mesh": {"dp": dp, "tp": tp, "devices": str(qmodel.device)},
           "episodes": [int(e) for e in episodes], "chunk_steps": run.chunk_steps,
           "wall_s": wall_s, "launches": launches, "shard_attention_calls": calls[0],
           "shard_attention_calls_expected": want_calls,
           "shard_heads": sorted({sh.heads for blk in run.net.blocks for sh in blk.shards}),
           "goal_desc_bit_equal": goal_equal,
           "goal_desc_rel_err": ((g_split - g_ref).abs().max() / g_ref.abs().max()).item(),
           "goal_desc_row_cos_min": torch.nn.functional.cosine_similarity(
               g_split, g_ref, dim=-1).min().item(),
           "teacher_forced": {**forced, "episode_steps": episode_steps}}
    out["failed"] = [clause for clause, ok in (
        ("no hand-kernel launch", not any(launches.values())),
        ("shard attention runs", calls[0] == want_calls),
        ("goal descriptors bit for bit", goal_equal),
        ("pairs on every episode-step", not any(forced["flips"])),
        ("twists bit for bit on every episode-step",
         forced["episode_steps_bit_equal"] == episode_steps)) if not ok]
    if hold and out["failed"]:
        raise AssertionError(f"int8 tp: {json.dumps(out)}")
    return out


@contextmanager
def scrambled_int8_split():
    """While open, every TPQuantBlock's first two shards project their
    heads' attention outputs through each other's int8 columns of the
    output projection (a planted fault)."""
    orig = TPQuantBlock.__init__

    def swapped(self, blk, cfg, devices):
        orig(self, blk, cfg, devices)
        a, b = self.shards[0], self.shards[1]
        a.proj_weight, b.proj_weight = b.proj_weight, a.proj_weight

    TPQuantBlock.__init__ = swapped
    try:
        yield
    finally:
        TPQuantBlock.__init__ = orig


def run_int8_tp_plant(qnet, cfg: VSConfig, qmodel: ServoModel, scene: Scene,
                      num_steps: int = INT8_TP_PLANT_STEPS) -> dict:
    """3m(a)'s check on a planted fault (:func:`scrambled_int8_split`) over
    ``num_steps`` chunk-steps: its readings, which must fail a clause."""
    with scrambled_int8_split():
        out = run_int8_tp(qnet, cfg, qmodel, scene, num_steps=num_steps,
                          segment_steps=min(num_steps, CHUNK_SEGMENT), hold=False)
    if not out["failed"]:
        raise AssertionError(f"int8 tp: the planted fault passed the check: {json.dumps(out)}")
    return out


def check_int8_shard_kernels(qnet, model: ServoModel, split, frame,
                             tol: float = ATTN_TOL) -> dict:
    """3m(b): block 0's kernel 4 on each shard's [q | k | v] column slices
    of its own qkv product (h / tp heads, columns at offsets n and 2 n of a
    3 n wide output) against the unsplit kernel's output for those heads
    (bit for bit) and against fused_int8_attention_plain on the same slices
    (max abs err within ``tol``)."""
    cfg = model.vit
    with torch.inference_mode():
        x = qnet.embed(preprocess(model, frame)[None])
        blk = qnet.blocks[0]
        xn = blk.norm1(x, cfg.ln_f32)
        full = blk.qkv(xn, blk.act(0))
        D = cfg.embed_dim
        whole = attn_int8.fused_int8_attention(full[..., :D], full[..., D:2 * D],
                                               full[..., 2 * D:], heads=cfg.num_heads)
        out = {"bit_equal": [], "max_abs_err_vs_plain": [], "column_offset_bytes": []}
        for s, sh in enumerate(split.blocks[0].shards):
            qkv = sh.qkv(xn.to(sh.proj_weight.device), sh.act(0))
            n = sh.heads * cfg.head_dim
            sl = (qkv[..., :n], qkv[..., n:2 * n], qkv[..., 2 * n:])
            got = attn_int8.fused_int8_attention(*sl, heads=sh.heads)
            plain = attn_int8.fused_int8_attention_plain(*sl, sh.heads)
            out["bit_equal"].append(bool(torch.equal(got.to(whole.device),
                                                     whole[..., s * n:(s + 1) * n])))
            out["max_abs_err_vs_plain"].append((got.float() - plain.float()).abs().max().item())
            out["column_offset_bytes"].append(n * qkv.element_size())
    if not (all(out["bit_equal"]) and max(out["max_abs_err_vs_plain"]) <= tol):
        raise AssertionError(f"int8 shard kernel 4: {json.dumps(out)}")
    return out


def run_int8_tp_serving(variants: dict, cfg: VSConfig, seed: int = 0,
                        tp: int = INT8_TP_SERVE) -> dict:
    """3m(b): each int8 ViT of ``variants`` (name -> (QuantViT, model, the
    counter of the kernel its attention launches)) split over a (1, tp) grid
    of its device: goal + N_STEPS steps of the split against the unsplit on
    the same frames and scores (twists within TWIST_TOL where pairs agree,
    bit-equal steps counted), the split's launches (counters zeroed just
    before its run) beside those it gives on the card, tp x blocks x
    forwards of its kernel; for 'fused' the shards' kernel 4 outputs against
    the unsplit's (:func:`check_int8_shard_kernels`)."""
    goal, frames, depth = make_frames(cfg, seed)
    frames = frames[:N_STEPS]
    out = {}
    for name, (qnet, model, kernel) in variants.items():
        split = TPQuantViT(qnet, [torch.device(model.device)] * tp)
        scores = pair_scores(model, len(frames), seed)
        for fn in _counters().values():
            fn.launches = 0
        ker = drive(split, model, goal, frames, depth, scores)
        launches = {k: fn.launches for k, fn in _counters().items()}
        ref = drive(qnet, model, goal, frames, depth, scores)
        check_outputs(model, *ker)
        summ = compare_runs(ref, ker)
        want = {k: 0 for k in _counters()}
        want[kernel] = tp * (cfg.layer + 1) * (1 + len(frames))
        summ.update(launches=launches, launches_on_the_card=want, tp=tp, steps_bit_equal=sum(
            bool(torch.equal(r.body_twist, k.body_twist)) for r, k in zip(ref[1], ker[1])))
        if name == "fused":
            summ["shard_kernels"] = check_int8_shard_kernels(qnet, model, split, goal)
        out[name] = summ
    return out


def check_bf16l(device, shapes=BF16L_SHAPES, seed: int = 40, tol: float = ATTN_TOL,
                share: float = BF16L_MEAN_SHARE) -> dict:
    """3m(c): the exact kernel's bf16-logits variant against its plain
    version (mha_attention_plain(bf16_logits=True)) on the same bf16
    inputs: two launches bit for bit, the largest |diff| within ``tol``, and
    the mean |diff| at most ``share`` of the exact kernel's (f32 scores)
    mean |diff| to the same plain version, so that a variant without its
    roundings fails.  Returns both kernels' readings by shape."""
    rs = np.random.default_rng(seed)
    out = {}
    for shape in shapes:
        q, k, v = (torch.from_numpy(rs.standard_normal(shape).astype(np.float32))
                   .to(device, torch.bfloat16) for _ in range(3))
        got = attention.mha_attention(q, k, v, bf16_logits=True)
        again = attention.mha_attention(q, k, v, bf16_logits=True)
        ref = attention.mha_attention_plain(q, k, v, bf16_logits=True).float()
        d, d1 = (got.float() - ref).abs(), (attention.mha_attention(q, k, v).float() - ref).abs()
        r = {"max_abs_err": d.max().item(), "mean_abs_err": d.mean().item(),
             "share_differing": (d > 0).float().mean().item(),
             "exact_kernel_max_abs_err": d1.max().item(),
             "exact_kernel_mean_abs_err": d1.mean().item(),
             "exact_kernel_share_differing": (d1 > 0).float().mean().item()}
        out[str(shape)] = r
        if not (r["max_abs_err"] <= tol and torch.equal(got, again)
                and r["mean_abs_err"] <= share * r["exact_kernel_mean_abs_err"]):
            raise AssertionError(f"bf16-logits attention at {shape}: {json.dumps(out)}")
    return out


def _port_measure():
    import importlib.util

    path = Path(__file__).resolve().parent / "scripts" / "port_measure.py"
    spec = importlib.util.spec_from_file_location("port_measure", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def measure_launches(what: str, blocks: int, short: int, long: int, reps: int) -> int:
    """The attention launches of one port_measure.py run: the goal's forward,
    then (1 + reps) chains of each length, a forward (attn: one launch)
    an iteration (match: none)."""
    iters = (1 + reps) * (short + long)
    return blocks * (1 + (iters if what in ("step", "desc") else 0)) + (
        iters if what == "attn" else 0)


def run_port_measure(device, size: int = 518, model: str = "dinov2_vitb14",
                     modes=MEASURE_MODES, runs=MEASURE_RUNS, chain=MEASURE_CHAIN) -> dict:
    """3m(d): scripts/port_measure.py's modes in this process, each
    configuration of ``runs`` with the launch counters zeroed before its
    modes and read after: the float ones launch the exact kernel (and the
    bf16 matcher in step and match), the int8 fast-math ones with 'xla' the
    bf16-logits variant, as many times as the chains run forwards."""
    pm = _port_measure()
    short, long, reps = int(chain[3]), int(chain[1]), int(chain[5])
    out = {}
    for name, flags in runs.items():
        for fn in _counters().values():
            fn.launches = 0
        attention.mha_attention_bf16l.launches = 0
        lines = {}
        for what in modes:
            res = pm.main([what, "--device", str(device), "--size", str(size), "--model", model,
                           *chain, *flags])
            lines[what] = res["line"]
            log(f"3m(d) {name}: {res['device']} | {res['line']}")
        launches = {k: fn.launches for k, fn in _counters().items()}
        launches["attention_bf16l"] = attention.mha_attention_bf16l.launches
        blocks = 11 + 1                     # port_measure.py's layer 11
        n = sum(measure_launches(w, blocks, short, long, reps) for w in modes)
        want = {k: 0 for k in launches}
        kernel = "attention_bf16l" if "--quant" in flags else "attention"
        want[kernel] = n
        if "--quant" not in flags:
            want["matcher_bf16"] = sum((1 + reps) * (short + long) for w in modes
                                       if w in ("step", "match"))
        if launches != want:
            raise AssertionError(f"port_measure {name}: launches {launches} != {want}")
        out[name] = {"lines": lines, "launches": launches}
    return out


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


def matcher_bound_ms(shape=MATCH_SHAPE, bf16: bool = False, nb: int = 1) -> tuple[float, str]:
    """f32 mode: f32 rows, products outside the tensor cores; bf16 mode: bf16
    rows on the bf16 tensor cores; the goal's t rows against ``nb`` frames'."""
    t, d = shape
    flops = 2.0 * nb * t * t * d
    # the goal's and the frames' rows read, the quartets written
    nbytes = (1 + nb) * t * d * (2 if bf16 else 4) + 2.0 * nb * t * 8
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
        "matcher": {"ms": cuda_ms(lambda: matcher._launch_f32(a, b[None])),
                    "plain_ms": cuda_ms(lambda: matcher.dual_argmax_cosine_plain(a, b), iters=50),
                    "library_ms": cuda_ms(library_match, iters=50)},
        "matcher_bf16": {
            "ms": cuda_ms(lambda: matcher._launch_bf16(ua, ub[None])),
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


def time_bf16l_kernels(device, shapes=BF16L_SHAPES) -> dict:
    """The bf16-logits variant alone at each shape, beside the exact kernel
    (f32 scores) on the same inputs, its plain version and SDPA (bf16), with
    the bound (the exact kernel's work: the roundings add no bytes and a few
    operations an element)."""
    rs = np.random.default_rng(41)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    out = {}
    for shape in shapes:
        q, k, v = (torch.from_numpy(rs.standard_normal(shape).astype(np.float32))
                   .to(device, torch.bfloat16) for _ in range(3))
        qh, kh, vh = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        bound, by = attention_bound_ms(shape)
        out[str(shape)] = {
            "shape": list(shape),
            "ms": cuda_ms(lambda: attention._launch(attention.BF16L_ENTRY, q, k, v)),
            "exact_f32_scores_ms": cuda_ms(lambda: attention._launch("vitvs_attention_fwd",
                                                                     q, k, v)),
            "plain_ms": cuda_ms(lambda: attention.mha_attention_plain(q, k, v, bf16_logits=True),
                                iters=20),
            "library_ms": cuda_ms(lambda: sdpa(qh, kh, vh)),
            "bound_ms": bound, "bound_by": by}
    return out


def time_trained_kernels(device) -> dict:
    """The kernels phase 3e launches, at its shapes (ViT-S/14 @ 518): each
    kernel alone, its plain version and the library call, with the bound."""
    rs = np.random.default_rng(9)
    bf16 = lambda shape: _normal(device, shape, rs, torch.bfloat16)
    heads_first = lambda *xs: [x.transpose(1, 2).contiguous() for x in xs]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    out = {}
    for name, shape in (("attention", TRAINED_ATTN_SHAPE),
                        ("attention_search", TRAINED_SEARCH_ATTN_SHAPE)):
        q, k, v = (bf16(shape) for _ in range(3))
        qh, kh, vh = heads_first(q, k, v)
        out[name] = {"shape": shape, "ms": cuda_ms(lambda: attention.mha_attention(q, k, v)),
                     "plain_ms": cuda_ms(lambda: attention.mha_attention_plain(q, k, v), iters=50),
                     "library_ms": cuda_ms(lambda: sdpa(qh, kh, vh)),
                     **dict(zip(("bound_ms", "bound_by"), attention_bound_ms(shape)))}
    t, d = TRAINED_MATCH_SHAPE
    a, b = bf16((t, d)), bf16((t, d))
    ua, ub = matcher.bf16_unit_rows(a), matcher.bf16_unit_rows(b)

    def library_match_bf16():
        sim = ua @ ub.T
        return sim.max(1), sim.max(0)

    out["matcher_bf16"] = {"shape": (t, t, d),
                           "ms": cuda_ms(lambda: matcher._launch_bf16(ua, ub[None])),
                           "plain_ms": cuda_ms(lambda: matcher.dual_argmax_cosine_bf16_plain(a, b),
                                               iters=50),
                           "library_ms": cuda_ms(library_match_bf16),
                           **dict(zip(("bound_ms", "bound_by"),
                                      matcher_bound_ms(TRAINED_MATCH_SHAPE, bf16=True)))}
    B, T, H, hd = TRAINED_ATTN_SHAPE
    fq, fk, fv = (bf16(TRAINED_ATTN_SHAPE) for _ in range(3))
    fqs = attention._fast_scaled_q(fq)
    fqh, fkh, fvh = heads_first(fq, fk, fv)
    out["attention_fast"] = {
        "shape": TRAINED_ATTN_SHAPE,
        "ms": cuda_ms(lambda: attention._launch("vitvs_attention_fast_fwd", fqs, fk, fv)),
        "plain_ms": cuda_ms(lambda: attention.mha_attention_fast_plain(fq, fk, fv), iters=50),
        "library_ms": cuda_ms(lambda: sdpa(fqh, fkh, fvh)),
        **dict(zip(("bound_ms", "bound_by"), attention_bound_ms(TRAINED_ATTN_SHAPE)))}
    qkv = bf16((B, T, 3 * H * hd))
    D = H * hd
    iq, ik, iv = qkv[..., :D], qkv[..., D:2 * D], qkv[..., 2 * D:]
    out["attn_int8"] = {
        "shape": (B, T, D), "ms": cuda_ms(lambda: attn_int8._launch(iq, ik, iv, H)),
        "plain_ms": cuda_ms(lambda: attn_int8.fused_int8_attention_plain(iq, ik, iv, H), iters=50),
        "library_ms": None,
        **dict(zip(("bound_ms", "bound_by"), int8_attention_bound_ms(TRAINED_ATTN_SHAPE)))}
    return out


def time_chunk_kernels(device) -> dict:
    """The kernels at the chunk's shapes: the bf16 matcher on one goal
    against CHUNK frames (ViT-S/14 @ 518) beside CHUNK single launches,
    its plain version and cuBLAS bmm + max/argmax; exact attention at the
    chunk's and its search's batch beside SDPA; each with its bound."""
    rs = np.random.default_rng(22)
    bf16 = lambda shape: _normal(device, shape, rs, torch.bfloat16)
    t, d = TRAINED_MATCH_SHAPE
    a, b = bf16((t, d)), bf16((CHUNK, t, d))
    ua, ub = matcher.bf16_unit_rows(a), matcher.bf16_unit_rows(b)

    def library_match_bf16():     # cuBLAS bf16 bmm with a bf16 output, then max/argmax
        sim = torch.matmul(ua, ub.mT)
        return sim.max(-1), sim.max(-2)

    out = {"matcher_bf16_batched": {
        "shape": (CHUNK, t, t, d), "ms": cuda_ms(lambda: matcher._launch_bf16(ua, ub)),
        "singles_ms": cuda_ms(lambda: [matcher._launch_bf16(ua, ub[i:i + 1])
                                       for i in range(CHUNK)]),
        "plain_ms": cuda_ms(lambda: matcher.dual_argmax_cosine_bf16_plain(a, b), iters=20),
        "library_ms": cuda_ms(library_match_bf16),
        **dict(zip(("bound_ms", "bound_by"),
                   matcher_bound_ms(TRAINED_MATCH_SHAPE, bf16=True, nb=CHUNK)))}}
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for name, shape in (("attention_chunk", CHUNK_ATTN_SHAPE),
                        ("attention_chunk_search", CHUNK_SEARCH_ATTN_SHAPE)):
        q, k, v = (bf16(shape) for _ in range(3))
        qh, kh, vh = [x.transpose(1, 2).contiguous() for x in (q, k, v)]
        out[name] = {"shape": shape, "ms": cuda_ms(lambda: attention.mha_attention(q, k, v)),
                     "plain_ms": cuda_ms(lambda: attention.mha_attention_plain(q, k, v),
                                         iters=10),
                     "library_ms": cuda_ms(lambda: sdpa(qh, kh, vh)),
                     **dict(zip(("bound_ms", "bound_by"), attention_bound_ms(shape)))}
    return out


def time_vitg_kernels(device) -> dict:
    """Kernels 1, 2a and 4 at ViT-g/14 @ 518's shapes, each alone, its plain
    version and the library call (SDPA; cuBLAS bf16 + max/argmax), with the
    bound; beside the matcher, the factorized path's product (cuBLAS bf16
    with an f32 output) and its whole similarity, one frame and a chunk."""
    rs = np.random.default_rng(46)
    bf16 = lambda shape: _normal(device, shape, rs, torch.bfloat16)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    out = {}
    for name, shape in (("attention_vitg", VITG_ATTN_SHAPE),
                        ("attention_vitg_chunk", VITG_CHUNK_ATTN_SHAPE)):
        q, k, v = (bf16(shape) for _ in range(3))
        qh, kh, vh = [x.transpose(1, 2).contiguous() for x in (q, k, v)]
        out[name] = {"shape": shape, "ms": cuda_ms(lambda: attention.mha_attention(q, k, v)),
                     "plain_ms": cuda_ms(lambda: attention.mha_attention_plain(q, k, v),
                                         iters=10),
                     "library_ms": cuda_ms(lambda: sdpa(qh, kh, vh)),
                     **dict(zip(("bound_ms", "bound_by"), attention_bound_ms(shape)))}
    t, d = VITG_MATCH_SHAPE
    a, b = bf16((t, d)), bf16((CHUNK, t, d))
    ua, ub = matcher.bf16_unit_rows(a), matcher.bf16_unit_rows(b)

    def library_match_bf16(n):
        sim = torch.matmul(ua, ub[:n].mT)
        return sim.max(-1), sim.max(-2)

    for name, n in (("matcher_bf16_vitg", 1), ("matcher_bf16_vitg_batched", CHUNK)):
        out[name] = {
            "shape": (n, t, t, d), "ms": cuda_ms(lambda: matcher._launch_bf16(ua, ub[:n])),
            "plain_ms": cuda_ms(lambda: matcher.dual_argmax_cosine_bf16_plain(a, b[:n]),
                                iters=10),
            "library_ms": cuda_ms(lambda: library_match_bf16(n)),
            **dict(zip(("bound_ms", "bound_by"),
                       matcher_bound_ms(VITG_MATCH_SHAPE, bf16=True, nb=n)))}
    t, D = VITG_FAST_SHAPE
    g, f = bf16((t, D)), bf16((CHUNK, t, D))
    grid = (37, 37)
    for name, n in (("matcher_bf16_vitg", 1), ("matcher_bf16_vitg_batched", CHUNK)):
        rows = f[:n].reshape(n * t, D)
        out[name]["factorized_product_ms"] = cuda_ms(
            lambda: torch.mm(rows, g.T, out_dtype=torch.float32))
        out[name]["factorized_similarity_ms"] = cuda_ms(
            lambda: binned_cosine_similarity(g, f[:n], grid), iters=20)
        out[name]["factorized_product_bound_ms"] = _bound(
            2.0 * n * t * t * D / PEAK_BF16_FLOPS,
            ((1 + n) * t * D * 2 + n * t * t * 4) / PEAK_BYTES)[0]
    B, T, H, hd = VITG_ATTN_SHAPE
    qkv = bf16((B, T, 3 * H * hd))
    D = H * hd
    iq, ik, iv = qkv[..., :D], qkv[..., D:2 * D], qkv[..., 2 * D:]
    out["attn_int8_vitg"] = {
        "shape": (B, T, D), "ms": cuda_ms(lambda: attn_int8._launch(iq, ik, iv, H)),
        "plain_ms": cuda_ms(lambda: attn_int8.fused_int8_attention_plain(iq, ik, iv, H), iters=20),
        "library_ms": None,
        **dict(zip(("bound_ms", "bound_by"), int8_attention_bound_ms(VITG_ATTN_SHAPE)))}
    return out


def time_pooled_attention(device, vit) -> dict:
    """The int8 chunk's pooled 'nomax3' attention (plain PyTorch) at
    POOLED_ATTN_SHAPE in bf16, beside SDPA (exact softmax) on the same
    shapes and the bound of its two products."""
    B, T, Tk, H, hd = POOLED_ATTN_SHAPE
    rs = np.random.default_rng(27)
    q = _normal(device, (B, T, H, hd), rs, torch.bfloat16)
    k, v = (_normal(device, (B, Tk, H, hd), rs, torch.bfloat16) for _ in range(2))
    qh, kh, vh = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    flops = 4.0 * B * H * T * Tk * hd
    nbytes = 2.0 * (2 * B * T + 2 * B * Tk) * H * hd        # bf16 q, k, v read, o written
    bound, by = _bound(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES)
    return {"ms": cuda_ms(lambda: _nomax_attention(q, k, v, vit), iters=50),
            "sdpa_ms": cuda_ms(lambda: sdpa(qh, kh, vh)), "bound_ms": bound, "bound_by": by}


def step_runner(net, model: ServoModel):
    """One servo_step a call, from a host (numpy) frame and depth map of
    phase 3 to the twist on the card."""
    goal, frames, depth = make_frames(model.cfg, seed=0)
    goal_desc = goal_descriptors(net, model, goal)
    ema, prev = EmaState.init(device=model.device), torch.zeros(6, device=model.device)
    gen = torch.Generator(device=model.device).manual_seed(7)
    return lambda: servo_step(net, model, goal_desc, frames[0], depth, ema, prev, generator=gen)


def profile_run(run, steps=10, top=25, trace_path: Path | None = None) -> dict:
    """Device time by kernel over ``steps`` calls of ``run`` (torch.profiler)
    after 3 warm-up calls, the device's busy share of that window, and the
    host's waits on the device.  Returns the window's ms per step and busy
    share and its device activities (kernels and copies) a step."""
    from torch.profiler import ProfilerActivity, profile

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
    # kernels and copies are the rows on the device; operator rows repeat their time, and
    # so do user-annotated ranges (torch.optim's "Optimizer.step#AdamW.step")
    on_device = [e for e in rows if str(e.device_type).endswith("CUDA")
                 and not getattr(e, "is_user_annotation", False)]
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
    return {"wall_ms_per_step": wall_ms / steps, "device_ms_per_step": device_ms / steps,
            "busy_share": device_ms / wall_ms,
            "activities_per_step": sum(e.count for e in on_device) / steps}


# ---------------------------------------------------------------------------
# --replay A:B: a convergence rate on the trained weights
# ---------------------------------------------------------------------------


class BudgetSpent(Exception):
    """The replay's time budget ran out inside an episode."""


def replay_name(lo: int, hi: int, int8: bool = False, perturbed: bool = False,
                method: str = "dino", attn_score: str = "softmax",
                fast_binned: bool = False) -> str:
    """The replay's file stem: its checkpoint, npz and JSON."""
    pert = "_pert" if perturbed else ""
    if method != "dino":
        return f"replay_{method}{pert}_{lo}_{hi}"
    score = "" if attn_score == "softmax" else f"_{attn_score}"
    fast = "_fast" if fast_binned else ""
    return f"replay_s518{score}{'_int8' if int8 else ''}{fast}{pert}_{lo}_{hi}"


def run_replay(lo: int, hi: int, checkpoint: Path, budget_s: float, out_dir: Path,
               device, chunk: int = CHUNK, path: Path = TRAINED_S518,
               int8: bool = False, perturbed: bool = False, method: str = "dino",
               attn_score: str = "softmax", fast_binned: bool = False) -> dict:
    """run_benchmark on episodes [lo, hi) of the 500-episode seed-41 stream
    (runs Z and AA's) at configs/real_s518.yaml's other settings on the
    trained ViT-S/14 @ 518 (cast whole to bf16, rotation search on),
    ``chunk`` episodes a chunk, resuming from ``checkpoint`` (whole chunks);
    on the standard texture, or with ``perturbed`` on each episode's
    perturbed texture (run AM's protocol); with ``int8`` run AD's
    configuration instead (configs/real_s518_pool2mm.yaml served by
    run_benchmark(quantized=True, int8_static=True)).  A classical
    ``method`` ('sift', 'orb', 'akaze', 'harris') runs
    run_classical_benchmark instead, on episodes [lo, hi) of the 64-episode
    stream at configs/real64.yaml's settings (runs J, K and AN's), with the
    method's default keypoints.  ``attn_score`` serves the weights of
    ``path`` with that score (configs/real_s518_relu.yaml's setting; the
    weights co-trained for it).  ``fast_binned`` matches by the factorized
    binned similarity (ServoModel.fast_binned_match).  Each of these runs has its own checkpoint
    fingerprint, so none resumes another's file.  When ``budget_s`` seconds
    have passed the chunk in flight is dropped (it reruns, bit for bit, on
    resume).  Returns the checkpoint's episodes summarized and this call's
    times."""
    classical = method != "dino"
    if classical:
        cfg, net, info = real64_config(), None, {"file": None}
    else:
        cfg = dataclasses.replace(ad_config() if int8 else trained_config(),
                                  attn_score=attn_score)
        model = ServoModel.create(cfg, device=device)
        net, info = load_trained(model, path)
        model = dataclasses.replace(model, fast_binned_match=fast_binned)
    checkpoint.parent.mkdir(parents=True, exist_ok=True)
    out_dir.mkdir(parents=True, exist_ok=True)
    before = len(load_episodes(str(checkpoint), "replay", verbose=False)[0])
    steps = {"chunk": 0, "episode": 0}
    sync(device)
    t0 = time.perf_counter()

    def on_step(abs_ids, inputs, result):
        steps["chunk"] += 1
        steps["episode"] += len(set(int(i) for i in abs_ids))   # the padding repeats the last
        if time.perf_counter() - t0 > budget_s:
            raise BudgetSpent

    common = dict(episode_indices=range(lo, hi), checkpoint_path=str(checkpoint), chunk=chunk,
                  out_dir=str(out_dir),
                  config_name=replay_name(lo, hi, int8, perturbed, method, attn_score,
                                          fast_binned),
                  device=device, on_step=on_step, perturbation=perturbed)
    try:
        if classical:
            run_classical_benchmark(cfg, method=method, **common)
        else:
            run_benchmark(cfg, net=net, model=model, quantized=int8, int8_static=int8, **common)
        finished = True
    except BudgetSpent:
        finished = False
    sync(device)
    wall_s = time.perf_counter() - t0
    episodes = load_episodes(str(checkpoint), "replay", verbose=False)[0]
    flags = [bool(e.converged) for e in episodes]
    stats = convergence_stats({
        "convergence_flags": np.asarray(flags),
        "lowest_position_errors": np.asarray([float(e.lowest_position_error) for e in episodes]),
        "lowest_orientation_errors": np.asarray([float(e.lowest_orientation_error)
                                                 for e in episodes]),
        "all_iteration_histories": np.asarray([int(e.iterations) for e in episodes]),
        "total_execution_time": wall_s})
    done_now = len(episodes) - before
    return {"episodes": [lo, hi], "method": method, "weights": info["file"], "int8": int8,
            "perturbed": perturbed, "chunk": chunk, "attn_score": attn_score,
            "fast_binned": fast_binned,
            "finished": finished,
            "episodes_done": len(episodes), "episodes_this_call": done_now,
            "converged": int(sum(flags)), "not_converged": [lo + i for i, f in enumerate(flags)
                                                             if not f],
            "stats": dataclasses.asdict(stats),
            "iterations": [int(e.iterations) for e in episodes],
            "lowest_pos_err_cm": [float(e.lowest_position_error) for e in episodes],
            "lowest_rot_err_deg": [float(e.lowest_orientation_error) for e in episodes],
            "final_pos_err_cm": [float(e.position_error) for e in episodes],
            "call_wall_s": wall_s, "call_chunk_steps": steps["chunk"],
            "call_steps": steps["episode"],
            "ms_per_chunk_step": 1e3 * wall_s / max(steps["chunk"], 1),
            "ms_per_step": 1e3 * wall_s / max(steps["episode"], 1),
            "card_s_per_episode": wall_s / done_now if done_now else None}


# ---------------------------------------------------------------------------


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", nargs="?", const="bf16",
                    choices=["bf16", "f32", *VARIANTS, *PROB_VARIANTS, "relu", "loop",
                             "loop518", "int8loop", *CLASSICAL, "train", "vitg", "fastbin"],
                    help="build, then only profile servo steps of the bf16 path (default), "
                         "the f32 path or an int8 serving variant (F, N, none, nomax3, pv, "
                         "qk+pv at ViT-B/14 @ 518, static scales but F and N), or the relu bf16 step on the trained ViT-S/14 @ 518 (with "
                         "--chunk B its closed-loop chunk-step), or closed-loop steps at "
                         "308 (seeded) or 518 (trained; int8loop: the int8 closed loop at "
                         "run AD's settings), or a classical method's closed loop at 640x480, "
                         "or (train) train steps of ViT-S/14 @ 308 at batch 8, or (vitg, "
                         "fastbin) the seeded ViT-g/14 @ 518 bf16 step with materialized or "
                         "factorized binning (with --chunk B its closed-loop chunk-step) (no "
                         "checks, no result line)")
    ap.add_argument("--trace", type=Path, default=None,
                    help="with --profile: write the profiler's chrome trace here")
    ap.add_argument("--replay", default=None, metavar="A:B",
                    help="build, then only run episodes [A, B) of the seed-41 benchmark on the "
                         "trained ViT-S/14 @ 518 (bf16), or of a classical --method, resuming "
                         "from --checkpoint")
    ap.add_argument("--int8", action="store_true",
                    help="with --replay: run AD's int8 configuration (configs/"
                         "real_s518_pool2mm.yaml, int8 static scales, nomax3)")
    ap.add_argument("--method", default="dino", choices=["dino", *CLASSICAL],
                    help="with --replay: a classical baseline on the 64-episode stream "
                         "(configs/real64.yaml, runs J, K and AN's) instead of dino")
    ap.add_argument("--fast-binned", action="store_true",
                    help="with --replay: match by the factorized binned similarity "
                         "(ServoModel.fast_binned_match) instead of binned descriptors")
    ap.add_argument("--perturbed", action="store_true",
                    help="with --replay: each episode on its perturbed texture (run AM's "
                         "protocol) instead of the standard one")
    ap.add_argument("--checkpoint", type=Path, default=None,
                    help="with --replay: the resume file (default .replay/replay_s518_A_B.ckpt, "
                         ".replay/replay_s518_int8_A_B.ckpt with --int8; a copy is left in "
                         "chiprun_out/ when the run is unfinished)")
    ap.add_argument("--budget-s", type=float, default=None,
                    help="with --replay: stop after this many seconds of episodes (default "
                         "480); with --train: stop at the first chain boundary after this many "
                         "seconds, leaving the trainer's part checkpoint (default: no budget)")
    ap.add_argument("--train", type=int, default=None, metavar="N",
                    help="build, then only train ViT-S/14 for N steps with the JAX run's "
                         "arguments (train_servo's defaults, batch 8; --train 3000 is the JAX "
                         "run), resumable from the trainer's part files under .train/")
    ap.add_argument("--size", type=int, default=308, help="with --train: the input size")
    ap.add_argument("--poster", default=TRAIN_POSTER, choices=["synthetic", "real"],
                    help="with --train: the synthetic poster the JAX run trained on (default), "
                         "or the real poster (train_servo's default today)")
    ap.add_argument("--resume", type=Path, default=None,
                    help="with --train: start from these weights (exported .npz or .pth)")
    ap.add_argument("--cotrain", default=None, choices=list(SCORES),
                    help="build, then only co-train ckpt_real518 for the score (the campaign's "
                         "2000 steps at 518) and run episodes 0 to 63 at chunk 8 with it, "
                         f"held to at least {COTRAIN_MIN_CONVERGED} converged; --budget-s "
                         f"bounds both (default {COTRAIN_BUDGET_S:.0f} s)")
    ap.add_argument("--chunk", type=int, default=None,
                    help=f"with --replay: episodes a chunk (default {CHUNK}); with --profile "
                         f"loop, loop518 or int8loop: profile chunk-steps of this many episodes")
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
        err = check_attention(device, shape=SEARCH_ATTN_SHAPE, ts=(), seed=14)
        log(f"attention {SEARCH_ATTN_SHAPE} bf16 (the rotation search's batch): max abs err "
            f"{err:.3e} (tol {ATTN_TOL}), two launches bit for bit")
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
        log(f"int8 kernel's Q/K quantization, _quant_th on the card and _quant_th on "
            f"the CPU equal bit for bit on {probe['rows']} rows")
        # the trained ViT-S/14 @ 518's shapes (phase 3e)
        for shape, seed in ((TRAINED_ATTN_SHAPE, 15), (TRAINED_SEARCH_ATTN_SHAPE, 16)):
            err = check_attention(device, shape=shape, ts=(), seed=seed)
            log(f"attention {shape} bf16 (ViT-S/14 @ 518): max abs err {err:.3e} "
                f"(tol {ATTN_TOL}), two launches bit for bit")
        t, d = TRAINED_MATCH_SHAPE
        err = check_matcher_bf16(device, shapes=[(t, t, d)], seed=17)
        log(f"bf16 matcher {(t, t, d)} (ViT-S/14 @ 518): max abs err {err:.3e} "
            f"(tol {MATCH_VAL_TOL}), argmax ok, first-index ties ok")
        err = check_attention_fast(device, shape=TRAINED_ATTN_SHAPE, seed=18)
        log(f"no-max attention {TRAINED_ATTN_SHAPE} bf16 (6 heads): max abs err {err:.3e} "
            f"(tol {ATTN_TOL}); B = 2 at T = {FAST_ATTN_T} ok")
        err = check_int8_attention(device, shape=TRAINED_ATTN_SHAPE, ts=(), seed=19)
        log(f"int8 attention {TRAINED_ATTN_SHAPE} (D = 384): max abs err {err:.3e} "
            f"(tol {ATTN_TOL}), padded columns ok")
        # the batched chunk's shapes (phase 3f): the matcher with a batch axis,
        # the exact attention at the chunk's and its search's batch
        t, d = TRAINED_MATCH_SHAPE
        berrs = check_matcher_batched(device, t, d, [CHUNK, *MATCH_BATCHES], seed=23)
        berrs.update(check_matcher_batched(device, MATCH_SHAPE[0], MATCH_SHAPE[1],
                                           MATCH_BATCHES, seed=24))
        errs["matcher_bf16_batched"] = berrs[f"bf16_b{CHUNK}"]
        log(f"batched matcher, both modes, a goal against B frames at {(t, t, d)} for B in "
            f"{[CHUNK, *MATCH_BATCHES]} and at {(MATCH_SHAPE[0],) + MATCH_SHAPE} for B in "
            f"{MATCH_BATCHES}: each item bit for bit a launch on it alone, two launches bit "
            f"for bit, the scratch left zero; max abs err against plain "
            f"{json.dumps({k: float(f'{v:.3e}') for k, v in berrs.items()})} "
            f"(tol {MATCH_VAL_TOL})")
        for shape, seed in ((CHUNK_ATTN_SHAPE, 25), (CHUNK_SEARCH_ATTN_SHAPE, 26)):
            err = check_attention(device, shape=shape, ts=(), seed=seed)
            log(f"attention {shape} bf16 (the chunk's batch): max abs err {err:.3e} "
                f"(tol {ATTN_TOL}), two launches bit for bit")
        # ViT-g/14 @ 518's shapes (phase 3k): 24 heads, binned rows 13824 deep, D = 1536
        errs["attention_vitg"] = max(check_attention(device, shape=shape, ts=(), seed=seed)
                                     for shape, seed in ((VITG_ATTN_SHAPE, 41),
                                                         (VITG_CHUNK_ATTN_SHAPE, 42)))
        log(f"attention {VITG_ATTN_SHAPE} and {VITG_CHUNK_ATTN_SHAPE} bf16 (ViT-g/14 @ 518): "
            f"max abs err {errs['attention_vitg']:.3e} (tol {ATTN_TOL}), two launches bit for bit")
        t, d = VITG_MATCH_SHAPE
        errs["matcher_bf16_vitg"] = check_matcher_bf16(device, shapes=[(t, t, d)], seed=43)
        berrs = check_matcher_batched(device, t, d, [CHUNK], seed=44)
        log(f"bf16 matcher {(t, t, d)} (ViT-g/14 @ 518): max abs err "
            f"{errs['matcher_bf16_vitg']:.3e} (tol {MATCH_VAL_TOL}), argmax ok, first-index ties "
            f"ok; batched at B = {CHUNK}, both modes, each item bit for bit a launch alone: "
            f"{json.dumps({k: float(f'{v:.3e}') for k, v in berrs.items()})}")
        errs["attn_int8_vitg"] = check_int8_attention(device, shape=VITG_ATTN_SHAPE, ts=(),
                                                      seed=45)
        log(f"int8 attention {VITG_ATTN_SHAPE} (D = 1536): max abs err "
            f"{errs['attn_int8_vitg']:.3e} (tol {ATTN_TOL}), padded columns ok")

    if args.replay:
        lo, hi = (int(x) for x in args.replay.split(":"))
        if (args.int8 or args.fast_binned) and args.method != "dino":
            ap.error("--int8 and --fast-binned apply to --method dino only")
        name = replay_name(lo, hi, args.int8, args.perturbed, args.method,
                           fast_binned=args.fast_binned)
        ckpt = args.checkpoint or here / ".replay" / f"{name}.ckpt"
        out_dir = here / "chiprun_out"
        with phase(f"replay {lo}:{hi} {args.method}{' int8' if args.int8 else ''}"
                   f"{' perturbed' if args.perturbed else ''}"
                   f"{' fast-binned' if args.fast_binned else ''}"):
            # the npz and the checkpoint of hundreds of episodes' histories stay
            # beside the checkpoint (chiprun_out/ is kept to 64 MiB at most);
            # an unfinished run's checkpoint is copied out to be resumed
            budget = 480.0 if args.budget_s is None else args.budget_s
            rep_out = run_replay(lo, hi, ckpt, budget, ckpt.parent, device,
                                 chunk=args.chunk or CHUNK, int8=args.int8,
                                 perturbed=args.perturbed, method=args.method,
                                 fast_binned=args.fast_binned)
            out_dir.mkdir(parents=True, exist_ok=True)
            if not rep_out["finished"]:
                shutil.copy(ckpt, out_dir / ckpt.name)
            (out_dir / f"{name}.json").write_text(json.dumps(rep_out))
        log(f"[{card}] replay: {rep_out['converged']} of {rep_out['episodes_done']} converged "
            f"({rep_out['episodes_this_call']} this call, finished={rep_out['finished']}), "
            f"not converged: {rep_out['not_converged']}; lowest errors "
            f"{rep_out['stats']['mean_lowest_position_error']:.4f} +- "
            f"{rep_out['stats']['std_lowest_position_error']:.4f} cm, "
            f"{rep_out['stats']['mean_lowest_orientation_error']:.4f} +- "
            f"{rep_out['stats']['std_lowest_orientation_error']:.4f} deg; mean iterations "
            f"{rep_out['stats']['mean_iterations']:.1f}; chunk {rep_out['chunk']}: "
            f"{rep_out['ms_per_chunk_step']:.3f} ms a chunk-step, "
            f"{rep_out['ms_per_step']:.3f} ms an episode-step, "
            f"{rep_out['card_s_per_episode']} card-s an episode")
        print(json.dumps({"replay": {k: v for k, v in rep_out.items()
                                     if not isinstance(v, list) or k == "not_converged"}}),
              flush=True)
        print(card, flush=True)
        print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                                 "kind": torch.cuda.get_device_name(0),
                                                 "count": torch.cuda.device_count()}}), flush=True)
        return 0

    if args.cotrain:
        with phase(f"cotrain {args.cotrain}"):
            res = run_cotrain(args.cotrain, here, device, args.budget_s)
        tr = res["train"]
        log(f"[{card}] cotrain {args.cotrain}: {tr['done']} steps at 518 from ckpt_real518, "
            f"{tr['ms_per_step']:.1f} ms a step; 25-step loss means "
            f"{json.dumps([round(x, 4) for x in tr['windows_25']])}; matching before "
            f"{tr['init_matching']}, after {tr['final_matching']}")
        if "quality" in res:
            log(f"[{card}] cotrain {args.cotrain}: matching quality kernels "
                f"{res['quality']['kernels']}, plain {res['quality']['plain']} (softmax "
                f"ckpt_real518: patch-acc {SOFTMAX_PATCH_ACC}); episodes {res['episodes']}: "
                f"{res['converged']} converged, not converged "
                f"{res['replay']['not_converged']}, bound at least {COTRAIN_MIN_CONVERGED}: "
                f"{'met' if res['bound_met'] else 'missed'}")
        print(json.dumps({"cotrain": {k: v for k, v in res.items() if k != "train"},
                          "train": {k: v for k, v in tr.items() if k != "windows_25"}}),
              flush=True)
        if not res["bound_met"]:
            print(f"cotrain: bound missed: {res.get('why', res.get('converged'))}",
                  file=sys.stderr)
            return 1
        print(card, flush=True)
        print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                                 "kind": torch.cuda.get_device_name(0),
                                                 "count": torch.cuda.device_count()}}), flush=True)
        return 0

    if args.train:
        with phase(f"train {args.train} at {args.size}"):
            res = run_train_command(args.train, args.size, args.resume, args.budget_s, here,
                                    device, args.poster)
        log(f"[{card}] train: {json.dumps({k: v for k, v in res.items() if k != 'loss'})}")
        print(json.dumps({"train": {k: v for k, v in res.items() if k != "loss"}}), flush=True)
        if res.get("bounds_met") is False:
            print(f"train: bounds missed: {res['bounds']}", file=sys.stderr)
            return 1
        print(card, flush=True)
        print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                                 "kind": torch.cuda.get_device_name(0),
                                                 "count": torch.cuda.device_count()}}), flush=True)
        return 0

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
            if args.profile == "train":
                tmodel = train_model(308, device)
                log(f"profile: train steps of ViT-S/14 @ 308, batch {TRAIN_BATCH}, bf16 over "
                    f"f32 weights, from a seeded init")
                profile_run(train_step_runner(init_vit(tmodel.vit, torch.Generator().manual_seed(0),
                                                       device=device), tmodel,
                                              load_poster_scene(device=device)),
                            trace_path=args.trace)
            elif args.profile in CLASSICAL:
                log(f"profile: classical {args.profile} closed loop, a chunk of "
                    f"{args.chunk or 1} episodes a step")
                profile_run(classical_runner(args.profile, load_poster_scene(device=device),
                                             args.chunk or 1), trace_path=args.trace)
            elif args.profile in ("loop", "loop518", "int8loop"):
                lnet, lmodel = net, model
                lscene = load_poster_scene(device=device)
                if args.profile == "loop518":
                    lmodel = ServoModel.create(trained_config(), device=device)
                    lnet = load_trained(lmodel)[0]
                elif args.profile == "int8loop":
                    lmodel = ServoModel.create(ad_config(), device=device)
                    lnet, lmodel = int8_serving_of_stream(load_trained(lmodel)[0], lmodel, lscene)
                run = (loop_runner(lnet, lmodel, lscene, *loop_start(lmodel.cfg),
                                   torch.Generator(device).manual_seed(0))
                       if args.chunk is None else chunk_runner(lnet, lmodel, lscene, args.chunk))
                log(f"profile: closed-loop {args.profile}, a chunk of {args.chunk or 1} "
                    f"episodes a step")
                profile_run(run, trace_path=args.trace)
            elif args.profile == "relu":
                rmodel = ServoModel.create(score_config("relu"), device=device)
                rnet = load_trained(rmodel)[0].cast_blocks(rmodel.compute_dtype)
                run = (step_runner(rnet, rmodel) if args.chunk is None else
                       chunk_runner(rnet, rmodel, load_poster_scene(device=device), args.chunk))
                log(f"profile: relu bf16, trained ViT-S/14 @ 518, "
                    f"{'a servo step' if args.chunk is None else f'chunk-steps of {args.chunk}'}")
                profile_run(run, trace_path=args.trace)
            elif args.profile in ("vitg", "fastbin"):
                gcfg = vitg_config()
                gnet32, draw_s = seeded_vitg(gcfg, device)
                gnet, gmodel = build_model(gcfg, net=gnet32.cast_blocks(torch.bfloat16),
                                           device=device)
                gmodel = dataclasses.replace(gmodel, fast_binned_match=args.profile == "fastbin")
                run = (step_runner(gnet, gmodel) if args.chunk is None else
                       chunk_runner(gnet, gmodel, load_poster_scene(device=device), args.chunk))
                log(f"profile: ViT-g/14 @ 518 bf16 (seeded on the card in {draw_s:.2f} s), "
                    f"{'factorized' if gmodel.fast_binned_match else 'materialized'} binning, "
                    f"{'a servo step' if args.chunk is None else f'chunk-steps of {args.chunk}'}")
                profile_run(run, trace_path=args.trace)
            elif args.profile == "bf16":
                profile_run(step_runner(net, model), trace_path=args.trace)
            elif args.profile == "f32":
                profile_run(step_runner(net32, model32), trace_path=args.trace)
            else:
                smodel = serving_model(scfg, args.profile, device)
                goal, frames, _ = make_frames(scfg, 0, shifts=SHIFTS + CALIB_SHIFTS)
                qnet = quantized_vit(fnet, smodel, [goal, *frames[N_STEPS:]])
                profile_run(step_runner(qnet, smodel), trace_path=args.trace)
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

    with phase("3d closed-loop"):
        scene = load_poster_scene(device=device)
        lcfg = loop_config(cfg)
        log(f"closed loop cut from the config: episodes {cfg.num_samples} -> {LOOP_EPISODES} "
            f"(and {LOOP_PERTURBED} perturbed), steps {cfg.max_iterations} -> {LOOP_STEPS} "
            f"in segments of {LOOP_SEGMENT}, min_iterations {cfg.min_iterations} -> "
            f"{LOOP_MIN_ITERATIONS}, max_iterations {cfg.max_iterations} -> "
            f"{LOOP_MAX_ITERATIONS}; ViT-S/14 @ 308 bf16, seeded weights, the poster scene")
        with tempfile.TemporaryDirectory() as out:
            lsum = run_closed_loop(net, lcfg, dataclasses.replace(model, cfg=lcfg), scene, out)
        log(f"closed loop: {json.dumps(lsum)}")
        for name, got in lsum["launches"].items():
            want = {k: 0 for k in _counters()}
            want.update(loop_launches(cfg.layer, lsum["episodes"][name],
                                      lsum["chunk_steps"][name]))
            if got != want:
                raise AssertionError(f"closed loop ({name}): launch counts {got} != {want}")
            for k in ("attention", "matcher_bf16"):
                launches[k] += got[k]
        run = loop_runner(net, model, scene, *loop_start(cfg),
                          torch.Generator(device).manual_seed(0))
        bare = step_runner(net, model)
        # host times drift between moments of a call by more than the loop adds:
        # the loop step and the bare step are timed in alternating rounds
        rounds = [(time_run(run), time_run(bare)) for _ in range(TIMING_ROUNDS)]
        loop_ms = statistics.median(r[0] for r in rounds)
        prof = profile_run(run, top=12)
        log(f"[{card}] closed-loop step median {loop_ms:.3f} ms (render, servo step, "
            f"integrate, ladder; ViT-S/14 @ 308, bf16, kernels), the bare bf16 step "
            f"{statistics.median(r[1] for r in rounds):.3f} ms, medians of {TIMING_ROUNDS} "
            f"alternating rounds of 20 steps; loop - bare by round "
            f"{[round(a - b, 3) for a, b in rounds]} ms; profiled "
            f"{prof['wall_ms_per_step']:.3f} ms/step, device busy "
            f"{prof['device_ms_per_step']:.3f} ms/step = {100 * prof['busy_share']:.1f}%")

    with phase("3e trained-weights"):
        tcfg = trained_config()
        tmodel = ServoModel.create(tcfg, device=device)
        tnet32, tinfo = load_trained(tmodel)
        log(f"trained weights: {json.dumps(tinfo)}")
        tnet = copy.deepcopy(tnet32).cast_blocks(tmodel.compute_dtype)
        scene = load_poster_scene(device=device)
        tsum = run_trained_step(tnet, tcfg, tmodel, scene)
        tsteps = tsum.pop("steps")
        log(f"trained bf16 step, ViT-S/14 @ 518: {json.dumps(tsum)}")
        log(f"trained bf16 step: {sum(1 for f in tsum['differing_pairs'] if f)} of {N_STEPS} "
            f"steps with pair flips ({sum(tsum['differing_pairs'])} pairs); twists within "
            f"{tsum['twist_max_abs_err']:.3e} on the {tsum['steps_compared']} others "
            f"(tol {TWIST_TOL})")
        want = {name: 0 for name in _counters()}
        want.update(attention=(tcfg.layer + 1) * (1 + N_STEPS), matcher_bf16=N_STEPS)
        if tsum["launches"] != want:
            raise AssertionError(f"trained step: launch counts {tsum['launches']} != {want}")
        for k in ("attention", "matcher_bf16"):
            launches[k] += want[k]
        gap = run_trained_int8(tnet32, tcfg, device, scene, tsteps)
        for variant, g in gap.items():
            log(f"trained int8 {variant} (logged, not held): {json.dumps(g['summary'])}")
            log(f"trained int8 {variant} vs bf16 step: pairs agreeing "
                f"{g['pairs_agreeing_with_bf16']} of {g['pairs']}, max |twist diff| "
                f"{g['twist_gap_to_bf16']:.4e}")
            kernel = VARIANTS[variant][2]
            want = {name: 0 for name in _counters()}
            want[kernel] = (tcfg.layer + 1) * (1 + N_STEPS)
            if g["summary"]["launches"] != want:
                raise AssertionError(f"trained int8 {variant}: launch counts "
                                     f"{g['summary']['launches']} != {want}")
            launches[kernel] += want[kernel]
        with tempfile.TemporaryDirectory() as out:
            tloop = run_trained_loop(tnet, tcfg, tmodel, scene, out)
        log(f"trained closed loop, episode {tloop['episode']} of the {tcfg.num_samples}-episode "
            f"stream at the full ladder "
            f"({tcfg.min_iterations} to {tcfg.max_iterations}): {json.dumps(tloop)}")
        want = {k: 0 for k in _counters()}
        want.update(loop_launches(tcfg.layer, 1, tloop["chunk_steps"]))
        if tloop["launches"] != want:
            raise AssertionError(f"trained closed loop: launch counts {tloop['launches']} != {want}")
        for k in ("attention", "matcher_bf16"):
            launches[k] += want[k]
        log(f"[{card}] trained closed loop: {tloop['device_steps']} steps in "
            f"{tloop['wall_s']:.2f} s with the goal and the search = "
            f"{1e3 * tloop['wall_s'] / tloop['device_steps']:.3f} ms a step")

    with phase("3f trained-chunk"):
        with tempfile.TemporaryDirectory() as out:
            csum = run_trained_chunk(tnet, tcfg, tmodel, scene, out)
        log(f"trained chunk of {CHUNK}, episodes {csum['episodes']} of the "
            f"{tcfg.num_samples}-episode stream, {CHUNK_STEPS} steps in segments of "
            f"{CHUNK_SEGMENT}: {json.dumps(csum)}")
        if csum["chunk_steps"] != CHUNK_STEPS or csum["device_steps"] != CHUNK * CHUNK_STEPS:
            raise AssertionError(f"trained chunk: {csum['chunk_steps']} chunk-steps, "
                                 f"{csum['device_steps']} episode-steps")
        want = {k: 0 for k in _counters()}
        want.update(loop_launches(tcfg.layer, 1, csum["chunk_steps"]))
        if csum["launches"] != want:
            raise AssertionError(f"trained chunk: launch counts {csum['launches']} != {want}")
        for k in ("attention", "matcher_bf16"):
            launches[k] += want[k]
        launches["matcher_bf16_batched"] = want["matcher_bf16"]
        tf = csum["teacher_forced"]
        log(f"[{card}] trained chunk: {csum['chunk_steps']} chunk-steps of {CHUNK} in "
            f"{csum['wall_s']:.2f} s with the goal, the search and the teacher-forced plain "
            f"steps; flips per episode (teacher-forced) {tf['steps_with_flips']} of "
            f"{CHUNK_STEPS} steps, twists within {tf['twist_max_abs_err']:.3e} on the "
            f"{tf['episode_steps_compared']} others; against chunk 1: first flip at "
            f"{csum['alone']['first_flip_step']}, twists within "
            f"{csum['alone']['twist_max_abs_err']:.3e} before it (tol {TWIST_TOL})")

    with phase("3g int8-closed-loop"):
        acfg = ad_config()
        amodel = ServoModel.create(acfg, device=device)
        with tempfile.TemporaryDirectory() as out:
            isum = run_int8_chunk(tnet32, acfg, amodel, scene, out)
        irun = isum.pop("run")
        log(f"int8 chunk of {CHUNK} at run AD's settings (configs/real_s518_pool2mm.yaml: "
            f"int8 static scales, {isum['quant_attn']}, kv_pool {isum['kv_pool']} by the "
            f"matrix, conv embed, '{isum['pp_precision']}' preprocess, source-quantized bins), "
            f"episodes {isum['episodes']}, {CHUNK_STEPS} steps: {json.dumps(isum)}")
        if isum["chunk_steps"] != CHUNK_STEPS or isum["device_steps"] != CHUNK * CHUNK_STEPS:
            raise AssertionError(f"int8 chunk: {isum['chunk_steps']} chunk-steps, "
                                 f"{isum['device_steps']} episode-steps")
        if any(isum["launches"].values()):
            raise AssertionError(f"int8 chunk: hand kernels launched {isum['launches']}")
        tf = isum["teacher_forced"]
        log(f"[{card}] int8 chunk: {isum['chunk_steps']} chunk-steps of {CHUNK} in "
            f"{isum['wall_s']:.2f} s with the calibration, the goal and the search; no hand "
            f"kernel launched; teacher-forced on the CPU ({tf['steps']} chunk-steps, "
            f"{tf['cpu_s']:.1f} s): flips per episode {tf['steps_with_flips']}, twists "
            f"within {tf['twist_max_abs_err']:.3e} on the {tf['episode_steps_compared']} "
            f"others; against chunk 1: first flip at {isum['alone']['first_flip_step']}, "
            f"twists within {isum['alone']['twist_max_abs_err']:.3e} before it "
            f"(tol {TWIST_TOL})")
        for fn in _counters().values():
            fn.launches = 0
        graph = compare_bench_graph(tnet32, amodel, scene)
        if any(fn.launches for fn in _counters().values()):
            raise AssertionError("the bench.py graph launched a hand kernel")
        log(f"bench.py graph (real_s518_pool2mmpre: K/V pooled before the projection, reshape "
            f"embed) against run AD's, goal + {N_STEPS} steps near the goal (logged): "
            f"{json.dumps(graph)}")
        gap = preprocess_gap(amodel, scene)
        log(f"'default' preprocess (one TF32 pass) against 'highest' on the goal view: "
            f"{json.dumps(gap)}; TF32 off again after it")

    with phase("3h classical"):
        ccfg = real64_config()
        log(f"classical baselines at configs/real64.yaml's settings (runs J, K and AN's), the "
            f"poster at {ccfg.u_max}x{ccfg.v_max}, episodes {CHUNK_EPISODES} of the "
            f"{CLASSICAL_STREAM}-episode stream as one chunk, {CLASSICAL_STEPS} steps, the "
            f"methods' default keypoints {json.dumps(DEFAULT_MAX_CORNERS)}")
        for method in CLASSICAL:
            with tempfile.TemporaryDirectory() as out:
                c = run_classical_chunk(method, ccfg, scene, out)
            log(f"classical {method}: {json.dumps(c)}")
            if any(c["launches"].values()):
                raise AssertionError(f"classical {method}: hand kernels launched {c['launches']}")
            if not 0 < c["chunk_steps"] <= CLASSICAL_STEPS or c["pairs_per_step"] < 4:
                raise AssertionError(f"classical {method}: {c['chunk_steps']} chunk-steps, "
                                     f"{c['pairs_per_step']} pairs a step")
            cpu = c["cpu"]
            log(f"[{card}] classical {method}: {c['chunk_steps']} chunk-steps of {CHUNK} in "
                f"{c['wall_s']:.2f} s with the goal; a second run equal bit for bit; no hand "
                f"kernel launched; against the CPU port ({cpu['cpu_s']:.1f} s): "
                f"{cpu['frames_with_same_keypoints']} of {cpu['frames']} frames with the same "
                f"keypoints, {cpu['frames_with_same_pairs']} with the same pairs, twists within "
                f"{cpu['twist_max_abs_err']:.3e} there (tol {CLASSICAL_TWIST_TOL}); "
                f"{cpu['hamming_distances_bit_for_bit']} Hamming distances bit for bit; "
                f"against chunk 1: first flip at {c['alone']['first_flip_step']}, twists within "
                f"{c['alone']['twist_max_abs_err']:.3e} before it")

    with phase("3i training"):
        log(f"training at full width: ViT-S/14, batch {TRAIN_BATCH}, bf16 blocks over f32 "
            f"weights; (a) and (c) on the real poster, (b) on the JAX run's {TRAIN_POSTER} "
            f"poster; bounds: (a) loss within {TRAIN_LOSS_RTOL} relative, "
            f"gradient cosines at least {TRAIN_GRAD_COS_MIN}; (b) steps 76-100 at most "
            f"{TRAIN_EARLY_MAX} and {TRAIN_EARLY_DROP} below steps 1-25; (c) matching quality "
            f"at least {TRAIN_QUALITY_MIN}, 25 resumed steps at most {TRAIN_RESUME_MAX}")
        g = check_train_grads(device)
        log(f"(a) one step at 308, batch 2, card against CPU: {json.dumps(g)}")
        tr = run_training(device, scene)
        sc, rs = tr["scratch"], tr["resume"]
        log(f"(b) {sc['steps']} steps from scratch at 308 ({sc['poster']} poster): mean loss "
            f"steps 1-25 "
            f"{sc['first_window']:.4f} (JAX {JAX_LOSS_WINDOWS[1, 25]}), steps 76-100 "
            f"{sc['last_window']:.4f} (JAX {JAX_LOSS_WINDOWS[76, 100]}); losses "
            f"{json.dumps([round(x, 4) for x in sc['losses']])}")
        q = rs["quality"]
        log(f"(c) trained ViT-S/14 @ 518: matching quality kernels {q['kernels']}, plain "
            f"{q['plain']} (JAX final {[1.0, 0.975]}), launches {json.dumps(q['launches'])}; "
            f"{TRAIN_RESUME_STEPS} resumed steps mean loss {rs['mean_loss']:.4f} (JAX last "
            f"window 1.468)")
        log(f"(d) saved, loaded and served: {json.dumps(tr['served'])}")
        want = {k: 0 for k in _counters()}
        # the goal's forward and the 8 views' one, a launch a block each; one batched match
        want.update(attention=2 * (tcfg.layer + 1), matcher_bf16=1)
        if q["launches"] != want:
            raise AssertionError(f"matching_quality: launch counts {q['launches']} != {want}")
        for k in ("attention", "matcher_bf16"):
            launches[k] += want[k]
        for name, part in (("308", sc), ("518", rs)):
            prof = part["profile"]
            log(f"[{card}] train step at {name}, batch {TRAIN_BATCH}: {part['ms_per_step']:.3f} "
                f"ms a step over the run (chains of {TRAIN_CHAIN}), profiled "
                f"{prof['wall_ms_per_step']:.3f} ms, device busy "
                f"{prof['device_ms_per_step']:.3f} ms = {100 * prof['busy_share']:.1f}%, "
                f"{prof['activities_per_step']:.0f} device activities a step, peak "
                f"{part['peak_bytes'] / 2 ** 30:.3f} GiB allocated")

    with phase("3j attention-scores"):
        sc = {}
        for score in SCORES:
            summ, steps, snet, smodel_s = run_score_step(score, device, scene)
            sc[score] = (steps, snet, smodel_s)
            log(f"(a) {score} bf16 step, ViT-S/14 @ 518 on ckpt_real518: {json.dumps(summ)}")
            log(f"(a) {score}: {sum(1 for f in summ['differing_pairs'] if f)} of {N_STEPS} "
                f"steps with pair flips; twists within {summ['twist_max_abs_err']:.3e} on the "
                f"{summ['steps_compared']} others (tol {TWIST_TOL}); launches "
                f"{json.dumps(summ['launches'])}")
            launches["matcher_bf16"] += N_STEPS
        summ, _, _, _ = run_score_step("relu", device, scene, kv_pool=2, seeded=True)
        log(f"(a) relupool (relu, 2 x 2 K/V pooling) bf16 step, seeded weights: "
            f"{json.dumps(summ)}")
        launches["matcher_bf16"] += N_STEPS
        prods = check_int8_products(device)
        log(f"(b) int8 products of 'qk+pv' and 'pv' at {SERVE_ATTN_SHAPE}: bit for bit the "
            f"int64 product on the card: {json.dumps(prods)}")
        prods = check_int8_products(device, shape=TRAINED_ATTN_SHAPE, seed=33)
        log(f"(b) the same at {TRAINED_ATTN_SHAPE}: {json.dumps(prods)}")
        prob = run_prob_variants(fnet, scfg, device)
        for variant, (ssum, _, _) in prob.items():
            log(f"(b) int8 {variant}, ViT-B/14 @ 518 (seeded): {json.dumps(ssum)}")
        launches["attention"] += prob["none"][0]["launches"]["attention"]
        log(f"(b) ViT-B/14 @ 518 twist gaps between the int8 variants: "
            f"{json.dumps(twist_gaps({k: v[0] for k, v in prob.items()}))}")
        tprob = run_trained_int8(tnet32, tcfg, device, scene, tsteps, variants=tuple(PROB_VARIANTS))
        for variant, g in tprob.items():
            kernel = PROB_VARIANTS[variant][2]
            want = {name: 0 for name in _counters()}
            if kernel is not None:
                want[kernel] = (tcfg.layer + 1) * (1 + N_STEPS)
            if g["summary"]["launches"] != want:
                raise AssertionError(f"trained int8 {variant}: launch counts "
                                     f"{g['summary']['launches']} != {want}")
            if kernel is not None:
                launches[kernel] += want[kernel]
            log(f"(b) trained ViT-S/14 @ 518 int8 {variant} (logged): "
                f"{json.dumps(g['summary'])}; vs the bf16 softmax step: pairs agreeing "
                f"{g['pairs_agreeing_with_bf16']} of {g['pairs']}, max |twist diff| "
                f"{g['twist_gap_to_bf16']:.4e}")
        log(f"(b) trained twist gaps between the int8 variants: "
            f"{json.dumps(twist_gaps({k: g['summary'] for k, g in tprob.items()}))}")
        rsteps, rnet, rmodel = sc["relu"]
        rint8 = run_trained_int8(tnet32, score_config("relu"), device, scene, rsteps,
                                 variants=("nomax3",))["nomax3"]
        if any(rint8["summary"]["launches"].values()):
            raise AssertionError(f"relu int8: hand kernels launched {rint8['summary']['launches']}")
        log(f"(c) relu on the int8 static path (calibrated through the scores, nomax3 "
            f"superseded): {json.dumps(rint8['summary'])}; vs the float relu step: pairs "
            f"agreeing {rint8['pairs_agreeing_with_bf16']} of {rint8['pairs']}, max |twist "
            f"diff| {rint8['twist_gap_to_bf16']:.4e}")
        fid = score_fidelity(tnet32, device, scene)
        log(f"(d) zero-shot fidelity on ckpt_real518 against softmax, {FID_VIEWS} start views "
            f"(informative, not a gate): {json.dumps(fid)}")
        # from ckpt_real518's weights: a seeded init's LayerScale of 1e-5 would leave
        # the attention, and so the scores, almost out of the loss
        rg = check_score_train_grads(device, {k: v.cpu() for k, v in tnet32.state_dict().items()})
        log(f"(e) one relu train step at 308, batch 2, from ckpt_real518, card against the "
            f"card machine's CPU, f32 and bf16 (bf16 gradients beside the f64 ones, "
            f"logged, not held): "
            f"{json.dumps(rg)}")

    with phase("3k vitg-attn-fastbin"):
        vg = run_vitg_phase(device, scene, tnet, tnet32, tmodel)
        gnet, gmodel = vg["gnet"], vg["gmodel"]
        vitg_launches = vg["launches"]

    with phase("3l pixel-mesh-sensors-live-native-profiling"):
        with tempfile.TemporaryDirectory() as out:
            px = run_pixel_phase(device, scene, tnet, tcfg, tmodel, Path(out))
        errs.update(px["errs"])
        launches.update(px["launches"])
        log(f"[{card}] pixel14 @ 308 bf16 servo_step median {px['pixel14_step_ms']:.3f} ms "
            f"(any-width attention and the bf16 matcher, kernels)")

    with phase("3m int8-tp-fastmath"):
        t3m = time.perf_counter()
        tp = run_int8_tp(irun.net, acfg, irun.model, scene)
        log(f"3m(a) int8 at run AD's settings on a (dp, tp) = {INT8_TP_MESH} grid of the one "
            f"card, episodes {tp['episodes']}, {tp['chunk_steps']} chunk-steps, "
            f"teacher-forced through the unsplit int8 ViT: {json.dumps(tp)}")
        tf = tp["teacher_forced"]
        log(f"[{card}] 3m(a) goal descriptors equal to the unsplit's to the bit; "
            f"{tf['episode_steps_bit_equal']} of {tf['episode_steps']} episode-steps' pairs "
            f"and twists equal to the bit; the run {tp['wall_s']:.2f} s with its "
            f"teacher-forcing")
        plant = run_int8_tp_plant(irun.net, acfg, irun.model, scene)
        log(f"3m(a) the check on a planted fault (two shards' proj columns swapped, "
            f"{plant['chunk_steps']} chunk-steps) fails {plant['failed']}: goal descriptors' "
            f"least row cosine {plant['goal_desc_row_cos_min']:.4f}, max |diff| / max |ref| "
            f"{plant['goal_desc_rel_err']:.3e}; teacher-forced {json.dumps(plant['teacher_forced'])}")
        tps = run_int8_tp_serving(
            {"fused": (*serving["F"], "attn_int8"), "none": (prob["none"][1], prob["none"][2],
                                                             "attention")}, scfg)
        for name, summ in tps.items():
            log(f"3m(b) int8 '{name}' ViT-B/14 @ 518 split over a (1, {INT8_TP_SERVE}) grid, "
                f"goal + {N_STEPS} steps against the unsplit: {json.dumps(summ)}")
            if summ["launches"] != summ["launches_on_the_card"]:
                raise AssertionError(f"3m(b) {name}: launches {summ['launches']} != "
                                     f"{summ['launches_on_the_card']}")
        launches["attn_int8"] += tps["fused"]["launches"]["attn_int8"]
        launches["attention"] += tps["none"]["launches"]["attention"]
        bl = check_bf16l(device)
        log(f"3m(c) bf16-logits attention vs plain (largest |diff| within {ATTN_TOL}, mean "
            f"|diff| at most {BF16L_MEAN_SHARE} of the exact kernel's to the same plain "
            f"version), two launches bit for bit: {json.dumps(bl)}")
        errs["attention_bf16l"] = bl[str(SERVE_ATTN_SHAPE)]["max_abs_err"]
        pmr = run_port_measure(device)
        log(f"3m(d) scripts/port_measure.py at ViT-B/14 @ 518 ({' '.join(MEASURE_CHAIN)}): "
            f"{json.dumps(pmr)}")
        launches["attention_bf16l"] = pmr["int8 fast-math"]["launches"]["attention_bf16l"]
        log(f"phase 3m took {time.perf_counter() - t3m:.1f} s")

    with phase("4 times"):
        step_ms = time_run(step_runner(net, model))
        log(f"[{card}] servo_step median {step_ms:.3f} ms (ViT-S/14 @ 308, bf16, kernels)")
        ms = time_run(step_runner(net32, model32))
        log(f"[{card}] servo_step median {ms:.3f} ms (ViT-S/14 @ 308, f32, exact GELU, kernels)")
        ms = time_run(step_runner(tnet, tmodel))
        log(f"[{card}] servo_step median {ms:.3f} ms (ViT-S/14 @ 518, bf16, trained, kernels)")
        for variant, (qnet, smodel) in serving.items():
            ms = time_run(step_runner(qnet, smodel))
            log(f"[{card}] servo_step median {ms:.3f} ms (ViT-B/14 @ 518, int8 W8A8, "
                f"variant {variant}, kernels)")
        # the scores and the int8-probability modes (phase 3j), in alternating rounds
        runners = {f"int8 {v}": step_runner(q, m) for v, (_, q, m) in prob.items()}
        for score in SCORES:
            runners[f"{score} bf16"] = step_runner(sc[score][1], sc[score][2])
        runners["softmax bf16"] = step_runner(tnet, tmodel)
        rounds = [{k: time_run(r) for k, r in runners.items()} for _ in range(TIMING_ROUNDS)]
        for k in runners:
            what = ("ViT-B/14 @ 518, int8 W8A8 static" if k.startswith("int8") else
                    "ViT-S/14 @ 518, trained weights")
            got = [r[k] for r in rounds]
            log(f"[{card}] servo_step median {statistics.median(got):.3f} ms ({k}, {what}; "
                f"spread {min(got):.3f} to {max(got):.3f} over {TIMING_ROUNDS} rounds: "
                f"{[round(x, 3) for x in got]})")
        for name, tm in int8_product_times(device).items():
            log(f"[{card}] int8_bmm '{name}' product at {SERVE_ATTN_SHAPE} (f32 products over "
                f"1024-deep chunks, exact): {tm['ms']:.4f} ms, bound {tm['bound_ms']:.5f} ms "
                f"({tm['bound_by']}, int8 peak)")
        rrun = {b: chunk_runner(rnet, rmodel, scene, b) for b in (1, CHUNK)}
        rrun.update({("softmax", b): chunk_runner(tnet, tmodel, scene, b) for b in (1, CHUNK)})
        rounds = [{k: time_run(r) for k, r in rrun.items()} for _ in range(TIMING_ROUNDS)]
        for k in rrun:
            b = k if isinstance(k, int) else k[1]
            got = [r[k] for r in rounds]
            ms = statistics.median(got)
            log(f"[{card}] closed-loop chunk step, B = {b} (ViT-S/14 @ 518, "
                f"{'relu' if isinstance(k, int) else 'softmax'} bf16, kernels): median "
                f"{ms:.3f} ms (spread {min(got):.3f} to {max(got):.3f} over {TIMING_ROUNDS} "
                f"rounds: {[round(x, 3) for x in got]}), "
                f"{ms * EPISODE_CAP / b / 1e3:.3f} card-s an episode at {EPISODE_CAP} steps")
        rt = score_train_step(tnet32, device, scene)
        log(f"[{card}] relu train step at 518, batch {TRAIN_BATCH} (from ckpt_real518): "
            f"{rt['ms_per_step']:.3f} ms a step, peak {rt['peak_bytes'] / 2 ** 30:.3f} GiB "
            f"allocated; losses {json.dumps([round(x, 4) for x in rt['losses']])}")
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
        for name, tm in time_trained_kernels(device).items():
            lib_ms = "none" if tm["library_ms"] is None else f"{tm['library_ms']:.4f} ms"
            log(f"[{card}] {name} at {tm['shape']} (ViT-S/14 @ 518): kernel {tm['ms']:.4f} ms, "
                f"plain {tm['plain_ms']:.4f} ms, library {lib_ms}, bound "
                f"{tm['bound_ms']:.5f} ms ({tm['bound_by']})")
        chunk_times = time_chunk_kernels(device)
        for name, tm in chunk_times.items():
            extra = {k: v for k, v in tm.items() if k.endswith("_ms") and k not in
                     ("ms", "plain_ms", "library_ms", "bound_ms")}
            log(f"[{card}] {name} at {tm['shape']}: kernel {tm['ms']:.4f} ms, plain "
                f"{tm['plain_ms']:.4f} ms, library {tm['library_ms']:.4f} ms, bound "
                f"{tm['bound_ms']:.5f} ms ({tm['bound_by']}) "
                + " ".join(f"{k} {v:.4f} ms" for k, v in extra.items()))
        times["matcher_bf16_batched"] = chunk_times["matcher_bf16_batched"]
        bounds["matcher_bf16_batched"] = matcher_bound_ms(TRAINED_MATCH_SHAPE, bf16=True,
                                                          nb=CHUNK)
        # the closed-loop chunk step on the trained weights, bf16 and int8 (run
        # AD's settings), in alternating rounds
        runners = {(kind, b): chunk_runner(n, m, scene, b) for b in LOOP_CHUNKS
                   for kind, n, m in (("bf16", tnet, tmodel), ("int8", irun.net, irun.model))}
        rounds = [{key: time_run(run) for key, run in runners.items()} for _ in range(3)]
        for kind, b in runners:
            ms = statistics.median(r[kind, b] for r in rounds)
            what = ("bf16, kernels" if kind == "bf16" else
                    "int8 at run AD's settings, no hand kernel")
            log(f"[{card}] closed-loop chunk step, B = {b} (ViT-S/14 @ 518, {what}, trained): "
                f"median {ms:.3f} ms a chunk-step (rounds "
                f"{[round(r[kind, b], 3) for r in rounds]}), {1e3 * b / ms:.1f} episode-steps "
                f"a second, {ms * EPISODE_CAP / b / 1e3:.3f} card-s an episode at "
                f"{EPISODE_CAP} steps")
        for method in CLASSICAL:
            for b in (1, CHUNK):
                ms = time_run(classical_runner(method, scene, b))
                log(f"[{card}] classical {method} chunk step, B = {b} (640x480, "
                    f"{DEFAULT_MAX_CORNERS[method]} keypoints, f32, no hand kernel): median "
                    f"{ms:.3f} ms a chunk-step, {ms * EPISODE_CAP / b / 1e3:.3f} card-s an "
                    f"episode at {EPISODE_CAP} steps")
        pooled = time_pooled_attention(device, irun.model.vit)
        log(f"[{card}] pooled nomax3 attention at (B, T, keys, h, hd) = {POOLED_ATTN_SHAPE} "
            f"(the int8 chunk's, plain PyTorch: no hand kernel on this path): "
            f"{json.dumps(pooled)}")
        vt = time_vitg_kernels(device)
        for name, tm in vt.items():
            extra = {k: v for k, v in tm.items() if k.endswith("_ms") and k not in
                     ("ms", "plain_ms", "library_ms", "bound_ms")}
            lib_ms = "none" if tm["library_ms"] is None else f"{tm['library_ms']:.4f} ms"
            log(f"[{card}] {name} at {tm['shape']} (ViT-g/14 @ 518): kernel {tm['ms']:.4f} ms, "
                f"plain {tm['plain_ms']:.4f} ms, library {lib_ms}, bound {tm['bound_ms']:.5f} ms "
                f"({tm['bound_by']}) " + " ".join(f"{k} {v:.4f} ms" for k, v in extra.items()))
        for name in ("attention_vitg", "matcher_bf16_vitg", "attn_int8_vitg"):
            times[name] = vt[name]
            bounds[name] = (vt[name]["bound_ms"], vt[name]["bound_by"])
        for name, tm in time_pixel_kernels(device).items():
            fma = ("" if "fma_bound_ms" not in tm else
                   f"; f32 FMA bound {tm['fma_bound_ms']:.5f} ms")
            log(f"[{card}] {name} at {tm['shape']}: kernel {tm['ms']:.4f} ms, plain "
                f"{tm['plain_ms']:.4f} ms, library (SDPA) {tm['library_ms']:.4f} ms, bound "
                f"{tm['bound_ms']:.5f} ms ({tm['bound_by']}){fma}")
            times[name] = tm
            bounds[name] = (tm["bound_ms"], tm["bound_by"])
        # the ViT-g step and chunk-step, materialized against factorized binning
        gfast = dataclasses.replace(gmodel, fast_binned_match=True)
        runners = {"step, materialized": step_runner(gnet, gmodel),
                   "step, factorized": step_runner(gnet, gfast),
                   f"chunk-step of {CHUNK}, materialized": chunk_runner(gnet, gmodel, scene, CHUNK),
                   f"chunk-step of {CHUNK}, factorized": chunk_runner(gnet, gfast, scene, CHUNK)}
        rounds = [{k: time_run(r, iters=VITG_TIMING_ITERS) for k, r in runners.items()}
                  for _ in range(TIMING_ROUNDS)]
        for k in runners:
            got = [r[k] for r in rounds]
            log(f"[{card}] ViT-g/14 @ 518 bf16 {k}: median {statistics.median(got):.3f} ms "
                f"(spread {min(got):.3f} to {max(got):.3f} over {TIMING_ROUNDS} rounds: "
                f"{[round(x, 3) for x in got]})")
        bt = time_bf16l_kernels(device)
        for name, tm in bt.items():
            log(f"[{card}] attention_bf16l at {name}: kernel {tm['ms']:.4f} ms, exact kernel "
                f"(f32 scores) {tm['exact_f32_scores_ms']:.4f} ms, plain {tm['plain_ms']:.4f} "
                f"ms, library (SDPA) {tm['library_ms']:.4f} ms, bound {tm['bound_ms']:.5f} ms "
                f"({tm['bound_by']})")
        times["attention_bf16l"] = bt[str(SERVE_ATTN_SHAPE)]
        bounds["attention_bf16l"] = (times["attention_bf16l"]["bound_ms"],
                                     times["attention_bf16l"]["bound_by"])
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
               "attn_int8": ("vitvs_tpu_torch/csrc/attn_int8.cu", "vitvs_tpu/ops/attn_int8.py:80"),
               # the bf16 matcher with its batch axis, at the chunk's (8, 1369, 1369, 3456)
               "matcher_bf16_batched": ("vitvs_tpu_torch/csrc/matcher.cu",
                                        "vitvs_tpu/ops/matcher.py:39"),
               # kernels 1, 2a and 4 at ViT-g/14 @ 518's shapes (phase 3k)
               "attention_vitg": ("vitvs_tpu_torch/csrc/attention.cu",
                                  "vitvs_tpu/ops/attention.py:42"),
               "matcher_bf16_vitg": ("vitvs_tpu_torch/csrc/matcher.cu",
                                     "vitvs_tpu/ops/matcher.py:39"),
               "attn_int8_vitg": ("vitvs_tpu_torch/csrc/attn_int8.cu",
                                  "vitvs_tpu/ops/attn_int8.py:80"),
               # kernels 1 and 1b at other head widths: pixel14's (bf16) and pixel8's (f32)
               "attention_hd": ("vitvs_tpu_torch/csrc/attention_hd.cu",
                                "vitvs_tpu/ops/attention.py:42"),
               "attention_hd_f32": ("vitvs_tpu_torch/csrc/attention_hd.cu",
                                    "vitvs_tpu/ops/attention.py:42"),
               # kernel 1's bf16-logits variant (softmax_f32=False), at ViT-B/14 @ 518's int8
               # 'none' shape: the reference computes it in XLA's plain softmax
               # (vitvs_tpu/models/vit.py:445-447), the port on the exact kernel
               "attention_bf16l": ("vitvs_tpu_torch/csrc/attention.cu",
                                   "vitvs_tpu/ops/attention.py:42")}
    launches.update({f"{k}_vitg": v for k, v in vitg_launches.items()})
    kernels = [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], "max_abs_err": errs[name],
         "ms": times[name]["ms"], "plain_ms": times[name]["plain_ms"],
         "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
         "library_ms": times[name]["library_ms"]}
        for name, (src, rep) in sources.items()]
    # the trained weights phase 3e ran on: file, size, config
    print(json.dumps({"kernels": kernels, "weights": tinfo}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
