"""Per-component timings of the PyTorch port (``scripts/measure.py``'s modes).

Usage: python scripts/port_measure.py [desc|step|match|attn|pre] [--quant] ...
        [--device cuda|cpu]

Builds the graph ``scripts/measure.py`` times (the ``VSConfig`` at
``--size`` with layer 11, the ``dls`` solve and binning unless
``--no-bin``; seeded weights on the device, seeded frames) with the port,
and prints the time of one iteration by the slope between a long and a
short chain: the best of ``--reps`` wall times of a chain of n iterations,
one synchronize at each chain's end, then (long - short) / (n_long -
n_short).  The last line is ``measure.py``'s; the line before it names the
card and its power limit (``nvidia-smi``), or says the run was on the CPU,
which measures no card.

Modes: ``pre`` the preprocess; ``desc`` preprocess + the facet forward +
binning; ``match`` ``find_correspondences`` of the goal against seeded
random descriptors; ``attn`` the ViT's attention dispatch
(``models/vit.attention_core``) on (1, t, h, hd) bf16 (with the defaults
the exact kernel, as measure.py's ``mha_attention`` call); ``step`` the
servo step with its EMA threaded.  ``--fast-math`` sets tanh GELU,
``ln_f32=False`` and ``softmax_f32=False``; ``--softmax-bf16`` the last
alone.  ``--unroll`` (XLA's scan unrolling) has no meaning in PyTorch and
is refused.  Runs on the card by default (``--device cuda``, which fails
without one) and on the CPU when asked.

On the source-quantized int8 path (``--quant`` with binning) the goal
descriptors are a ``QuantizedBinned``: the goal line prints its int8 rows'
shape, and ``match`` draws seeded int8 rows (where measure.py reads the
tuple's ``.shape`` and stops).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from vitvs_tpu_torch.control.ibvs import EmaState  # noqa: E402
from vitvs_tpu_torch.harness.pipeline import (  # noqa: E402
    ServoModel, goal_descriptors, preprocess, servo_step)
from vitvs_tpu_torch.io_bridge.config import VSConfig  # noqa: E402
from vitvs_tpu_torch.match.binned import QuantizedBinned  # noqa: E402
from vitvs_tpu_torch.match.correspondence import find_correspondences  # noqa: E402
from vitvs_tpu_torch.models.extractor import extract_descriptors  # noqa: E402
from vitvs_tpu_torch.models.quant import quantize_vit_params  # noqa: E402
from vitvs_tpu_torch.models.vit import attention_core, init_vit  # noqa: E402

MODES = ("desc", "step", "match", "attn", "pre")
N_FRAMES = 4


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("what", choices=list(MODES))
    ap.add_argument("--bf16-params", action="store_true")
    ap.add_argument("--chain", type=int, default=45)
    ap.add_argument("--chain-short", type=int, default=5)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--model", default="dinov2_vitb14")
    ap.add_argument("--no-bin", action="store_true")
    ap.add_argument("--attn", default="auto", choices=["auto", "xla", "pallas"])
    ap.add_argument("--unroll", type=int, default=1,
                    help="measure.py's scan unrolling: only 1 (refused otherwise)")
    ap.add_argument("--gelu-approx", action="store_true")
    ap.add_argument("--fast-math", action="store_true",
                    help="gelu approx + bf16 LN + bf16 softmax")
    ap.add_argument("--softmax-bf16", action="store_true", help="bf16 softmax only")
    ap.add_argument("--quant", action="store_true", help="int8 W8A8 ViT path")
    ap.add_argument("--static-scales", action="store_true",
                    help="calibrated static qkv/fc1 activation scales")
    ap.add_argument("--size", type=int, default=518)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.unroll != 1:
        ap.error(f"--unroll {args.unroll}: scan unrolling is an XLA lowering choice with no "
                 f"meaning in PyTorch (the port refuses it, as it refuses 'einsum6')")
    if args.chain <= args.chain_short:
        ap.error("--chain must be longer than --chain-short")
    return args


def device_line(device: str) -> str:
    """The card's name and power limit as nvidia-smi gives them, or the CPU."""
    if device == "cpu":
        return "device cpu (no card measured)"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[torch.cuda.current_device()]


def build_model(args) -> tuple[ServoModel, VSConfig]:
    cfg = VSConfig(dino_input_size=args.size, model_name=args.model, layer=11, pinv_mode="dls",
                   use_feature_binning=not args.no_bin)
    model = ServoModel.create(cfg, compute_dtype=torch.bfloat16, device=args.device,
                              attn_impl=args.attn, quantized=args.quant)
    vit_kw = {"gelu_approx": args.gelu_approx}
    if args.fast_math:
        vit_kw.update(gelu_approx=True, ln_f32=False, softmax_f32=False)
    if args.softmax_bf16:
        vit_kw.update(softmax_f32=False)
    return dataclasses.replace(model, vit=dataclasses.replace(model.vit, **vit_kw)), cfg


def build_net(args, model: ServoModel, rng: np.random.Generator):
    """Seeded weights (a generator of the device, seed 0): the float ViT
    with its blocks in bf16 (every parameter with ``--bf16-params``), or
    the int8 ViT quantized from the f32 weights, with static scales
    calibrated on 2 seeded frames at ``--size`` (``--static-scales``)."""
    dev = torch.device(args.device)
    net = init_vit(model.vit, torch.Generator(device=dev).manual_seed(0), device=dev).eval()
    if args.bf16_params:
        net = net.to(torch.bfloat16)
    if not args.quant:
        return net.cast_blocks(model.compute_dtype)
    calib = None
    if args.static_scales:
        calib = torch.from_numpy(rng.random((2, args.size, args.size, 3)).astype(np.float32))
        calib = calib.to(dev)
    return quantize_vit_params(net, model.vit, calib, layer=model.cfg.layer,
                               compute_dtype=model.compute_dtype)


def random_descriptors(goal, rng: np.random.Generator, device) -> list:
    """N_FRAMES seeded random descriptors shaped as the goal's: normal rows
    in its dtype, or int8 rows with their sums of squares."""
    if isinstance(goal, QuantizedBinned):
        qs = torch.from_numpy(rng.integers(-127, 128, (N_FRAMES, *goal.q.shape), np.int8))
        return [QuantizedBinned(q.to(device), q.float().square().sum(-1).to(device)) for q in qs]
    descs = torch.from_numpy(rng.standard_normal((N_FRAMES, *goal.shape)).astype(np.float32))
    return list(descs.to(device, goal.dtype))


def make_chain(args, model: ServoModel, cfg: VSConfig, net, goal, frames, depth, rng):
    """fn(n, seed) running n iterations of the mode; the result is a tensor
    that depends on every iteration."""
    dev = torch.device(args.device)
    grid = model.grid()
    t = grid[0] * grid[1]
    if args.what == "match":
        descs = random_descriptors(goal, rng, dev)
    if args.what == "attn":
        h, hd = model.vit.num_heads, model.vit.head_dim
        qs = torch.from_numpy(rng.standard_normal((N_FRAMES, 1, t + 1, h, hd)).astype(np.float32))
        qs = list(qs.to(dev, torch.bfloat16))

    @torch.inference_mode()
    def run(n: int, seed: int) -> torch.Tensor:
        gen = torch.Generator(device=dev).manual_seed(seed)
        acc = torch.zeros((), device=dev)
        if args.what == "step":
            ema, v = EmaState.init(device=dev), torch.zeros(6, device=dev)
            for i in range(n):
                res = servo_step(net, model, goal, frames[i % N_FRAMES], depth, ema, v,
                                 generator=gen)
                ema, v = res.ema, res.v_c
            return v
        for i in range(n):
            if args.what == "pre":
                acc = acc + preprocess(model, frames[i % N_FRAMES]).sum()
            elif args.what == "desc":
                x = preprocess(model, frames[i % N_FRAMES])[None]
                d = extract_descriptors(net, x, layer=cfg.layer, facet="token",
                                        bin=cfg.use_feature_binning,
                                        use_kernels=model.use_kernels,
                                        quantized=model.quantized)[0, 0]
                acc = acc + d.float().sum()
            elif args.what == "match":
                scores = torch.rand(t, generator=gen, device=dev)
                m = find_correspondences(goal, descs[i % N_FRAMES], grid, cfg.num_pairs, scores,
                                         use_kernel=model.use_kernels and not model.quantized,
                                         int8=model.quantized,
                                         use_match_kernel=model.use_match_kernel)
                acc = acc + m.points1.sum() + m.sim.sum()
            else:
                q = qs[i % N_FRAMES]
                o = attention_core(q, q, q, model.use_kernels, model.vit.attn_impl,
                                   model.vit.softmax_f32)
                acc = acc + o.float().sum()
        return acc

    return run


def _sync(device: str) -> None:
    if device != "cpu":
        torch.cuda.synchronize(device)


def main(argv=None) -> dict:
    """Time the mode; returns {'what', 'ms_per_iter', 'chain_s', 'line', 'device'}."""
    args = parse_args(argv)
    if args.device != "cpu" and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: no CUDA device (pass --device cpu to run "
                         f"on the CPU, which measures no card)")
    model, cfg = build_model(args)
    rng = np.random.default_rng(0)
    net = build_net(args, model, rng)
    dev = torch.device(args.device)
    frames = [torch.from_numpy(f).to(dev)
              for f in rng.random((N_FRAMES, 480, 640, 3), np.float32)]
    depth = torch.full((480, 640), 0.61, device=dev)
    goal = goal_descriptors(net, model, frames[0])
    shape = tuple((goal.q if isinstance(goal, QuantizedBinned) else goal).shape)
    print(f"[measure] goal desc shape {shape}", flush=True)
    run = make_chain(args, model, cfg, net, goal, frames, depth, rng)
    n_long, n_short = args.chain, args.chain_short
    times = {}
    for n in (n_short, n_long):
        t0 = time.perf_counter()
        out = run(n, 0)
        _sync(args.device)
        if not torch.isfinite(out).all():
            raise AssertionError(f"{args.what}: a chain of {n} gave non-finite values")
        print(f"[measure] chain {n}: first {time.perf_counter() - t0:.1f}s", flush=True)
        best = float("inf")
        for r in range(args.reps):
            t0 = time.perf_counter()
            run(n, r + 1)
            _sync(args.device)
            best = min(best, time.perf_counter() - t0)
        times[n] = best
    per = (times[n_long] - times[n_short]) / (n_long - n_short) * 1000
    dline = device_line(args.device)
    line = (f"[measure] {args.what} ({args.model}@{args.size}, "
            f"{'bf16' if args.bf16_params else 'f32'} params, attn={args.attn}, "
            f"quant={args.quant}, bin={not args.no_bin}, unroll={args.unroll}): "
            f"{per:.3f} ms/iter  ({1000 / per if per > 0 else float('nan'):.1f} Hz)")
    print(dline, flush=True)
    print(line, flush=True)
    return {"what": args.what, "ms_per_iter": per, "chain_s": times, "line": line,
            "device": dline}


if __name__ == "__main__":
    main()
