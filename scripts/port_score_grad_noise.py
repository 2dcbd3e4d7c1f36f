#!/usr/bin/env python3
"""How far the bf16 gradients of one train step lie from the f64 ones, per
parameter, on the card and on the CPU, for the relu and softmax attention
scores, over several servo pair batches: the readings behind chip_smoke.py
3j(e), which holds the card's relu train step against the CPU's in f32 and
only logs its bf16 gradients.

    python scripts/port_score_grad_noise.py [--seeds 1 2 3 4] [--size 308]
        [--batch 2] [--attn32-seeds 1 2] [--out chiprun_out/score_grad_noise.json]

Runs on a machine with a CUDA card (the f64 and CPU steps run on its CPU),
from the trained ViT-S/14 @ 518 weights (vitvs_tpu_torch/assets/ckpt_real518.npz)
as 3j(e) does.  For each score and batch seed it prints the loss of each
step, the least cosine to the f64 gradient on the card and on the CPU, and
the parameters where the card lies furthest below the CPU, with the q, k
and v thirds of that block's qkv bias.  ``--attn32-seeds``: for relu on
those seeds, also the same steps with the attention computed in f32 from
the bf16 q, k, v (a more accurate attention, to see whether the distance
to f64 follows the attention's precision).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
from pathlib import Path

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[1, 2, 3, 4])
    ap.add_argument("--scores", nargs="+", default=["relu", "softmax"])
    ap.add_argument("--size", type=int, default=308)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--attn32-seeds", type=int, nargs="*", default=[1, 2])
    ap.add_argument("--threads", type=int, default=8)
    ap.add_argument("--out", type=Path, default=Path("chiprun_out/score_grad_noise.json"))
    args = ap.parse_args()

    import torch

    import chip_smoke as C
    from vitvs_tpu_torch.harness.pipeline import ServoModel
    from vitvs_tpu_torch.models import vit as V
    from vitvs_tpu_torch.sim.scene import load_poster_scene
    from vitvs_tpu_torch.train.finetune import _servo_batch_loss, make_servo_pair_batch

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    torch.set_num_threads(args.threads)
    card = torch.device("cuda")
    net0, _ = C.load_trained(ServoModel.create(C.trained_config(), device="cpu"))
    state_dict = {k: v.cpu() for k, v in net0.state_dict().items()}
    scene = load_poster_scene(device="cpu")
    score_attention = V.score_attention

    def attn32(q, k, v, cfg, out_dtype, score_dtype):
        return score_attention(q.float(), k.float(), v.float(), cfg, torch.float32,
                               score_dtype=torch.float32).to(out_dtype)

    def step(score, dtype, device, seed, attention=score_attention):
        vit = dataclasses.replace(C.train_model(args.size, "cpu").vit, attn_score=score)
        base = C.train_model(args.size, "cpu", vit=vit)
        goal, data = make_servo_pair_batch(base, scene, torch.Generator().manual_seed(seed),
                                           args.batch)
        wdt = torch.float64 if dtype == torch.float64 else torch.float32
        net = V.ViT.from_state_dict(vit, state_dict).to(device, wdt)
        cast = lambda t: t.to(device, wdt) if t.is_floating_point() else t.to(device)
        V.score_attention = attention
        try:
            loss = _servo_batch_loss(net, dataclasses.replace(base, compute_dtype=dtype,
                                                              device=device),
                                     cast(goal), {k: cast(v) for k, v in data.items()})
            loss.backward()
        finally:
            V.score_attention = score_attention
        return loss.item(), {n: p.grad.double().cpu().flatten() for n, p in net.named_parameters()}

    def cos(a, b):
        na, nb = a.norm().item(), b.norm().item()
        return 1.0 if na == nb == 0.0 else (a @ b).item() / max(na * nb, 1e-300)

    out, t0 = {}, time.perf_counter()
    for score in args.scores:
        for seed in args.seeds:
            loss64, g64 = step(score, torch.float64, "cpu", seed)
            runs = {"cpu": step(score, torch.bfloat16, "cpu", seed),
                    "card": step(score, torch.bfloat16, card, seed)}
            if score == "relu" and seed in args.attn32_seeds:
                runs["card_attn32"] = step(score, torch.bfloat16, card, seed, attn32)
                runs["cpu_attn32"] = step(score, torch.bfloat16, "cpu", seed, attn32)
            c = {k: {n: cos(g[n], g64[n]) for n in g64} for k, (_, g) in runs.items()}
            gap = {n: c["cpu"][n] - c["card"][n] for n in g64}
            top = sorted(gap, key=gap.get, reverse=True)[:5]
            rec = {"loss_f64": loss64, "loss": {k: l for k, (l, _) in runs.items()},
                   "f64_cos_min": {k: [min(v, key=v.get), min(v.values())] for k, v in c.items()},
                   "gap_max": [top[0], gap[top[0]]], "gap_min": min(gap.values()),
                   "top_gaps": {n: {k: c[k][n] for k in c} for n in top}}
            if top[0].startswith("blocks."):
                name = f"blocks.{top[0].split('.')[1]}.attn.qkv.bias"
                d = g64[name].numel() // 3
                rec["qkv_bias_thirds"] = {
                    "param": name,
                    **{k: [cos(g[name][i * d:(i + 1) * d], g64[name][i * d:(i + 1) * d])
                           for i in range(3)] for k, (_, g) in runs.items()}}
            out[f"{score}/{seed}"] = rec
            print(f"{score} seed {seed}: {json.dumps(rec)} "
                  f"[{time.perf_counter() - t0:.1f} s]", flush=True)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps({"card": torch.cuda.get_device_name(0), "size": args.size,
                                    "batch": args.batch, "runs": out}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
