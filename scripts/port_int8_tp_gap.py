"""Where a tensor-parallel shard's 'nomax3' attention departs from the
whole's, op by op.

    python scripts/port_int8_tp_gap.py [--device cuda|cpu] [--tp 2] [--batch 1 4 8]

On seeded bf16 q, k, v at run AD's attention shape (B, 1370 tokens, 6 heads
of 64; K/V pooled 2 x 2 by the matrix to 362 keys; q drawn with a std of
16, so that the logits span the clamp's range as a trained ViT's do), each
op of the int8 ViT's 'nomax3' attention (``models/quant.py:
_nomax_attention``) runs on a shard's h / tp heads and is compared with the
same op on all the heads, sliced to the shard's.  Each op takes the
whole's inputs, sliced, so a difference is that op's own: the pooled K and
V, the logits product, exp2, the denominators (as the port sums them, in
f64, and as the reference does, in f32), the P.V product, and the output.
Prints one JSON line a batch size: for each op, the share of the shard's
elements that differ from the whole's and the largest difference.
``--trained N`` then does the same on the q, k, v of every block of run
AD's int8 ViT (``chip_smoke.py``'s: the trained ViT-S/14 @ 518, static
scales from the seed-41 stream) on N start views of that stream, one line
a block.  Last, the card's name and power limit (nvidia-smi).  Runs on the
card by default.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from vitvs_tpu_torch.models.vit import ViTConfig, pool_kv  # noqa: E402

T, HEADS, HD, POOL = 1370, 6, 64, 2
Q_STD = 16.0


def _ops(q, k, v, clamp: float) -> dict:
    """The 'nomax3' attention's intermediates, as ``_nomax_attention``
    computes them after ``pool_kv``."""
    dt, hd = q.dtype, q.shape[-1]
    kp, vp = pool_kv(k, POOL, "matmul"), pool_kv(v, POOL, "matmul")
    qs = q * torch.tensor(math.log2(math.e) / math.sqrt(hd), dtype=dt, device=q.device)
    logits = torch.einsum("bqhd,bkhd->bhqk", qs, kp)
    e = torch.exp2(torch.minimum(logits, torch.tensor(clamp * math.log2(math.e), dtype=dt,
                                                      device=q.device)))
    denom = torch.clamp(e.sum(-1, dtype=torch.float64).float(), min=1e-30)
    pv = torch.einsum("bhqk,bkhd->bqhd", e.to(dt), vp)
    out = (pv.float() / denom.transpose(1, 2)[..., None]).to(dt)
    return {"qs": qs, "kp": kp, "vp": vp, "logits": logits, "e": e, "denom": denom,
            "pv": pv, "out": out}


def _diff(a: torch.Tensor, b: torch.Tensor) -> dict:
    d = (a.float() - b.float()).abs()
    return {"share_differing": (d > 0).float().mean().item(), "max_abs_diff": d.max().item()}


def gaps(batch: int, tp: int, device: str, seed: int = 0) -> dict:
    """:func:`op_gaps` on seeded bf16 q, k, v of ``batch`` images."""
    rs = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rs.standard_normal((batch, T, HEADS, HD)).astype(np.float32)
                                * std).to(device, torch.bfloat16) for std in (Q_STD, 1.0, 1.0))
    return op_gaps(q, k, v, tp)


def op_gaps(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, tp: int) -> dict:
    """The shards' op-by-op differences from the whole on (B, T, h, hd) q,
    k, v: for each op, the largest share and difference over the shards."""
    clamp = ViTConfig.nomax_clamp
    device = q.device
    w = _ops(q, k, v, clamp)
    n = q.shape[2] // tp
    out: dict = {}
    for s in range(tp):
        h = slice(s * n, (s + 1) * n)
        cut = lambda t: t[:, :, h].contiguous()          # noqa: E731  (B, T, h, ...)
        cut_bh = lambda t: t[:, h].contiguous()          # noqa: E731  (B, h, ...)
        c = clamp * math.log2(math.e)
        got = {
            "pooled_k": (pool_kv(cut(k), POOL, "matmul"), cut(w["kp"])),
            "pooled_v": (pool_kv(cut(v), POOL, "matmul"), cut(w["vp"])),
            "logits": (torch.einsum("bqhd,bkhd->bhqk", cut(w["qs"]), cut(w["kp"])),
                       cut_bh(w["logits"])),
            "exp2": (torch.exp2(torch.minimum(cut_bh(w["logits"]), torch.tensor(
                c, dtype=q.dtype, device=device))), cut_bh(w["e"])),
            "denominator": (torch.clamp(cut_bh(w["e"]).sum(-1, dtype=torch.float64).float(),
                                        min=1e-30), cut_bh(w["denom"])),
            "denominator_f32_sum": (cut_bh(w["e"]).sum(-1, dtype=torch.float32),
                                    w["e"].sum(-1, dtype=torch.float32)[:, h]),
            "pv": (torch.einsum("bhqk,bkhd->bqhd", cut_bh(w["e"]).to(q.dtype), cut(w["vp"])),
                   cut(w["pv"])),
            "attention": (_ops(cut(q), cut(k), cut(v), clamp)["out"], cut(w["out"])),
        }
        for name, (a, b) in got.items():
            r = _diff(a, b)
            prev = out.get(name, {"share_differing": 0.0, "max_abs_diff": 0.0})
            out[name] = {key: max(prev[key], r[key]) for key in r}
    return out


def trained_gaps(device: str, tp: int, views: int):
    """:func:`op_gaps` on each block's q, k, v of run AD's int8 ViT (the
    blocks fed the unsplit's output) on ``views`` start views, a dict a
    block."""
    import chip_smoke as cs
    from vitvs_tpu_torch.harness.pipeline import ServoModel, preprocess
    from vitvs_tpu_torch.harness.samplers import generate_episode_starts
    from vitvs_tpu_torch.models.quant import _block_q
    from vitvs_tpu_torch.sim.env import observe
    from vitvs_tpu_torch.sim.scene import load_poster_scene

    tnet32, _ = cs.load_trained(ServoModel.create(cs.trained_config(), device=device))
    scene = load_poster_scene(device=device)
    acfg = cs.ad_config()
    qnet, qmodel = cs.int8_serving_of_stream(tnet32, ServoModel.create(acfg, device=device),
                                             scene)
    cfg = qmodel.vit
    pos, quat, _ = generate_episode_starts(acfg)
    pose = lambda a, i: torch.tensor(a[i], dtype=torch.float32, device=device)  # noqa: E731
    rgb = [observe(scene, qmodel.camera, pose(pos, i), pose(quat, i))[0] for i in range(views)]
    with torch.inference_mode():
        x = qnet.embed(torch.stack([preprocess(qmodel, f) for f in rgb]))
        for i, blk in enumerate(qnet.blocks):
            qkv = blk.qkv(blk.norm1(x, cfg.ln_f32), blk.act(0))
            B, T, _ = qkv.shape
            q, k, v = qkv.reshape(B, T, 3, cfg.num_heads, cfg.head_dim).permute(
                2, 0, 1, 3, 4).contiguous().unbind(0)
            yield {"block": i, "gaps": op_gaps(q, k, v, tp)}
            x = _block_q(x, blk, cfg, True)


def device_line(device: str) -> str:
    """The card's name and power limit as nvidia-smi gives them, or the CPU."""
    if device == "cpu":
        return "device cpu (no card measured)"
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return res.stdout.strip().splitlines()[torch.cuda.current_device()]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--tp", type=int, default=2, choices=(2, 3, 6))
    ap.add_argument("--batch", type=int, nargs="+", default=[1, 4, 8])
    ap.add_argument("--trained", type=int, default=0, metavar="N",
                    help="also run AD's int8 ViT on N start views (0: not)")
    args = ap.parse_args(argv)
    for b in args.batch:
        print(json.dumps({"batch": b, "tp": args.tp, "gaps": gaps(b, args.tp, args.device)}),
              flush=True)
    if args.trained:
        for r in trained_gaps(args.device, args.tp, args.trained):
            print(json.dumps({"trained_views": args.trained, "tp": args.tp, **r}), flush=True)
    print(device_line(args.device))
    return 0


if __name__ == "__main__":
    sys.exit(main())
