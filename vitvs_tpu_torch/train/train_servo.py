"""Train servo descriptors in the simulator and save them
(``scripts/train_servo.py``).

Trains the reference operating model (DINOv2-architecture ViT-S/14 @ 308,
layer 11) from random init, or from ``--resume`` weights, with the
goal-view / episode-view InfoNCE objective (``train/finetune.py``) on the
benchmark poster, and saves the weights as an exported weight file
(``models/convert.save_exported``, f32) that ``load_exported`` and the
command line's ``--checkpoint`` read:

    python -m vitvs_tpu_torch.train.train_servo --out ckpt_vits308.npz \\
        [--steps 2000] [--batch 8] [--size 308] [--model dinov2_vits14] \\
        [--resume weights.npz|weights.pth] [--device cuda|cpu]

Every flag of the reference keeps its default; ``--device`` (default
``cuda``) and ``--budget-s`` are the port's.  Every ``--chain`` x 8 steps it
prints the serving-path matching quality (8 views) and, before the last
step, saves a part checkpoint: ``<out>.part.npz`` (the weights, which ``--resume`` takes, with
``--steps`` the remainder and the schedule restarted, as in the reference),
``<out>.part.json`` (the steps done and the run's arguments) and
``<out>.part.state.pt`` (the optimizer, the schedule, the sampler's
generator and the losses so far).  A run started again with the same
arguments continues from the part exactly where it stopped; ``--budget-s``
stops a run at the first chain boundary after that many seconds and saves
its part.  The finished run writes ``<out>``, ``<out>.trainlog.json``
(``loss``, ``final_matching``, ``args``) and removes the part.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import torch

# the arguments that must agree for a part checkpoint to be continued
_PART_KEYS = ("steps", "batch", "chain", "lr", "warmup", "size", "model", "layer", "seed",
              "poster", "perturb_prob", "resume", "attn_score", "remat", "kv_pool", "ls_init")


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", required=True, help="the weight file to write (.npz)")
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--chain", type=int, default=25,
                    help="train steps between host syncs")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=100)
    ap.add_argument("--size", type=int, default=308)
    ap.add_argument("--model", default="dinov2_vits14")
    ap.add_argument("--layer", type=int, default=11)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--poster", default=None,
                    help="texture image, or 'synthetic' (default: the reference's real poster)")
    ap.add_argument("--perturb-prob", type=float, default=0.5)
    ap.add_argument("--resume", default=None,
                    help="weights to start from: an exported .npz or a torch-hub .pth")
    ap.add_argument("--attn-score", default="softmax", choices=["softmax", "relu", "sqrelu"],
                    help="attention score to co-train for (ViTConfig.attn_score)")
    ap.add_argument("--remat", action="store_true",
                    help="recompute each block in the backward pass (ViTConfig.remat_blocks)")
    ap.add_argument("--kv-pool", type=int, default=1,
                    help="K/V patch-grid pooling to co-train for (ViTConfig.kv_pool)")
    ap.add_argument("--ls-init", type=float, default=None,
                    help="LayerScale init for from-scratch training (default 1e-5; ignored "
                         "with --resume)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--budget-s", type=float, default=None,
                    help="stop at the first chain boundary after this many seconds, saving "
                         "the part checkpoint")
    return ap.parse_args(argv)


def scene_of(poster: str | None, device):
    """The scene of ``--poster``: the synthetic poster, an image file, or (None)
    the real poster."""
    from vitvs_tpu_torch.io_bridge.images import load_image
    from vitvs_tpu_torch.sim.scene import Scene, load_poster_scene, make_synthetic_poster

    if poster == "synthetic":
        return Scene.create(make_synthetic_poster(512, seed=0), device=device)
    if poster:
        return Scene.create(load_image(poster), device=device)
    return load_poster_scene(device=device)


def _paths(out: str) -> dict[str, str]:
    return {"part": out + ".part.npz", "json": out + ".part.json",
            "state": out + ".part.state.pt", "trainlog": out + ".trainlog.json"}


def _weights(path: str, vit_cfg, device) -> torch.nn.Module:
    """A ViT of ``vit_cfg`` with the f32 weights of ``path`` (an exported
    .npz or a torch-hub file; an orbax directory raises)."""
    from vitvs_tpu_torch.io_bridge.cli import load_checkpoint
    from vitvs_tpu_torch.io_bridge.config import VSConfig
    from vitvs_tpu_torch.models.vit import ViT

    src = load_checkpoint(path, VSConfig(model_name=vit_cfg.model_name), "cpu")
    return ViT.from_state_dict(vit_cfg, src.state_dict()).to(device)


def train(args: argparse.Namespace, budget_s: float | None = None, log=print) -> dict:
    """The run of ``args``; returns {"finished", "done", "loss" (every step's
    loss so far), "init_matching", "final_matching", "ms_per_step"}."""
    import dataclasses

    from vitvs_tpu_torch.harness.pipeline import ServoModel
    from vitvs_tpu_torch.io_bridge.config import VSConfig
    from vitvs_tpu_torch.models.convert import save_exported
    from vitvs_tpu_torch.models.vit import init_vit
    from vitvs_tpu_torch.train.finetune import (init_train_state, make_servo_train_epoch,
                                                matching_quality, warmup_cosine_decay_schedule)

    budget_s = args.budget_s if budget_s is None else budget_s
    cfg = VSConfig(dino_input_size=args.size, model_name=args.model, layer=args.layer,
                   attn_score=args.attn_score, kv_pool=args.kv_pool)
    model = ServoModel.create(cfg, compute_dtype=torch.bfloat16, device=args.device)
    if args.remat:
        model = dataclasses.replace(model, vit=dataclasses.replace(model.vit, remat_blocks=True))
    scene = scene_of(args.poster, args.device)
    paths = _paths(args.out)
    every = args.chain * 8
    fingerprint = {k: getattr(args, k) for k in _PART_KEYS}

    def quality(seed: int) -> tuple[float, float]:
        return matching_quality(state.net, model, scene, torch.Generator().manual_seed(seed))

    part = None
    if os.path.exists(paths["json"]) and os.path.exists(paths["state"]):
        with open(paths["json"]) as fh:
            part = json.load(fh)
        if part.get("args") != fingerprint:
            part = None
    if part is not None:
        net = _weights(paths["part"], model.vit, args.device)
        log(f"[train] continuing {paths['part']} at step {part['done']}/{args.steps}")
    elif args.resume:
        net = _weights(args.resume, model.vit, args.device)
        log(f"[train] resumed params from {args.resume}")
    else:
        net = init_vit(model.vit, torch.Generator().manual_seed(args.seed), device=args.device,
                       layerscale=args.ls_init)
        if args.ls_init is not None:
            log(f"[train] LayerScale init overridden to {args.ls_init}")
    net.train()
    sched = warmup_cosine_decay_schedule(0.0, args.lr, args.warmup,
                                         max(args.steps, args.warmup + 1), args.lr * 0.05)
    state = init_train_state(net, sched)
    epoch = make_servo_train_epoch(model, args.batch, args.chain, perturb_prob=args.perturb_prob)
    gen = torch.Generator().manual_seed(args.seed + 1)
    done, history, init_q = 0, [], None
    if part is not None:
        saved = torch.load(paths["state"], map_location=args.device, weights_only=False)
        state.optimizer.load_state_dict(saved["optimizer"])
        state.scheduler.load_state_dict(saved["scheduler"])
        gen.set_state(saved["generator"])
        done, history, init_q = part["done"], saved["loss"], saved["init_matching"]
        state = state._replace(step=done)
    else:
        init_q = quality(123)
        log(f"[train] init matching: valid-frac {init_q[0]:.3f}, patch-acc {init_q[1]:.3f}")

    def save_part():
        """The weights, the json of steps done and the full state, each
        written beside and moved into place."""
        save_exported(paths["part"] + ".new", state.net.state_dict(), state.net.cfg, "float32",
                      source=os.path.basename(args.out))
        torch.save({"optimizer": state.optimizer.state_dict(),
                    "scheduler": state.scheduler.state_dict(), "generator": gen.get_state(),
                    "loss": history, "init_matching": init_q}, paths["state"] + ".new")
        os.replace(paths["part"] + ".new", paths["part"])
        os.replace(paths["state"] + ".new", paths["state"])
        with open(paths["json"], "w") as fh:
            json.dump({"done": done, "steps": args.steps, "args": fingerprint}, fh)

    t0 = time.time()
    start = done
    final_q = None
    while done < args.steps:
        state, losses = epoch(state, scene, gen)
        done += args.chain
        losses = losses.cpu()
        history.extend(losses.tolist())
        log(f"[train] step {done}/{args.steps}: loss {float(losses[-1]):.4f} "
            f"(mean {float(losses.mean()):.4f})  [{time.time() - t0:.0f}s]")
        saved_now = False
        if done % every == 0 or done >= args.steps:
            final_q = quality(done)
            log(f"[train]   matching: valid-frac {final_q[0]:.3f}, patch-acc {final_q[1]:.3f}")
            if done < args.steps:
                save_part()
                saved_now = True
        if budget_s is not None and done < args.steps and time.time() - t0 > budget_s:
            if not saved_now:
                save_part()
            log(f"[train] budget of {budget_s} s spent at step {done}; part saved to "
                f"{paths['part']}")
            return {"finished": False, "done": done, "loss": history, "init_matching": init_q,
                    "final_matching": final_q,
                    "ms_per_step": 1e3 * (time.time() - t0) / (done - start)}
    wall = time.time() - t0
    os.makedirs(os.path.dirname(os.path.abspath(args.out)) or ".", exist_ok=True)
    save_exported(args.out, state.net.state_dict(), state.net.cfg, "float32",
                  source=os.path.basename(args.out))
    with open(paths["trainlog"], "w") as fh:
        json.dump({"loss": history, "final_matching": list(final_q), "args": vars(args)}, fh)
    # the finished weights supersede the part: a stale part would be taken up
    # by a later run of the same arguments
    for k in ("part", "json", "state"):
        if os.path.exists(paths[k]):
            os.remove(paths[k])
    log(f"[train] saved checkpoint to {args.out}")
    return {"finished": True, "done": done, "loss": history, "init_matching": init_q,
            "final_matching": list(final_q),
            "ms_per_step": 1e3 * wall / max(done - start, 1)}


def main(argv=None) -> dict:
    return train(parse_args(argv), log=lambda msg: print(msg, flush=True))


if __name__ == "__main__":
    main()
