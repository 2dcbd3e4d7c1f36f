#!/usr/bin/env python3
"""Export a trained orbax checkpoint of the JAX package as the PyTorch port's
weight file, which numpy reads without JAX or orbax.

    python scripts/export_port_weights.py            # artifacts/ckpt_real518
    python scripts/export_port_weights.py --ckpt artifacts/ckpt_real518 \\
        --model dinov2_vits14 --out vitvs_tpu_torch/assets/ckpt_real518.npz

Runs where JAX and orbax are installed: it reads the checkpoint through
``vitvs_tpu.models.convert.load_params``, converts it with the port's
``from_jax_params`` and writes a compressed npz with one array per key of
the port's ViT state dict: the embedding (patch kernel and bias, cls and pos
embeddings) in f32, and the blocks rounded to bf16 (round to nearest even),
each stored as its bits in two uint8 planes, high bytes then low bytes, which
compress better than interleaved.  Those are the dtypes the bf16 servo step
and the benchmark's cast compute in (the step keeps the embedding in f32),
at 33 MB where f32 blocks take 88 MB.  ``__config__``, a unicode scalar,
holds the architecture as JSON (model name, patch, stride, embed dim, depth,
heads, ``pos_grid``, LayerScale, the blocks' dtype, the source checkpoint's
name).  The port reads it back with
``vitvs_tpu_torch.models.convert.load_exported``
(``np.load(..., allow_pickle=False)``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

CONFIG_KEY = "__config__"


def export(ckpt: str, model_name: str, out: str) -> dict:
    """Write ``out`` from ``ckpt`` (an orbax ViT checkpoint of preset
    ``model_name``); returns the config written beside the weights."""
    import jax
    import torch

    from vitvs_tpu.models.convert import load_params
    from vitvs_tpu.models.vit import make_config
    from vitvs_tpu_torch.models.convert import from_jax_params

    params = jax.tree.map(np.asarray, load_params(ckpt))
    sd = from_jax_params(params)
    cfg = make_config(model_name)
    D = cfg.embed_dim
    if sd["patch_embed.proj.weight"].shape != (D, 3, cfg.patch_size, cfg.patch_size):
        raise ValueError(f"{ckpt} does not hold a {model_name}: patch kernel "
                         f"{tuple(sd['patch_embed.proj.weight'].shape)}")
    depth = 1 + max(int(k.split(".")[1]) for k in sd if k.startswith("blocks."))
    if depth != cfg.depth or sd["pos_embed"].shape[1] != 1 + cfg.pos_grid ** 2:
        raise ValueError(f"{ckpt}: depth {depth}, pos_embed {tuple(sd['pos_embed'].shape)} "
                         f"do not match {model_name}")
    config = {"model_name": model_name, "patch_size": cfg.patch_size, "stride": cfg.stride,
              "embed_dim": D, "depth": cfg.depth, "num_heads": cfg.num_heads,
              "pos_grid": cfg.pos_grid, "use_layerscale": cfg.use_layerscale,
              "blocks_dtype": "bfloat16", "source": os.path.basename(os.path.normpath(ckpt))}
    arrays = {}
    for k, v in sd.items():
        if k.startswith("blocks."):
            bits = v.to(torch.bfloat16).view(torch.uint16).numpy()
            arrays[k] = np.stack([(bits >> 8).astype(np.uint8), (bits & 0xFF).astype(np.uint8)])
        else:
            arrays[k] = v.numpy().astype(np.float32)
    arrays[CONFIG_KEY] = np.array(json.dumps(config, sort_keys=True))
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    np.savez_compressed(out, **arrays)
    return config


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ckpt", default=os.path.join(REPO, "artifacts", "ckpt_real518"))
    ap.add_argument("--model", default="dinov2_vits14")
    ap.add_argument("--out", default=os.path.join(REPO, "vitvs_tpu_torch", "assets",
                                                  "ckpt_real518.npz"))
    args = ap.parse_args()
    config = export(args.ckpt, args.model, args.out)
    print(f"wrote {args.out} ({os.path.getsize(args.out)} bytes): {json.dumps(config)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
