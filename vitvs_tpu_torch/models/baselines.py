"""Non-learned descriptor baselines (``vitvs_tpu/models/baselines.py``).

``pixel{P}`` models plug into the ViT pipeline but compute descriptors that
are the raw (normalized) image patches: an identity patch embedding, one
pass-through block (LayerScale about 1e-8 of its initial value) and a zero
position embedding.  Dense cosine matching then is patch template matching,
a baseline without learning.  The one block has one head of width 3 P^2
(48 for pixel4, 588 for pixel14), which the any-width attention kernel
(``csrc/attention_hd.cu``) serves on the card.
"""

from __future__ import annotations

import re

import torch

from vitvs_tpu_torch.models.vit import ViT, ViTConfig, init_vit


def is_pixel_model(name: str) -> bool:
    return bool(re.fullmatch(r"pixel(\d+)", name))


def pixel_config(name: str) -> ViTConfig:
    m = re.fullmatch(r"pixel(\d+)", name)
    if not m:
        raise ValueError(f"not a pixel model: {name!r}")
    p = int(m.group(1))
    return ViTConfig(patch_size=p, embed_dim=p * p * 3, depth=1, num_heads=1,
                     pos_grid=16, use_layerscale=False, stride=p, model_name=name)


def init_pixel_params(cfg: ViTConfig, generator: torch.Generator | None = None,
                      device="cuda") -> ViT:
    """Identity patch embed, zero bias and pos embed, and the block's
    LayerScale times 1e-8; the block's other weights are ``init_vit``'s draws
    from ``generator`` (seed 0 on the CPU when None), whose contribution
    (about 1e-8) leaves the descriptors the raw patches whatever the draw."""
    net = init_vit(cfg, generator or torch.Generator().manual_seed(0), device=device)
    d, p = cfg.embed_dim, cfg.patch_size
    with torch.no_grad():
        # the JAX kernel eye(d).reshape(P, P, 3, d) is HWIO; the port's conv weight is OIHW
        eye = torch.eye(d, device=net.pos_embed.device).reshape(p, p, 3, d)
        net.patch_embed.proj.weight.copy_(eye.permute(3, 2, 0, 1))
        net.patch_embed.proj.bias.zero_()
        net.pos_embed.zero_()
        for blk in net.blocks:
            blk.ls1.gamma.mul_(1e-8)
            blk.ls2.gamma.mul_(1e-8)
    return net
