"""Weights of the JAX package -> the port's ViT state dict.

``from_jax_params`` takes a ``vitvs_tpu`` ``ViTParams`` pytree whose leaves
are numpy arrays (e.g. ``jax.tree.map(np.asarray, params)``) and returns a
state dict for :class:`vitvs_tpu_torch.models.vit.ViT`:

    patch_embed.kernel (P, P, 3, D) HWIO -> patch_embed.proj.weight (D, 3, P, P) OIHW
    cls_token (D,), pos_embed (1+N, D)   -> (1, 1, D), (1, 1+N, D)
    blocks.<name> stacked on depth L     -> blocks.<i>.<module>.<param>
    qkv_kernel (L, D, 3, h, hd) or the legacy flat (L, D, 3D)
                                         -> blocks.<i>.attn.qkv.weight (3D, D)
    *_kernel (L, in, out)                -> Linear weights (out, in)

The final ``norm_scale`` / ``norm_bias`` are not on the facet path and are
not carried.

``from_jax_quant_params`` takes the int8 ``QuantParams`` pytree of
``vitvs_tpu.models.quant.quantize_vit_params`` (numpy leaves: int8 kernels
on the flat (L, in, out) view, ``*_kernel_scale`` (L, 1, out), optional
``act_scales`` (L, 4), folded norms, embedding parameters) and returns the
port's :class:`~vitvs_tpu_torch.models.quant.QuantViT` on the CPU.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from vitvs_tpu_torch.models.quant import QuantViT
from vitvs_tpu_torch.models.vit import ViTConfig


def from_jax_params(params_np: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    def t(a) -> torch.Tensor:
        return torch.tensor(np.asarray(a, dtype=np.float32))

    pe = params_np["patch_embed"]
    D = np.asarray(pe["bias"]).shape[0]
    sd = {
        "patch_embed.proj.weight": t(np.transpose(pe["kernel"], (3, 2, 0, 1))),
        "patch_embed.proj.bias": t(pe["bias"]),
        "cls_token": t(params_np["cls_token"]).reshape(1, 1, D),
        "pos_embed": t(params_np["pos_embed"]).reshape(1, -1, D),
    }
    bp = {k: np.asarray(v) for k, v in params_np["blocks"].items()}
    L = bp["norm1_scale"].shape[0]
    for i in range(L):
        pre = f"blocks.{i}."
        sd.update({
            pre + "norm1.weight": t(bp["norm1_scale"][i]),
            pre + "norm1.bias": t(bp["norm1_bias"][i]),
            # head-major (D, 3, h, hd) and flat (D, 3D) are the same bytes
            pre + "attn.qkv.weight": t(bp["qkv_kernel"][i].reshape(D, 3 * D).T),
            pre + "attn.proj.weight": t(bp["proj_kernel"][i].T),
            pre + "attn.proj.bias": t(bp["proj_bias"][i]),
            pre + "ls1.gamma": t(bp["ls1"][i]),
            pre + "norm2.weight": t(bp["norm2_scale"][i]),
            pre + "norm2.bias": t(bp["norm2_bias"][i]),
            pre + "mlp.fc1.weight": t(bp["fc1_kernel"][i].T),
            pre + "mlp.fc1.bias": t(bp["fc1_bias"][i]),
            pre + "mlp.fc2.weight": t(bp["fc2_kernel"][i].T),
            pre + "mlp.fc2.bias": t(bp["fc2_bias"][i]),
            pre + "ls2.gamma": t(bp["ls2"][i]),
        })
        if "qkv_bias" in bp:
            sd[pre + "attn.qkv.bias"] = t(bp["qkv_bias"][i].reshape(3 * D))
    return sd


def from_jax_quant_params(qparams_np: Mapping[str, Any], cfg: ViTConfig,
                          compute_dtype: torch.dtype = torch.bfloat16) -> QuantViT:
    def t(a) -> torch.Tensor:
        a = np.asarray(a)
        if a.dtype == np.int8:
            return torch.from_numpy(a.copy())
        return torch.tensor(a.astype(np.float32))

    pe = qparams_np["patch_embed"]
    embed = {"kernel": t(pe["kernel"]), "bias": t(pe["bias"]),
             "cls_token": t(qparams_np["cls_token"]), "pos_embed": t(qparams_np["pos_embed"])}
    blocks = {k: t(v) for k, v in qparams_np["blocks"].items()}
    return QuantViT(cfg, blocks, embed, compute_dtype)
