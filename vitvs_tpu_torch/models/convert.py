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

``load_exported`` reads the file ``scripts/export_port_weights.py`` writes
(an npz of the state dict, the embedding in f32 and the blocks in bf16 as
two byte planes of their bits, plus ``__config__``, the architecture as
JSON) with numpy alone: it is how trained weights reach a machine without
JAX or orbax.  ``vitvs_tpu_torch/assets/ckpt_real518.npz`` is the trained
ViT-S/14 @ 518 (``artifacts/ckpt_real518``) exported so; the bf16 step and
the benchmark's cast run exactly these values.

``infer_config``, ``from_torch_state_dict`` and ``from_torch_file`` take a
torch-hub DINO / DINOv2 state dict that the user supplies (nothing is
downloaded) and map it straight to the port's state dict: the port keeps
torch-hub's names, so the map drops what the facet path never reads
(``norm``, ``mask_token``, ``register_tokens``, heads), reads LayerScale
from ``ls1.gamma`` or the legacy ``gamma_1`` (ones where there is none) and
casts to f32.
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Any, Mapping

import numpy as np
import torch

from vitvs_tpu_torch.models.quant import QuantViT
from vitvs_tpu_torch.models.vit import PRESETS, ViTConfig, make_config

EXPORTED_CONFIG_KEY = "__config__"
# the architecture fields an exported file's config carries
_EXPORTED_FIELDS = ("model_name", "patch_size", "stride", "embed_dim", "depth", "num_heads",
                    "pos_grid", "use_layerscale")
# the blocks' bf16 bits as (2, ...) uint8: the high-byte plane, then the low
_PLANES = 2
TRAINED_S518 = Path(__file__).resolve().parent.parent / "assets" / "ckpt_real518.npz"


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


def _bf16_from_planes(planes: np.ndarray) -> torch.Tensor:
    """(2, ...) uint8 byte planes of bf16 bits -> a bf16 tensor."""
    if planes.dtype != np.uint8 or planes.shape[0] != _PLANES:
        raise ValueError(f"bf16 planes must be (2, ...) uint8, got {planes.dtype} {planes.shape}")
    bits = (planes[0].astype(np.uint16) << 8) | planes[1]
    return torch.from_numpy(bits.view(np.int16)).view(torch.bfloat16)


def load_exported(path: str | os.PathLike) -> tuple[dict[str, torch.Tensor], ViTConfig]:
    """An exported weight file -> (the port's state dict: the embedding in
    f32, the blocks in bf16; its ViTConfig).  numpy only
    (``allow_pickle=False``); raises on a missing or unreadable file and on
    a config that disagrees with its preset."""
    with np.load(path, allow_pickle=False) as f:
        if EXPORTED_CONFIG_KEY not in f.files:
            raise ValueError(f"{path} has no {EXPORTED_CONFIG_KEY}: not an exported weight file")
        meta = json.loads(str(f[EXPORTED_CONFIG_KEY]))
        if meta.get("blocks_dtype") != "bfloat16":
            raise ValueError(f"{path}: blocks_dtype {meta.get('blocks_dtype')!r}, not bfloat16")
        sd = {k: (_bf16_from_planes(f[k]) if k.startswith("blocks.")
                  else torch.from_numpy(np.array(f[k], np.float32)))
              for k in f.files if k != EXPORTED_CONFIG_KEY}
    cfg = ViTConfig(**{k: meta[k] for k in _EXPORTED_FIELDS})
    if cfg.model_name in PRESETS and make_config(cfg.model_name, cfg.stride) != cfg:
        raise ValueError(f"{path}: config {meta} does not match preset {cfg.model_name}")
    return sd, cfg


def _f32(t: Any) -> torch.Tensor:
    if isinstance(t, torch.Tensor):
        return t.detach().to("cpu", torch.float32).contiguous()
    return torch.tensor(np.asarray(t, dtype=np.float32))


def infer_config(state_dict: Mapping[str, Any], model_name: str | None = None,
                 stride: int | None = None) -> ViTConfig:
    """The architecture of a torch-hub state dict from its shapes
    (``vitvs_tpu/models/convert.py:infer_config``); a preset ``model_name``
    is checked against them.  SwiGLU checkpoints (``mlp.w12``, dinov2_vitg14)
    raise: the port's ViT has a GELU MLP only."""
    if "blocks.0.mlp.w12.weight" in state_dict:
        raise NotImplementedError("SwiGLU FFN checkpoints (dinov2_vitg14) are not ported "
                                  "(ROADMAP.md queue 1, item 4)")
    d, _, p, _ = tuple(state_dict["patch_embed.proj.weight"].shape)
    depth = 1 + max(int(k.split(".")[1]) for k in state_dict if k.startswith("blocks."))
    n = tuple(state_dict["pos_embed"].shape)[1] - 1
    if model_name is not None and model_name in PRESETS:
        cfg = make_config(model_name, stride)
        if (cfg.embed_dim, cfg.depth, cfg.patch_size) != (d, depth, p):
            raise ValueError(f"checkpoint shapes (d={d}, depth={depth}, patch={p}) do not "
                             f"match preset {model_name}")
        return cfg
    use_ls = "blocks.0.ls1.gamma" in state_dict or "blocks.0.gamma_1" in state_dict
    heads = {384: 6, 768: 12, 1024: 16, 1536: 24}.get(d, max(1, d // 64))
    return ViTConfig(patch_size=p, embed_dim=d, depth=depth, num_heads=heads,
                     pos_grid=int(round(np.sqrt(n))), use_layerscale=use_ls,
                     stride=stride if stride is not None else p,
                     model_name=model_name or f"custom_vit_d{d}_p{p}")


_BLOCK_PARAMS = ("norm1.weight", "norm1.bias", "attn.qkv.weight", "attn.qkv.bias",
                 "attn.proj.weight", "attn.proj.bias", "norm2.weight", "norm2.bias",
                 "mlp.fc1.weight", "mlp.fc1.bias", "mlp.fc2.weight", "mlp.fc2.bias")


def from_torch_state_dict(state_dict: Mapping[str, Any], model_name: str | None = None,
                          stride: int | None = None
                          ) -> tuple[dict[str, torch.Tensor], ViTConfig]:
    """A torch-hub DINO / DINOv2 state dict -> (the port's state dict in
    f32, its ViTConfig) (``vitvs_tpu/models/convert.py:from_torch_state_dict``).
    A missing key of the facet path raises ``KeyError``."""
    cfg = infer_config(state_dict, model_name, stride)
    D = cfg.embed_dim
    sd = {"patch_embed.proj.weight": _f32(state_dict["patch_embed.proj.weight"]),
          "patch_embed.proj.bias": _f32(state_dict["patch_embed.proj.bias"]),
          "cls_token": _f32(state_dict["cls_token"]).reshape(1, 1, D),
          "pos_embed": _f32(state_dict["pos_embed"]).reshape(1, -1, D)}
    for i in range(cfg.depth):
        pre = f"blocks.{i}."
        sd.update({pre + k: _f32(state_dict[pre + k]) for k in _BLOCK_PARAMS})
        for n in (1, 2):
            gamma = next((state_dict[pre + k] for k in (f"ls{n}.gamma", f"gamma_{n}")
                          if pre + k in state_dict), None)
            sd[pre + f"ls{n}.gamma"] = torch.ones(D) if gamma is None else _f32(gamma)
    return sd, cfg


def from_torch_file(path: str | os.PathLike, model_name: str | None = None,
                    stride: int | None = None
                    ) -> tuple[dict[str, torch.Tensor], ViTConfig]:
    """:func:`from_torch_state_dict` of a ``.pth`` file: a ``"model"``
    wrapper is unwrapped and ``module.`` prefixes are stripped."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and isinstance(sd.get("model"), dict):
        sd = sd["model"]
    sd = {k.removeprefix("module."): v for k, v in sd.items()}
    return from_torch_state_dict(sd, model_name, stride)
