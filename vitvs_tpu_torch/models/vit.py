"""DINOv2-style Vision Transformer (``vitvs_tpu/models/vit.py``) as an
``nn.Module``, with the facet forward of the servo step.

Covered: patch embedding (a reshape and one matmul when stride == patch, a
convolution otherwise), bicubic pos-embed resampling with the DINO "+0.1"
scale fudge, pre-norm blocks with LayerScale, LayerNorm statistics in f32,
exact or tanh GELU, softmax attention, and ``vit_features`` up to block
``layer`` for the token / query / key / value facets.

Dtypes follow the JAX package: the embedding (patch kernel, cls, pos) stays
f32 and sees the images rounded to the compute dtype; the blocks run in the
compute dtype, which is the dtype of their parameters (``cast_blocks``).  A
ViT cast whole (``net.to(dtype)``, the benchmark's cast) computes its
embedding in that dtype too.

Attention goes through one dispatch point, :func:`attention_core`, routed by
``ViTConfig.attn_impl``: exact softmax ('xla', 'pallas', 'auto') or the
no-max serving variant ('fast'), each the kernel wrapper of
``ops.attention`` (CUDA kernel on the card, plain version on the CPU), or
its plain version when ``use_kernels`` is off.
State-dict names follow torch-hub DINOv2 (``blocks.0.attn.qkv.weight`` ...).
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from vitvs_tpu_torch.core.image import interpolate_bicubic_scale_factor
from vitvs_tpu_torch.ops.attention import (mha_attention, mha_attention_fast_plain,
                                           mha_attention_plain)

# 'xla', 'pallas' and 'auto' name the JAX package's exact-softmax paths; the
# port runs them all as exact softmax.  'fast' is the no-max serving kernel.
ATTN_IMPLS = ("xla", "pallas", "auto", "fast")
# int8 serving attention modes of models/quant.py that the port runs; the
# others ('pv', 'qk+pv', 'nomax', 'nomax2', 'nomax3') wait for ROADMAP.md
# queue 1, item 3
QUANT_ATTN_MODES = ("none", "fused")


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    patch_size: int = 14
    embed_dim: int = 384
    depth: int = 12
    num_heads: int = 6
    mlp_ratio: float = 4.0
    pos_grid: int = 37           # pretrained pos-embed grid (518/14 for DINOv2)
    use_layerscale: bool = True  # DINOv2 yes, DINO v1 no
    qkv_bias: bool = True
    stride: int = 14             # patch-embed stride override
    ln_eps: float = 1e-6
    gelu_approx: bool = False    # tanh GELU; exact erf is the torch-parity default
    model_name: str = "dinov2_vits14"
    attn_impl: str = "xla"       # see ATTN_IMPLS
    quant_attn: str = "none"     # int8 serving path only (models/quant.py)

    def __post_init__(self):
        if self.attn_impl not in ATTN_IMPLS:
            raise ValueError(f"attn_impl must be one of {ATTN_IMPLS}, got {self.attn_impl!r}")
        if self.quant_attn not in QUANT_ATTN_MODES:
            raise NotImplementedError(
                f"quant_attn={self.quant_attn!r} is not ported (ROADMAP.md queue 1, item 3); "
                f"the port runs {QUANT_ATTN_MODES}")

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads

    @property
    def hidden_dim(self) -> int:
        return int(self.embed_dim * self.mlp_ratio)

    def num_patches(self, h: int, w: int) -> tuple[int, int]:
        return (1 + (h - self.patch_size) // self.stride,
                1 + (w - self.patch_size) // self.stride)


# The GELU-MLP presets of vitvs_tpu/models/vit.py:PRESETS (the SwiGLU
# dinov2_vitg14 is not ported).
PRESETS: dict[str, dict] = {
    "dinov2_vits14": dict(patch_size=14, embed_dim=384, depth=12, num_heads=6, pos_grid=37),
    "dinov2_vitb14": dict(patch_size=14, embed_dim=768, depth=12, num_heads=12, pos_grid=37),
    "dinov2_vitl14": dict(patch_size=14, embed_dim=1024, depth=24, num_heads=16, pos_grid=37),
    "dino_vits8": dict(patch_size=8, embed_dim=384, depth=12, num_heads=6, pos_grid=28, use_layerscale=False),
    "dino_vits16": dict(patch_size=16, embed_dim=384, depth=12, num_heads=6, pos_grid=14, use_layerscale=False),
    "dino_vitb8": dict(patch_size=8, embed_dim=768, depth=12, num_heads=12, pos_grid=28, use_layerscale=False),
    "dino_vitb16": dict(patch_size=16, embed_dim=768, depth=12, num_heads=12, pos_grid=14, use_layerscale=False),
    "vit_small_patch16_224": dict(patch_size=16, embed_dim=384, depth=12, num_heads=6, pos_grid=14, use_layerscale=False),
    "vit_small_patch8_224": dict(patch_size=8, embed_dim=384, depth=12, num_heads=6, pos_grid=28, use_layerscale=False),
    "vit_base_patch16_224": dict(patch_size=16, embed_dim=768, depth=12, num_heads=12, pos_grid=14, use_layerscale=False),
    "vit_base_patch8_224": dict(patch_size=8, embed_dim=768, depth=12, num_heads=12, pos_grid=28, use_layerscale=False),
}


def make_config(model_name: str, stride: int | None = None) -> ViTConfig:
    if model_name not in PRESETS:
        raise ValueError(f"unknown model {model_name!r}; options: {sorted(PRESETS)}")
    kw = dict(PRESETS[model_name])
    patch = kw["patch_size"]
    if stride is None:
        stride = patch
    if (patch // stride) * stride != patch:
        raise ValueError(f"stride {stride} must divide patch size {patch}")
    return ViTConfig(model_name=model_name, stride=stride, **kw)


def attention_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   use_kernels: bool, attn_impl: str = "xla") -> torch.Tensor:
    """The one attention dispatch point of the ViT, (B, T, h, hd) layout."""
    fast = attn_impl == "fast"
    if use_kernels:
        return mha_attention(q, k, v, fast=fast)
    return (mha_attention_fast_plain if fast else mha_attention_plain)(q, k, v)


def _layernorm(x: torch.Tensor, norm: nn.LayerNorm) -> torch.Tensor:
    """LayerNorm with f32 statistics whatever the compute dtype."""
    return F.layer_norm(x.float(), norm.normalized_shape, norm.weight.float(),
                        norm.bias.float(), norm.eps).to(x.dtype)


class PatchEmbed(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        self.proj = nn.Conv2d(3, cfg.embed_dim, cfg.patch_size, cfg.stride)


class LayerScale(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(dim))


class Attention(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        D = cfg.embed_dim
        self.num_heads = cfg.num_heads
        self.attn_impl = cfg.attn_impl
        self.qkv = nn.Linear(D, 3 * D, bias=cfg.qkv_bias)
        self.proj = nn.Linear(D, D)

    def qkv_heads(self, x_norm: torch.Tensor) -> torch.Tensor:
        """(B, T, D) -> (3, B, T, h, hd), contiguous."""
        B, T, D = x_norm.shape
        qkv = self.qkv(x_norm).reshape(B, T, 3, self.num_heads, D // self.num_heads)
        return qkv.permute(2, 0, 1, 3, 4).contiguous()

    def forward(self, x_norm: torch.Tensor, use_kernels: bool) -> torch.Tensor:
        B, T, D = x_norm.shape
        q, k, v = self.qkv_heads(x_norm).unbind(0)
        out = attention_core(q, k, v, use_kernels, self.attn_impl).reshape(B, T, D)
        return self.proj(out)


class Mlp(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        self.fc1 = nn.Linear(cfg.embed_dim, cfg.hidden_dim)
        self.fc2 = nn.Linear(cfg.hidden_dim, cfg.embed_dim)
        self.approximate = "tanh" if cfg.gelu_approx else "none"

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x), approximate=self.approximate))


class Block(nn.Module):
    """Pre-norm block with LayerScale (DINOv2 eval path)."""

    def __init__(self, cfg: ViTConfig):
        super().__init__()
        self.norm1 = nn.LayerNorm(cfg.embed_dim, eps=cfg.ln_eps)
        self.attn = Attention(cfg)
        self.ls1 = LayerScale(cfg.embed_dim)
        self.norm2 = nn.LayerNorm(cfg.embed_dim, eps=cfg.ln_eps)
        self.mlp = Mlp(cfg)
        self.ls2 = LayerScale(cfg.embed_dim)

    def forward(self, x: torch.Tensor, use_kernels: bool) -> torch.Tensor:
        x = x + self.ls1.gamma * self.attn(_layernorm(x, self.norm1), use_kernels)
        return x + self.ls2.gamma * self.mlp(_layernorm(x, self.norm2))


class ViT(nn.Module):
    """Weights and structure of the ViT; :func:`vit_features` runs it."""

    def __init__(self, cfg: ViTConfig):
        super().__init__()
        self.cfg = cfg
        D = cfg.embed_dim
        self.patch_embed = PatchEmbed(cfg)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, D))
        self.pos_embed = nn.Parameter(torch.zeros(1, 1 + cfg.pos_grid ** 2, D))
        self.blocks = nn.ModuleList(Block(cfg) for _ in range(cfg.depth))

    @property
    def compute_dtype(self) -> torch.dtype:
        return self.blocks[0].norm1.weight.dtype

    def cast_blocks(self, dtype: torch.dtype) -> "ViT":
        """Run the blocks in ``dtype``; the embedding stays f32."""
        self.blocks.to(dtype)
        return self

    def embed(self, images: torch.Tensor) -> torch.Tensor:
        """images (B, H, W, 3) -> tokens (B, 1+t, D) with pos embeddings, in
        the embedding's dtype: f32 after ``cast_blocks``, the compute dtype
        when the whole ViT was cast (the benchmark's cast, as the JAX
        benchmark casts every parameter).

        The images are rounded to the compute dtype first, as the JAX
        package casts them before its patch matmul."""
        return embed_tokens(self.cfg, images.to(self.compute_dtype),
                            self.patch_embed.proj.weight, self.patch_embed.proj.bias,
                            self.cls_token, self.pos_embed)


def _resample_pos_embed(pos: torch.Tensor, gh: int, gw: int) -> torch.Tensor:
    """(1 + N, D) pos embedding -> (1 + gh*gw, D) in its dtype, bicubically
    resampled in f32 with the DINO "+0.1" scale-factor fudge when the grid
    differs."""
    g = int(round(math.sqrt(pos.shape[0] - 1)))
    if gh == g and gw == g:
        return pos
    grid = pos[1:].reshape(g, g, -1).float()
    out = interpolate_bicubic_scale_factor(grid, (gh + 0.1) / g, (gw + 0.1) / g)
    assert out.shape[:2] == (gh, gw)
    return torch.cat([pos[:1], out.reshape(gh * gw, -1).to(pos.dtype)], dim=0)


def embed_tokens(cfg: ViTConfig, images: torch.Tensor, weight: torch.Tensor,
                 bias: torch.Tensor, cls_token: torch.Tensor,
                 pos_embed: torch.Tensor) -> torch.Tensor:
    """Patch embedding (``vitvs_tpu/models/vit.py:_embed``): images
    (B, H, W, 3), patch kernel (D, 3, P, P) OIHW -> tokens (B, 1+t, D) with
    cls and pos embeddings, computed in the promoted dtype of the images and
    the kernel (a reshape and one matmul when stride == patch, a
    convolution otherwise)."""
    B, H, W, _ = images.shape
    gh, gw = cfg.num_patches(H, W)
    ct = torch.promote_types(images.dtype, weight.dtype)
    x, w = images.to(ct), weight.to(ct)
    if cfg.stride == cfg.patch_size:
        P = cfg.patch_size
        x = x[:, : gh * P, : gw * P, :].reshape(B, gh, P, gw, P, 3)
        x = x.permute(0, 1, 3, 2, 4, 5).reshape(B, gh * gw, P * P * 3)
        patches = x @ w.permute(2, 3, 1, 0).reshape(P * P * 3, -1)
    else:
        patches = F.conv2d(x.permute(0, 3, 1, 2), w, stride=cfg.stride)
        patches = patches.flatten(2).transpose(1, 2)
    patches = patches + bias
    cls = cls_token.reshape(1, 1, -1).expand(B, 1, -1).to(patches.dtype)
    tokens = torch.cat([cls, patches], dim=1)
    pos = _resample_pos_embed(pos_embed.reshape(-1, pos_embed.shape[-1]), gh, gw)
    return tokens + pos.to(tokens.dtype)


def vit_features(net: ViT, images: torch.Tensor, layer: int = 11,
                 facet: str = "token", use_kernels: bool = True) -> torch.Tensor:
    """Facet after block ``layer``, running blocks 0..layer only.

    facet 'token' -> (B, 1+t, D) block output (with cls);
    'query' | 'key' | 'value' -> (B, h, 1+t, hd) of block ``layer``.
    """
    if facet not in ("token", "query", "key", "value"):
        raise ValueError(f"unsupported facet {facet!r}")
    x = net.embed(images).to(net.compute_dtype)
    if facet == "token":
        for blk in net.blocks[: layer + 1]:
            x = blk(x, use_kernels)
        return x
    for blk in net.blocks[:layer]:
        x = blk(x, use_kernels)
    blk = net.blocks[layer]
    qkv = blk.attn.qkv_heads(_layernorm(x, blk.norm1))     # (3, B, T, h, hd)
    return qkv[("query", "key", "value").index(facet)].transpose(1, 2)


def _trunc_normal(shape, generator: torch.Generator, std: float = 0.02) -> torch.Tensor:
    """Normal(0, std) truncated to +-2 std, by inverse CDF of seeded uniforms."""
    lo, hi = (1.0 + math.erf(-2.0 / math.sqrt(2.0))) / 2.0, (1.0 + math.erf(2.0 / math.sqrt(2.0))) / 2.0
    u = lo + (hi - lo) * torch.rand(shape, generator=generator, dtype=torch.float64)
    return (math.sqrt(2.0) * torch.erfinv(2.0 * u - 1.0) * std).float()


def init_vit(cfg: ViTConfig, generator: torch.Generator, device="cuda",
             layerscale: float | None = None) -> ViT:
    """Seeded random weights in the layout of ``vitvs_tpu.models.vit.init_vit``:
    truncated normal (std 0.02) kernels, cls and pos embeddings; zero biases;
    unit norms; LayerScale 1e-5 (1.0 without LayerScale) unless
    ``layerscale`` is given.  ``generator`` is a CPU generator, so the
    weights are the same whatever the device."""
    net = ViT(cfg)
    ls = layerscale if layerscale is not None else (1e-5 if cfg.use_layerscale else 1.0)
    with torch.no_grad():
        for name, p in net.named_parameters():
            if name.endswith(".gamma"):
                p.fill_(ls)
            elif name.endswith("bias"):
                p.zero_()
            elif ".norm" in name:
                p.fill_(1.0)
            else:
                p.copy_(_trunc_normal(p.shape, generator))
    return net.to(device)
