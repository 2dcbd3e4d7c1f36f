"""DINOv2-style Vision Transformer (``vitvs_tpu/models/vit.py``) as an
``nn.Module``, with the facet forward of the servo step.

Covered: patch embedding (a reshape and one matmul when stride == patch
and ``patch_embed_impl='reshape'``, a convolution otherwise), bicubic
pos-embed resampling with the DINO "+0.1" scale fudge, pre-norm blocks with
LayerScale, LayerNorm statistics in f32, the GELU MLP (exact or tanh) or
DINOv2-giant's fused SwiGLU FFN (``ffn``), softmax attention or the relu /
sqrelu scores (``attn_score``), K/V pooling
(``kv_pool``: the spatial keys and values mean-pooled
``kv_pool`` x ``kv_pool`` over the patch grid, after the qkv projection or,
with ``kv_pool_where='pre'``, of the normed tokens before the K/V
projection), ``vit_features`` up to block ``layer`` for the token / query /
key / value / attn facets, and ``vit_forward`` through every block and the
final LayerNorm, which a ViT carries only when its weights do (the facet
path never reads it; ``ViT.from_state_dict``).

Dtypes follow the JAX package: the embedding (patch kernel, cls, pos) stays
f32 and sees the images rounded to the compute dtype; the blocks run in the
compute dtype, which is the dtype of their parameters (``cast_blocks``).  A
ViT cast whole (``net.to(dtype)``, the benchmark's cast) computes its
embedding in that dtype too.

Attention goes through one dispatch point, :func:`attention_core`, routed by
``ViTConfig.attn_impl``: exact softmax ('xla', 'pallas', 'auto') or the
no-max serving variant ('fast'), each the kernel wrapper of
``ops.attention`` (CUDA kernel on the card, plain version on the CPU), or
its plain version when ``use_kernels`` is off.  Pooled attention
(``kv_pool > 1``) and the relu / sqrelu scores (:func:`score_attention`) are
plain PyTorch whatever ``attn_impl`` says: the JAX package sends them to no
Pallas kernel either.

Training (``vitvs_tpu_torch/train``) runs ``vit_features`` with a
``compute_dtype``: the parameters stay f32 and each block runs on casts of
them made inside the autograd graph, so the gradients land on the f32
weights, as the JAX package casts ``params["blocks"]`` inside its traced
forward.  It runs with ``use_kernels=False``: the kernels have no backward
and refuse inputs that require grad.  ``ViTConfig.remat_blocks`` then
recomputes each block in the backward pass (``torch.utils.checkpoint``).
State-dict names follow torch-hub DINOv2 (``blocks.0.attn.qkv.weight`` ...).
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from vitvs_tpu_torch.core.image import interpolate_bicubic_scale_factor
from vitvs_tpu_torch.ops.attention import (mha_attention, mha_attention_fast_plain,
                                           mha_attention_plain)

# 'xla', 'pallas' and 'auto' name the JAX package's exact-softmax paths; the
# port runs them all as exact softmax.  'fast' is the no-max serving kernel.
ATTN_IMPLS = ("xla", "pallas", "auto", "fast")
# int8 serving attention modes of models/quant.py
QUANT_ATTN_MODES = ("none", "fused", "nomax", "nomax2", "nomax3", "pv", "qk+pv")
# attention scores: exact softmax, or relu / sqrelu with the normalization
# deferred onto the P.V output (a different model: its weights are co-trained)
ATTN_SCORES = ("softmax", "relu", "sqrelu")
# the FFN: the GELU MLP (fc1, fc2) or DINOv2-giant's fused SwiGLU (w12, w3)
FFNS = ("mlp", "swiglu")
KV_POOL_IMPLS = ("window", "matmul")
KV_POOL_WHERE = ("post", "pre")
PATCH_EMBED_IMPLS = ("reshape", "conv")
FACETS = ("token", "query", "key", "value", "attn")


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
    # the no-max modes clamp the logits at this bound instead of subtracting
    # the row max
    nomax_clamp: float = 30.0
    # mean-pool K and V kv_pool x kv_pool over a square patch grid (the CLS
    # token passes through; edge windows of odd grids average their true
    # count); 'window' sums reshaped windows, 'matmul' applies the static
    # (T_out, T) pooling matrix; 'pre' pools the normed tokens before the K/V
    # projection (always by the matrix), 'post' pools K and V after it
    kv_pool: int = 1
    kv_pool_impl: str = "window"
    kv_pool_where: str = "post"
    # non-overlapping patch embedding: a reshape and one matmul, or a convolution
    patch_embed_impl: str = "reshape"
    # recompute each block in the backward pass instead of keeping its
    # activations (a training-memory knob; forwards without grad are unchanged)
    remat_blocks: bool = False
    # see ATTN_SCORES; relu and sqrelu take no logit scale (it cancels in the
    # deferred quotient) and never run an attention kernel
    attn_score: str = "softmax"
    # see FFNS; ffn_hidden None: int(embed_dim * mlp_ratio) for the MLP, the
    # fused-SwiGLU width round8(int(embed_dim * mlp_ratio) * 2 / 3) for SwiGLU
    ffn: str = "mlp"
    ffn_hidden: int | None = None

    def __post_init__(self):
        if self.attn_impl not in ATTN_IMPLS:
            raise ValueError(f"attn_impl must be one of {ATTN_IMPLS}, got {self.attn_impl!r}")
        if self.quant_attn not in QUANT_ATTN_MODES:
            raise ValueError(f"quant_attn must be one of {QUANT_ATTN_MODES}, "
                             f"got {self.quant_attn!r}")
        if self.attn_score not in ATTN_SCORES:
            raise ValueError(f"unknown attn_score {self.attn_score!r} "
                             "(expected 'softmax', 'relu' or 'sqrelu')")
        for name, allowed in (("kv_pool_impl", KV_POOL_IMPLS), ("kv_pool_where", KV_POOL_WHERE),
                              ("patch_embed_impl", PATCH_EMBED_IMPLS), ("ffn", FFNS)):
            if getattr(self, name) not in allowed:
                raise ValueError(f"{name} must be one of {allowed}, got {getattr(self, name)!r}")
        if self.kv_pool < 1:
            raise ValueError(f"kv_pool must be at least 1, got {self.kv_pool}")

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads

    @property
    def hidden_dim(self) -> int:
        """The FFN's hidden width (``vitvs_tpu/models/vit.py:ViTConfig.hidden_dim``)."""
        if self.ffn_hidden is not None:
            return self.ffn_hidden
        h = int(self.embed_dim * self.mlp_ratio)
        if self.ffn == "swiglu":
            return (int(h * 2 / 3) + 7) // 8 * 8
        return h

    def num_patches(self, h: int, w: int) -> tuple[int, int]:
        return (1 + (h - self.patch_size) // self.stride,
                1 + (w - self.patch_size) // self.stride)


# vitvs_tpu/models/vit.py:PRESETS
PRESETS: dict[str, dict] = {
    "dinov2_vits14": dict(patch_size=14, embed_dim=384, depth=12, num_heads=6, pos_grid=37),
    "dinov2_vitb14": dict(patch_size=14, embed_dim=768, depth=12, num_heads=12, pos_grid=37),
    "dinov2_vitl14": dict(patch_size=14, embed_dim=1024, depth=24, num_heads=16, pos_grid=37),
    "dinov2_vitg14": dict(patch_size=14, embed_dim=1536, depth=40, num_heads=24, pos_grid=37,
                          ffn="swiglu"),
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


def _pool_grid_dims(T: int, pool: int) -> tuple[int, int]:
    """(grid side g, windows per side) of T = 1 + g * g tokens."""
    g = int(round(math.sqrt(T - 1)))
    if g * g != T - 1:
        raise ValueError(f"kv_pool requires a square patch grid; got {T - 1} spatial tokens")
    return g, -(-g // pool)


@functools.lru_cache(maxsize=8)
def _pool_matrix(T: int, pool: int) -> np.ndarray:
    """Static (1 + nw * nw, T) f32 mean-pooling matrix over the (1 + g * g)
    token axis: row 0 passes CLS through; a window's row holds 1 / count at
    its member patches (edge windows of odd grids count their true
    members).  ``vitvs_tpu/models/vit.py:_pool_matrix``, copied."""
    g, nw = _pool_grid_dims(T, pool)
    P = np.zeros((1 + nw * nw, T), np.float32)
    P[0, 0] = 1.0
    for wi in range(nw):
        rows = range(wi * pool, min((wi + 1) * pool, g))
        for wj in range(nw):
            cols = range(wj * pool, min((wj + 1) * pool, g))
            w = 1.0 / (len(rows) * len(cols))
            for r in rows:
                for c in cols:
                    P[1 + wi * nw + wj, 1 + r * g + c] = w
    return P


def pool_matrix(T: int, pool: int, like: torch.Tensor) -> torch.Tensor:
    """:func:`_pool_matrix` in ``like``'s dtype on its device."""
    return torch.from_numpy(_pool_matrix(T, pool)).to(like.device, like.dtype)


def pool_kv(t: torch.Tensor, pool: int, impl: str = "window") -> torch.Tensor:
    """Mean-pool the spatial tokens of (B, 1 + g * g, h, hd) ``pool`` x
    ``pool`` over the patch grid, in t's dtype; the CLS token passes
    through.  'matmul': one token-axis product with the pooling matrix;
    'window': zero-pad, window sums, then times the windows' inverse counts."""
    if pool <= 1:
        return t
    B, T, h, hd = t.shape
    if impl == "matmul":
        return torch.einsum("ot,bthd->bohd", pool_matrix(T, pool, t), t)
    if impl != "window":
        raise ValueError(f"unknown kv_pool_impl {impl!r} (expected 'window' or 'matmul')")
    g, nw = _pool_grid_dims(T, pool)
    pad = nw * pool - g
    sp = t[:, 1:].reshape(B, g, g, h * hd)
    if pad:
        sp = F.pad(sp, (0, 0, 0, pad, 0, pad))
    sums = sp.reshape(B, nw, pool, nw, pool, h * hd).sum(dim=(2, 4))
    cnt = np.full(nw, pool, np.float32)
    if pad:
        cnt[-1] = g - pool * (nw - 1)
    inv = torch.from_numpy(1.0 / (cnt[:, None] * cnt[None, :])).to(t.device, t.dtype)
    pooled = (sums * inv[None, :, :, None]).reshape(B, nw * nw, h, hd)
    return torch.cat([t[:, :1], pooled], dim=1)


def softmax_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Exact softmax attention in plain PyTorch, the JAX package's XLA path:
    q (B, Tq, h, hd) against (possibly pooled) k, v (B, Tk, h, hd) -> (B, Tq,
    h * hd); logits in q's dtype, then softmax of the f32 logits times
    hd^-0.5, probabilities rounded to q's dtype for P.V."""
    B, T, h, hd = q.shape
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float()
    probs = torch.softmax(logits * (1.0 / math.sqrt(hd)), dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(B, T, h * hd)


def attention_probs(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """The 'attn' facet: q, k (B, h, T, hd) -> (B, h, T, T) f32 softmax
    probabilities; the logits come out of the product in q's dtype, are cast
    to f32 and divided by sqrt(hd) (``vitvs_tpu/models/vit.py:606-610``).
    Plain PyTorch on every device: no attention kernel returns its
    probabilities."""
    logits = torch.einsum("bhqd,bhkd->bhqk", q, k).float()
    return torch.softmax(logits / math.sqrt(q.shape[-1]), dim=-1)


def score_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, cfg: ViTConfig,
                    out_dtype: torch.dtype, score_dtype: torch.dtype) -> torch.Tensor:
    """relu / sqrelu scored attention with the normalization deferred
    (``vitvs_tpu/models/vit.py:_score_attention``): q (B, Tq, h, hd) against
    (possibly pooled) k, v (B, Tk, h, hd) -> (B, Tq, h * hd) in ``out_dtype``.

    The logits come out of the product in q's dtype and are cast to
    ``score_dtype``; max(., 0), squared for sqrelu, in that dtype; the denominator sums in f32, floored at 1e-6; P.V takes the
    scores rounded to ``out_dtype``, and the f32 quotient is rounded to it.
    No logit scale: it cancels in the quotient.  The float ViT (f32 scores),
    the int8 ViT and static calibration (scores in the compute dtype) all
    call here."""
    B, T, h, hd = q.shape
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k)
    e = torch.relu(logits.to(score_dtype))
    if cfg.attn_score == "sqrelu":
        e = e * e
    denom = torch.clamp(e.sum(-1, dtype=torch.float32), min=1e-6)          # (B, h, Tq)
    pv = torch.einsum("bhqk,bkhd->bqhd", e.to(out_dtype), v)
    out = pv.float() / denom.transpose(1, 2)[..., None]
    return out.to(out_dtype).reshape(B, T, h * hd)


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
        self.cfg = cfg
        self.num_heads = cfg.num_heads
        self.qkv = nn.Linear(D, 3 * D, bias=cfg.qkv_bias)
        self.proj = nn.Linear(D, D)

    def qkv_heads(self, x_norm: torch.Tensor) -> torch.Tensor:
        """(B, T, D) -> (3, B, T, h, hd), contiguous."""
        B, T, D = x_norm.shape
        qkv = self.qkv(x_norm).reshape(B, T, 3, self.num_heads, D // self.num_heads)
        return qkv.permute(2, 0, 1, 3, 4).contiguous()

    def qkv_prepool(self, x_norm: torch.Tensor):
        """kv_pool_where='pre': q (B, T, h, hd) projected from every token,
        k and v (B, T_p, h, hd) from the pooled normed tokens (equal to
        project-then-pool up to float association: each pooling row sums to
        1, so the bias passes through)."""
        B, T, D = x_norm.shape
        h = self.num_heads
        w, b = self.qkv.weight, self.qkv.bias
        xp = torch.einsum("ot,btd->bod", pool_matrix(T, self.cfg.kv_pool, x_norm), x_norm)
        q = F.linear(x_norm, w[:D], None if b is None else b[:D]).reshape(B, T, h, D // h)
        kv = F.linear(xp, w[D:], None if b is None else b[D:]).reshape(B, -1, 2, h, D // h)
        return q, kv[:, :, 0], kv[:, :, 1]

    def forward(self, x_norm: torch.Tensor, use_kernels: bool) -> torch.Tensor:
        B, T, D = x_norm.shape
        cfg = self.cfg
        if cfg.kv_pool > 1 and cfg.kv_pool_where == "pre":
            q, k, v = self.qkv_prepool(x_norm)
        else:
            q, k, v = self.qkv_heads(x_norm).unbind(0)
            k = pool_kv(k, cfg.kv_pool, cfg.kv_pool_impl)
            v = pool_kv(v, cfg.kv_pool, cfg.kv_pool_impl)
        if cfg.attn_score != "softmax":
            out = score_attention(q, k, v, cfg, x_norm.dtype, score_dtype=torch.float32)
        elif cfg.kv_pool > 1:
            out = softmax_attention(q, k, v)
        else:
            out = attention_core(q, k, v, use_kernels, cfg.attn_impl).reshape(B, T, D)
        return self.proj(out)


def ffn_activation(hidden: torch.Tensor, cfg: ViTConfig) -> torch.Tensor:
    """The FFN's nonlinearity on the first product's output: GELU (exact or
    tanh), or for SwiGLU silu(x1) * x2 of its two halves in that order
    (``vitvs_tpu/models/vit.py:454-462``).  The float ViT, the int8 ViT and
    static calibration all call here."""
    if cfg.ffn == "swiglu":
        x1, x2 = hidden.chunk(2, dim=-1)
        return F.silu(x1) * x2
    return F.gelu(hidden, approximate="tanh" if cfg.gelu_approx else "none")


class Mlp(nn.Module):
    """The GELU MLP, torch-hub's ``mlp.fc1`` (D -> H) and ``mlp.fc2`` (H -> D)."""

    def __init__(self, cfg: ViTConfig):
        super().__init__()
        self.cfg = cfg
        self.fc1 = nn.Linear(cfg.embed_dim, cfg.hidden_dim)
        self.fc2 = nn.Linear(cfg.hidden_dim, cfg.embed_dim)

    def linears(self) -> tuple[nn.Linear, nn.Linear]:
        return self.fc1, self.fc2

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(ffn_activation(self.fc1(x), self.cfg))


class SwiGLUFFN(nn.Module):
    """DINOv2-giant's fused SwiGLU FFN, torch-hub's names: ``mlp.w12`` (D ->
    2H) and ``mlp.w3`` (H -> D)."""

    def __init__(self, cfg: ViTConfig):
        super().__init__()
        self.cfg = cfg
        self.w12 = nn.Linear(cfg.embed_dim, 2 * cfg.hidden_dim)
        self.w3 = nn.Linear(cfg.hidden_dim, cfg.embed_dim)

    def linears(self) -> tuple[nn.Linear, nn.Linear]:
        return self.w12, self.w3

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.w3(ffn_activation(self.w12(x), self.cfg))


class Block(nn.Module):
    """Pre-norm block with LayerScale (DINOv2 eval path)."""

    def __init__(self, cfg: ViTConfig):
        super().__init__()
        self.norm1 = nn.LayerNorm(cfg.embed_dim, eps=cfg.ln_eps)
        self.attn = Attention(cfg)
        self.ls1 = LayerScale(cfg.embed_dim)
        self.norm2 = nn.LayerNorm(cfg.embed_dim, eps=cfg.ln_eps)
        self.mlp = SwiGLUFFN(cfg) if cfg.ffn == "swiglu" else Mlp(cfg)
        self.ls2 = LayerScale(cfg.embed_dim)

    def forward(self, x: torch.Tensor, use_kernels: bool, facet: str | None = None) -> torch.Tensor:
        """The block's output, or with ``facet`` ('query' | 'key' | 'value')
        that projection of its normed input, (B, h, T, hd), or ('attn') the
        softmax probabilities of its query and key, (B, h, T, T) f32."""
        if facet is not None:
            qkv = self.attn.qkv_heads(_layernorm(x, self.norm1)).transpose(2, 3)  # (3, B, h, T, hd)
            if facet == "attn":
                return attention_probs(qkv[0], qkv[1])
            return qkv[("query", "key", "value").index(facet)]
        x = x + self.ls1.gamma * self.attn(_layernorm(x, self.norm1), use_kernels)
        return x + self.ls2.gamma * self.mlp(_layernorm(x, self.norm2))


class ViT(nn.Module):
    """Weights and structure of the ViT; :func:`vit_features` runs it.
    ``final_norm`` False: no final LayerNorm, for weights that carry none
    (the facet path's, such as ``ckpt_real518.npz``), so that none is made
    up for them; :meth:`from_state_dict` decides it from the weights."""

    def __init__(self, cfg: ViTConfig, final_norm: bool = True):
        super().__init__()
        self.cfg = cfg
        D = cfg.embed_dim
        self.patch_embed = PatchEmbed(cfg)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, D))
        self.pos_embed = nn.Parameter(torch.zeros(1, 1 + cfg.pos_grid ** 2, D))
        self.blocks = nn.ModuleList(Block(cfg) for _ in range(cfg.depth))
        self.norm = nn.LayerNorm(D, eps=cfg.ln_eps) if final_norm else None

    @classmethod
    def from_state_dict(cls, cfg: ViTConfig, state_dict: dict) -> "ViT":
        """A ViT of ``cfg`` holding ``state_dict``, with the final norm
        where the weights carry one (``norm.weight``)."""
        net = cls(cfg, final_norm="norm.weight" in state_dict)
        net.load_state_dict(state_dict)
        return net

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
    the kernel (a reshape and one matmul when stride == patch and
    ``patch_embed_impl`` is 'reshape', a convolution otherwise)."""
    B, H, W, _ = images.shape
    gh, gw = cfg.num_patches(H, W)
    ct = torch.promote_types(images.dtype, weight.dtype)
    x, w = images.to(ct), weight.to(ct)
    if cfg.stride == cfg.patch_size and cfg.patch_embed_impl == "reshape":
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


def _block_call(blk: Block, x: torch.Tensor, use_kernels: bool, dtype: torch.dtype | None,
                facet: str | None = None) -> torch.Tensor:
    """``blk`` on x, in its parameters' dtype, or (``dtype``) on casts of its
    parameters made here, inside the autograd graph."""
    if dtype is None:
        return blk(x, use_kernels, facet)
    params = {n: p.to(dtype) for n, p in blk.named_parameters()}
    return torch.func.functional_call(blk, params, (x, use_kernels, facet))


def _run_block(net: "ViT", blk: Block, x: torch.Tensor, use_kernels: bool,
               dtype: torch.dtype | None) -> torch.Tensor:
    if net.cfg.remat_blocks and torch.is_grad_enabled():
        # the casts run inside the checkpoint, so the recomputation makes them again
        return checkpoint(_block_call, blk, x, use_kernels, dtype, use_reentrant=False)
    return _block_call(blk, x, use_kernels, dtype)


def vit_features(net: ViT, images: torch.Tensor, layer: int = 11,
                 facet: str = "token", use_kernels: bool = True,
                 compute_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Facet after block ``layer``, running blocks 0..layer only.

    facet 'token' -> (B, 1+t, D) block output (with cls);
    'query' | 'key' | 'value' -> (B, h, 1+t, hd) of block ``layer``;
    'attn' -> (B, h, 1+t, 1+t) f32 softmax probabilities of block ``layer``
    (:func:`attention_probs`, never an attention kernel).

    ``compute_dtype`` (the training forward): the images are rounded to it,
    the embedding computes in the promoted dtype of the images and its
    weights, and the blocks run in it on casts of their parameters made in
    the autograd graph; None runs every parameter in its own dtype.
    """
    if facet not in FACETS:
        raise ValueError(f"unsupported facet {facet!r}")
    if compute_dtype is None:
        x = net.embed(images).to(net.compute_dtype)
    else:
        pe = net.patch_embed.proj
        x = embed_tokens(net.cfg, images.to(compute_dtype), pe.weight, pe.bias,
                         net.cls_token, net.pos_embed).to(compute_dtype)
    last = layer + 1 if facet == "token" else layer
    for blk in net.blocks[:last]:
        x = _run_block(net, blk, x, use_kernels, compute_dtype)
    if facet == "token":
        return x
    return _block_call(net.blocks[layer], x, use_kernels, compute_dtype, facet)


def vit_forward(net: ViT, images: torch.Tensor, use_kernels: bool = True) -> torch.Tensor:
    """Every block, then the final LayerNorm with f32 statistics -> (B, 1+t,
    D) in the compute dtype (``vitvs_tpu/models/vit.py:vit_forward``).
    Weights without the final norm raise ``ValueError``."""
    if net.norm is None:
        raise ValueError("this ViT's weights carry no final norm (norm.weight, norm.bias): "
                         "vit_forward needs one; vit_features does not")
    x = net.embed(images).to(net.compute_dtype)
    for blk in net.blocks:
        x = _run_block(net, blk, x, use_kernels, None)
    return _layernorm(x, net.norm)


def count_flops_per_image(cfg: ViTConfig, input_size: int, layer: int | None = None) -> float:
    """Matmul FLOPs of one facet forward, for reports and cost models;
    ``vitvs_tpu/models/vit.py:count_flops_per_image``, copied (the FFN at
    int(D * mlp_ratio) wide and not SwiGLU's width, as there)."""
    gh, gw = cfg.num_patches(input_size, input_size)
    t = gh * gw + 1
    D, H = cfg.embed_dim, int(cfg.embed_dim * cfg.mlp_ratio)
    nblocks = (layer + 1) if layer is not None else cfg.depth
    per_block = (
        2 * t * D * 3 * D          # qkv
        + 2 * t * t * D * 2        # qk^T and probs@v
        + 2 * t * D * D            # proj
        + 2 * t * D * H * 2        # mlp
    )
    patch = 2 * t * (cfg.patch_size ** 2 * 3) * D
    return float(nblocks * per_block + patch)


def _trunc_normal(shape, generator: torch.Generator, std: float = 0.02) -> torch.Tensor:
    """Normal(0, std) truncated to +-2 std, by inverse CDF of seeded
    uniforms drawn on the generator's device."""
    lo, hi = (1.0 + math.erf(-2.0 / math.sqrt(2.0))) / 2.0, (1.0 + math.erf(2.0 / math.sqrt(2.0))) / 2.0
    u = lo + (hi - lo) * torch.rand(shape, generator=generator, dtype=torch.float64,
                                    device=generator.device)
    return (math.sqrt(2.0) * torch.erfinv(2.0 * u - 1.0) * std).float()


def init_vit(cfg: ViTConfig, generator: torch.Generator, device="cuda",
             layerscale: float | None = None) -> ViT:
    """Seeded random weights in the layout of ``vitvs_tpu.models.vit.init_vit``:
    truncated normal (std 0.02) kernels, cls and pos embeddings; zero biases;
    unit norms, the final one included; LayerScale 1e-5 (1.0 without
    LayerScale) unless ``layerscale`` is given.  With a CPU generator the
    weights are the same whatever the device; a generator of another device
    builds and draws them there (the same distribution, other values: a
    ViT-g's 1.1 B draws on the host take tens of seconds)."""
    with torch.device(generator.device):
        net = ViT(cfg)
    ls = layerscale if layerscale is not None else (1e-5 if cfg.use_layerscale else 1.0)
    with torch.no_grad():
        for name, p in net.named_parameters():
            if name.endswith(".gamma"):
                p.fill_(ls)
            elif name.endswith("bias"):
                p.zero_()
            elif name.startswith("norm.") or ".norm" in name:
                p.fill_(1.0)
            else:
                p.copy_(_trunc_normal(p.shape, generator))
    return net.to(device)
