"""W8A8 int8 inference path for the ViT (``vitvs_tpu/models/quant.py``).

Weights: symmetric per-output-channel int8, scale = max|w| / 127.
Activations: per-token dynamic int8 scales, or calibrated static
per-tensor scales (``quantize_vit_params(..., calib_images=...)``) with the
SmoothQuant per-channel factors folded into the preceding LayerNorm and the
weight rows for the qkv and fc1 inputs; the proj and fc2 inputs get static
scales with 1.25x headroom.  Products accumulate in int32
(``ops/int_mm.py``) and are dequantized by the outer product of scales.

Attention inside the int8 block follows ``ViTConfig.quant_attn``:
'none' runs bf16 attention (exact softmax, or the no-max kernel under
``attn_impl='fast'``), 'fused' the fused int8-QK^T kernel
(``ops/attn_int8.py``), each the CUDA kernel on the card or its plain
version.  The other modes of the JAX package ('pv', 'qk+pv', 'nomax',
'nomax2', 'nomax3'), ``kv_pool``, ``attn_score`` and the 'attn' facet are
not ported (ROADMAP.md queue 1, item 3).

Dtype points follow the JAX package: activation scales are f32, the
inverse scale is rounded to the activation dtype and ``round(x * inv)``
runs in it (half to even); the embedding parameters are staged in the
compute dtype; LayerNorm statistics stay f32, and so do the LayerNorm
scales, which ``_cast_block`` passes with every other ``*_scale``.

The weights live in a :class:`QuantViT` (buffers only; move it with
``.to(device)``, never ``.to(dtype)``, which would cast the f32 scales).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from vitvs_tpu_torch.models.vit import ViT, ViTConfig, attention_core, embed_tokens
from vitvs_tpu_torch.ops.attn_int8 import fused_int8_attention, fused_int8_attention_plain
from vitvs_tpu_torch.ops.int_mm import int8_matmul_nt

_QUANT_KERNELS = ("qkv_kernel", "proj_kernel", "fc1_kernel", "fc2_kernel")


def _quantize_weight(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(..., in, out) f32 -> int8 values + (..., 1, out) f32 scales."""
    amax = w.abs().amax(-2, keepdim=True)
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return q, scale.float()


def _dyn_quant_act(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, T, D) -> int8 values + (B, T, 1) f32 per-token scales."""
    amax = x.abs().amax(-1, keepdim=True).float()
    scale = torch.clamp(amax, min=1e-12) / 127.0
    inv = (1.0 / scale).to(x.dtype)
    return torch.clamp(torch.round(x * inv), -127, 127).to(torch.int8), scale


def _q_matmul(x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor,
              bias: torch.Tensor | None, out_dtype,
              act_scale: torch.Tensor | None = None) -> torch.Tensor:
    """int8 matmul: x (B, T, D) @ w_q^T, w_q (E, D) int8 -> (B, T, E).

    act_scale None -> per-token dynamic activation scales; a () tensor -> a
    calibrated static per-tensor scale."""
    if act_scale is None:
        x_q, x_scale = _dyn_quant_act(x)
    else:
        x_scale = act_scale.reshape(1, 1, 1).float()
        inv = (1.0 / x_scale).to(x.dtype)
        x_q = torch.clamp(torch.round(x * inv), -127, 127).to(torch.int8)
    B, T, D = x.shape
    acc = int8_matmul_nt(x_q.reshape(B * T, D), w_q).reshape(B, T, -1)
    out = acc.float() * x_scale * w_scale                       # (B,T,E)*(B,T,1)*(E,)
    if bias is not None:
        out = out + bias.float()
    return out.to(out_dtype)


class QuantLinear(nn.Module):
    """int8 weight (out, in), f32 per-output scale, bias in the compute dtype."""

    def __init__(self, kernel: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor):
        super().__init__()
        self.register_buffer("weight", kernel.t().contiguous())     # (in, out) -> (out, in)
        self.register_buffer("scale", scale.reshape(-1))
        self.register_buffer("bias", bias)

    def forward(self, x: torch.Tensor, act_scale: torch.Tensor | None) -> torch.Tensor:
        return _q_matmul(x, self.weight, self.scale, self.bias, x.dtype, act_scale)


def _cast_block(bp: dict[str, torch.Tensor], compute_dtype) -> dict[str, torch.Tensor]:
    """int8 kernels and f32 scales pass through; everything else casts.  As
    in JAX, every name ending in ``_scale`` passes, the LayerNorm scales
    among them: they stay f32 while the LayerNorm biases cast."""
    return {k: (v if k in _QUANT_KERNELS or k.endswith("_scale") or k == "act_scales"
                else v.to(compute_dtype))
            for k, v in bp.items()}


def _layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    """LayerNorm with f32 statistics, the affine in f32, result in x's dtype."""
    return F.layer_norm(x.float(), x.shape[-1:], scale.float(), bias.float(), eps).to(x.dtype)


class QuantBlock(nn.Module):
    """One pre-norm block with int8 projections; the LayerNorms carry the
    SmoothQuant fold when the scales are static."""

    def __init__(self, cfg: ViTConfig, bp: dict[str, torch.Tensor], dtype: torch.dtype):
        super().__init__()
        bp = _cast_block(bp, dtype)
        self.eps = cfg.ln_eps
        for name in ("norm1_scale", "norm1_bias", "norm2_scale", "norm2_bias", "ls1", "ls2"):
            self.register_buffer(name, bp[name])
        for name in ("qkv", "proj", "fc1", "fc2"):
            setattr(self, name, QuantLinear(bp[name + "_kernel"], bp[name + "_kernel_scale"],
                                            bp[name + "_bias"]))
        acts = bp.get("act_scales")      # (4,) static [qkv, fc1, proj, fc2], or None
        self.register_buffer("act_scales", acts)

    def act(self, i: int) -> torch.Tensor | None:
        return None if self.act_scales is None else self.act_scales[i]

    def norm1(self, x: torch.Tensor) -> torch.Tensor:
        return _layernorm(x, self.norm1_scale, self.norm1_bias, self.eps)

    def norm2(self, x: torch.Tensor) -> torch.Tensor:
        return _layernorm(x, self.norm2_scale, self.norm2_bias, self.eps)


class QuantViT(nn.Module):
    """The int8 serving ViT: embedding parameters in the compute dtype and
    one :class:`QuantBlock` per block, built from stacked arrays in the JAX
    package's layout (``blocks``: ``qkv_kernel`` (L, D, 3D) int8,
    ``*_kernel_scale`` (L, 1, out), ``act_scales`` (L, 4) or absent, ...;
    ``embed``: ``kernel`` (P, P, 3, D), ``bias``, ``cls_token``,
    ``pos_embed``)."""

    def __init__(self, cfg: ViTConfig, blocks: dict[str, torch.Tensor],
                 embed: dict[str, torch.Tensor], compute_dtype: torch.dtype):
        super().__init__()
        self.cfg = cfg
        D = cfg.embed_dim
        self.register_buffer("patch_weight", embed["kernel"].permute(3, 2, 0, 1)
                             .contiguous().to(compute_dtype))      # HWIO -> OIHW
        self.register_buffer("patch_bias", embed["bias"].to(compute_dtype))
        self.register_buffer("cls_token", embed["cls_token"].reshape(1, 1, D).to(compute_dtype))
        self.register_buffer("pos_embed", embed["pos_embed"].reshape(1, -1, D).to(compute_dtype))
        L = blocks["qkv_kernel"].shape[0]
        self.blocks = nn.ModuleList(
            QuantBlock(cfg, {k: v[i] for k, v in blocks.items()}, compute_dtype)
            for i in range(L))

    @property
    def compute_dtype(self) -> torch.dtype:
        return self.blocks[0].ls1.dtype

    def embed(self, images: torch.Tensor) -> torch.Tensor:
        """images (B, H, W, 3) -> tokens (B, 1+t, D) in the compute dtype."""
        dt = self.compute_dtype
        x = embed_tokens(self.cfg, images.to(dt), self.patch_weight, self.patch_bias,
                         self.cls_token, self.pos_embed)
        return x.to(dt)


def _attn_qkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, cfg: ViTConfig,
              use_kernels: bool) -> torch.Tensor:
    """quant_attn='none': bf16 attention of (B, T, h, hd) q, k, v -> (B, T, D),
    exact softmax or the no-max variant under attn_impl='fast'."""
    B, T, h, hd = q.shape
    return attention_core(q, k, v, use_kernels, cfg.attn_impl).reshape(B, T, h * hd)


def _block_q(x: torch.Tensor, blk: QuantBlock, cfg: ViTConfig,
             use_kernels: bool) -> torch.Tensor:
    """Pre-norm block with int8 projections (mirrors the JAX ``_block_q``)."""
    B, T, D = x.shape
    h, hd = cfg.num_heads, cfg.head_dim
    qkv = blk.qkv(blk.norm1(x), blk.act(0))
    if cfg.quant_attn == "fused":
        # q, k, v stay column slices of the qkv output, no head transpose
        fn = fused_int8_attention if use_kernels else fused_int8_attention_plain
        attn = fn(qkv[..., :D], qkv[..., D:2 * D], qkv[..., 2 * D:], heads=h)
    else:
        q, k, v = qkv.reshape(B, T, 3, h, hd).permute(2, 0, 1, 3, 4).contiguous().unbind(0)
        attn = _attn_qkv(q, k, v, cfg, use_kernels)
    x = x + blk.ls1 * blk.proj(attn.to(x.dtype), blk.act(2))
    mid = blk.fc1(blk.norm2(x), blk.act(1))
    mid = F.gelu(mid, approximate="tanh" if cfg.gelu_approx else "none")
    return x + blk.ls2 * blk.fc2(mid, blk.act(3))


def vit_features_quant(qnet: QuantViT, images: torch.Tensor, layer: int = 11,
                       facet: str = "token", use_kernels: bool = True) -> torch.Tensor:
    """int8 facet forward, the contract of ``vit.vit_features``:
    'token' -> (B, 1+t, D); 'query' | 'key' | 'value' -> (B, h, 1+t, hd)."""
    if facet == "attn":
        raise NotImplementedError("the 'attn' facet of the int8 path is not ported "
                                  "(ROADMAP.md queue 1, item 3)")
    if facet not in ("token", "query", "key", "value"):
        raise ValueError(f"unsupported facet {facet!r}")
    cfg = qnet.cfg
    x = qnet.embed(images)
    last = layer + 1 if facet == "token" else layer
    for blk in qnet.blocks[:last]:
        x = _block_q(x, blk, cfg, use_kernels)
    if facet == "token":
        return x
    # recompute the int8 qkv projection of block `layer`
    blk = qnet.blocks[layer]
    B, T, _ = x.shape
    qkv = blk.qkv(blk.norm1(x), blk.act(0))
    qkv = qkv.reshape(B, T, 3, cfg.num_heads, cfg.head_dim).permute(2, 0, 3, 1, 4)
    return qkv[("query", "key", "value").index(facet)]


# ---------------------------------------------------------------------------
# quantization of a float ViT
# ---------------------------------------------------------------------------


def _stacked_blocks(net: ViT) -> dict[str, torch.Tensor]:
    """The float blocks of ``net`` as f32 arrays stacked on depth, in the
    JAX layout: kernels (L, in, out), qkv on the flat (L, D, 3D) view."""
    get = {
        "norm1_scale": lambda b: b.norm1.weight, "norm1_bias": lambda b: b.norm1.bias,
        "qkv_kernel": lambda b: b.attn.qkv.weight.T, "qkv_bias": lambda b: b.attn.qkv.bias,
        "proj_kernel": lambda b: b.attn.proj.weight.T, "proj_bias": lambda b: b.attn.proj.bias,
        "ls1": lambda b: b.ls1.gamma,
        "norm2_scale": lambda b: b.norm2.weight, "norm2_bias": lambda b: b.norm2.bias,
        "fc1_kernel": lambda b: b.mlp.fc1.weight.T, "fc1_bias": lambda b: b.mlp.fc1.bias,
        "fc2_kernel": lambda b: b.mlp.fc2.weight.T, "fc2_bias": lambda b: b.mlp.fc2.bias,
        "ls2": lambda b: b.ls2.gamma,
    }
    with torch.no_grad():
        return {k: torch.stack([f(b).float() for b in net.blocks]) for k, f in get.items()}


@torch.no_grad()
def _collect_act_amax(net: ViT, cfg: ViTConfig, images: torch.Tensor, layer: int,
                      compute_dtype: torch.dtype):
    """|activation| maxima of the four int8 matmul inputs over a calibration
    batch, blocks 0..layer: per channel for the LayerNorm outputs (qkv, fc1
    inputs), per tensor for the attention and GELU outputs (proj, fc2
    inputs).  Exact softmax in the compute dtype, whatever ``quant_attn``
    says.  Returns ((layer+1, D), (layer+1, D), (layer+1,), (layer+1,))."""
    dt = compute_dtype
    x = embed_tokens(cfg, images.to(dt), net.patch_embed.proj.weight.float(),
                     net.patch_embed.proj.bias.float(), net.cls_token.float(),
                     net.pos_embed.float()).to(dt)
    D, h, hd = cfg.embed_dim, cfg.num_heads, cfg.head_dim
    scale = 1.0 / math.sqrt(hd)
    approximate = "tanh" if cfg.gelu_approx else "none"
    # the block's parameters are rounded to the compute dtype first, as JAX casts them
    lin = lambda mod, a: a @ mod.weight.to(dt).T + mod.bias.to(dt)
    ln = lambda a, norm: F.layer_norm(a.float(), (D,), norm.weight.to(dt).float(),
                                      norm.bias.to(dt).float(), norm.eps).to(dt)
    amax_c = lambda n: n.float().abs().amax(dim=(0, 1))
    amax_t = lambda n: n.float().abs().amax()
    out = ([], [], [], [])
    for blk in net.blocks[: layer + 1]:
        B, T, _ = x.shape
        n1 = ln(x, blk.norm1)
        q, k, v = lin(blk.attn.qkv, n1).reshape(B, T, 3, h, hd).unbind(2)
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float()
        probs = torch.softmax(logits * scale, -1).to(dt)
        attn = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(B, T, D)
        x = x + blk.ls1.gamma.to(dt) * lin(blk.attn.proj, attn)
        n2 = ln(x, blk.norm2)
        act = F.gelu(lin(blk.mlp.fc1, n2), approximate=approximate)
        x = x + blk.ls2.gamma.to(dt) * lin(blk.mlp.fc2, act)
        for lst, val in zip(out, (amax_c(n1), amax_c(n2), amax_t(attn), amax_t(act))):
            lst.append(val)
    return tuple(torch.stack(lst) for lst in out)


@torch.no_grad()
def quantize_vit_params(net: ViT, cfg: ViTConfig | None = None,
                        calib_images: torch.Tensor | None = None, layer: int | None = None,
                        smooth_alpha: float = 0.5,
                        compute_dtype: torch.dtype = torch.bfloat16) -> QuantViT:
    """A float :class:`ViT` -> the int8 serving :class:`QuantViT` on the
    same device, which runs ``cfg`` (``quant_attn``, ``attn_impl``; the
    float net's own config when None).

    Without ``calib_images``, activations use per-token dynamic scales.
    With ``calib_images`` (B, H, W, 3) (and ``cfg``), the qkv / fc1 inputs
    get static per-tensor scales with the SmoothQuant fold (``smooth_alpha``;
    0 disables it) and the proj / fc2 inputs static scales with 1.25x
    headroom; blocks past ``layer`` get scale 1.
    """
    blocks = _stacked_blocks(net)
    qblocks = dict(blocks)
    if calib_images is not None:
        if cfg is None:
            raise ValueError("pass cfg when calibrating")
        L = blocks["qkv_kernel"].shape[0]
        lyr = cfg.depth - 1 if layer is None else layer
        a1, a2, a3, a4 = _collect_act_amax(net, cfg, calib_images, lyr, compute_dtype)
        act_scales = []
        for amax_c, kern, norm in ((a1, "qkv_kernel", "norm1"), (a2, "fc1_kernel", "norm2")):
            amax_c = F.pad(amax_c, (0, 0, 0, L - amax_c.shape[0]))
            wmax = blocks[kern].abs().amax(-1)                         # (L, D)
            if smooth_alpha > 0:
                s = (torch.clamp(amax_c, min=1e-6) ** smooth_alpha
                     / torch.clamp(wmax, min=1e-6) ** (1.0 - smooth_alpha))
                s = torch.where((amax_c > 1e-6) & (wmax > 1e-6), s, torch.ones_like(s))
                s = torch.clamp(s, 0.01, 100.0)
            else:
                s = torch.ones_like(amax_c)
            qblocks[norm + "_scale"] = qblocks[norm + "_scale"] / s
            qblocks[norm + "_bias"] = qblocks[norm + "_bias"] / s
            qblocks[kern] = qblocks[kern] * s[:, :, None]
            amax_t = (amax_c / s).amax(-1)                             # (L,)
            act_scales.append(torch.clamp(amax_t, min=1e-6) / 127.0)
        for amax_t in (a3, a4):
            amax_t = F.pad(amax_t, (0, L - amax_t.shape[0]))
            act_scales.append(torch.clamp(amax_t * 1.25, min=1e-6) / 127.0)
        qblocks["act_scales"] = torch.stack(act_scales, dim=-1)       # (L, 4) f32
    for name in _QUANT_KERNELS:
        qblocks[name], qblocks[name + "_scale"] = _quantize_weight(qblocks[name])
    embed = {"kernel": net.patch_embed.proj.weight.permute(2, 3, 1, 0),   # OIHW -> HWIO
             "bias": net.patch_embed.proj.bias, "cls_token": net.cls_token,
             "pos_embed": net.pos_embed}
    return QuantViT(cfg or net.cfg, qblocks, embed, compute_dtype).to(qblocks["qkv_kernel"].device)
