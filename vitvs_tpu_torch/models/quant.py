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
version; 'nomax', 'nomax2' and 'nomax3' the JAX package's no-max,
deferred-normalize softmax, which is plain XLA there and plain PyTorch
here (logits clamped at ``nomax_clamp`` instead of max-subtracted, the
1/denominator applied to the P.V output; 'nomax3', the serving mode, folds
hd^-0.5 log2(e) into Q and keeps logits and probabilities in the compute
dtype); 'pv' and 'qk+pv' the int8-probability modes (the row-max trick:
exp(l - m) rounded times 127 is the probabilities' int8 quantization, V is
quantized per (head, channel), int32 P.V, the 1/denominator on the output;
'qk+pv' also takes QK^T in int8 with per-(token, head) scales), plain
PyTorch with exact int8 products (``ops/int_mm.int8_bmm``).  The relu /
sqrelu scores (``attn_score``) supersede every softmax mode but 'pv' and
'qk+pv', which they do not compose with, and 'fused', which refuses them:
``models/vit.score_attention`` at the compute dtype.  K/V pooling
(``kv_pool``) runs with every mode but 'fused': after the qkv projection
('post') or, with ``kv_pool_where='pre'``, as the K/V columns of the int8
qkv product on the pooled normed tokens; pooled attention takes no kernel.
The FFN follows ``ViTConfig.ffn``: fc1 and fc2 through the W8A8 products
around GELU, or for SwiGLU (ViT-g) the fused w12 and w3 products around
silu(x1) * x2, the fc2 input's static scale calibrated on that product.
The 'attn' facet is the f32 softmax of the int8 qkv product's q and k.

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

from vitvs_tpu_torch.models.vit import (FACETS, ViT, ViTConfig, attention_core,
                                        attention_probs, embed_tokens, ffn_activation, pool_kv,
                                        pool_matrix, score_attention, softmax_attention)
from vitvs_tpu_torch.ops.attn_int8 import (INV127, _quant_th, fused_int8_attention,
                                           fused_int8_attention_plain)
from vitvs_tpu_torch.ops.int_mm import int8_bmm, int8_matmul_nt

_QUANT_KERNELS = ("qkv_kernel", "proj_kernel", "fc1_kernel", "fc2_kernel")


def _quantize_weight(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(..., in, out) f32 -> int8 values + (..., 1, out) f32 scales."""
    amax = w.abs().amax(-2, keepdim=True)
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return q, scale.float()


def _dyn_quant_act(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, T, D) -> int8 values + (B, T, 1) f32 per-token scales (amax times
    f32(1/127), as the jitted reference computes them)."""
    amax = x.abs().amax(-1, keepdim=True).float()
    scale = torch.clamp(amax, min=1e-12) * INV127
    inv = (1.0 / scale).to(x.dtype)
    return torch.clamp(torch.round(x * inv), -127, 127).to(torch.int8), scale


def static_quant_act(x: torch.Tensor, act_scale: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Activations on a calibrated static per-tensor grid: int8 codes
    round(x * (1 / scale)), the inverse scale and the product in x's dtype,
    and the (1, 1, 1) f32 scale."""
    x_scale = act_scale.reshape(1, 1, 1).float()
    inv = (1.0 / x_scale).to(x.dtype)
    return torch.clamp(torch.round(x * inv), -127, 127).to(torch.int8), x_scale


def _q_matmul(x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor,
              bias: torch.Tensor | None, out_dtype,
              act_scale: torch.Tensor | None = None) -> torch.Tensor:
    """int8 matmul: x (B, T, D) @ w_q^T, w_q (E, D) int8 -> (B, T, E).

    act_scale None -> per-token dynamic activation scales; a () tensor -> a
    calibrated static per-tensor scale."""
    if act_scale is None:
        x_q, x_scale = _dyn_quant_act(x)
    else:
        x_q, x_scale = static_quant_act(x, act_scale)
    B, T, D = x.shape
    acc = int8_matmul_nt(x_q.reshape(B * T, D), w_q).reshape(B, T, -1)
    out = acc.float() * x_scale                                 # (B,T,E)*(B,T,1)
    if bias is None:
        return (out * w_scale).to(out_dtype)
    # one rounding for "* w_scale + bias", as XLA contracts the reference's
    # epilogue into an FMA under jit
    return torch.addcmul(bias.float(), out, w_scale).to(out_dtype)


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


NOMAX_MODES = ("nomax", "nomax2", "nomax3")


def _nomax_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     cfg: ViTConfig) -> torch.Tensor:
    """The no-max modes of the JAX ``_attn_qkv``: q (B, T, h, hd) against
    (possibly pooled) k, v (B, Tk, h, hd) -> (B, T, h * hd) in q's dtype.
    Exp is taken of the logits clamped at ``nomax_clamp`` (no row max); the
    denominator sums in f32, floored at 1e-30, and divides the P.V output.
    'nomax': f32 logits scaled by hd^-0.5, exp(min(l, c) - c); 'nomax2':
    hd^-0.5 folded into Q, exp(min(l, c)) in f32; 'nomax3': hd^-0.5 log2(e)
    folded into Q (rounded to q's dtype), logits and exp2(min(l, c log2(e)))
    in q's dtype."""
    B, T, h, hd = q.shape
    dt, mode, clamp = q.dtype, cfg.quant_attn, cfg.nomax_clamp
    scale = 1.0 / math.sqrt(hd)
    if mode == "nomax2":
        q = q * torch.tensor(scale, dtype=dt, device=q.device)
    elif mode == "nomax3":
        q = q * torch.tensor(scale * math.log2(math.e), dtype=dt, device=q.device)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k)
    if mode == "nomax3":
        e = torch.exp2(torch.minimum(logits, torch.tensor(clamp * math.log2(math.e), dtype=dt,
                                                          device=q.device)))
    elif mode == "nomax2":
        e = torch.exp(torch.clamp(logits.float(), max=clamp))
    else:
        e = torch.exp(torch.clamp(logits.float() * scale, max=clamp) - clamp)
    denom = torch.clamp(e.sum(-1, dtype=torch.float32), min=1e-30)       # (B, h, T)
    pv = torch.einsum("bhqk,bkhd->bqhd", e.to(dt), v)
    return (pv.float() / denom.transpose(1, 2)[..., None]).to(dt).reshape(B, T, h * hd)


INT8_PROB_MODES = ("pv", "qk+pv")


def _int8_probs(ls: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The row-max trick on f32 scaled logits (B, h, T, Tk): with the row
    max subtracted, a row's largest exp is 1, so round(exp * 127) is its
    int8 quantization.  Returns (int8 probabilities, f32 denominators (B,
    h, T))."""
    e = torch.exp(ls - ls.amax(-1, keepdim=True))
    return torch.round(e * 127.0).to(torch.int8), e.sum(-1)


def _quant_v(v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """V (B, Tk, h, hd) quantized per (head, channel) over its tokens:
    int8 values and f32 scales (B, 1, h, hd), amax times f32(1/127) as the
    jitted reference computes them."""
    vs = torch.clamp(v.abs().amax(1, keepdim=True).float(), min=1e-12) * INV127
    return torch.clamp(torch.round(v * (1.0 / vs).to(v.dtype)), -127, 127).to(torch.int8), vs


def _int8_qk_logits(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """'qk+pv': f32 logits (B, h, T, Tk) of the int8 QK^T, Q and K quantized
    per (token, head) (``ops/attn_int8._quant_th``), dequantized by the
    outer product of their scales."""
    (B, T, h, hd), Tk = q.shape, k.shape[1]
    qq, qs = _quant_th(q.reshape(B, T, h * hd), h)
    kq, ks = _quant_th(k.reshape(B, Tk, h * hd), h)
    acc = int8_bmm(qq.reshape(B, T, h, hd).transpose(1, 2),
                   kq.reshape(B, Tk, h, hd).permute(0, 2, 3, 1))
    return acc.float() * qs.transpose(1, 2)[..., None] * ks.transpose(1, 2)[:, :, None, :]


def _int8_prob_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         cfg: ViTConfig) -> torch.Tensor:
    """'pv' and 'qk+pv' (the JAX ``_attn_qkv``): q (B, T, h, hd) against
    (possibly pooled) k, v (B, Tk, h, hd) -> (B, T, h * hd) in q's dtype.
    The scaled f32 logits (QK^T in q's dtype, or in int8 for 'qk+pv') give
    int8 probabilities by the row-max trick, V goes int8 per (head,
    channel), P.V accumulates in int32 and is dequantized as
    pv * vs / (127 * denominator)."""
    B, T, h, hd = q.shape
    if cfg.quant_attn == "qk+pv":
        logits = _int8_qk_logits(q, k)
    else:
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k)
    p_q, denom = _int8_probs(logits.float() * (1.0 / math.sqrt(hd)))
    v_q, vs = _quant_v(v)
    pv = int8_bmm(p_q, v_q.transpose(1, 2)).transpose(1, 2)            # (B, T, h, hd)
    out = pv.float() * vs / (127.0 * denom.transpose(1, 2)[..., None])
    return out.to(q.dtype).reshape(B, T, h * hd)


def _attn_qkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, cfg: ViTConfig,
              use_kernels: bool) -> torch.Tensor:
    """Attention of (B, T, h, hd) q against (possibly pooled) k, v -> (B, T,
    D) for every mode but 'fused': the relu / sqrelu scores at q's dtype
    (refusing 'pv' and 'qk+pv'); the no-max modes; 'pv' and 'qk+pv'; 'none'
    the bf16 attention (exact softmax, or the no-max kernel under
    attn_impl='fast'), in plain PyTorch when the keys are pooled."""
    B, T, h, hd = q.shape
    mode = cfg.quant_attn
    if cfg.attn_score != "softmax":
        if mode in INT8_PROB_MODES:
            raise ValueError(f"quant_attn={mode!r} (int8 probs) does not compose with "
                             f"attn_score={cfg.attn_score!r}")
        return score_attention(q, k, v, cfg, q.dtype, score_dtype=q.dtype)
    if mode in NOMAX_MODES:
        return _nomax_attention(q, k, v, cfg)
    if mode in INT8_PROB_MODES:
        return _int8_prob_attention(q, k, v, cfg)
    if cfg.kv_pool > 1:
        return softmax_attention(q, k, v)
    return attention_core(q, k, v, use_kernels, cfg.attn_impl).reshape(B, T, h * hd)


def _block_q(x: torch.Tensor, blk: QuantBlock, cfg: ViTConfig,
             use_kernels: bool) -> torch.Tensor:
    """Pre-norm block with int8 projections (mirrors the JAX ``_block_q``)."""
    B, T, D = x.shape
    h, hd = cfg.num_heads, cfg.head_dim
    if cfg.quant_attn == "fused" and (cfg.attn_score != "softmax" or cfg.kv_pool > 1):
        raise ValueError("quant_attn='fused' (ops/attn_int8.py) does not compose with "
                         "attn_score/kv_pool redesigns")
    x_norm = blk.norm1(x)
    if cfg.kv_pool > 1 and cfg.kv_pool_where == "pre":
        # the K/V columns of the int8 qkv product run on the pooled tokens,
        # their per-column weight scales sliced with them and the static qkv
        # activation scale shared (pooled means stay within the calibrated amax)
        lin = blk.qkv
        xp = torch.einsum("ot,btd->bod", pool_matrix(T, cfg.kv_pool, x_norm), x_norm)
        q = _q_matmul(x_norm, lin.weight[:D], lin.scale[:D], lin.bias[:D], x.dtype, blk.act(0))
        kv = _q_matmul(xp, lin.weight[D:], lin.scale[D:], lin.bias[D:], x.dtype, blk.act(0))
        kv = kv.reshape(B, -1, 2, h, hd)
        attn = _attn_qkv(q.reshape(B, T, h, hd), kv[:, :, 0], kv[:, :, 1], cfg, use_kernels)
    else:
        qkv = blk.qkv(x_norm, blk.act(0))
        if cfg.quant_attn == "fused":
            # q, k, v stay column slices of the qkv output, no head transpose
            fn = fused_int8_attention if use_kernels else fused_int8_attention_plain
            attn = fn(qkv[..., :D], qkv[..., D:2 * D], qkv[..., 2 * D:], heads=h)
        else:
            q, k, v = qkv.reshape(B, T, 3, h, hd).permute(2, 0, 1, 3, 4).contiguous().unbind(0)
            k = pool_kv(k, cfg.kv_pool, cfg.kv_pool_impl)
            v = pool_kv(v, cfg.kv_pool, cfg.kv_pool_impl)
            attn = _attn_qkv(q, k, v, cfg, use_kernels)
    x = x + blk.ls1 * blk.proj(attn.to(x.dtype), blk.act(2))
    mid = ffn_activation(blk.fc1(blk.norm2(x), blk.act(1)), cfg)
    return x + blk.ls2 * blk.fc2(mid, blk.act(3))


def vit_features_quant(qnet: QuantViT, images: torch.Tensor, layer: int = 11,
                       facet: str = "token", use_kernels: bool = True) -> torch.Tensor:
    """int8 facet forward, the contract of ``vit.vit_features``:
    'token' -> (B, 1+t, D); 'query' | 'key' | 'value' -> (B, h, 1+t, hd);
    'attn' -> (B, h, 1+t, 1+t) f32 softmax probabilities of the int8 qkv
    product's q and k (``vitvs_tpu/models/quant.py:514-518``)."""
    if facet not in FACETS:
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
    if facet == "attn":
        return attention_probs(qkv[0], qkv[1])
    return qkv[("query", "key", "value").index(facet)]


# ---------------------------------------------------------------------------
# quantization of a float ViT
# ---------------------------------------------------------------------------


def _stacked_blocks(net: ViT) -> dict[str, torch.Tensor]:
    """The float blocks of ``net`` as f32 arrays stacked on depth, in the
    JAX layout: kernels (L, in, out), qkv on the flat (L, D, 3D) view; the
    FFN's two products (SwiGLU's w12 and w3) as fc1 and fc2."""
    get = {
        "norm1_scale": lambda b: b.norm1.weight, "norm1_bias": lambda b: b.norm1.bias,
        "qkv_kernel": lambda b: b.attn.qkv.weight.T, "qkv_bias": lambda b: b.attn.qkv.bias,
        "proj_kernel": lambda b: b.attn.proj.weight.T, "proj_bias": lambda b: b.attn.proj.bias,
        "ls1": lambda b: b.ls1.gamma,
        "norm2_scale": lambda b: b.norm2.weight, "norm2_bias": lambda b: b.norm2.bias,
        "fc1_kernel": lambda b: b.mlp.linears()[0].weight.T,
        "fc1_bias": lambda b: b.mlp.linears()[0].bias,
        "fc2_kernel": lambda b: b.mlp.linears()[1].weight.T,
        "fc2_bias": lambda b: b.mlp.linears()[1].bias,
        "ls2": lambda b: b.ls2.gamma,
    }
    with torch.no_grad():
        return {k: torch.stack([f(b).float() for b in net.blocks]) for k, f in get.items()}


@torch.no_grad()
def _collect_act_amax(net: ViT, cfg: ViTConfig, images: torch.Tensor, layer: int,
                      compute_dtype: torch.dtype):
    """|activation| maxima of the four int8 matmul inputs over a calibration
    batch, blocks 0..layer: per channel for the LayerNorm outputs (qkv, fc1
    inputs), per tensor for the attention and FFN-activation outputs (proj,
    fc2 inputs: GELU's, or SwiGLU's silu(x1) * x2).  Exact softmax (f32 scores) whatever ``quant_attn`` says, or
    the relu / sqrelu scores at the compute dtype, as the int8 ViT serves
    them; with ``kv_pool`` K and V pooled after the projection, whatever
    ``kv_pool_where`` says (as the JAX package calibrates).  Returns
    ((layer+1, D), (layer+1, D), (layer+1,), (layer+1,))."""
    dt = compute_dtype
    x = embed_tokens(cfg, images.to(dt), net.patch_embed.proj.weight.float(),
                     net.patch_embed.proj.bias.float(), net.cls_token.float(),
                     net.pos_embed.float()).to(dt)
    D, h, hd = cfg.embed_dim, cfg.num_heads, cfg.head_dim
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
        k, v = (pool_kv(t, cfg.kv_pool, cfg.kv_pool_impl) for t in (k, v))
        if cfg.attn_score != "softmax":
            attn = score_attention(q, k, v, cfg, dt, score_dtype=dt)
        else:
            attn = softmax_attention(q, k, v)
        x = x + blk.ls1.gamma.to(dt) * lin(blk.attn.proj, attn)
        n2 = ln(x, blk.norm2)
        fc1, fc2 = blk.mlp.linears()
        act = ffn_activation(lin(fc1, n2), cfg)
        x = x + blk.ls2.gamma.to(dt) * lin(fc2, act)
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
