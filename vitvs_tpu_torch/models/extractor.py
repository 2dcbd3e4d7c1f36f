"""Dense patch descriptors: facets plus log-binning
(``vitvs_tpu/models/extractor.py``).

``log_bin`` is a fixed set of edge-clamped spatial shifts of average-pooled
feature maps; bin order and edge clamping match the reference's
``_log_bin``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from vitvs_tpu_torch.models.vit import ViT, vit_features


def _avg_pool_same(x: torch.Tensor, win: int) -> torch.Tensor:
    """AvgPool2d(win, stride=1, padding=win//2, count_include_pad=False)
    over (B, H, W, D)."""
    if win == 1:
        return x
    y = F.avg_pool2d(x.permute(0, 3, 1, 2), win, stride=1, padding=win // 2,
                     count_include_pad=False)
    return y.permute(0, 2, 3, 1)


def log_bin(feats: torch.Tensor, grid: tuple[int, int], hierarchy: int = 1) -> torch.Tensor:
    """(B, t, D) features on the row-major ``grid`` (gh, gw) ->
    (B, t, D * (1 + 8 * hierarchy)) log-binned descriptors.

    Level k (pool window 3^k) samples the 3x3 offsets {-3^k, 0, 3^k}^2 in
    row-major order, skipping the centre for k > 0, with edge-clamped
    indices."""
    B, t, D = feats.shape
    gh, gw = grid
    if t != gh * gw:
        raise ValueError(f"feats tokens {t} != grid {gh}x{gw}")
    x = feats.reshape(B, gh, gw, D)
    ys = torch.arange(gh, device=feats.device)
    xs = torch.arange(gw, device=feats.device)
    parts = []
    for k in range(hierarchy):
        step = 3 ** k
        pooled = _avg_pool_same(x, step)
        for dy in (-step, 0, step):
            for dx in (-step, 0, step):
                if k != 0 and dy == 0 and dx == 0:
                    continue
                iy = (ys + dy).clamp(0, gh - 1)
                ix = (xs + dx).clamp(0, gw - 1)
                parts.append(pooled[:, iy][:, :, ix])
    return torch.cat(parts, dim=-1).reshape(B, gh * gw, -1)


def extract_descriptors(
    net: ViT,
    images: torch.Tensor,
    layer: int = 11,
    facet: str = "token",
    bin: bool = False,
    include_cls: bool = False,
    hierarchy: int = 1,
    use_kernels: bool = True,
    quantized: bool = False,
    compute_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """Dense patch descriptors (B, 1, t, d') from (B, H, W, 3) images.

    facet 'token': d' = D; 'query' | 'key' | 'value': heads folded as the
    reference's permute(0, 2, 3, 1) (per component, then head); bin=True
    multiplies d' by 9 (hierarchy 1).  Descriptors stay in the compute dtype.
    quantized=True runs the int8 W8A8 forward (``models/quant.py``; ``net``
    is then a ``QuantViT``).  ``compute_dtype`` selects the training
    forward of :func:`~vitvs_tpu_torch.models.vit.vit_features`.
    """
    if quantized:
        from vitvs_tpu_torch.models.quant import vit_features_quant

        feats = vit_features_quant(net, images, layer, facet, use_kernels)
    else:
        feats = vit_features(net, images, layer, facet, use_kernels, compute_dtype)
    if facet == "token":
        x = feats
    else:
        # (B, h, 1+t, hd) -> (B, 1+t, hd, h) -> (B, 1+t, hd*h)
        x = feats.permute(0, 2, 3, 1)
        x = x.reshape(x.shape[0], x.shape[1], -1)
    if include_cls:
        if bin:
            raise ValueError("bin and include_cls are mutually exclusive")
        return x[:, None]
    x = x[:, 1:]
    if bin:
        x = log_bin(x, net.cfg.num_patches(images.shape[-3], images.shape[-2]), hierarchy)
    return x[:, None]
