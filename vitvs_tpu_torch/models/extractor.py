"""Dense patch descriptors: facets plus log-binning, CLS-attention
saliency, and the stateful :class:`DescriptorExtractor`
(``vitvs_tpu/models/extractor.py``).

``log_bin`` is a fixed set of edge-clamped spatial shifts of average-pooled
feature maps; bin order and edge clamping match the reference's
``_log_bin``.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch
import torch.nn.functional as F

from vitvs_tpu_torch.core import image as image_ops
from vitvs_tpu_torch.models.vit import ViT, ViTConfig, init_vit, make_config, vit_features


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
    if facet not in ("token", "query", "key", "value"):
        raise ValueError(f"descriptors come from the token, query, key or value facet, "
                         f"not {facet!r}")
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


def extract_saliency_maps(net: ViT, images: torch.Tensor, layer: int | None = None,
                          head_idxs: Sequence[int] = (0, 2, 4, 5),
                          use_kernels: bool = True) -> torch.Tensor:
    """[0, 1]-normalized CLS-attention saliency (B, t): the mean over the
    heads ``head_idxs`` of the CLS query's f32 attention to each patch at
    block ``layer`` (the last by default), min-max normalized per image."""
    layer = net.cfg.depth - 1 if layer is None else layer
    return saliency_from_attention(vit_features(net, images, layer, "attn", use_kernels),
                                   head_idxs)


def saliency_from_attention(attn: torch.Tensor,
                            head_idxs: Sequence[int] = (0, 2, 4, 5)) -> torch.Tensor:
    """:func:`extract_saliency_maps` of the 'attn' facet's (B, h, 1+t, 1+t)
    probabilities -> (B, t)."""
    cls_attn = attn[:, list(head_idxs), 0, 1:].mean(1)                 # (B, t)
    lo = cls_attn.amin(1, keepdim=True)
    hi = cls_attn.amax(1, keepdim=True)
    return (cls_attn - lo) / (hi - lo)


@dataclasses.dataclass
class DescriptorExtractor:
    """A ViT with its config, compute dtype and device, the reference's
    ``ViTExtractor`` API (model name, stride): ``preprocess`` a camera frame,
    then ``extract_descriptors``.  The blocks run in ``compute_dtype`` (cast
    here), the embedding in f32."""

    net: ViT
    cfg: ViTConfig
    compute_dtype: torch.dtype = torch.float32
    device: str = "cuda"

    def __post_init__(self):
        self.net = self.net.cast_blocks(self.compute_dtype).to(self.device).eval()

    @classmethod
    def random_init(cls, model_name: str = "dinov2_vits14", stride: int | None = None,
                    seed: int = 0, compute_dtype: torch.dtype = torch.float32,
                    device: str = "cuda") -> "DescriptorExtractor":
        """Seeded random weights (``init_vit`` from a CPU generator)."""
        cfg = make_config(model_name, stride)
        net = init_vit(cfg, torch.Generator().manual_seed(seed), device=device)
        return cls(net=net, cfg=cfg, compute_dtype=compute_dtype, device=device)

    @property
    def mean(self):
        return image_ops.IMAGENET_MEAN if "dino" in self.cfg.model_name else image_ops.HALF_MEAN

    @property
    def std(self):
        return image_ops.IMAGENET_STD if "dino" in self.cfg.model_name else image_ops.HALF_STD

    def preprocess(self, rgb: torch.Tensor, input_size: int) -> torch.Tensor:
        """Camera frame(s) (..., H, W, 3), uint8 or float in [0, 1] -> the
        normalized (..., S, S, 3) f32 input on the device."""
        return image_ops.preprocess_frame(torch.as_tensor(rgb).to(self.device), input_size,
                                          self.mean, self.std)

    @torch.inference_mode()
    def extract_descriptors(self, images: torch.Tensor, layer: int = 11, facet: str = "token",
                            bin: bool = False, include_cls: bool = False,
                            use_kernels: bool = True) -> torch.Tensor:
        """(B, 1, t, d') descriptors of preprocessed images (B, S, S, 3)
        (:func:`extract_descriptors`)."""
        return extract_descriptors(self.net, torch.as_tensor(images).to(self.device), layer,
                                   facet, bin, include_cls, use_kernels=use_kernels)
