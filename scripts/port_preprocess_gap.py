#!/usr/bin/env python3
"""The preprocess's last-bit gap between the PyTorch port and the jitted JAX
reference (CPU; needs JAX).

    JAX_PLATFORMS=cpu python scripts/port_preprocess_gap.py

On a seeded 640 x 480 uint8 frame, at 308 and at 518, the port's
``preprocess_frame`` (f32: divides by 255 and by the ImageNet std, as the
eager reference writes it) against ``jax.jit`` of the reference's (under
jit XLA multiplies by the f32 reciprocals), then the port's arithmetic
with the reciprocal multiplies written out, which leaves the resize
products' summation order as the only difference.  Prints, for each, the
share of the outputs that differ and the largest difference.
"""

from __future__ import annotations

import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main() -> int:
    import jax
    import torch

    from vitvs_tpu.core import image as jimg
    from vitvs_tpu_torch.core import image as timg

    rgb = np.random.default_rng(0).integers(0, 256, (480, 640, 3), dtype=np.uint8)
    for size in (308, 518):
        ref = np.asarray(jax.jit(lambda x, s=size: jimg.preprocess_frame(x, s))(rgb))
        port = timg.preprocess_frame(torch.from_numpy(rgb), size).numpy()
        img = torch.from_numpy(rgb).float() * np.float32(1.0 / 255.0)
        img = timg.resize(img, (size, size), "bicubic", True)
        mean = torch.tensor(timg.IMAGENET_MEAN, dtype=torch.float32)
        inv_std = torch.tensor(timg.IMAGENET_STD, dtype=torch.float32).reciprocal()
        recip = ((img - mean) * inv_std).numpy()
        for name, out in (("as the port computes it", port), ("with reciprocals", recip)):
            apart = out != ref
            print(f"{size}: {name}: {100 * apart.mean():.1f}% of {out.size} outputs differ, "
                  f"max |diff| {np.abs(out - ref).max():.3e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
