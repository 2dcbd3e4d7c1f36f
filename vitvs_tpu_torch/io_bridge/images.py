"""Image files (goal images, poster textures) as float32 [0, 1] RGB numpy
arrays (``vitvs_tpu/io_bridge/images.py``).

The port's own images are numpy archives (``np.savez_compressed`` of a
uint8 (H, W, 3) array under the key ``image``), read without an image
library: the card's machine promises none.  Other formats go through
Pillow, which is imported only for them.
"""

from __future__ import annotations

import numpy as np


def _pil():
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError("image files other than .npz need Pillow, which is not "
                          "installed; pass an .npz with an 'image' array") from e
    return Image


def load_image(path: str) -> np.ndarray:
    """RGB float32 [0, 1] (H, W, 3) from an npz archive or an image file."""
    if str(path).endswith(".npz"):
        with np.load(path) as f:
            return np.asarray(f["image"], np.float32) / 255.0
    img = _pil().open(path).convert("RGB")
    return np.asarray(img, np.float32) / 255.0


def load_goal_image(path: str) -> np.ndarray:
    """The reference's name for :func:`load_image`."""
    return load_image(path)


def _uint8(rgb) -> np.ndarray:
    arr = np.asarray(rgb)
    if arr.dtype != np.uint8:
        arr = (np.clip(arr, 0.0, 1.0) * 255).astype(np.uint8)
    return arr


def save_image(path: str, rgb: np.ndarray) -> None:
    """Write RGB (H, W, 3) (uint8, or float in [0, 1]): an npz archive, or
    an image file through Pillow."""
    if str(path).endswith(".npz"):
        np.savez_compressed(path, image=_uint8(rgb))
        return
    _pil().fromarray(_uint8(rgb)).save(path)
