"""Image files (poster textures) as float32 [0, 1] RGB numpy arrays
(``vitvs_tpu/io_bridge/images.py``).

The port's images are numpy archives (``np.savez_compressed`` of a uint8
(H, W, 3) array under the key ``image``), read without an image library:
the card's machine promises none.
"""

from __future__ import annotations

import numpy as np


def load_image(path: str) -> np.ndarray:
    """RGB float32 [0, 1] (H, W, 3) from an npz archive."""
    with np.load(path) as f:
        return np.asarray(f["image"], np.float32) / 255.0
