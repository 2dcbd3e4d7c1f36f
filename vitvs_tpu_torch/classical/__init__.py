from vitvs_tpu_torch.classical.features import (
    grayscale,
    harris_response,
    detect_corners,
    sift_like_descriptors,
    match_descriptors,
)
from vitvs_tpu_torch.classical.scalespace import sift_features
from vitvs_tpu_torch.classical.binary import akaze_features, orb_features

__all__ = [
    "grayscale",
    "harris_response",
    "detect_corners",
    "sift_like_descriptors",
    "match_descriptors",
    "sift_features",
    "orb_features",
    "akaze_features",
]
