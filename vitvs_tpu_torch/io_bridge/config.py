"""Configuration: the same flat YAML schema and defaults as
``vitvs_tpu/io_bridge/config.py`` (the reference's ``config.yaml`` keys plus
the model / dtype / solver extensions), as a frozen dataclass."""

from __future__ import annotations

import dataclasses
import os
from typing import Any


@dataclasses.dataclass(frozen=True)
class VSConfig:
    # Camera / image
    u_max: int = 640
    v_max: int = 480
    f_x: float = 502.3016357421875
    f_y: float = 502.3016357421875

    # Control (min_error / max_error are loaded but never read, as in the reference)
    lambda_: float = 0.03
    max_velocity: float = 1.0
    min_error: float = 100.0
    max_error: float = 70000.0
    num_pairs: int = 24

    # DINO feature detection
    dino_input_size: int = 308
    background_thresh: float = 0.005
    # cyclical-distance eligibility threshold, threaded into find_correspondences
    thresh_filter_keypoints: float = 1.0
    use_feature_binning: bool = True

    # Sampling
    num_samples: int = 500
    num_circles: int = 4
    circle_radius_aug: float = 0.08
    rz_max_deg: float = 120.0

    # Convergence (inert by reference parity: the decision ladder hardcodes them)
    velocity_convergence_threshold: float = 0.00008
    velocity_threshold_translation: float = 5e-19
    velocity_threshold_rotation: float = 5e-19
    error_threshold_ratio: float = 0.001
    error_threshold_absolute_translation: float = 0.1
    error_threshold_absolute_rotation: float = 0.1

    # Iteration control
    min_iterations: int = 300
    max_iterations: int = 1500

    # EMA / velocity history
    max_velocity_vector_history: int = 200
    ema_alpha: float = 0.8

    image_path: str = "goalrgb.jpg"

    # ---- extensions without a reference equivalent ----
    model_name: str = "dinov2_vits14"
    stride: int = 14
    layer: int = 11
    facet: str = "token"
    compute_dtype: str = "bfloat16"
    pinv_mode: str = "svd"   # 'svd' (np.linalg.pinv parity) | 'dls' (damped Cholesky)
    pinv_damping: float = 1e-9
    divergence_multiplier: float = 2.0
    control_dt: float = 0.4
    # sub-patch parabola refinement of the current image's matched positions
    subpixel_matching: bool = True
    # phantom (0, 0) pixels for invalid pairs, as the reference's calculate_uv
    reference_pad_bug: bool = False
    max_feature_failures: int = 10
    attn_score: str = "softmax"
    kv_pool: int = 1
    kv_pool_impl: str = "window"
    kv_pool_where: str = "post"
    early_divergence_abort: bool = False

    def __post_init__(self) -> None:
        if self.kv_pool_impl not in ("window", "matmul"):
            raise ValueError(
                f"kv_pool_impl must be 'window' or 'matmul', "
                f"got {self.kv_pool_impl!r}")
        if self.attn_score not in ("softmax", "relu", "sqrelu"):
            raise ValueError(
                f"attn_score must be 'softmax', 'relu' or 'sqrelu', "
                f"got {self.attn_score!r}")
        if self.kv_pool_where not in ("post", "pre"):
            raise ValueError(
                f"kv_pool_where must be 'post' or 'pre', "
                f"got {self.kv_pool_where!r}")

    @property
    def c_x(self) -> float:
        return self.u_max / 2.0

    @property
    def c_y(self) -> float:
        return self.v_max / 2.0

    def replace(self, **kw: Any) -> "VSConfig":
        return dataclasses.replace(self, **kw)


_FIELDS = {f.name for f in dataclasses.fields(VSConfig)}


def _yaml():
    """pyyaml, which only config files need (a machine may lack it)."""
    try:
        import yaml
    except ImportError as e:
        raise ImportError("YAML config files need pyyaml, which is not installed; build "
                          "the VSConfig in code instead") from e
    return yaml


def load_config(path: str | os.PathLike) -> VSConfig:
    """Load a reference-format YAML config; unknown keys are ignored and
    missing keys take the defaults above."""
    yaml = _yaml()
    with open(path, "r") as fh:
        raw = yaml.safe_load(fh) or {}
    return VSConfig(**{k: v for k, v in raw.items() if k in _FIELDS})


def save_config(cfg: VSConfig, path: str | os.PathLike) -> None:
    """Write ``cfg`` as a YAML config that :func:`load_config` reads back."""
    yaml = _yaml()
    with open(path, "w") as fh:
        yaml.safe_dump(dataclasses.asdict(cfg), fh, sort_keys=False)
