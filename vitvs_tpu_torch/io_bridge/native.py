"""ctypes bindings of the native sensor bridge (``native/sensor_bridge.cpp``;
``vitvs_tpu/io_bridge/native.py``).

The library is built at first use from the source as it stands in the
checkout, with ``$CXX`` (or ``c++``) and the Makefile's flags, into
``vitvs_tpu_torch/_build/`` under a name that carries the hash of the source
and the flags; each build writes a temporary file of its own and renames it
into place, so parallel builds are safe, and nothing is written under
``native/``.
Without a compiler each function takes its numpy version (host code, not a
device kernel), as the JAX package does.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import logging
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np

from vitvs_tpu_torch.ops._build import BUILD_DIR, PKG_DIR

_log = logging.getLogger(__name__)

SOURCE = PKG_DIR.parent / "native" / "sensor_bridge.cpp"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared")

_P, _I, _I64, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
# C entry points: (argtypes, restype)
_SIGNATURES = {
    "fb_create": ([_I, _I], _P),
    "fb_create_ir": ([_I, _I], _P),
    "fb_destroy": ([_P], None),
    "fb_publish": ([_P, _P, _P, _F, _F], None),
    "fb_publish_ir": ([_P, _P, _P, _P, _P, _F, _F], None),
    "fb_latest": ([_P, _P, _P], ctypes.c_uint64),
    "fb_latest_ir": ([_P, _P, _P, _P, _P], ctypes.c_uint64),
    "depth_m_to_u16mm": ([_P, _P, _I64, _F, _F], None),
    "depth_u16mm_to_m": ([_P, _P, _I64], None),
    "rgb8_to_unit_float": ([_P, _P, _I64, _P, _P], None),
    "bilinear_resize_u8": ([_P, _I, _I, _P, _I, _I], None),
}


def build_library(build_dir: Path = BUILD_DIR) -> Path:
    """The shared library of :data:`SOURCE` in ``build_dir``, compiled unless
    it is there.  Raises RuntimeError without a compiler or when it fails."""
    tag = hashlib.sha256(" ".join(CXX_FLAGS).encode() + SOURCE.read_bytes()).hexdigest()[:16]
    lib = build_dir / f"libsensor_bridge-{tag}.so"
    if lib.is_file():
        return lib
    cxx = os.environ.get("CXX") or shutil.which("c++") or shutil.which("g++")
    if not cxx:
        raise RuntimeError("no C++ compiler ($CXX, c++ or g++)")
    build_dir.mkdir(parents=True, exist_ok=True)
    fd, name = tempfile.mkstemp(dir=build_dir, prefix=f".tmp-{lib.stem}-", suffix=".so")
    os.close(fd)
    tmp = Path(name)
    try:
        done = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                              capture_output=True, text=True, timeout=300)
        if done.returncode != 0:
            raise RuntimeError(f"{cxx} failed ({done.returncode}) on {SOURCE.name}:\n"
                               f"{done.stderr}")
        os.replace(tmp, lib)
    finally:
        tmp.unlink(missing_ok=True)
    return lib


@functools.cache
def _load() -> ctypes.CDLL | None:
    """The loaded library, built first if needed, or None (numpy versions)."""
    try:
        lib = ctypes.CDLL(str(build_library()))
    except (OSError, RuntimeError, subprocess.SubprocessError) as exc:
        _log.warning("native sensor bridge unavailable (%s); using the numpy versions", exc)
        return None
    for name, (argtypes, restype) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib


def native_available() -> bool:
    return _load() is not None


def _depth_m_to_u16mm_np(d: np.ndarray, min_range: float, max_range: float) -> np.ndarray:
    ok = np.isfinite(d) & (d >= min_range) & (d <= max_range)
    with np.errstate(invalid="ignore"):                 # NaN and out-of-range casts, masked
        mm = (d * 1000.0 + 0.5).astype(np.uint16)
    return np.where(ok, mm, 0).astype(np.uint16)


def depth_m_to_u16mm(depth_m: np.ndarray, min_range: float = 0.1,
                     max_range: float = 10.0) -> np.ndarray:
    """float metres -> uint16 mm, 0 outside [min_range, max_range] or not
    finite (the emulated RealSense's clip)."""
    d = np.ascontiguousarray(depth_m, np.float32)
    lib = _load()
    if lib is None:
        return _depth_m_to_u16mm_np(d, min_range, max_range)
    out = np.empty(d.shape, np.uint16)
    lib.depth_m_to_u16mm(d.ctypes.data, out.ctypes.data, d.size, min_range, max_range)
    return out


def depth_u16mm_to_m(depth_mm: np.ndarray) -> np.ndarray:
    d = np.ascontiguousarray(depth_mm, np.uint16)
    lib = _load()
    if lib is None:
        return d.astype(np.float32) * np.float32(0.001)
    out = np.empty(d.shape, np.float32)
    lib.depth_u16mm_to_m(d.ctypes.data, out.ctypes.data, d.size)
    return out


def _rgb8_to_unit_float_np(r: np.ndarray, mean, std) -> np.ndarray:
    out = r.astype(np.float32) / np.float32(255.0)
    if mean is not None:
        out = (out - np.asarray(mean, np.float32)) / np.asarray(std, np.float32)
    return out


def rgb8_to_unit_float(rgb: np.ndarray, mean=None, std=None) -> np.ndarray:
    """uint8 RGB -> float32 in [0, 1], then (x - mean) / std when given."""
    if (mean is None) != (std is None):
        raise ValueError("pass mean and std together (or neither)")
    r = np.ascontiguousarray(rgb, np.uint8)
    lib = _load()
    if lib is None:
        return _rgb8_to_unit_float_np(r, mean, std)
    out = np.empty(r.shape, np.float32)
    m = None if mean is None else np.ascontiguousarray(mean, np.float32)
    s = None if std is None else np.ascontiguousarray(std, np.float32)
    lib.rgb8_to_unit_float(r.ctypes.data, out.ctypes.data, r.size // 3,
                           None if m is None else m.ctypes.data,
                           None if s is None else s.ctypes.data)
    return out


def _bilinear_resize_u8_np(r: np.ndarray, oh: int, ow: int) -> np.ndarray:
    ih, iw, _ = r.shape
    ys = np.clip((np.arange(oh) + 0.5) * ih / oh - 0.5, 0, ih - 1)
    xs = np.clip((np.arange(ow) + 0.5) * iw / ow - 0.5, 0, iw - 1)
    y0 = np.minimum(ys.astype(int), ih - 2)
    x0 = np.minimum(xs.astype(int), iw - 2)
    fy = (ys - y0)[:, None, None]
    fx = (xs - x0)[None, :, None]
    a = r[y0][:, x0].astype(np.float32)
    b = r[y0][:, x0 + 1].astype(np.float32)
    c = r[y0 + 1][:, x0].astype(np.float32)
    d = r[y0 + 1][:, x0 + 1].astype(np.float32)
    return ((a * (1 - fx) + b * fx) * (1 - fy) + (c * (1 - fx) + d * fx) * fy
            + 0.5).astype(np.uint8)


def bilinear_resize_u8(rgb: np.ndarray, oh: int, ow: int) -> np.ndarray:
    """uint8 RGB (H, W, 3) -> (oh, ow, 3), bilinear, half-pixel centres."""
    r = np.ascontiguousarray(rgb, np.uint8)
    lib = _load()
    if lib is None:
        return _bilinear_resize_u8_np(r, oh, ow)
    ih, iw, _ = r.shape
    out = np.empty((oh, ow, 3), np.uint8)
    lib.bilinear_resize_u8(r.ctypes.data, ih, iw, out.ctypes.data, oh, ow)
    return out


class NativeFrameBuffer:
    """Seqlock'd latest-frame mailbox (one producer, any readers): the
    last frame published wins, readers see a consistent frame.  Without the
    library a Python buffer under the interpreter lock stands in."""

    def __init__(self, width: int, height: int, min_range: float = 0.1,
                 max_range: float = 10.0, with_ir: bool = False):
        self.width = width
        self.height = height
        self.min_range = min_range
        self.max_range = max_range
        self.with_ir = with_ir
        self._lib = _load()
        self._h = None
        if self._lib is not None:
            self._h = (self._lib.fb_create_ir(width, height) if with_ir
                       else self._lib.fb_create(width, height))
        else:
            self._rgb = np.zeros((height, width, 3), np.uint8)
            self._depth = np.zeros((height, width), np.float32)
            self._ir = np.zeros((2, height, width), np.uint8) if with_ir else None
            self._stamp = 0

    def publish(self, rgb: np.ndarray, depth_m: np.ndarray,
                ir1: np.ndarray | None = None, ir2: np.ndarray | None = None) -> None:
        """Publish a frame.  ir1 and ir2 come together; on a with_ir buffer a
        frame without them keeps the last IR planes (the plugin's sensors
        publish at their own rates)."""
        rgb = np.ascontiguousarray(rgb, np.uint8)
        depth = np.ascontiguousarray(depth_m, np.float32)
        if rgb.shape != (self.height, self.width, 3) or depth.shape != (self.height, self.width):
            # the C side copies width * height * 3 bytes from the pointer
            raise ValueError(f"frame shape mismatch: rgb {rgb.shape} / depth {depth.shape} "
                             f"vs buffer ({self.height}, {self.width})")
        if (ir1 is None) != (ir2 is None):
            raise ValueError("pass ir1 and ir2 together (or neither)")
        has_ir = ir1 is not None
        if has_ir:
            if not self.with_ir:
                raise ValueError("buffer created without with_ir=True")
            ir1 = np.ascontiguousarray(ir1, np.uint8)
            ir2 = np.ascontiguousarray(ir2, np.uint8)
            if ir1.shape != (self.height, self.width) or ir1.shape != ir2.shape:
                raise ValueError(f"IR shape mismatch: {ir1.shape} / {ir2.shape} "
                                 f"vs buffer ({self.height}, {self.width})")
        if self._h is not None:
            if has_ir:
                self._lib.fb_publish_ir(self._h, rgb.ctypes.data, depth.ctypes.data,
                                        ir1.ctypes.data, ir2.ctypes.data,
                                        self.min_range, self.max_range)
            else:
                self._lib.fb_publish(self._h, rgb.ctypes.data, depth.ctypes.data,
                                     self.min_range, self.max_range)
            return
        ok = np.isfinite(depth) & (depth >= self.min_range) & (depth <= self.max_range)
        self._rgb = rgb.copy()
        self._depth = np.where(ok, np.round(depth * 1000) / 1000, 0.0).astype(np.float32)
        if has_ir:
            self._ir = np.stack([ir1, ir2])
        self._stamp += 1

    def latest(self) -> tuple[int, np.ndarray, np.ndarray]:
        """(stamp, rgb uint8 (H, W, 3), depth metres (H, W)) of the last frame."""
        if self._h is None:
            return self._stamp, self._rgb.copy(), self._depth.copy()
        rgb = np.empty((self.height, self.width, 3), np.uint8)
        depth = np.empty((self.height, self.width), np.float32)
        stamp = self._lib.fb_latest(self._h, rgb.ctypes.data, depth.ctypes.data)
        return int(stamp), rgb, depth

    def latest_ir(self) -> tuple[int, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """The last four-sensor frame (stamp, rgb, depth_m, ir1, ir2)."""
        if not self.with_ir:
            raise ValueError("buffer created without with_ir=True")
        if self._h is None:
            return (self._stamp, self._rgb.copy(), self._depth.copy(),
                    self._ir[0].copy(), self._ir[1].copy())
        rgb = np.empty((self.height, self.width, 3), np.uint8)
        depth = np.empty((self.height, self.width), np.float32)
        ir1 = np.empty((self.height, self.width), np.uint8)
        ir2 = np.empty((self.height, self.width), np.uint8)
        stamp = self._lib.fb_latest_ir(self._h, rgb.ctypes.data, depth.ctypes.data,
                                       ir1.ctypes.data, ir2.ctypes.data)
        return int(stamp), rgb, depth, ir1, ir2

    def get_frame(self) -> tuple[np.ndarray, np.ndarray]:
        """The FrameSource protocol of ``io_bridge/host_loop.py``."""
        _, rgb, depth = self.latest()
        return rgb, depth

    def close(self) -> None:
        """Free the native buffer (also done when the object is collected)."""
        if self._h is not None:
            self._lib.fb_destroy(self._h)
            self._h = None

    def __del__(self):
        if getattr(self, "_h", None) is not None:
            self.close()
