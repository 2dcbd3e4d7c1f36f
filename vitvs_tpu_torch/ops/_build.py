"""Build and load the CUDA kernels of ``csrc/``.

One ``nvcc -c`` per ``csrc/*.cu``, all started together, then one ``nvcc``
link of the objects into one shared library with a plain C interface,
loaded with ``ctypes`` (no PyTorch headers: the build takes seconds).  The
library lands in ``vitvs_tpu_torch/_build/`` under a name that carries the
hash of the sources, the headers they share and the flags, so it is rebuilt
only when they change.  The build writes to temporary names and renames the
library into place, so an interrupted build leaves no lock or partial file
behind.

Nothing here runs at import; the first kernel launch builds and loads.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
COMPILE_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_long, ctypes.c_float
# C entry points: (argtypes, restype)
_SIGNATURES = {
    "vitvs_attention_fwd": ([_P, _P, _P, _P, _I, _I, _I, _P], _I),
    "vitvs_attention_split_fwd": ([_P, _P, _P, _P, _I, _I, _I, _I, _P], _I),
    "vitvs_attention_bf16l_fwd": ([_P, _P, _P, _P, _I, _I, _I, _P], _I),
    "vitvs_attention_fast_fwd": ([_P, _P, _P, _P, _I, _I, _I, _P], _I),
    "vitvs_attn_int8_fwd": ([_P] * 4 + [_I] * 3 + [_L] * 6 + [_F, _P], _I),
    "vitvs_quant_th_probe": ([_P] * 3 + [_I, _I, _L, _F, _I, _P], _I),
    "vitvs_attention_f32_fwd": ([_P, _P, _P, _P, _I, _I, _I, _P], _I),
    "vitvs_attention_hd_fwd": ([_P] * 4 + [_I] * 4 + [_F, _P], _I),
    "vitvs_attention_hd_f32_fwd": ([_P] * 4 + [_I] * 4 + [_F, _P], _I),
    "vitvs_attention_hd_plan": ([_I, _I, _L, _P], _I),
    "vitvs_dual_argmax_cosine": ([_P] * 7 + [_I] * 7 + [_P], _I),
    "vitvs_dual_argmax_bf16": ([_P] * 7 + [_I] * 4 + [_P], _I),
    "vitvs_error_string": ([_I], ctypes.c_char_p),
}


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").is_file():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                           "of vitvs_tpu_torch cannot be built")
    return found


def sources() -> tuple[list[Path], list[Path]]:
    """The CUDA sources (one object each) and the headers they share (which
    enter the library's hash)."""
    return sorted(CSRC_DIR.glob("*.cu")), sorted(CSRC_DIR.glob("*.cuh"))


def _digest(srcs: list[Path]) -> str:
    h = hashlib.sha256(" ".join(COMPILE_FLAGS).encode())
    for p in srcs:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


@functools.cache
def build() -> dict:
    """Compile the kernels unless a library for these sources exists.

    Returns {'path', 'seconds', 'compiled', 'log'}; ``log`` holds nvcc's
    output (the ``-Xptxas -v`` register and shared-memory lines).  Raises
    when nvcc fails.
    """
    srcs, headers = sources()
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC_DIR}")
    tag = _digest(srcs + headers)
    lib = BUILD_DIR / f"libvitvs_kernels-{tag}.so"
    log = BUILD_DIR / f"libvitvs_kernels-{tag}.log"
    if lib.is_file():
        return {"path": str(lib), "seconds": 0.0, "compiled": False,
                "log": log.read_text() if log.is_file() else ""}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f".tmp-{os.getpid()}-{lib.name}"
    objs = [BUILD_DIR / f".tmp-{os.getpid()}-{src.stem}.o" for src in srcs]
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = []
    try:
        for src, obj in zip(srcs, objs):
            procs.append(subprocess.Popen([nvcc, *COMPILE_FLAGS, "-c", str(src), "-o", str(obj)],
                                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                          text=True))
        out = ""
        for src, proc in zip(srcs, procs):
            text = proc.communicate(timeout=600)[0]
            out += text
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}) on {src.name}:\n{text}")
        cmd = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]
        link = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
        out += link.stdout + link.stderr
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}): {' '.join(cmd)}\n{out}")
    except BaseException:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for p in (tmp, *objs):
            p.unlink(missing_ok=True)
        raise
    for obj in objs:
        obj.unlink(missing_ok=True)
    seconds = time.perf_counter() - t0
    log.write_text(out)
    os.replace(tmp, lib)
    return {"path": str(lib), "seconds": seconds, "compiled": True, "log": out}


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    lib = ctypes.CDLL(build()["path"])
    for name, (argtypes, restype) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error (a refused launch)."""
    if err != 0:
        msg = library().vitvs_error_string(err).decode()
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err} ({msg})")


def refuse_grad(what: str, *tensors) -> None:
    """Raise when grad is enabled and an input requires it: the hand kernels
    have no backward, and their output would carry no ``grad_fn`` (their
    share of the gradient would vanish without a word).  Called before any
    device check, so CPU tensors take it too."""
    import torch

    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(f"{what}: the kernel has no backward; inputs that require grad "
                           f"take the plain version (the training forward runs "
                           f"use_kernels=False)")
