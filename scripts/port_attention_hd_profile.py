"""Where the any-width attention kernel's time goes, by phase, on the card.

Copies ``vitvs_tpu_torch/csrc/attention_hd.cu`` with clock64() stamps put
after each phase of the key-block loop (lane 0 of each warp of block
(0, 0) adds the cycles since its previous stamp to a device array), builds
the copy into ``vitvs_tpu_torch/_build/`` and launches it at pixel14's,
pixel8's, pixel14 @ 518's and pixel4 @ 308's shapes.  Prints, per shape,
the cycles a key block (or once, for the prologue and the end) of each
phase for warps 0 to 3, and the stamped build's CUDA-event time beside the
kernel's own and SDPA's at the shape.  The stamps cost a few percent.

Run on the card from the repository's root:

    python3 scripts/port_attention_hd_profile.py
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402
from vitvs_tpu_torch.ops import _build, attention  # noqa: E402

SHAPES = [("bf16", (1, 485, 1, 588), torch.bfloat16), ("f32", (1, 197, 1, 192), torch.float32),
          ("bf16", (1, 1370, 1, 588), torch.bfloat16), ("bf16", (1, 5930, 1, 48), torch.bfloat16)]
# (anchor line in the source, stamp index put after it); the phases run from one stamp to the next
STAMPS = [
    ("    cluster.sync();                                 // every block's barriers are armed\n", 0),
    ("    __syncthreads();                                // Q and key block 0 landed\n", 1),
    ("    send_scores(0);\n", 2),
    ("        __syncthreads();                            // every warp is past P_{j-1} V\n", 3),
    ("load_kv(j + pl.stages - 1);   // into block j - 1's stage\n        cp_async_commit();\n", 4),
    ("        mbar_wait(bar_recv + (j & 1), (j >> 1) & 1);\n", 5),
    ("        if (tid == 0 && j + 2 < nkb) mbar_arrive_expect_tx(bar_recv + (j & 1), recv_bytes);\n", 6),
    ("            __syncthreads();\n            score_block(j + 1);\n", 7),
    ("            if (nbuf == 2) send_scores(j + 1);\n", 8),
    ("        mbar_wait(bar_p + pb, (j / nbuf) & 1);\n", 9),
    ("               ldv, warp, lane);\n", 10),
    ("    cluster.sync();                                 // no remote access after this\n", 11),
]
PHASES = [("barrier init, cluster barrier", True), ("Q and block 0 loads", True),
          ("scores 0 and send", True), ("loop-top barrier", False), ("load issue", False),
          ("wait for the scores", False), ("owner softmax and P sends", False),
          ("wait for block j + 1, scores", False), ("send scores j + 1", False),
          ("wait for P", False), ("P V", False), ("row sums and the end barrier", True)]


def stamped_source() -> str:
    src = (_build.CSRC_DIR / "attention_hd.cu").read_text()
    src = src.replace('#include "sm90_ptx.cuh"', f'#include "{_build.CSRC_DIR}/sm90_ptx.cuh"')
    src = src.replace("namespace cg = cooperative_groups;", """namespace cg = cooperative_groups;
__device__ unsigned long long g_prof[64];
#define STAMP(i) do { if (lane == 0 && blockIdx.x == 0 && blockIdx.y == 0) { \\
    const unsigned long long t_ = clock64(); g_prof[(i) + 16 * warp] += t_ - t_last; t_last = t_; } } while (0)
extern "C" int prof_read(unsigned long long* out) {
    return (int)cudaMemcpyFromSymbol(out, g_prof, sizeof(g_prof)); }
extern "C" int prof_reset() {
    unsigned long long z[64] = {}; return (int)cudaMemcpyToSymbol(g_prof, z, sizeof(z)); }""")
    anchor = "    const float C = scale * 1.4426950408889634f;    // D^-0.5 log2(e)\n"
    src = src.replace(anchor, anchor + "    unsigned long long t_last = clock64();\n")
    for line, i in STAMPS:
        if src.count(line) != 1:
            raise RuntimeError(f"the kernel source changed: anchor {line.strip()!r} found "
                               f"{src.count(line)} times")
        src = src.replace(line, line + f"    STAMP({i});\n")
    return src


def build() -> ctypes.CDLL:
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = _build.BUILD_DIR / "attention_hd_stamped.cu"
    so = _build.BUILD_DIR / "libattention_hd_stamped.so"
    cu.write_text(stamped_source())
    subprocess.run([_build._nvcc(), *_build.COMPILE_FLAGS, "-shared", str(cu), "-o", str(so)],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(so))
    for entry in attention.HD_ENTRIES.values():
        getattr(lib, entry).argtypes = _build._SIGNATURES[entry][0]
        getattr(lib, entry).restype = ctypes.c_int
    return lib


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    lib = build()
    print(chip_smoke.card_line(), flush=True)
    rs = np.random.default_rng(0)
    stream = torch.cuda.current_stream().cuda_stream
    for name, shape, dtype in SHAPES:
        q, k, v = (chip_smoke._normal("cuda", shape, rs, dtype) for _ in range(3))
        o = torch.empty_like(q)
        B, T, H, D = shape
        entry = attention.HD_ENTRIES[dtype]
        fn = getattr(lib, entry)

        def stamped():
            _build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B, T, H, D,
                            D ** -0.5, stream), "stamped any-width attention")

        for _ in range(5):
            stamped()
        torch.cuda.synchronize()
        lib.prof_reset()
        n = 20
        for _ in range(n):
            stamped()
        torch.cuda.synchronize()
        buf = (ctypes.c_ulonglong * 64)()
        lib.prof_read(buf)
        nkb = -(-T // 64)
        plan = attention.hd_plan(D, dtype, q.data_ptr(), k.data_ptr(), v.data_ptr())
        qh, kh, vh = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        sdpa = torch.nn.functional.scaled_dot_product_attention
        print(f"{name} {shape}: {nkb} key blocks; cluster {plan['cluster']} x slice "
              f"{plan['slice']}; cycles of warp 0 a launch {sum(buf[:12]) / n:.0f}; "
              f"stamped {chip_smoke.cuda_ms(stamped):.4f} ms, kernel "
              f"{chip_smoke.cuda_ms(lambda: attention._launch(entry, q, k, v, D, D ** -0.5)):.4f}"
              f" ms, SDPA {chip_smoke.cuda_ms(lambda: sdpa(qh, kh, vh)):.4f} ms", flush=True)
        for i, (phase, once) in enumerate(PHASES):
            per = [buf[16 * w + i] / n / (1 if once else nkb) for w in range(4)]
            print(f"  {phase:32s} " + " ".join(f"{x:8.0f}" for x in per)
                  + (" (once)" if once else " (a key block)"), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
