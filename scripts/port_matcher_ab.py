#!/usr/bin/env python3
"""A/B of the port's matcher kernels (``vitvs_tpu_torch/csrc/matcher.cu``)
across trees, on one NVIDIA card: the device time of one launch of each
mode at ViT-S/14 @ 308's and @ 518's shapes, (484 or 1369, 3456).

    python3 scripts/port_matcher_ab.py parent=PATH change=PATH [NAME=PATH ...]

Each PATH is the root of a tree that holds ``vitvs_tpu_torch/ops`` and
``vitvs_tpu_torch/csrc`` (for the parent commit: ``git archive HEAD
vitvs_tpu_torch/ops vitvs_tpu_torch/csrc vitvs_tpu_torch/__init__.py``
unpacked into a git-ignored directory).  The trees run in alternating
order, each in a process of its own that builds its kernels: names in the
order given, then reversed.  Times are CUDA events over 200 launches queued
behind a device sleep.  A tree whose matcher takes a batch of frames is
also held bit for bit: a batch of 3 frames against 3 single launches, both
modes.  Prints one JSON line per run and writes them all to
``chiprun_out/port_matcher_ab.json``.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

CHILD = r'''
import json, sys
root = sys.argv[1]
sys.path.insert(0, root)
import numpy as np, torch
import vitvs_tpu_torch
if not vitvs_tpu_torch.__file__.startswith(root):
    raise SystemExit(f"imported {vitvs_tpu_torch.__file__}, not the tree at {root}")
from vitvs_tpu_torch.ops import _build, matcher

_build.build()
_build.library()
batched = len(_build._SIGNATURES["vitvs_dual_argmax_bf16"][0]) == 12


def ms(fn, iters=200):
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    sleep = 50_000_000
    for _ in range(4):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(sleep)
        s.record()
        for _ in range(iters):
            fn()
        e.record()
        queued_in_time = not s.query()
        torch.cuda.synchronize()
        if queued_in_time:
            break
        sleep *= 2
    return s.elapsed_time(e) / iters


rs = np.random.default_rng(3)
out = {}
for t in (484, 1369):
    a = torch.from_numpy(rs.standard_normal((t, 3456)).astype(np.float32)).cuda()
    b = torch.from_numpy(rs.standard_normal((t, 3456)).astype(np.float32)).cuda()
    ua, ub = matcher.bf16_unit_rows(a.bfloat16()), matcher.bf16_unit_rows(b.bfloat16())
    bb, fb = (ub[None], b[None]) if batched else (ub, b)
    out[f"bf16_{t}_ms"] = ms(lambda: matcher._launch_bf16(ua, bb))
    out[f"f32_{t}_ms"] = ms(lambda: matcher._launch_f32(a, fb))
if batched:
    bits = lambda x: x.view(torch.int32) if x.dtype == torch.float32 else x
    a = torch.from_numpy(rs.standard_normal((484, 3456)).astype(np.float32)).cuda().bfloat16()
    b = torch.from_numpy(rs.standard_normal((3, 484, 3456)).astype(np.float32)).cuda().bfloat16()
    same = True
    for fn in (matcher.dual_argmax_cosine_bf16, matcher.dual_argmax_cosine):
        got = fn(a, b)
        for i in range(3):
            same &= all(torch.equal(bits(x[i]), bits(y)) for x, y in zip(got, fn(a, b[i])))
    out["batch_equals_single_launches"] = bool(same)
print(json.dumps(out))
'''


def main() -> int:
    roots = dict(arg.split("=", 1) for arg in sys.argv[1:])
    if len(roots) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    order = list(roots) + list(reversed(roots))
    runs = []
    for name in order:
        root = str(Path(roots[name]).resolve())
        r = subprocess.run([sys.executable, "-c", CHILD, root], capture_output=True, text=True)
        if r.returncode:
            print(r.stderr[-3000:], file=sys.stderr)
            return 1
        runs.append({"tree": name, **json.loads(r.stdout.strip().splitlines()[-1])})
        print(json.dumps(runs[-1]), flush=True)
    out = Path(__file__).resolve().parent.parent / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "port_matcher_ab.json").write_text(json.dumps(runs))
    return 0


if __name__ == "__main__":
    sys.exit(main())
