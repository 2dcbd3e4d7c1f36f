"""Tracing and profiling (``vitvs_tpu/utils/profiling.py``).

* :class:`StageTimer`: wall time by stage, each stage fenced on the device
  of the result it is given (``torch.cuda.synchronize`` of a CUDA tensor's
  card; nothing for a CPU tensor), so device work counts to the stage that
  launched it;
* :func:`trace_to`: ``torch.profiler`` over the CPU and, where there is
  one, the card, written as a Chrome trace file into a directory;
* :func:`annotate`: a named range in that trace
  (``torch.profiler.record_function``).
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Any, Dict

import torch


def _fence(result: Any) -> None:
    """Wait for the devices of the CUDA tensors in ``result`` (a tensor or a
    nest of tuples, lists and dicts of them)."""
    if isinstance(result, torch.Tensor):
        if result.device.type == "cuda":
            torch.cuda.synchronize(result.device)
    elif isinstance(result, (tuple, list)):
        for x in result:
            _fence(x)
    elif isinstance(result, dict):
        for x in result.values():
            _fence(x)


class StageTimer:
    """Accumulating per-stage timer.

    >>> t = StageTimer()
    >>> with t.stage("vit") as h:
    ...     h["result"] = vit_features(net, x)   # fenced on exit
    >>> t.summary()
    {'vit': {'total_s': ..., 'count': 1, 'mean_ms': ...}}
    """

    def __init__(self, fence: bool = True):
        self.fence = fence
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str, result: Any = None):
        t0 = time.perf_counter()
        holder: dict = {}
        try:
            yield holder
        finally:
            if self.fence:
                _fence(holder.get("result", result))
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {
            name: {
                "total_s": self.totals[name],
                "count": self.counts[name],
                "mean_ms": 1000.0 * self.totals[name] / max(self.counts[name], 1),
            }
            for name in self.totals
        }

    def report(self) -> str:
        rows = sorted(self.summary().items(), key=lambda kv: -kv[1]["total_s"])
        width = max((len(k) for k, _ in rows), default=5)
        lines = [f"{'stage':<{width}}  {'calls':>6}  {'mean ms':>9}  {'total s':>8}"]
        for k, v in rows:
            lines.append(f"{k:<{width}}  {v['count']:>6}  {v['mean_ms']:>9.3f}  {v['total_s']:>8.2f}")
        return "\n".join(lines)


TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace_to(log_dir: str):
    """``torch.profiler`` trace of everything inside the context, CPU and
    (with a card) CUDA activities, written to ``log_dir/trace.json`` (Chrome
    trace format) on exit.  Yields the profiler."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


def annotate(name: str):
    """A named host range in the profiler's timeline."""
    return torch.profiler.record_function(name)
