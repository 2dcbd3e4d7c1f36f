"""The port's profiling utilities (``utils/profiling.py``) on the CPU:
StageTimer as tests/test_harness.py:271 asks of the JAX package's, its
fence over nests of results and its report in the JAX package's format, and
trace_to writing a Chrome trace that holds the annotate ranges."""

import json

import numpy as np
import torch

from vitvs_tpu.utils.profiling import StageTimer as JStageTimer
from vitvs_tpu_torch.utils import profiling
from vitvs_tpu_torch.utils.profiling import StageTimer, annotate, trace_to


def test_stage_timer():
    t = StageTimer()
    with t.stage("work") as h:
        h["result"] = torch.zeros(10) + 1
    with t.stage("work"):
        pass
    with t.stage("nest", result=(torch.ones(2), {"a": [torch.zeros(1)]})):
        pass
    s = t.summary()
    assert s["work"]["count"] == 2 and s["nest"]["count"] == 1
    assert s["work"]["mean_ms"] == 1000.0 * s["work"]["total_s"] / 2
    assert "work" in t.report()


def test_report_is_the_jax_packages():
    """The same totals and counts give the same summary and report text."""
    ours, theirs = StageTimer(), JStageTimer()
    for timer in (ours, theirs):
        for name, total, count in (("vit", 1.25, 10), ("match", 0.5, 10), ("render", 2.0, 3)):
            timer.totals[name] = total
            timer.counts[name] = count
    assert ours.summary() == theirs.summary()
    assert ours.report() == theirs.report()
    assert StageTimer().report() == JStageTimer().report()


def test_fence_waits_only_for_card_tensors(monkeypatch):
    """The fence synchronizes the card of each CUDA tensor of the result and
    nothing for CPU tensors (no synchronize call here)."""
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: calls.append(device))
    profiling._fence([torch.zeros(3), {"x": (torch.ones(1), 5)}, None, np.zeros(2)])
    assert calls == []
    timer = StageTimer(fence=False)
    with timer.stage("unfenced", result=torch.zeros(1)):
        pass
    assert timer.counts["unfenced"] == 1 and calls == []


def test_trace_to_writes_the_annotated_ranges(tmp_path):
    with trace_to(str(tmp_path / "trace")) as prof:
        with annotate("outer_range"):
            with annotate("inner_range"):
                torch.ones(64, 64) @ torch.ones(64, 64)
    assert prof is not None
    events = json.loads((tmp_path / "trace" / profiling.TRACE_FILE).read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert {"outer_range", "inner_range"} <= names
    assert any("mm" in str(n) for n in names)
