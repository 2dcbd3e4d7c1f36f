"""What the host decides for the any-width attention kernel
(``csrc/attention_hd.cu``), checked without a card: the launch geometry of
``ops/attention.py:hd_plan`` at every head width from 1 to 1024, bf16 and
f32, at aligned pointers and at those of pixel14's qkv split; its constants
against the kernel source's; its refusals before any launch; and the
smoke's edge checks at a small size on the CPU."""

import re
from pathlib import Path

import pytest
import torch

import chip_smoke
from vitvs_tpu_torch.ops import _build, attention

CSRC = Path(attention.__file__).resolve().parent.parent / "csrc" / "attention_hd.cu"
DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}
BASE = 1 << 20            # an allocation's start: 256-byte aligned as PyTorch's are


def _pointers(d, dtype, layout):
    """q, k, v addresses: three allocations, or the slices of one
    (3, 1, 485, 1, d) tensor (pixel14 @ 308's qkv split at width d)."""
    es = 2 if dtype == torch.bfloat16 else 4
    if layout == "aligned":
        return [BASE, 2 * BASE, 3 * BASE]
    return [BASE + i * 485 * d * es for i in range(3)]


@pytest.mark.parametrize("layout", ["aligned", "qkv_split"])
@pytest.mark.parametrize("dt", DTYPES)
def test_geometry_at_every_width(dt, layout):
    """For every d in 1..1024: the slices tile d zero-padded to the k-step
    exactly once, each holding a real dim; the cluster is at most 8; shared
    memory at most 232,448 bytes; the copy width is 16, 8, 4 or (bf16 only)
    2 bytes and divides every pointer and the row stride in bytes."""
    dtype = DTYPES[dt]
    es = 2 if dtype == torch.bfloat16 else 4
    seen_copies = set()
    for d in range(1, attention.HD_MAX + 1):
        ptrs = _pointers(d, dtype, layout)
        p = attention.hd_plan(d, dtype, *ptrs)
        ks = p["kstep"]
        dp = -(-d // ks) * ks
        starts = [s for s, _ in p["slices"]]
        widths = [w for _, w in p["slices"]]
        assert 1 <= p["cluster"] == len(p["slices"]) <= 8, (d, p)
        assert starts == [sum(widths[:i]) for i in range(len(widths))], (d, p)
        assert sum(widths) == dp and dp - d < ks, (d, p)
        assert all(w % ks == 0 and 0 < w <= p["slice"] for w in widths), (d, p)
        assert starts[-1] < d, (d, p)                 # the last slice holds a real dim
        assert p["smem"] <= attention.SMEM_LIMIT, (d, p)
        assert p["stages"] in (2, 3) and p["pbufs"] in (1, 2), (d, p)
        assert p["copy"] in ((16, 8, 4, 2) if es == 2 else (16, 8, 4)), (d, p)
        for heads in (1, 3):                          # row stride H d elements
            assert heads * d * es % p["copy"] == 0, (d, p)
        assert all(ptr % p["copy"] == 0 for ptr in ptrs), (d, p)
        # the widest such width: twice it divides neither a pointer nor the row
        if p["copy"] < 16:
            wider = 2 * p["copy"]
            assert d * es % wider or any(ptr % wider for ptr in ptrs), (d, p)
        seen_copies.add(p["copy"])
    if layout == "qkv_split" and es == 2:
        assert seen_copies == {16, 8, 4, 2}


def test_geometry_of_the_pixel_widths():
    """The geometry the source note states: 8 x 80 at pixel14's 588, 6 x 32
    at pixel8's 192, 2 x 32 at pixel4's 48; pixel14's qkv split (k and v 8
    bytes off a 16-byte boundary) takes 8-byte copies; f32 at 1024 keeps
    two stages and one P tile to fit."""
    b16, f32 = torch.bfloat16, torch.float32
    assert [attention.hd_plan(d, b16, 0)["slices"] for d in (588, 192, 48)] == [
        [(80 * r, 80) for r in range(7)] + [(560, 32)], [(32 * r, 32) for r in range(6)],
        [(0, 32), (32, 16)]]
    q, k, v = torch.zeros((3, 1, 485, 1, 588), dtype=b16).unbind(0)
    assert k.data_ptr() % 16 == 8
    assert attention.hd_plan(588, b16, q.data_ptr(), k.data_ptr(), v.data_ptr())["copy"] == 8
    assert attention.hd_plan(27, b16, 0)["copy"] == 2 and attention.hd_plan(27, f32, 0)["copy"] == 4
    big = attention.hd_plan(1024, f32, 0)
    assert (big["cluster"], big["slice"], big["stages"], big["pbufs"]) == (8, 128, 2, 1)


def _constant(name):
    m = re.search(rf"constexpr int {name} = (\d+);", CSRC.read_text())
    assert m, name
    return int(m.group(1))


def test_geometry_constants_follow_the_kernel_source():
    """hd_plan's constants are the kernel's (make_plan in the source reads
    them; vitvs_attention_hd_plan returns its geometry, which chip_smoke.py
    holds equal to hd_plan's on the card)."""
    assert _constant("BQ") == _constant("BK") == attention.HD_ROWS
    assert _constant("KSTEP") == attention.HD_KSTEP
    assert _constant("MIN_SLICE") == attention.HD_MIN_SLICE
    assert _constant("MAX_CLUSTER") == attention.HD_MAX_CLUSTER
    assert _constant("MAX_D") == attention.HD_MAX
    assert _constant("SMEM_LIMIT") == attention.SMEM_LIMIT
    assert "vitvs_attention_hd_plan" in _build._SIGNATURES


@pytest.mark.parametrize("bad", ["width", "dtype", "pointer"])
def test_geometry_refuses_what_the_kernel_cannot_take(bad):
    with pytest.raises(ValueError):
        if bad == "width":
            attention.hd_plan(1025, torch.bfloat16, 0)
        elif bad == "dtype":
            attention.hd_plan(48, torch.float16, 0)
        else:
            attention.hd_plan(48, torch.float32, 0, 2, 0)


def test_any_width_launch_refuses_a_grid_it_cannot_take(monkeypatch):
    """B x h above the grid's 65535 rows raises before the library is
    reached (meta tensors stand in for CUDA ones)."""
    def refuse(*_):
        raise AssertionError("the kernel was launched")

    monkeypatch.setattr(attention, "_check",
                        lambda q, k, v, dtype, head_dim: attention._check_layout(
                            q, k, v, dtype, head_dim))
    monkeypatch.setattr(attention, "_launch", refuse)
    q = torch.empty((65536, 2, 1, 48), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="65535"):
        attention._attention_hd(q, q, q, torch.bfloat16)


def test_smoke_edge_checks_run_small_on_cpu():
    """chip_smoke.check_attention_hd_edges at small long-T stand-ins: on the
    CPU both sides are the plain version (0 error), the qkv split's k sits
    8 bytes off in bf16 and takes 8-byte copies."""
    out = chip_smoke.check_attention_hd_edges("cpu", long_shapes=((1, 70, 1, 588), (1, 130, 1, 48)),
                                              split_shape=(1, 37, 1, 588))
    assert set(out["long"].values()) == {0.0} and len(out["long"]) == 4
    assert out["qkv_split"]["bf16"] == {"k_offset_mod_16": 8, "copy": 8, "max_abs_err": 0.0}
    assert out["qkv_split"]["f32"]["max_abs_err"] == 0.0
