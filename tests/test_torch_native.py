"""The port's native sensor bridge (``io_bridge/native.py``: ctypes to
``native/sensor_bridge.cpp`` built into the port's build directory) on the
CPU: every converter's native and numpy paths against each other and
against vitvs_tpu's (which load the same source's library), and the
seqlock'd frame buffer's last-writer-wins, IR round trip and guards on both
paths, as tests/test_io_bridge.py:12-48 and 196-226 ask of the JAX
package."""

import numpy as np
import pytest

from vitvs_tpu.io_bridge import native as jnative
from vitvs_tpu_torch.io_bridge import native

RNG = np.random.default_rng(61)


@pytest.fixture(autouse=True)
def _fresh_rng():
    """Each test draws its inputs from the same seed, whatever ran before it."""
    global RNG
    RNG = np.random.default_rng(61)


@pytest.fixture(params=["native", "numpy"])
def path(request, monkeypatch):
    """Run a test on the built library (skipped where no C++ compiler
    builds it), or on the numpy versions (the library made unavailable)."""
    if request.param == "native":
        if not native.native_available():
            pytest.skip("no C++ compiler built native/sensor_bridge.cpp here")
    else:
        monkeypatch.setattr(native, "_load", lambda: None)
    return request.param


def _depths():
    d = RNG.uniform(0.0, 12.0, (48, 64)).astype(np.float32)
    d[0, :6] = [0.5, 0.05, 20.0, np.nan, 0.1, 10.0]
    return d


def test_depth_conversion_roundtrip_and_clipping(path):
    d = np.array([[0.5, 0.05, 20.0, np.nan], [1.234, 0.0, 9.99, 3.0]], np.float32)
    mm = native.depth_m_to_u16mm(d)
    assert mm.tolist() == [[500, 0, 0, 0], [1234, 0, 9990, 3000]]
    np.testing.assert_allclose(native.depth_u16mm_to_m(mm)[0, 0], 0.5, atol=1e-3)


@pytest.mark.parametrize("fn", ["depth_m_to_u16mm", "depth_u16mm_to_m"])
def test_depth_paths_equal_each_other_and_jax(fn, monkeypatch):
    """Depth both ways: native, numpy and vitvs_tpu's two paths all equal,
    bit for bit (the same f32 arithmetic)."""
    d = _depths()
    x = d if fn == "depth_m_to_u16mm" else native.depth_m_to_u16mm(d)
    got = getattr(native, fn)(x)
    ref = getattr(jnative, fn)(x)
    np.testing.assert_array_equal(got, ref)
    monkeypatch.setattr(native, "_load", lambda: None)
    monkeypatch.setattr(jnative, "_load", lambda: None)
    np.testing.assert_array_equal(getattr(native, fn)(x), got)
    np.testing.assert_array_equal(getattr(jnative, fn)(x), got)


@pytest.mark.parametrize("norm", [False, True], ids=["unit", "normalized"])
def test_rgb8_paths(norm, monkeypatch):
    """uint8 -> f32 (and normalized): the native path equals vitvs_tpu's
    native path bit for bit, the numpy path vitvs_tpu's numpy path; the two
    within 2 f32 ulps of each other (the library multiplies by 1 / 255 and
    by 1 / std, numpy divides)."""
    rgb = RNG.integers(0, 256, (20, 30, 3), dtype=np.uint8)
    kw = dict(mean=(0.485, 0.456, 0.406), std=(0.229, 0.224, 0.225)) if norm else {}
    nat = native.rgb8_to_unit_float(rgb, **kw)
    np.testing.assert_array_equal(nat, jnative.rgb8_to_unit_float(rgb, **kw))
    monkeypatch.setattr(native, "_load", lambda: None)
    monkeypatch.setattr(jnative, "_load", lambda: None)
    num = native.rgb8_to_unit_float(rgb, **kw)
    np.testing.assert_array_equal(num, jnative.rgb8_to_unit_float(rgb, **kw))
    np.testing.assert_allclose(nat, num, rtol=2.4e-7, atol=2.4e-7)
    if not norm:
        np.testing.assert_allclose(num, rgb / 255.0, atol=1e-6)
    with pytest.raises(ValueError, match="together"):
        native.rgb8_to_unit_float(rgb, mean=(0.5, 0.5, 0.5))


def test_bilinear_resize_paths(monkeypatch):
    """uint8 bilinear resize, down and up: native equals vitvs_tpu's native,
    numpy equals vitvs_tpu's numpy; the two within one level (f32 and f64
    sample coordinates), but for the last output row and column when
    upsampling: there the library (native/sensor_bridge.cpp, built as it
    stands) extrapolates past the last sample, and uint8 wraps, where numpy
    clamps to it, in the JAX package as in the port."""
    rgb = RNG.integers(0, 256, (37, 53, 3), dtype=np.uint8)
    for oh, ow in ((16, 20), (60, 71)):
        nat = native.bilinear_resize_u8(rgb, oh, ow)
        np.testing.assert_array_equal(nat, jnative.bilinear_resize_u8(rgb, oh, ow))
        with monkeypatch.context() as m:
            m.setattr(native, "_load", lambda: None)
            m.setattr(jnative, "_load", lambda: None)
            num = native.bilinear_resize_u8(rgb, oh, ow)
            np.testing.assert_array_equal(num, jnative.bilinear_resize_u8(rgb, oh, ow))
        assert nat.shape == (oh, ow, 3)
        inner = (slice(None), slice(None)) if oh < 37 else (slice(0, -1), slice(0, -1))
        assert np.abs(nat[inner].astype(int) - num[inner].astype(int)).max() <= 1
    step = np.zeros((8, 8, 3), np.uint8)
    step[:4], step[4:] = 100, 200
    out = native.bilinear_resize_u8(step, 4, 4)
    assert out[0, 0, 0] == 100 and out[3, 0, 0] == 200


def test_frame_buffer_last_writer_wins(path):
    fb = native.NativeFrameBuffer(4, 3)
    for i in range(3):
        fb.publish(np.full((3, 4, 3), i, np.uint8), np.full((3, 4), 0.5 + i, np.float32))
    stamp, rgb, depth = fb.latest()
    assert stamp == 3 and rgb[0, 0, 0] == 2
    np.testing.assert_allclose(depth, 2.5, atol=1e-3)
    rgb2, depth2 = fb.get_frame()
    np.testing.assert_array_equal(rgb2, rgb)
    fb.close()


def test_frame_buffer_ir_roundtrip(path):
    """The four-sensor mailbox: IR planes ride the seqlock'd frame with
    colour and depth; a frame without IR keeps the last IR planes; depth
    outside the range reads back as 0."""
    fb = native.NativeFrameBuffer(4, 3, with_ir=True)
    rgb = np.arange(36, dtype=np.uint8).reshape(3, 4, 3)
    depth = np.full((3, 4), 1.5, np.float32)
    depth[0, 0] = 20.0
    ir1 = np.arange(12, dtype=np.uint8).reshape(3, 4)
    fb.publish(rgb, depth, ir1, ir1 + 100)
    stamp, r, d, i1, i2 = fb.latest_ir()
    assert stamp == 1 and d[0, 0] == 0.0
    np.testing.assert_array_equal(r, rgb)
    np.testing.assert_allclose(d[1:], 1.5, atol=1e-3)
    np.testing.assert_array_equal(i1, ir1)
    np.testing.assert_array_equal(i2, ir1 + 100)
    fb.publish(rgb + 1, depth)
    stamp, r, _, i1, _ = fb.latest_ir()
    assert stamp == 2 and r[0, 0, 0] == 1
    np.testing.assert_array_equal(i1, ir1)


def test_frame_buffer_guards(path):
    fb = native.NativeFrameBuffer(4, 3)
    frame = (np.zeros((3, 4, 3), np.uint8), np.zeros((3, 4), np.float32))
    with pytest.raises(ValueError, match="with_ir"):
        fb.publish(*frame, np.zeros((3, 4), np.uint8), np.zeros((3, 4), np.uint8))
    with pytest.raises(ValueError, match="with_ir"):
        fb.latest_ir()
    with pytest.raises(ValueError, match="frame shape mismatch"):
        fb.publish(np.zeros((2, 4, 3), np.uint8), frame[1])
    fbi = native.NativeFrameBuffer(4, 3, with_ir=True)
    with pytest.raises(ValueError, match="IR shape"):
        fbi.publish(*frame, np.zeros((2, 2), np.uint8), np.zeros((3, 4), np.uint8))
    with pytest.raises(ValueError, match="together"):
        fbi.publish(*frame, np.zeros((3, 4), np.uint8))
