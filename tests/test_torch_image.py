"""Port parity: core/image.py of vitvs_tpu_torch against vitvs_tpu, f32."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vitvs_tpu.core import image as jimage
from vitvs_tpu_torch.core import image as timage

RNG = np.random.default_rng(7)


@pytest.mark.parametrize("args", [(48, 28, "bicubic", True), (20, 31, "bicubic", False),
                                  (17, 9, "bilinear", False), (9, 13, "nearest", False)])
def test_resize_weights_identical(args):
    np.testing.assert_array_equal(timage.resize_weights(*args), jimage.resize_weights(*args))


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_preprocess_frame_matches(dtype):
    if dtype == np.uint8:
        rgb = RNG.integers(0, 256, (48, 64, 3), dtype=np.uint8)
    else:
        rgb = RNG.uniform(0, 1, (48, 64, 3)).astype(np.float32)
    ref = np.asarray(jimage.preprocess_frame(jnp.asarray(rgb), 28))
    out = timage.preprocess_frame(torch.from_numpy(rgb), 28).numpy()
    assert out.dtype == np.float32 and out.shape == (28, 28, 3)
    # both are f32 matmuls of the same weights; summation order differs
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


def test_pos_embed_scale_factor_resample_matches():
    grid = RNG.standard_normal((5, 5, 8)).astype(np.float32)
    s = (4 + 0.1) / 5
    ref = np.asarray(jimage.interpolate_bicubic_scale_factor(jnp.asarray(grid), s, s))
    out = timage.interpolate_bicubic_scale_factor(torch.from_numpy(grid), s, s).numpy()
    assert out.shape == (4, 4, 8)
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-6)


def test_set_f32_matmul_precision_turns_tf32_off():
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    timage.set_f32_matmul_precision()
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32


@pytest.mark.parametrize("precision", ["highest", "high", "default"])
def test_preprocess_frame_precision_matches(precision):
    """Each resize precision against jax.jit of the reference at that
    precision, uint8 640 x 480 -> 308: on the CPU both compute f32 at every
    precision (XLA's CPU dots take no reduced-precision pass), so the port's
    three are the same bits and within the f32 summation-order gap of the
    jitted reference (rtol / atol 1e-5, as test_preprocess_frame_matches)."""
    import jax

    rgb = RNG.integers(0, 256, (480, 640, 3), dtype=np.uint8)
    ref = np.asarray(jax.jit(lambda x: jimage.preprocess_frame(x, 308, precision=precision))(
        jnp.asarray(rgb)))
    out = timage.preprocess_frame(torch.from_numpy(rgb), 308, precision=precision)
    highest = timage.preprocess_frame(torch.from_numpy(rgb), 308)
    assert torch.equal(out, highest)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="precision"):
        timage.resize(torch.zeros(4, 4, 3), (2, 2), precision="bf16")


def test_default_precision_scopes_tf32_to_the_resize():
    """On the CPU 'default' leaves the process's TF32 setting as it found
    it, both ways (on the card the two products run with TF32 allowed and
    the setting is restored: tests/test_torch_gpu.py)."""
    img = torch.rand(8, 10, 3)
    for before in (False, True):
        torch.backends.cuda.matmul.allow_tf32 = before
        timage.resize(img, (4, 5), "bicubic", True, precision="default")
        assert torch.backends.cuda.matmul.allow_tf32 is before
    timage.set_f32_matmul_precision()
