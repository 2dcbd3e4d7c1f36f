"""Port parity: match/correspondence.py of vitvs_tpu_torch against
vitvs_tpu.  The pair-sampling scores are jax.random.uniform(key, (t,)),
drawn as find_correspondences draws them and handed to the port."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vitvs_tpu.match import correspondence as jc
from vitvs_tpu_torch.match import correspondence as tc

RNG = np.random.default_rng(17)


def _descs(t, d, noise, perm_seed=0):
    """desc2 is a noisy permutation of desc1, so most cycles close."""
    a = RNG.standard_normal((t, d)).astype(np.float32)
    perm = np.random.default_rng(perm_seed).permutation(t)
    b = a[perm] + noise * RNG.standard_normal((t, d)).astype(np.float32)
    return a, b


def _both(a, b, grid, k, key, **kw):
    ref = jc.find_correspondences(jnp.asarray(a), jnp.asarray(b), grid, k, key, **kw)
    scores = torch.tensor(np.asarray(jax.random.uniform(key, (grid[0] * grid[1],))))
    out = tc.find_correspondences(torch.from_numpy(a), torch.from_numpy(b), grid, k, scores, **kw)
    return ref, out


def _assert_match_equal(ref, out):
    for name in ("points1", "points2", "valid", "num_valid", "same_image"):
        np.testing.assert_array_equal(getattr(out, name).numpy(),
                                      np.asarray(getattr(ref, name)), err_msg=name)
    np.testing.assert_allclose(out.sim.numpy(), np.asarray(ref.sim), atol=1e-6)


@pytest.mark.parametrize("noise,k,seed", [(0.3, 8, 0), (1.2, 24, 1), (3.0, 16, 2)])
def test_find_correspondences_matches(noise, k, seed):
    a, b = _descs(49, 32, noise, seed)
    ref, out = _both(a, b, (7, 7), k, jax.random.PRNGKey(seed))
    _assert_match_equal(ref, out)


def test_find_correspondences_more_pairs_than_tokens():
    a, b = _descs(9, 16, 0.2)
    ref, out = _both(a, b, (3, 3), 12, jax.random.PRNGKey(4))
    _assert_match_equal(ref, out)


def test_find_correspondences_same_image_shortcut():
    a, _ = _descs(25, 16, 0.0)
    ref, out = _both(a, a.copy(), (5, 5), 6, jax.random.PRNGKey(5))
    assert bool(out.same_image) and bool(ref.same_image)
    _assert_match_equal(ref, out)


def test_find_correspondences_threshold_passes_through():
    a, b = _descs(49, 32, 1.5, 3)
    ref, out = _both(a, b, (7, 7), 16, jax.random.PRNGKey(6), distance_threshold=0.5)
    _assert_match_equal(ref, out)


def test_refine_matches_subpixel_matches():
    a, b = _descs(49, 32, 0.8, 7)
    key = jax.random.PRNGKey(8)
    ref, out = _both(a, b, (7, 7), 16, key)
    ref = jc.refine_matches_subpixel(jnp.asarray(a), jnp.asarray(b), ref, (7, 7))
    out = tc.refine_matches_subpixel(torch.from_numpy(a), torch.from_numpy(b), out, (7, 7))
    np.testing.assert_allclose(out.points2.numpy(), np.asarray(ref.points2), atol=1e-5)


@pytest.mark.parametrize("round_px", [True, False])
def test_match_points_to_pixels_matches(round_px):
    pts = RNG.uniform(0, 21, (24, 2)).astype(np.float32)
    ref = jc.match_points_to_pixels(jnp.asarray(pts), 22, 308, (640, 480), round_px=round_px)
    out = tc.match_points_to_pixels(torch.from_numpy(pts), 22, 308, (640, 480), round_px=round_px)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-5)


# ---------------------------------------------------------------------------
# bf16 descriptors: the reference's default arithmetic (use_match_kernel off)
# and its matcher kernel's (use_match_kernel on)
# ---------------------------------------------------------------------------


def _bf16_pair(a, b):
    """The same bf16 descriptors for both packages (bf16 -> f32 is exact)."""
    ja, jb = jnp.asarray(a, jnp.bfloat16), jnp.asarray(b, jnp.bfloat16)
    ta, tb = (torch.from_numpy(np.asarray(x, np.float32)).bfloat16() for x in (ja, jb))
    return ja, jb, ta, tb


def _both_bf16(ja, jb, ta, tb, grid, k, key, **kw):
    jkw = {"use_kernel": kw.pop("use_match_kernel")} if "use_match_kernel" in kw else {}
    ref = jc.find_correspondences(ja, jb, grid, k, key, **jkw)
    scores = torch.tensor(np.asarray(jax.random.uniform(key, (grid[0] * grid[1],))))
    out = tc.find_correspondences(ta, tb, grid, k, scores, use_match_kernel=bool(jkw), **kw)
    return ref, out


@pytest.mark.parametrize("use_kernel", [True, False], ids=["kernel", "plain"])
@pytest.mark.parametrize("noise,seed", [(0.4, 10), (1.5, 11)])
def test_bf16_matching_default_matches_reference_default(noise, seed, use_kernel):
    """bf16 descriptors with the default flag: rows normalized in bf16 by f32
    norms, product with f32 accumulation, as vitvs_tpu's default
    (use_kernel=False); the same pairs, sim within 1e-5 (f32 sums of exact
    products in another order).  On the CPU the kernel wrapper takes the
    plain version, so both settings of use_kernel hold."""
    a, b = _descs(64, 96, noise, seed)
    ref, out = _both_bf16(*_bf16_pair(a, b), (8, 8), 16, jax.random.PRNGKey(seed),
                          use_kernel=use_kernel)
    for name in ("points1", "points2", "valid", "num_valid", "same_image"):
        np.testing.assert_array_equal(getattr(out, name).numpy(),
                                      np.asarray(getattr(ref, name)), err_msg=name)
    np.testing.assert_allclose(out.sim.numpy(), np.asarray(ref.sim), atol=1e-5)


def test_use_match_kernel_matches_reference_kernel_arithmetic(monkeypatch):
    """use_match_kernel=True against the reference's use_kernel=True path
    with its Pallas matcher in interpret mode (off the TPU its fallback
    would normalize in bf16, which is not the kernel's arithmetic): the
    descriptors are cast to f32 and normalized in f32."""
    from vitvs_tpu.ops import matcher as jm

    monkeypatch.setattr(jm, "dual_argmax_cosine",
                        functools.partial(jm.dual_argmax_cosine, tile=64, d_tile=128,
                                          interpret=True))
    a, b = _descs(64, 96, 0.8, 12)
    ref, out = _both_bf16(*_bf16_pair(a, b), (8, 8), 16, jax.random.PRNGKey(12),
                          use_match_kernel=True)
    _assert_match_equal(ref, out)


def _texture(h, w, seed, smooth=4):
    rs = np.random.default_rng(seed)
    x = rs.standard_normal((h + 2 * smooth, w + 2 * smooth, 3))
    k = np.ones(2 * smooth + 1) / (2 * smooth + 1)
    for ax in (0, 1):
        x = np.apply_along_axis(lambda r: np.convolve(r, k, mode="valid"), ax, x)
    return ((x - x.min()) / (x.max() - x.min())).astype(np.float32)


def test_bf16_matching_on_trained_descriptors_matches_reference():
    """bf16 binned layer-11 descriptors of the trained real308 ViT-S/14
    (vitvs_tpu's bf16 forward) at a 112 px input, two crops of a texture
    shifted by (6, 9) px: the default arithmetic gives the reference
    default's pairs and sim_1/sim_2 within 1e-5, while the f32 arithmetic
    (use_match_kernel=True) moves sim_1 by far more than that."""
    import os

    from vitvs_tpu.models import extractor as jext
    from vitvs_tpu.models import vit as jvit
    from vitvs_tpu.models.convert import load_params
    from vitvs_tpu_torch.ops import matcher as tm

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    params = jax.tree.map(np.asarray, load_params(os.path.join(repo, "artifacts", "ckpt_real308")))
    big = _texture(152, 152, 3)
    crops = np.stack([big[20:132, 20:132], big[26:138, 29:141]])
    mean = np.array([0.485, 0.456, 0.406], np.float32)
    std = np.array([0.229, 0.224, 0.225], np.float32)
    desc = jext.extract_descriptors(params, jvit.make_config("dinov2_vits14"),
                                    jnp.asarray((crops - mean) / std), layer=11, bin=True,
                                    compute_dtype=jnp.bfloat16)
    assert desc.shape == (2, 1, 64, 384 * 9) and desc.dtype == jnp.bfloat16
    ja, jb = desc[0, 0], desc[1, 0]
    ta, tb = (torch.from_numpy(np.asarray(x, np.float32)).bfloat16() for x in (ja, jb))

    sim = jc.cosine_similarity_matrix(ja, jb)
    got = tm.dual_argmax_cosine_bf16(ta, tb)
    for o, r in ((got[0], sim.max(1)), (got[2], sim.max(0))):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(sim.argmax(1)))
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(sim.argmax(0)))
    f32_mode = tm.dual_argmax_cosine(ta, tb)[0].numpy()
    assert np.abs(f32_mode - np.asarray(sim.max(1))).max() > 1e-4

    for seed in (0, 1):
        ref, out = _both_bf16(ja, jb, ta, tb, (8, 8), 24, jax.random.PRNGKey(seed))
        for name in ("points1", "points2", "valid", "num_valid", "same_image"):
            np.testing.assert_array_equal(getattr(out, name).numpy(),
                                          np.asarray(getattr(ref, name)), err_msg=name)
        np.testing.assert_allclose(out.sim.numpy(), np.asarray(ref.sim), atol=1e-5)
