"""Port parity: int8 binned descriptors (match/binned.py) and int8 matching
(match/correspondence.py) of vitvs_tpu_torch against vitvs_tpu, f32, with
numpy-seeded descriptors on small grids."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vitvs_tpu.match import binned as jb
from vitvs_tpu.match import correspondence as jc
from vitvs_tpu_torch.match import binned as tb
from vitvs_tpu_torch.match import correspondence as tc
from vitvs_tpu_torch.models.extractor import log_bin

RNG = np.random.default_rng(23)


def _descs(t, d, noise, seed):
    """desc2 is a noisy permutation of desc1, so most cycles close."""
    rs = np.random.default_rng(seed)
    a = rs.standard_normal((t, d)).astype(np.float32)
    b = a[rs.permutation(t)] + noise * rs.standard_normal((t, d)).astype(np.float32)
    return a, b


@pytest.mark.parametrize("grid,d", [((5, 7), 16), ((6, 6), 40), ((1, 4), 8)])
def test_quantize_binned_int8_matches(grid, d):
    x = (3 * RNG.standard_normal((grid[0] * grid[1], d))).astype(np.float32)
    ref = jb.quantize_binned_int8(jnp.asarray(x), grid)
    out = tb.quantize_binned_int8(torch.from_numpy(x), grid)
    assert out.q.dtype == torch.int8 and out.q.shape == (grid[0] * grid[1], 9 * d)
    np.testing.assert_array_equal(out.q.numpy(), np.asarray(ref.q))
    np.testing.assert_array_equal(out.nq.numpy(), np.asarray(ref.nq))


def test_quantize_binned_int8_equals_quantized_log_bin():
    """The source-quantized values equal quantizing the materialized
    hierarchy-1 binned descriptors row by row on the amax/127 grid (both
    on the same f32 inverse scale)."""
    grid, d = (6, 5), 24
    x = torch.from_numpy(RNG.standard_normal((30, d)).astype(np.float32))
    binned = log_bin(x[None], grid)[0]
    inv = 127.0 / torch.clamp(binned.abs().amax(-1, keepdim=True), min=1e-12)
    want = torch.clamp(torch.round(binned * inv), -127, 127).to(torch.int8)
    np.testing.assert_array_equal(tb.quantize_binned_int8(x, grid).q.numpy(), want.numpy())


def test_shift_maps_and_row_quantizer_match():
    np.testing.assert_array_equal(tb._shift_maps((4, 6)), jb._shift_maps((4, 6)))
    x = (2 * RNG.standard_normal((20, 33))).astype(np.float32)
    # the reference as its step runs it, under jax.jit (fault 3.5)
    jq, js = jax.jit(jb.quantize_rows_int8)(jnp.asarray(x))
    tq, ts = tb.quantize_rows_int8(torch.from_numpy(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("branch", ["f32", "int8", "binned"])
def test_cosine_similarity_matrix_matches(branch):
    a, b = _descs(36, 48, 0.5, 1)
    if branch == "binned":
        ja, jb_ = (jb.quantize_binned_int8(jnp.asarray(x), (6, 6)) for x in (a, b))
        ta, tb_ = (tb.quantize_binned_int8(torch.from_numpy(x), (6, 6)) for x in (a, b))
    else:
        ja, jb_ = jnp.asarray(a), jnp.asarray(b)
        ta, tb_ = torch.from_numpy(a), torch.from_numpy(b)
    ref = np.asarray(jc.cosine_similarity_matrix(ja, jb_, int8=branch == "int8"))
    out = tc.cosine_similarity_matrix(ta, tb_, int8=branch == "int8").numpy()
    assert out.shape == ref.shape and out.dtype == np.float32
    # f32 sums in another order (the int8 products themselves are exact)
    np.testing.assert_allclose(out, ref, atol=2e-6)


def _match_both(a, b, grid, k, key, binned, **kw):
    if binned:
        ja, jb_ = (jb.quantize_binned_int8(jnp.asarray(x), grid) for x in (a, b))
        ta, tb_ = (tb.quantize_binned_int8(torch.from_numpy(x), grid) for x in (a, b))
    else:
        ja, jb_ = jnp.asarray(a), jnp.asarray(b)
        ta, tb_ = torch.from_numpy(a), torch.from_numpy(b)
    ref = jc.find_correspondences(ja, jb_, grid, k, key, int8=True, **kw)
    scores = torch.tensor(np.asarray(jax.random.uniform(key, (grid[0] * grid[1],))))
    out = tc.find_correspondences(ta, tb_, grid, k, scores, int8=True, use_kernel=False, **kw)
    return (ja, jb_, ref), (ta, tb_, out)


def _assert_match_equal(ref, out):
    for name in ("points1", "points2", "valid", "num_valid", "same_image"):
        np.testing.assert_array_equal(getattr(out, name).numpy(),
                                      np.asarray(getattr(ref, name)), err_msg=name)
    np.testing.assert_allclose(out.sim.numpy(), np.asarray(ref.sim), atol=2e-6)


@pytest.mark.parametrize("binned", [False, True], ids=["int8", "quantized_binned"])
@pytest.mark.parametrize("noise,seed", [(0.3, 0), (1.2, 1)])
def test_find_correspondences_int8_matches(binned, noise, seed):
    a, b = _descs(49, 32, noise, seed)
    (ja, jb_, ref), (ta, tb_, out) = _match_both(a, b, (7, 7), 12, jax.random.PRNGKey(seed),
                                                 binned)
    _assert_match_equal(ref, out)
    # sub-patch refinement on the same descriptors (int8 rows when binned)
    rref = jc.refine_matches_subpixel(ja, jb_, ref, (7, 7))
    rout = tc.refine_matches_subpixel(ta, tb_, out, (7, 7))
    np.testing.assert_allclose(rout.points2.numpy(), np.asarray(rref.points2), atol=1e-5)


def test_int8_matching_refuses_the_matcher_kernel():
    """The f32 matcher kernel does not compose with int8 matching."""
    a, b = _descs(16, 8, 0.1, 2)
    qa, qb = (tb.quantize_binned_int8(torch.from_numpy(x), (4, 4)) for x in (a, b))
    with pytest.raises(ValueError):
        tc.find_correspondences(qa, qb, (4, 4), 4, torch.rand(16), use_kernel=True)
    with pytest.raises(ValueError):
        tc.find_correspondences(torch.from_numpy(a), torch.from_numpy(b), (4, 4), 4,
                                torch.rand(16), use_kernel=True, int8=True)
    with pytest.raises(TypeError):
        tc.cosine_similarity_matrix(qa, torch.from_numpy(b))
