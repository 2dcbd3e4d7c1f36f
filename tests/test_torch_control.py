"""Port parity: control/ibvs.py of vitvs_tpu_torch against vitvs_tpu."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vitvs_tpu.control import ibvs as jibvs
from vitvs_tpu_torch.control import ibvs as tibvs

RNG = np.random.default_rng(23)


def _features(k=24):
    s = RNG.uniform(-0.5, 0.5, (k, 2)).astype(np.float32)
    s_star = (s + 0.05 * RNG.standard_normal((k, 2))).astype(np.float32)
    Z = RNG.uniform(0.4, 0.9, (k,)).astype(np.float32)
    valid = np.arange(k) < k - 5
    return s, s_star, Z, valid


def test_interaction_matrix_matches():
    s, _, Z, _ = _features()
    ref = np.asarray(jibvs.interaction_matrix(jnp.asarray(s), jnp.asarray(Z)))
    out = tibvs.interaction_matrix(torch.from_numpy(s), torch.from_numpy(Z)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-6)


@pytest.mark.parametrize("mode", ["svd", "dls"])
@pytest.mark.parametrize("masked", [False, True])
def test_ibvs_velocity_matches(mode, masked):
    s, s_star, Z, valid = _features()
    jv = jnp.asarray(valid) if masked else None
    tv = torch.from_numpy(valid) if masked else None
    ref = np.asarray(jibvs.ibvs_velocity(jnp.asarray(s), jnp.asarray(s_star), jnp.asarray(Z),
                                         0.5, valid=jv, mode=mode))
    out = tibvs.ibvs_velocity(torch.from_numpy(s), torch.from_numpy(s_star),
                              torch.from_numpy(Z), 0.5, valid=tv, mode=mode).numpy()
    # 6x6 solves in f32 by different LAPACK paths
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("num_valid", [1, 2])
def test_dls_with_one_or_two_valid_pairs_is_non_finite(num_valid):
    """1 or 2 live pairs leave L^T L singular in f32 (the 1e-9 damping is
    below its rounding): the reference's cho_factor gives non-finite
    values, and the port's solve gives them too instead of raising."""
    s, s_star, Z, _ = _features()
    valid = np.arange(len(Z)) < num_valid
    ref = np.asarray(jibvs.ibvs_velocity(jnp.asarray(s), jnp.asarray(s_star), jnp.asarray(Z),
                                         0.5, valid=jnp.asarray(valid), mode="dls"))
    out = tibvs.ibvs_velocity(torch.from_numpy(s), torch.from_numpy(s_star),
                              torch.from_numpy(Z), 0.5, valid=torch.from_numpy(valid),
                              mode="dls")
    assert out.shape == (6,)
    assert not np.isfinite(ref).all()
    assert not torch.isfinite(out).all()


def test_ema_and_body_twist_match():
    v1, v2 = (RNG.standard_normal(6).astype(np.float32) for _ in range(2))
    js, ts = jibvs.EmaState.init(), tibvs.EmaState.init(device="cpu")
    for v in (v1, v2):
        js, jout = jibvs.ema_update(js, jnp.asarray(v), 0.8)
        ts, tout = tibvs.ema_update(ts, torch.from_numpy(v), 0.8)
        np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=1e-6)
    assert bool(ts.initialized)
    np.testing.assert_array_equal(tibvs.body_twist_from_optical(tout, 0.3).numpy(),
                                  np.asarray(jibvs.body_twist_from_optical(jout, 0.3)))


def test_depth_at_points_sentinel_matches():
    depth = RNG.uniform(0.3, 1.0, (12, 16)).astype(np.float32)
    depth[2, 3] = 0.0
    uv = np.array([[3.7, 2.2], [15.9, 11.9], [16.0, 4.0], [-0.5, 3.0], [5.0, 12.0],
                   [-1.2, 5.0]], np.float32)
    ref = np.asarray(jibvs.depth_at_points(jnp.asarray(depth), jnp.asarray(uv)))
    out = tibvs.depth_at_points(torch.from_numpy(depth), torch.from_numpy(uv)).numpy()
    np.testing.assert_array_equal(out, ref)
    assert out[0] == 100.0 and out[2] == 100.0
