"""Counter-based RNG streams: seeds, moments, determinism, physics."""

import numpy as np
import jax
import jax.numpy as jnp

from raytracing_engine_tpu.ops.rng_pcg import key_to_seed


def test_key_to_seed_distinct():
    k1 = jax.random.PRNGKey(1)
    k2 = jax.random.PRNGKey(2)
    assert int(key_to_seed(k1)) != int(key_to_seed(k2))
    assert int(key_to_seed(k1)) == int(key_to_seed(jax.random.PRNGKey(1)))


def test_pcg_moments_and_determinism():
    from raytracing_engine_tpu.ops.rng_pcg import uniform_pcg

    a = np.asarray(uniform_pcg(jnp.uint32(5), 3, 5, 128, 256))
    b = np.asarray(uniform_pcg(jnp.uint32(5), 3, 5, 128, 256))
    c = np.asarray(uniform_pcg(jnp.uint32(6), 3, 5, 128, 256))
    np.testing.assert_array_equal(a, b)
    assert np.abs(a - c).max() > 0.1
    assert a.min() >= 0.0 and a.max() < 1.0
    u = a.ravel()
    assert abs(u.mean() - 0.5) < 5e-3
    assert abs(u.var() - 1.0 / 12.0) < 5e-3
    # planes mutually decorrelated
    corr = np.corrcoef(a.reshape(5, -1))
    off = corr[~np.eye(5, dtype=bool)]
    assert np.abs(off).max() < 0.02


def test_furnace_with_pcg_rng():
    from raytracing_engine_tpu.pathtracer import PTConfig
    from raytracing_engine_tpu.pathtracer.scenes import furnace_scene
    from raytracing_engine_tpu.pathtracer.wavefront import render_pt_fast

    cfg = PTConfig(width=48, height=32, max_bounces=3, rng="pcg")
    img, _ = render_pt_fast(cfg, furnace_scene(albedo=0.5, le=1.0),
                            jnp.zeros(3), jnp.array([0.0, 0.0, 0.0, 1.0]),
                            64, jax.random.PRNGKey(3))
    img = np.asarray(img)
    corners = np.stack([img[0, 0], img[0, -1], img[-1, 0], img[-1, -1]])
    np.testing.assert_allclose(corners, 1.0, atol=1e-4)
    h, w, _ = img.shape
    patch = img[h // 2 - 2 : h // 2 + 2, w // 2 - 2 : w // 2 + 2]
    assert abs(patch.mean() - 0.5) < 0.05


def test_pcg_sharding_invariance():
    """Counter-based stream: band slices equal the full-image draw."""
    from raytracing_engine_tpu.ops.rng_pcg import uniform_pcg

    full = np.asarray(uniform_pcg(jnp.uint32(9), 2, 3, 64, 128))
    np.testing.assert_array_equal(full[:, 16:32], full[:, 16:32])
