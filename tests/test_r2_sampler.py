"""Low-discrepancy (R_d) sampler: variance reduction + invariances."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from raytracing_engine_tpu.pathtracer import PTConfig, render_pt_fast
from raytracing_engine_tpu.pathtracer.integrator import render_pt
from raytracing_engine_tpu.pathtracer.scenes import cornell_box

KEY = jax.random.PRNGKey(1)
QUAT = jnp.array([0.0, 0.0, 0.0, 1.0])
POS = jnp.array([0.0, 0.2, 0.0])


def test_r2_reduces_variance_vs_random():
    """Cornell at 16 spp: the R_d camera/NEE dims must cut MSE vs the
    512-spp reference by a solid margin over pure random (measured -45%;
    assert a looser -25%)."""
    scene = cornell_box()
    base = PTConfig(width=48, height=48, max_bounces=3, rng="pcg")
    ref, _ = render_pt_fast(base, scene, POS, QUAT, 256,
                            jax.random.PRNGKey(77))
    ref = np.asarray(ref)

    img_rand, _ = render_pt_fast(base, scene, POS, QUAT, 16, KEY)
    img_r2, _ = render_pt_fast(dataclasses.replace(base, sampler="r2"),
                               scene, POS, QUAT, 16, KEY)
    mse_rand = float(((np.asarray(img_rand) - ref) ** 2).mean())
    mse_r2 = float(((np.asarray(img_r2) - ref) ** 2).mean())
    assert mse_r2 < 0.75 * mse_rand, (mse_rand, mse_r2)


def test_r2_unbiased_mean():
    """Same estimator expectation: r2 and random agree at high spp."""
    scene = cornell_box()
    base = PTConfig(width=32, height=32, max_bounces=2, rng="pcg")
    a, _ = render_pt_fast(base, scene, POS, QUAT, 128, KEY)
    b, _ = render_pt_fast(dataclasses.replace(base, sampler="r2"),
                          scene, POS, QUAT, 128, KEY)
    ma, mb = float(np.asarray(a).mean()), float(np.asarray(b).mean())
    assert abs(ma - mb) / ma < 0.02, (ma, mb)


def test_r2_chunk_invariant():
    """spp_offset chunking reproduces the same accumulated image (the
    sequence is indexed by the GLOBAL pass, not the chunk)."""
    scene = cornell_box()
    cfg = PTConfig(width=24, height=16, max_bounces=2, rng="pcg",
                   sampler="r2")
    whole, _ = render_pt_fast(cfg, scene, POS, QUAT, 8, KEY)
    a, _ = render_pt_fast(cfg, scene, POS, QUAT, 4, KEY, spp_offset=0)
    b, _ = render_pt_fast(cfg, scene, POS, QUAT, 4, KEY, spp_offset=4)
    np.testing.assert_allclose((np.asarray(a) + np.asarray(b)) / 2,
                               np.asarray(whole), rtol=1e-6, atol=1e-6)


def test_r2_requires_production_path():
    with pytest.raises(ValueError, match="r2"):
        render_pt(PTConfig(width=8, height=8, sampler="r2"),
                  cornell_box(), POS, QUAT, 1, KEY)


def test_r2_sequence_properties():
    """The 2D R_d points are well-stratified: star-discrepancy proxy —
    every 1/4 x 1/4 bin of [0,1)^2 gets hit within 64 points."""
    from raytracing_engine_tpu.ops.rng_pcg import r2_planes

    px = jnp.zeros((1, 1), jnp.int32)
    py = jnp.zeros((1, 1), jnp.int32)
    pts = np.array([
        [float(u[0, 0]) for u in r2_planes(123, i, 2, px, py)]
        for i in range(64)])
    binned = np.zeros((4, 4), bool)
    cells = np.minimum((pts * 4).astype(int), 3)
    binned[cells[:, 0], cells[:, 1]] = True
    assert binned.all(), binned
    # different pixels get different (rotated) sequences
    q = r2_planes(123, 0, 2, px + 7, py + 3)
    assert abs(float(q[0][0, 0]) - pts[0, 0]) > 1e-3
