"""Russian roulette path termination: unbiasedness + work reduction.

rr_start=0 (default) is the fixed-length estimator with the exact
pre-change sample stream (static branch). rr_start>=1 terminates paths
from that bounce with survival probability p = clamp(max(throughput),
0.05, 1), dividing throughput by p — expectation unchanged.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from raytracing_engine_tpu.pathtracer import PTConfig
from raytracing_engine_tpu.pathtracer.integrator import render_pt
from raytracing_engine_tpu.pathtracer.scenes import cornell_box
from raytracing_engine_tpu.pathtracer.wavefront import render_pt_fast

KEY = jax.random.PRNGKey(21)
QUAT = jnp.array([0.0, 0.0, 0.0, 1.0])
POS = jnp.array([0.0, 0.2, 0.0])


def test_rr_unbiased_and_cheaper():
    scene = cornell_box()
    base = PTConfig(width=32, height=32, max_bounces=8)
    rr = PTConfig(width=32, height=32, max_bounces=8, rr_start=2)
    img0, n0 = render_pt(base, scene, POS, QUAT, 96, KEY)
    img1, n1 = render_pt(rr, scene, POS, QUAT, 96, KEY)
    m0, m1 = float(np.asarray(img0).mean()), float(np.asarray(img1).mean())
    # unbiased: image means agree to MC tolerance
    assert abs(m1 - m0) / m0 < 0.03, (m0, m1)
    # terminating dim paths traces measurably fewer rays
    assert float(n1) < 0.9 * float(n0), (float(n0), float(n1))


def test_rr_off_is_bitexact_default():
    scene = cornell_box()
    a, _ = render_pt(PTConfig(width=16, height=16, max_bounces=3),
                     scene, POS, QUAT, 4, KEY)
    b, _ = render_pt(PTConfig(width=16, height=16, max_bounces=3,
                              rr_start=0), scene, POS, QUAT, 4, KEY)
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_rr_wavefront_matches_reference():
    scene = cornell_box()
    cfg = PTConfig(width=32, height=24, max_bounces=5, rr_start=2)
    a, na = render_pt(cfg, scene, POS, QUAT, 8, KEY)
    b, nb = render_pt_fast(cfg, scene, POS, QUAT, 8, KEY)
    a, b = np.asarray(a), np.asarray(b)
    assert np.abs(a - b).max() < 6e-3
    assert abs(a.mean() - b.mean()) < 1e-4
    assert abs(float(na) - float(nb)) <= max(8.0, 1e-3 * float(na))
