"""Thin-lens depth of field: focus-plane sharpness, blur growth, parity.

aperture=0 (default) is the pinhole camera and compiles the exact
pre-DOF program (static branch, no extra randoms). aperture>0 samples a
sensor-plane disk per camera ray and aims at the pixel's focal point on
the y=focus_dist camera-space plane.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from raytracing_engine_tpu.pathtracer import PTConfig
from raytracing_engine_tpu.pathtracer.integrator import render_pt
from raytracing_engine_tpu.pathtracer.scene import DIFFUSE, build_pt_scene
from raytracing_engine_tpu.pathtracer.wavefront import render_pt_fast
from raytracing_engine_tpu.pathtracer.scenes import furnace_scene

KEY = jax.random.PRNGKey(3)
QUAT = jnp.array([0.0, 0.0, 0.0, 1.0])
POS = jnp.zeros(3)


def two_spheres_scene():
    """A bright emissive sphere at y=8 (the focus plane) and another at
    y=40 (far behind it), on black background."""
    mats = [{"albedo": (0, 0, 0), "emission": (5.0,) * 3, "kind": DIFFUSE}]
    return build_pt_scene(
        spheres=[((0.0, 8.0, 0.0), 1.0, 0),      # in focus (center)
                 ((20.0, 40.0, 0.0), 2.0, 0)],   # far out of focus (right)
        materials=mats)


def _renders(aperture):
    cfg = PTConfig(width=96, height=64, max_bounces=1, aperture=aperture,
                   focus_dist=8.0)
    img, _ = render_pt(cfg, two_spheres_scene(), POS, QUAT, 48, KEY)
    return np.asarray(img)[..., 0]


def test_focus_plane_stays_sharp_background_blurs():
    pin = _renders(0.0)
    dof = _renders(0.6)

    # the focused sphere's interior is unchanged (every lens ray aims at
    # the same focal point, which lies ON the sphere)
    h, w = pin.shape
    ctr_pin = pin[h // 2 - 3: h // 2 + 3, w // 2 - 3: w // 2 + 3]
    ctr_dof = dof[h // 2 - 3: h // 2 + 3, w // 2 - 3: w // 2 + 3]
    np.testing.assert_allclose(ctr_dof, ctr_pin, atol=0.05)

    # the far sphere blurs: its silhouette spreads, so strictly MORE
    # pixels are touched (dimmer each) in its image half
    right_pin = pin[:, 2 * w // 3:]
    right_dof = dof[:, 2 * w // 3:]
    assert (right_dof > 0.01).sum() > 1.3 * (right_pin > 0.01).sum()
    # total energy of the far sphere is preserved under the blur
    assert abs(right_dof.sum() - right_pin.sum()) / right_pin.sum() < 0.1


def test_pinhole_is_default_and_exact():
    """aperture=0 must be bit-identical to a config that never mentions
    DOF (static branch -> same program, same sample stream)."""
    cfg_a = PTConfig(width=32, height=24, max_bounces=1)
    cfg_b = PTConfig(width=32, height=24, max_bounces=1, aperture=0.0,
                     focus_dist=123.0)
    a, _ = render_pt(cfg_a, two_spheres_scene(), POS, QUAT, 4, KEY)
    b, _ = render_pt(cfg_b, two_spheres_scene(), POS, QUAT, 4, KEY)
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_dof_wavefront_matches_reference():
    cfg = PTConfig(width=48, height=32, max_bounces=2, aperture=0.3,
                   focus_dist=8.0)
    a, _ = render_pt(cfg, two_spheres_scene(), POS, QUAT, 16, KEY)
    b, _ = render_pt_fast(cfg, two_spheres_scene(), POS, QUAT, 16, KEY)
    a, b = np.asarray(a), np.asarray(b)
    assert np.abs(a - b).max() < 2e-3
    assert abs(a.mean() - b.mean()) < 1e-5


def test_dof_furnace_energy():
    """Lens rays are normalized and weightless: a uniform-Le enclosure
    reads exactly Le regardless of aperture."""
    cfg = PTConfig(width=32, height=24, max_bounces=3, aperture=0.5,
                   focus_dist=5.0)
    img, _ = render_pt(cfg, furnace_scene(albedo=0.5, le=1.0), POS, QUAT,
                       32, KEY)
    img = np.asarray(img)
    corners = np.stack([img[0, 0], img[0, -1], img[-1, 0], img[-1, -1]])
    np.testing.assert_allclose(corners, 1.0, atol=1e-4)
