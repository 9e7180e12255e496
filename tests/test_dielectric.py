"""Dielectric (smooth glass) BSDF: physics anchors + integrator agreement.

The dielectric splits between Fresnel reflection and Snell refraction with
one-sample R/(1-R) selection, so throughput carries only the albedo tint —
a clear glass is energy-exact and must pass the furnace test. The same
scatter math lives in pathtracer/integrator.py (stacked reference) and
pathtracer/wavefront.py (SoA core of render_pt_fast); these tests pin the physics and the cross-implementation
agreement.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from raytracing_engine_tpu.pathtracer import PTConfig
from raytracing_engine_tpu.pathtracer.integrator import render_pt
from raytracing_engine_tpu.pathtracer.scene import (
    DIELECTRIC,
    DIFFUSE,
    build_pt_scene,
)
from raytracing_engine_tpu.pathtracer.wavefront import render_pt_fast

KEY = jax.random.PRNGKey(11)
QUAT = jnp.array([0.0, 0.0, 0.0, 1.0])
POS = jnp.zeros(3)


def glass_furnace_scene(le=1.0, ior=1.5):
    """A clear glass sphere inside a big emissive enclosure: every path
    keeps throughput 1 through any reflect/refract chain and terminates on
    the enclosure, so EVERY pixel must read exactly Le (up to path
    truncation ~ R^bounces ≈ 0.04^b)."""
    mats = [
        {"kind": DIELECTRIC, "ior": ior},
        {"albedo": (0.0,) * 3, "emission": (le,) * 3, "kind": DIFFUSE},
    ]
    spheres = [
        ((0.0, 4.0, 0.0), 1.0, 0),     # glass test sphere
        ((0.0, 0.0, 0.0), 100.0, 1),   # emissive enclosure (seen from inside)
    ]
    return build_pt_scene(spheres=spheres, materials=mats)


def glass_lens_scene(le=1.0):
    """Glass ball between the camera and a big emissive sphere. The axial
    ray crosses both surfaces at normal incidence: R = ((n-1)/(n+1))^2 =
    0.04 per surface, so the center pixel reads T^2*Le = 0.9216*Le (plus
    ~0.0015 from double internal reflections). A direct statistical check
    of the Fresnel coefficient."""
    mats = [
        {"kind": DIELECTRIC, "ior": 1.5},
        {"albedo": (0.0,) * 3, "emission": (le,) * 3, "kind": DIFFUSE},
    ]
    spheres = [
        ((0.0, 6.0, 0.0), 1.0, 0),     # glass ball
        ((0.0, 14.0, 0.0), 3.0, 1),    # emissive backdrop
    ]
    return build_pt_scene(spheres=spheres, materials=mats)


def test_glass_furnace_energy_exact():
    cfg = PTConfig(width=48, height=32, max_bounces=8)
    img, _ = render_pt(cfg, glass_furnace_scene(), POS, QUAT, 64, KEY)
    img = np.asarray(img)
    # corners: enclosure directly; center: through the glass — all = Le.
    # Residue: a silhouette-grazing sample (high R) can exceed max_bounces
    # and lose its 1/spp weight; 0.02 covers one lost sample per pixel.
    np.testing.assert_allclose(img, 1.0, atol=0.02)
    assert abs(img.mean() - 1.0) < 1e-3


def test_normal_incidence_fresnel():
    cfg = PTConfig(width=48, height=32, max_bounces=5)
    img, _ = render_pt(cfg, glass_lens_scene(), POS, QUAT, 256, KEY)
    img = np.asarray(img)
    h, w, _ = img.shape
    patch = img[h // 2 - 2: h // 2 + 2, w // 2 - 2: w // 2 + 2]
    # T^2 = 0.96^2 = 0.9216; + ~0.0015 double-internal-reflection paths
    assert abs(patch.mean() - 0.923) < 0.02, patch.mean()


def test_tinted_glass_scales_by_albedo_per_event():
    """Tinted glass multiplies throughput by the albedo at EVERY surface
    event: the straight-through path (2 events) reads T^2 * a^2 * Le."""
    mats = [
        {"kind": DIELECTRIC, "ior": 1.5, "albedo": (0.8, 0.8, 0.8)},
        {"albedo": (0.0,) * 3, "emission": (1.0,) * 3, "kind": DIFFUSE},
    ]
    scene = build_pt_scene(
        spheres=[((0.0, 6.0, 0.0), 1.0, 0), ((0.0, 14.0, 0.0), 3.0, 1)],
        materials=mats)
    cfg = PTConfig(width=48, height=32, max_bounces=5)
    img, _ = render_pt(cfg, scene, POS, QUAT, 256, KEY)
    img = np.asarray(img)
    h, w, _ = img.shape
    patch = img[h // 2 - 2: h // 2 + 2, w // 2 - 2: w // 2 + 2]
    assert abs(patch.mean() - 0.9216 * 0.64) < 0.02, patch.mean()


def test_wavefront_matches_reference_integrator():
    """Same threefry stream -> the SoA core and the stacked reference
    integrator agree to float-reassociation tolerance on a glass scene
    with a diffuse floor (NEE active) and multiple bounce types."""
    mats = [
        {"albedo": (0.6, 0.6, 0.6), "kind": DIFFUSE},
        {"kind": DIELECTRIC, "ior": 1.5},
        {"albedo": (0, 0, 0), "emission": (20.0,) * 3, "kind": DIFFUSE},
    ]
    scene = build_pt_scene(
        spheres=[((0.0, 6.0, -101.5), 100.0, 0),
                 ((0.0, 6.0, 0.0), 1.0, 1),
                 ((3.0, 4.0, 4.0), 0.8, 2)],
        materials=mats)
    cfg = PTConfig(width=64, height=48, max_bounces=6)
    a, _ = render_pt(cfg, scene, POS, QUAT, 24, KEY)
    b, _ = render_pt_fast(cfg, scene, POS, QUAT, 24, KEY)
    a, b = np.asarray(a), np.asarray(b)
    # float-reassociation noise scales with the Le=20 light
    assert np.abs(a - b).max() < 6e-3
    assert abs(a.mean() - b.mean()) < 1e-4


def test_sceneio_dielectric_kind(tmp_path):
    """JSON scenes accept kind=dielectric with optional ior and albedo."""
    import json

    from raytracing_engine_tpu.pathtracer.sceneio import load_scene_json

    spec = {
        "materials": [
            {"albedo": [0.5, 0.5, 0.5]},
            {"kind": "dielectric", "ior": 1.33},
            {"kind": "dielectric", "albedo": [0.9, 0.9, 1.0]},
        ],
        "spheres": [
            {"center": [0, 6, 0], "radius": 1.0, "mat": 1},
            {"center": [3, 6, 0], "radius": 1.0, "mat": 2},
            {"center": [-3, 6, 0], "radius": 1.0, "mat": 0},
        ],
    }
    p = tmp_path / "glass.json"
    p.write_text(json.dumps(spec))
    scene, *_ = load_scene_json(str(p))
    kinds = np.asarray(scene.mat_kind)
    iors = np.asarray(scene.mat_ior)
    assert kinds[1] == DIELECTRIC and kinds[2] == DIELECTRIC
    assert abs(iors[1] - 1.33) < 1e-6 and abs(iors[2] - 1.5) < 1e-6
    # dielectric albedo defaults to 1 (clear); explicit albedo is kept
    np.testing.assert_allclose(np.asarray(scene.mat_albedo)[1], 1.0)
    np.testing.assert_allclose(np.asarray(scene.mat_albedo)[2],
                               (0.9, 0.9, 1.0))
