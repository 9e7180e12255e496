"""Environment (gradient sky) light: exactness, physics, parity.

Escaped rays read a (bottom, top) gradient interpolated on the ray's z at
FULL weight — the env is BSDF-sampling-only (never in the NEE table), so
it is unbiased by construction; these tests pin the values.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from raytracing_engine_tpu.pathtracer import PTConfig
from raytracing_engine_tpu.pathtracer.integrator import render_pt
from raytracing_engine_tpu.pathtracer.scene import DIFFUSE, build_pt_scene
from raytracing_engine_tpu.pathtracer.wavefront import render_pt_fast

KEY = jax.random.PRNGKey(5)
QUAT = jnp.array([0.0, 0.0, 0.0, 1.0])
POS = jnp.zeros(3)


def test_constant_env_reads_exactly():
    """Empty scene + constant env: every pixel = the env radiance."""
    scene = build_pt_scene(env=(0.7, 0.8, 0.9))
    cfg = PTConfig(width=32, height=24, max_bounces=2)
    img, _ = render_pt(cfg, scene, POS, QUAT, 4, KEY)
    np.testing.assert_allclose(np.asarray(img),
                               np.broadcast_to((0.7, 0.8, 0.9), (24, 32, 3)),
                               atol=1e-5)


def test_env_furnace_diffuse_sphere():
    """A convex Lambertian sphere in a uniform env field reflects exactly
    albedo * Le (cosine sampling never re-hits a convex surface)."""
    scene = build_pt_scene(
        spheres=[((0.0, 4.0, 0.0), 1.0, 0)],
        materials=[{"albedo": (0.5, 0.5, 0.5), "kind": DIFFUSE}],
        env=(1.0, 1.0, 1.0))
    cfg = PTConfig(width=48, height=32, max_bounces=2)
    img, _ = render_pt(cfg, scene, POS, QUAT, 64, KEY)
    img = np.asarray(img)
    h, w, _ = img.shape
    patch = img[h // 2 - 2: h // 2 + 2, w // 2 - 2: w // 2 + 2]
    np.testing.assert_allclose(patch, 0.5, atol=1e-3)
    # background still reads the env exactly
    np.testing.assert_allclose(img[0, 0], 1.0, atol=1e-5)


def test_gradient_env_interpolates_on_z():
    scene = build_pt_scene(env=((0.0, 0.0, 0.0), (1.0, 1.0, 1.0)))
    cfg = PTConfig(width=32, height=32, max_bounces=0)
    img, _ = render_pt(cfg, scene, POS, QUAT, 16, KEY)
    img = np.asarray(img)[..., 0]
    # image row 0 looks DOWN (ncy=-1 -> ray z<0), last row looks up
    assert img[-1].mean() > img[0].mean() + 0.3
    # center pixel: dz ~ 0 -> t = 0.5 exactly under the lerp
    h, w = img.shape
    assert abs(img[h // 2 - 1: h // 2 + 1, w // 2 - 1: w // 2 + 1].mean()
               - 0.5) < 0.02


def test_env_wavefront_matches_reference():
    scene = build_pt_scene(
        spheres=[((0.0, 4.0, 0.0), 1.0, 0)],
        materials=[{"albedo": (0.6, 0.5, 0.4), "kind": DIFFUSE}],
        env=((0.2, 0.3, 0.4), (1.0, 0.9, 0.8)))
    cfg = PTConfig(width=48, height=32, max_bounces=3)
    a, _ = render_pt(cfg, scene, POS, QUAT, 16, KEY)
    b, _ = render_pt_fast(cfg, scene, POS, QUAT, 16, KEY)
    a, b = np.asarray(a), np.asarray(b)
    assert np.abs(a - b).max() < 2e-3
    assert abs(a.mean() - b.mean()) < 1e-5


def test_env_composes_with_nee_area_light():
    """Env radiance and NEE area-light radiance add: rendering with both
    equals (env-only) + (light-only) for a diffuse receiver (linearity of
    light transport; same sample streams cancel most MC noise)."""
    def make(env, le):
        mats = [{"albedo": (0.6, 0.6, 0.6), "kind": DIFFUSE},
                {"albedo": (0, 0, 0), "emission": (le,) * 3,
                 "kind": DIFFUSE}]
        return build_pt_scene(
            spheres=[((0.0, 5.0, 0.0), 1.0, 0), ((2.5, 3.0, 2.5), 0.5, 1)],
            materials=mats, env=env, light_pad=1)

    cfg = PTConfig(width=32, height=24, max_bounces=2)
    both, _ = render_pt(cfg, make((0.3, 0.3, 0.3), 10.0), POS, QUAT, 64, KEY)
    env_only, _ = render_pt(cfg, make((0.3, 0.3, 0.3), 0.0), POS, QUAT, 64, KEY)
    lit_only, _ = render_pt(cfg, make(None, 10.0), POS, QUAT, 64, KEY)
    s = np.asarray(env_only) + np.asarray(lit_only)
    np.testing.assert_allclose(np.asarray(both), s, atol=0.05)


def test_sceneio_env(tmp_path):
    import json

    from raytracing_engine_tpu.pathtracer.sceneio import load_scene_json

    p = tmp_path / "sky.json"
    p.write_text(json.dumps({
        "env": {"bottom": [0.1, 0.2, 0.3], "top": [1, 1, 1]},
    }))
    scene, *_ = load_scene_json(str(p))
    np.testing.assert_allclose(np.asarray(scene.env),
                               [[0.1, 0.2, 0.3], [1, 1, 1]], atol=1e-7)
    p2 = tmp_path / "flat.json"
    p2.write_text(json.dumps({"env": [0.5, 0.5, 0.5]}))
    scene2, *_ = load_scene_json(str(p2))
    np.testing.assert_allclose(np.asarray(scene2.env), 0.5)
