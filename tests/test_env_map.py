"""HDR environment-map lighting: alias sampling, NEE + MIS, parity.

Generalizes the gradient sky (test_env_light.py) to an importance-sampled
equirect image (scene.build_env_map): NEE picks the env with probability
env_pick via a luminance-x-solid-angle alias table, MIS pairs it against
BSDF sampling on both sides, and escaped rays fetch their direction's
texel. The reference's sky is black-beyond-RENDER_DIST
(/root/reference/shaders/fragment.glsl:137-140); this is the north-star
HDR generalization.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from raytracing_engine_tpu.pathtracer import PTConfig
from raytracing_engine_tpu.pathtracer.integrator import render_pt
from raytracing_engine_tpu.pathtracer.scene import (
    DIFFUSE,
    METAL,
    build_env_map,
    build_pt_scene,
)
from raytracing_engine_tpu.pathtracer.wavefront import render_pt_fast

KEY = jax.random.PRNGKey(5)
QUAT = jnp.array([0.0, 0.0, 0.0, 1.0])
POS = jnp.zeros(3)


def _const_map(c, K=8):
    return np.broadcast_to(np.asarray(c, np.float32), (K, 128, 3)).copy()


def _sun_map(K=16, sun=(2, 40), le=200.0, sky=0.05):
    img = np.full((K, 128, 3), sky, np.float32)
    img[sun[0], sun[1]] = (le, le, le)
    return img


def test_alias_table_reconstructs_pmf():
    """The Vose table must reproduce the pmf exactly:
    p[i] = prob[i]/N + sum_j alias[j]==i (1 - prob[j])/N."""
    from raytracing_engine_tpu.pathtracer.scene import _alias_table

    rng = np.random.default_rng(0)
    p = rng.random(257)
    p /= p.sum()
    prob, alias = _alias_table(p)
    n = p.size
    recon = prob / n
    np.add.at(recon, alias.astype(int), (1.0 - prob) / n)
    np.testing.assert_allclose(recon, p, atol=1e-6)


def test_env_sampler_pdf_normalizes():
    """MC check: E[1 / pdf(w)] over the sampler = full-sphere solid angle
    4*pi — catches any Jacobian / selection-prob slip in one number."""
    from raytracing_engine_tpu.pathtracer.wavefront import _sample_env

    rng = np.random.default_rng(0)  # mildly varying map: non-uniform psel
    img = (0.5 + rng.random((16, 128, 3))).astype(np.float32)
    scene = build_pt_scene(env=img)
    n = 65536
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(1), 3)
    s = jax.random.uniform(k1, (1, n))   # plane helpers expect 2D
    j1 = jax.random.uniform(k2, (1, n))
    j2 = jax.random.uniform(k3, (1, n))
    _, pdf, _ = _sample_env(scene, s, j1, j2)
    est = float(jnp.mean(1.0 / pdf))
    assert abs(est - 4.0 * np.pi) / (4.0 * np.pi) < 0.02, est


def test_env_sampler_hits_the_sun():
    """Alias selection concentrates on the bright texel and maps it to the
    right direction (texel -> direction -> texel round trip)."""
    from raytracing_engine_tpu.pathtracer.wavefront import (
        _env_texel_of,
        _sample_env,
    )

    K = 16
    # le=4000: the sun texel holds ~98% of the selection weight
    # (p = le*domega / (le*domega + sky*4pi))
    scene = build_pt_scene(env=_sun_map(K=K, le=4000.0))
    n = 4096
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(2), 3)
    d, pdf, le = _sample_env(scene, jax.random.uniform(k1, (1, n)),
                             jax.random.uniform(k2, (1, n)),
                             jax.random.uniform(k3, (1, n)))
    frac_sun = float(jnp.mean(le[0] > 100.0))
    assert frac_sun > 0.9  # ~all samples land on the dominant texel
    ty, tx = _env_texel_of(d, K)
    on_sun = np.asarray(le[0] > 100.0)
    assert (np.asarray(ty)[on_sun] == 2).mean() > 0.95
    assert (np.asarray(tx)[on_sun] == 40).mean() > 0.95


def test_constant_env_map_reads_exactly():
    """Empty scene + constant map: every pixel = the map radiance (escape
    fetch at full weight on camera rays)."""
    scene = build_pt_scene(env=_const_map((0.7, 0.8, 0.9)))
    cfg = PTConfig(width=32, height=24, max_bounces=2)
    img, _ = render_pt(cfg, scene, POS, QUAT, 4, KEY)
    np.testing.assert_allclose(np.asarray(img),
                               np.broadcast_to((0.7, 0.8, 0.9), (24, 32, 3)),
                               atol=1e-5)


def test_env_map_furnace_diffuse_sphere():
    """Convex Lambertian sphere under a constant map: NEE + MIS must
    converge to exactly albedo * Le on the sphere."""
    scene = build_pt_scene(
        spheres=[((0.0, 4.0, 0.0), 1.0, 0)],
        materials=[{"albedo": (0.5, 0.5, 0.5), "kind": DIFFUSE}],
        env=_const_map((1.0, 1.0, 1.0)))
    cfg = PTConfig(width=48, height=32, max_bounces=2, rng="pcg")
    img, _ = render_pt_fast(cfg, scene, POS, QUAT, 256, KEY)
    img = np.asarray(img)
    h, w, _ = img.shape
    patch = img[h // 2 - 2: h // 2 + 2, w // 2 - 2: w // 2 + 2]
    assert abs(patch.mean() - 0.5) < 0.01, patch.mean()
    np.testing.assert_allclose(img[0, 0], 1.0, atol=1e-5)


def test_env_map_nee_beats_bsdf_only_on_sun():
    """A small bright sun: the importance-sampled estimator at low spp must
    agree with the high-spp BSDF-only estimator in MEAN (unbiasedness +
    MIS weights sum to one) and be far less noisy (the point of NEE)."""
    import dataclasses

    scene = build_pt_scene(
        spheres=[((0.0, 4.0, -51.0), 50.0, 0)],
        materials=[{"albedo": (0.8, 0.8, 0.8), "kind": DIFFUSE}],
        env=_sun_map())
    cfg = PTConfig(width=32, height=24, max_bounces=2, rng="pcg")
    lit, _ = render_pt_fast(cfg, scene, POS, QUAT, 64, KEY)
    ref, _ = render_pt_fast(
        dataclasses.replace(cfg, use_nee=False), scene, POS, QUAT, 4096,
        jax.random.PRNGKey(7))
    lit, ref = np.asarray(lit), np.asarray(ref)
    floor = ref.max(-1) < 1.0  # exclude direct sun-view pixels
    assert floor.mean() > 0.5
    lm, rm = lit[floor].mean(), ref[floor].mean()
    assert abs(lm - rm) / rm < 0.05, (lm, rm)
    # variance: NEE at 64 spp must beat BSDF-only at the same spp by a lot
    noisy, _ = render_pt_fast(dataclasses.replace(cfg, use_nee=False),
                              scene, POS, QUAT, 64, KEY)
    mse_nee = float(((lit - ref) ** 2)[floor].mean())
    mse_bsdf = float(((np.asarray(noisy) - ref) ** 2)[floor].mean())
    assert mse_nee < 0.25 * mse_bsdf, (mse_nee, mse_bsdf)


def test_env_map_wavefront_matches_reference():
    """Stacked integrator vs SoA wavefront on an env-map scene with an
    area light AND a metal surface (exercises the split, both MIS sides,
    and the GGX NEE path)."""
    scene = build_pt_scene(
        spheres=[((0.0, 4.0, 0.0), 1.0, 0), ((2.0, 5.0, 1.5), 0.6, 1),
                 ((-2.0, 5.0, 0.0), 0.8, 2)],
        materials=[{"albedo": (0.6, 0.5, 0.4), "kind": DIFFUSE},
                   {"albedo": (0, 0, 0), "emission": (6.0,) * 3,
                    "kind": DIFFUSE},
                   {"albedo": (0.9, 0.7, 0.5), "kind": METAL,
                    "roughness": 0.4}],
        env=_sun_map(le=40.0, sky=0.2))
    cfg = PTConfig(width=48, height=32, max_bounces=3)
    a, na = render_pt(cfg, scene, POS, QUAT, 16, KEY)
    b, nb = render_pt_fast(cfg, scene, POS, QUAT, 16, KEY)
    a, b = np.asarray(a), np.asarray(b)
    assert np.abs(a - b).max() < 2e-3
    assert abs(a.mean() - b.mean()) < 1e-5
    assert float(na) == float(nb)


def test_env_map_excludes_gradient():
    """An image env replaces the gradient env (mutually exclusive)."""
    scene = build_pt_scene(env=_const_map((1.0, 1.0, 1.0)))
    assert scene.env is None and scene.has_env_map
    assert scene.env_img.shape == (3 * 8, 128)
    assert scene.env_smp.shape == (3 * 8, 128)


def test_env_map_json_roundtrip(tmp_path):
    """sceneio: {"env": {"image": ...}} builds the importance-sampled map."""
    import json

    from raytracing_engine_tpu.pathtracer.sceneio import load_scene_json

    spec = {
        "materials": [{"albedo": [0.5, 0.5, 0.5], "kind": "diffuse"}],
        "spheres": [{"center": [0, 4, 0], "radius": 1.0, "mat": 0}],
        "env": {"image": _const_map((0.3, 0.4, 0.5), K=4).tolist(),
                "rows": 4},
    }
    f = tmp_path / "s.json"
    f.write_text(json.dumps(spec))
    loaded = load_scene_json(str(f))
    scene = loaded.scene if hasattr(loaded, "scene") else loaded[0]
    assert scene.has_env_map and scene.env is None
    assert scene.env_img.shape == (12, 128)
    np.testing.assert_allclose(np.asarray(scene.env_img[0]), 0.3)


def test_env_map_sharded_matches_unsharded():
    """Env-map scene over a 2x4 (tiles x samples) device mesh: the tables
    replicate as scene leaves and the counter-keyed streams make the
    sharded SoA render match render_pt_fast bit-for-bit up to the psum."""
    from raytracing_engine_tpu.parallel import make_mesh
    from raytracing_engine_tpu.parallel.pt_sharding import render_pt_sharded

    scene = build_pt_scene(
        spheres=[((0.0, 4.0, 0.0), 1.0, 0), ((2.0, 5.0, 1.5), 0.6, 1)],
        materials=[{"albedo": (0.6, 0.5, 0.4), "kind": DIFFUSE},
                   {"albedo": (0, 0, 0), "emission": (6.0,) * 3,
                    "kind": DIFFUSE}],
        env=_sun_map(le=40.0, sky=0.2))
    cfg = PTConfig(width=32, height=24, max_bounces=2, rng="pcg")
    want, want_rays = render_pt_fast(cfg, scene, POS, QUAT, 8, KEY)
    got, nrays = render_pt_sharded(cfg, scene, POS, QUAT, 8, KEY,
                                   make_mesh(2, 4), soa=True)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-5, atol=1e-6)
    assert abs(float(nrays) - float(want_rays)) < 1e-3
