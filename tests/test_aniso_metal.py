"""Anisotropic GGX conductors (material key `roughness_y`).

Slope-space NDF sampling + Heitz Smith-G1 in the deterministic per-normal
ONB frame (sampler.build_onb). ax == ay reproduces the isotropic math
exactly; scenes without a distinct roughness_y compile the prior
(isotropic) program. Completes VERDICT round-3 item 4 with the rough
dielectric."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from raytracing_engine_tpu.pathtracer import PTConfig, sampler
from raytracing_engine_tpu.pathtracer.integrator import render_pt
from raytracing_engine_tpu.pathtracer.scene import (
    DIFFUSE,
    METAL,
    build_pt_scene,
)
from raytracing_engine_tpu.pathtracer.wavefront import render_pt_fast

KEY = jax.random.PRNGKey(17)
QUAT = jnp.array([0.0, 0.0, 0.0, 1.0])
POS = jnp.zeros(3)
AX, AY = 0.09, 0.36  # alpha_x, alpha_y used by the math tests


def _quad_moments(ax, ay, n=512):
    """Gauss-style quadrature of D(h)cosθ moments over the hemisphere."""
    th = (np.arange(n) + 0.5) / n * (np.pi / 2)
    ph = (np.arange(2 * n) + 0.5) / (2 * n) * (2 * np.pi)
    T, P = np.meshgrid(th, ph, indexing="ij")
    hx = np.sin(T) * np.cos(P)
    hy = np.sin(T) * np.sin(P)
    hz = np.cos(T)
    e = (hx / ax) ** 2 + (hy / ay) ** 2 + hz ** 2
    D = 1.0 / (np.pi * ax * ay * e * e)
    w = np.sin(T) * (np.pi / 2 / n) * (2 * np.pi / (2 * n))
    base = D * hz * w
    return (base.sum(), (base * hx * hx).sum(), (base * hy * hy).sum(),
            (base * hz).sum())


def test_aniso_ndf_normalizes():
    """∫ D(h) cosθ dω = 1 — the NDF normalization that makes D·cos a pdf."""
    total, _, _, _ = _quad_moments(AX, AY)
    assert abs(total - 1.0) < 1e-3, total


def test_aniso_sampler_matches_pdf_moments():
    """Moments of sample_ggx_h_aniso match quadrature of its claimed pdf
    D·cosθ — catches axis swaps, scaling and Jacobian slips in one shot."""
    n = 200000
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    u1 = jax.random.uniform(k1, (1, n))
    u2 = jax.random.uniform(k2, (1, n))
    z = jnp.zeros((1, n))
    nrm = (z, z, z + 1.0)
    t = (z + 1.0, z, z)
    s = (z, z + 1.0, z)
    h = sampler.sample_ggx_h_aniso(u1, u2, t, s, nrm, AX, AY)
    hx, hy, hz = (np.asarray(c).ravel() for c in h)
    _, mx, my, mz = _quad_moments(AX, AY)
    assert abs(np.mean(hx ** 2) - mx) / mx < 0.02, (np.mean(hx ** 2), mx)
    assert abs(np.mean(hy ** 2) - my) / my < 0.02, (np.mean(hy ** 2), my)
    assert abs(np.mean(hz) - mz) / mz < 0.01
    # eval agrees with its own sampling pdf: E[D·cos_h / pdf_reflect] sanity
    f, pdf = sampler.ggx_eval_aniso(nrm, t, s, (z, z, z + 1.0), h,
                                    (z + 1.0, z + 1.0, z + 1.0), AX, AY)
    assert bool(jnp.all(pdf >= 0.0))


def _plane_scene(rx, ry=None):
    mats = [{"albedo": (0.9, 0.9, 0.9), "kind": METAL, "roughness": rx},
            {"albedo": (0, 0, 0), "emission": (60.0,) * 3, "kind": DIFFUSE}]
    if ry is not None:
        mats[0]["roughness_y"] = ry
    return build_pt_scene(
        spheres=[((0.0, 8.0, -1001.0), 1000.0, 0),  # floor, n ~ +z
                 ((0.0, 8.0, 6.0), 0.5, 1)],        # light above
        materials=mats, env=((0.05,) * 3, (0.05,) * 3))


def test_iso_limit_matches_isotropic_path():
    """roughness_y == roughness runs the aniso code (mat_rough2 only ships
    when they DIFFER somewhere, so force it with a second material) and
    must reproduce the isotropic render to float tolerance — the slope-
    space sampler is the same distribution, hz² = (1-u)/(1+(a²-1)u)."""
    iso = _plane_scene(0.3)
    aniso = build_pt_scene(
        spheres=[((0.0, 8.0, -1001.0), 1000.0, 0), ((0.0, 8.0, 6.0), 0.5, 1)],
        materials=[{"albedo": (0.9, 0.9, 0.9), "kind": METAL,
                    "roughness": 0.3, "roughness_y": 0.3},
                   {"albedo": (0, 0, 0), "emission": (60.0,) * 3,
                    "kind": DIFFUSE},
                   # unused material with distinct axes: ships mat_rough2
                   {"albedo": (0.5,) * 3, "kind": METAL,
                    "roughness": 0.1, "roughness_y": 0.5}],
        env=((0.05,) * 3, (0.05,) * 3))
    assert not iso.has_aniso and aniso.has_aniso
    cfg = PTConfig(width=32, height=24, max_bounces=2, rng="pcg")
    a, _ = render_pt_fast(cfg, iso, POS, QUAT, 16, KEY)
    b, _ = render_pt_fast(cfg, aniso, POS, QUAT, 16, KEY)
    a, b = np.asarray(a), np.asarray(b)
    # same distribution and (mathematically) the same sample values, but
    # the float op order differs and a ULP in a reflected direction can
    # land a different hit — compare statistically
    d = np.abs(a - b).max(-1)
    assert (d > 1e-3).mean() < 0.02, f"{(d > 1e-3).mean():.3%} diverged"
    assert abs(a.mean() - b.mean()) / a.mean() < 1e-3


def test_stretched_highlight():
    """ax << ay elongates the floor highlight along the bitangent (the
    ONB frame at n=+z is t=+x, s=+y): the brightness spread along image
    y must exceed the spread along x by a wide margin."""
    scene = _plane_scene(0.06, ry=0.5)
    cfg = PTConfig(width=64, height=64, max_bounces=1, rng="pcg")
    img, _ = render_pt_fast(cfg, scene, POS, QUAT, 128, KEY)
    lum = np.asarray(img).mean(-1)
    lum = np.where(lum > 5.0, 0.0, lum)  # drop direct light views
    ys, xs = np.nonzero(lum > 0.05)
    w = lum[ys, xs]
    var = lambda v: float(np.average((v - np.average(v, weights=w)) ** 2,
                                     weights=w))
    assert var(ys) > 2.0 * var(xs), (var(ys), var(xs))


def test_engines_agree():
    scene = _plane_scene(0.1, ry=0.4)
    cfg = PTConfig(width=48, height=32, max_bounces=2)
    a, na = render_pt(cfg, scene, POS, QUAT, 16, KEY)
    b, nb = render_pt_fast(cfg, scene, POS, QUAT, 16, KEY)
    a, b = np.asarray(a), np.asarray(b)
    assert np.abs(a - b).max() < 2e-3
    assert abs(a.mean() - b.mean()) < 1e-5
    assert float(na) == float(nb)


def test_furnace_bound():
    """F0=1 conductor sphere in a constant furnace: single-scatter Smith
    masking only LOSES energy — patch mean <= 1 and well above zero."""
    from raytracing_engine_tpu.pathtracer.scene import build_env_map  # noqa

    scene = build_pt_scene(
        spheres=[((0.0, 4.0, 0.0), 1.0, 0)],
        materials=[{"albedo": (1.0, 1.0, 1.0), "kind": METAL,
                    "roughness": 0.1, "roughness_y": 0.5}],
        env=(1.0, 1.0, 1.0))
    cfg = PTConfig(width=32, height=24, max_bounces=4, rng="pcg")
    img, _ = render_pt_fast(cfg, scene, POS, QUAT, 128, KEY)
    img = np.asarray(img)
    h, w, _ = img.shape
    patch = img[h // 2 - 3: h // 2 + 3, w // 2 - 3: w // 2 + 3]
    assert patch.mean() < 1.02, patch.mean()
    assert patch.mean() > 0.5, patch.mean()


def test_json_roundtrip(tmp_path):
    import json

    from raytracing_engine_tpu.pathtracer.sceneio import load_scene_json

    spec = {
        "materials": [{"albedo": [0.9, 0.8, 0.6], "kind": "metal",
                       "roughness": 0.1, "roughness_y": 0.4}],
        "spheres": [{"center": [0, 4, 0], "radius": 1.0, "mat": 0}],
    }
    f = tmp_path / "s.json"
    f.write_text(json.dumps(spec))
    bundle = load_scene_json(str(f))
    assert bundle.scene.has_aniso
    np.testing.assert_allclose(np.asarray(bundle.scene.mat_rough2), [0.4])
