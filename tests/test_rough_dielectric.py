"""GGX rough dielectric (Walter 2007 microfacet refraction).

DIELECTRIC materials with roughness > 0 scatter about an NDF-sampled
half-vector: the Fresnel R/T coin runs about h (still cancelling F from
throughput) and the path carries the |d·h|·G/(cos_o·cos_h) weight of
D·cos_h half-vector sampling. Roughness-0 glass keeps the exact smooth
math per lane; scenes without rough glass compile the prior program.
Completes the material surface begun with the round-3 GGX conductor
(north-star multi-material; the reference has neither —
/root/reference/shaders/fragment.glsl is Blinn-Phong only).
"""

import dataclasses

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

KEY = jax.random.PRNGKey(9)
QUAT = jnp.array([0.0, 0.0, 0.0, 1.0])
POS = jnp.zeros(3)


def _glass_scene(rough, extra_unused_rough=False, env=(1.0, 1.0, 1.0)):
    mats = [{"kind": DIELECTRIC, "ior": 1.5, "roughness": rough},
            {"albedo": (0.6, 0.5, 0.4), "kind": DIFFUSE}]
    if extra_unused_rough:
        mats.append({"kind": DIELECTRIC, "ior": 1.5, "roughness": 0.3})
    return build_pt_scene(
        spheres=[((0.0, 4.0, 0.0), 1.0, 0), ((1.8, 5.5, -0.8), 0.7, 1)],
        materials=mats, env=env)


def test_flag_and_smooth_lanes_unchanged():
    """roughness-0 glass renders the same values whether or not ANOTHER
    material turns the rough-dielectric branch on (per-lane selects keep
    smooth lanes on the exact prior math)."""
    a = _glass_scene(0.0)
    b = _glass_scene(0.0, extra_unused_rough=True)
    assert not a.has_rough_dielectric and b.has_rough_dielectric
    cfg = PTConfig(width=32, height=24, max_bounces=4, rng="pcg")
    ia, _ = render_pt_fast(cfg, a, POS, QUAT, 8, KEY)
    ib, _ = render_pt_fast(cfg, b, POS, QUAT, 8, KEY)
    np.testing.assert_allclose(np.asarray(ia), np.asarray(ib),
                               rtol=1e-6, atol=1e-6)


def test_low_roughness_approaches_smooth():
    """roughness -> 0 limit: the Walter branch converges to smooth glass
    (h -> n, G -> 1, weight -> 1)."""
    cfg = PTConfig(width=32, height=24, max_bounces=6, rng="pcg")
    smooth, _ = render_pt_fast(cfg, _glass_scene(0.0), POS, QUAT, 128, KEY)
    near, _ = render_pt_fast(cfg, _glass_scene(0.02), POS, QUAT, 128, KEY)
    smooth, near = np.asarray(smooth), np.asarray(near)
    assert abs(smooth.mean() - near.mean()) / smooth.mean() < 0.02
    assert np.abs(smooth - near).mean() < 0.05


@pytest.mark.parametrize("rough", [0.15, 0.4])
def test_furnace_bound(rough):
    """Constant env furnace with a rough glass sphere: single-scatter GGX
    can only LOSE energy (separable Smith G <= 1) — mean <= 1 + MC tol and
    well above the all-absorbed floor."""
    scene = build_pt_scene(
        spheres=[((0.0, 4.0, 0.0), 1.0, 0)],
        materials=[{"kind": DIELECTRIC, "ior": 1.5, "roughness": rough}],
        env=(1.0, 1.0, 1.0))
    cfg = PTConfig(width=32, height=24, max_bounces=12, rng="pcg")
    img, _ = render_pt_fast(cfg, scene, POS, QUAT, 256, KEY)
    img = np.asarray(img)
    h, w, _ = img.shape
    patch = img[h // 2 - 3: h // 2 + 3, w // 2 - 3: w // 2 + 3]
    assert patch.mean() < 1.02, patch.mean()
    assert patch.mean() > 0.7, patch.mean()


def test_engines_agree():
    """Stacked integrator vs SoA wavefront: identical streams, identical
    rough-glass math — images match closely."""
    scene = _glass_scene(0.3, env=((0.2, 0.3, 0.5), (0.9, 0.9, 1.0)))
    cfg = PTConfig(width=48, height=32, max_bounces=4)
    a, na = render_pt(cfg, scene, POS, QUAT, 16, KEY)
    b, nb = render_pt_fast(cfg, scene, POS, QUAT, 16, KEY)
    a, b = np.asarray(a), np.asarray(b)
    assert np.abs(a - b).max() < 2e-3
    assert abs(a.mean() - b.mean()) < 1e-5
    assert float(na) == float(nb)


def test_transmission_blurs_with_roughness():
    """A bright area light behind a rough glass pane: transmitted energy
    stays comparable, but spatial spread grows with roughness (the visible
    signature of microfacet refraction)."""
    def pane(rough):
        # glass slab built from two triangles, light far behind it
        quad = np.array([
            [[-2, 6, -2], [2, 6, -2], [2, 6, 2]],
            [[-2, 6, -2], [2, 6, 2], [-2, 6, 2]],
        ], np.float32)
        return build_pt_scene(
            spheres=[((0.0, 12.0, 0.0), 1.0, 1)],
            triangles=quad, tri_mats=np.zeros(2, np.int32),
            materials=[{"kind": DIELECTRIC, "ior": 1.5, "roughness": rough},
                       {"albedo": (0, 0, 0), "emission": (50.0,) * 3,
                        "kind": DIFFUSE}])

    cfg = PTConfig(width=48, height=32, max_bounces=6, rng="pcg",
                   use_nee=False)
    lo, _ = render_pt_fast(cfg, pane(0.05), POS, QUAT, 256, KEY)
    hi, _ = render_pt_fast(cfg, pane(0.5), POS, QUAT, 256, KEY)
    lo, hi = np.asarray(lo).mean(-1), np.asarray(hi).mean(-1)
    assert lo.sum() > 0.0 and hi.sum() > 0.0
    # normalized spatial concentration: sharp pane focuses energy into
    # fewer pixels than the rough one
    conc = lambda im: float((im ** 2).sum() / max(im.sum(), 1e-9) ** 2)
    assert conc(lo) > 1.5 * conc(hi), (conc(lo), conc(hi))


def test_json_roundtrip(tmp_path):
    import json

    from raytracing_engine_tpu.pathtracer.sceneio import load_scene_json

    spec = {
        "materials": [
            {"kind": "dielectric", "ior": 1.5, "roughness": 0.3}],
        "spheres": [{"center": [0, 4, 0], "radius": 1.0, "mat": 0}],
    }
    f = tmp_path / "s.json"
    f.write_text(json.dumps(spec))
    bundle = load_scene_json(str(f))
    assert bundle.scene.has_rough_dielectric
