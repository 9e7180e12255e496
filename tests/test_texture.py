"""World-space checker textures: exact cell colors, parity, AOV albedo."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from raytracing_engine_tpu.pathtracer import (
    PTConfig,
    render_aovs,
    render_pt_fast,
)
from raytracing_engine_tpu.pathtracer.integrator import render_pt
from raytracing_engine_tpu.pathtracer.scene import DIFFUSE, build_pt_scene

KEY = jax.random.PRNGKey(17)
QUAT = jnp.array([0.0, 0.0, 0.0, 1.0])
POS = jnp.zeros(3)


def checker_floor_scene():
    """A giant checkered floor sphere under a constant env sky: pixel
    colors are analytically albedo_or_color * env (one diffuse bounce)."""
    mats = [{"albedo": (0.8, 0.2, 0.2), "kind": DIFFUSE,
             "checker": {"color": (0.2, 0.2, 0.8), "scale": 0.5}}]
    return build_pt_scene(
        spheres=[((0.0, 8.0, -1001.0), 1000.0, 0)],
        materials=mats, env=(1.0, 1.0, 1.0))


def test_checker_cells_exact():
    """AOV albedo reads the exact per-cell color: at scale 0.5 the cell
    size is 2 world units; probe two hit points one cell apart in x."""
    cfg = PTConfig(width=96, height=64)
    aovs = render_aovs(cfg, checker_floor_scene(), POS, QUAT, 8, KEY)
    alb = np.asarray(aovs["albedo"])
    dep = np.asarray(aovs["depth"])
    h, w, _ = alb.shape
    # near floor pixels (array row 0 looks DOWN — ncy=-1) have big
    # projected cells and read one of the two exact cell colors; far rows
    # may AA-average across shrinking cells
    near = dep[: h // 3] > 0
    a = alb[: h // 3][near]
    is_red = np.abs(a - (0.8, 0.2, 0.2)).max(-1) < 1e-4
    is_blue = np.abs(a - (0.2, 0.2, 0.8)).max(-1) < 1e-4
    assert (is_red | is_blue).mean() > 0.85, (is_red | is_blue).mean()
    assert is_red.any() and is_blue.any()


def test_checker_renders_match_across_integrators():
    scene = checker_floor_scene()
    cfg = PTConfig(width=48, height=32, max_bounces=2)
    a, _ = render_pt(cfg, scene, POS, QUAT, 8, KEY)
    b, _ = render_pt_fast(cfg, scene, POS, QUAT, 8, KEY)
    np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                               rtol=1e-5, atol=2e-3)


def test_untextured_scene_bitexact():
    """Scenes without checker materials compile the pre-texture program:
    byte-identical output (static None gating)."""
    mats = [{"albedo": (0.5, 0.5, 0.5), "kind": DIFFUSE}]
    s1 = build_pt_scene(spheres=[((0.0, 6.0, 0.0), 1.0, 0)],
                        materials=mats, env=(1.0, 1.0, 1.0))
    assert not s1.has_texture and s1.mat_tex_scale is None
    cfg = PTConfig(width=24, height=16, max_bounces=2)
    img, _ = render_pt(cfg, s1, POS, QUAT, 4, KEY)
    assert np.isfinite(np.asarray(img)).all()


def test_sceneio_checker(tmp_path):
    import json

    from raytracing_engine_tpu.pathtracer.sceneio import load_scene_json

    p = tmp_path / "checker.json"
    p.write_text(json.dumps({
        "materials": [{"albedo": [0.8, 0.2, 0.2],
                       "checker": {"color": [0.2, 0.2, 0.8], "scale": 2.0}}],
        "spheres": [{"center": [0, 8, -1001], "radius": 1000, "mat": 0}],
        "env": [1, 1, 1],
    }))
    scene, *_ = load_scene_json(str(p))
    assert scene.has_texture
    np.testing.assert_allclose(np.asarray(scene.mat_albedo2)[0],
                               (0.2, 0.2, 0.8))
    assert float(scene.mat_tex_scale[0]) == 2.0
