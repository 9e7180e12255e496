"""Tangent-space normal mapping over the shared texture atlas.

The design constraint mirrors UV textures (test_uv_texture.py): the
map texel fetch reuses the lane-axis atlas fetch, and the tangent frame
is DERIVED, never stored — triangles use the texture-u gradient
d(u_tex)/dp = du1*r1 + du2*r2 from the Baldwin–Weber barycentric
gradient rows already in the cluster tables (translation-invariant, 6
scalar FMAs per committed test), spheres the analytic azimuthal
direction (-y, x, 0). The reference shades analytic SDF normals only
(/root/reference/shaders/fragment.glsl) — normal maps are a north-star
material extension.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from raytracing_engine_tpu.pathtracer import (
    PTConfig,
    render_pt,
    render_pt_fast,
)
from raytracing_engine_tpu.pathtracer.scene import DIFFUSE, build_pt_scene

KEY = jax.random.PRNGKey(7)
QUAT = jnp.array([0.0, 0.0, 0.0, 1.0])
POS = jnp.zeros(3)


def tilt_map(tilt=0.8, n=8):
    """Checkerboard of ±tilt-in-u tangent-space normals, (n+1)/2 encoded."""
    nm = np.zeros((n, n, 3), np.float32)
    z = np.sqrt(1.0 - tilt * tilt)
    for yy in range(n):
        for xx in range(n):
            sgn = 1.0 if (xx + yy) % 2 == 0 else -1.0
            nm[yy, xx] = (np.array([sgn * tilt, 0.0, z]) + 1.0) / 2.0
    return nm


FLAT = np.full((4, 4, 3), 0.5, np.float32)
FLAT[..., 2] = 1.0  # (0, 0, 1) everywhere — the identity map


def quad(half=2.0):
    v = lambda x, z: (x, 5.0, z)  # noqa: E731
    tris = np.array([
        [v(-half, -half), v(half, -half), v(half, half)],
        [v(-half, -half), v(half, half), v(-half, half)],
    ], np.float32)
    uv = lambda x, z: ((x + half) / (2 * half), (z + half) / (2 * half))  # noqa: E731
    uvs = np.array([
        [uv(-half, -half), uv(half, -half), uv(half, half)],
        [uv(-half, -half), uv(half, half), uv(-half, half)],
    ], np.float32)
    return tris, uvs


def sphere_scene(nmap, scale=2.0):
    return build_pt_scene(
        spheres=[((0.0, 6.0, 0.0), 2.0, 0), ((0.0, 14.0, -103.0), 100.0, 1)],
        materials=[
            {"albedo": (0.6, 0.6, 0.6), "kind": DIFFUSE,
             **({"normal": {"pixels": nmap, "scale": scale}}
                if nmap is not None else {})},
            {"albedo": (0, 0, 0), "emission": (30.0,) * 3, "kind": DIFFUSE},
        ])


def test_flags_and_atlas_sharing():
    s = sphere_scene(tilt_map())
    assert s.has_normal_map and s.needs_uv and s.has_atlas
    assert not s.has_image  # normal map alone: no albedo image rects
    # image + normal map share ONE atlas
    tex = np.zeros((4, 4, 3), np.float32)
    s2 = build_pt_scene(
        spheres=[((0.0, 6.0, 0.0), 1.0, 0)],
        materials=[{"albedo": (0.5, 0.5, 0.5), "kind": DIFFUSE,
                    "image": {"pixels": tex, "scale": 1.0},
                    "normal": {"pixels": tilt_map(), "scale": 1.0}}],
        env=(1.0, 1.0, 1.0))
    assert s2.has_image and s2.has_normal_map
    K = s2.tex_atlas.shape[0] // 3
    assert K >= 2  # both images packed
    r_img = np.asarray(s2.mat_tex_rect[0])
    r_nrm = np.asarray(s2.mat_nrm_rect[0])
    assert r_img[2] == 4.0 and r_nrm[2] == 8.0
    assert tuple(r_img[:2]) != tuple(r_nrm[:2])


def test_flat_map_is_identity():
    """The (0, 0, 1) map reproduces the unmapped render to fp tolerance
    (the frame rotation is exactly n; only the final renormalization can
    differ in the last ulp)."""
    cfg = PTConfig(width=32, height=32, max_bounces=2, rng="pcg")
    a, _ = render_pt_fast(cfg, sphere_scene(FLAT), POS, QUAT, 4, KEY)
    b, _ = render_pt_fast(cfg, sphere_scene(None), POS, QUAT, 4, KEY)
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-4)


def test_tilted_map_changes_shading():
    cfg = PTConfig(width=32, height=32, max_bounces=2, rng="pcg")
    a, _ = render_pt_fast(cfg, sphere_scene(tilt_map()), POS, QUAT, 4, KEY)
    b, _ = render_pt_fast(cfg, sphere_scene(None), POS, QUAT, 4, KEY)
    assert float(jnp.abs(a - b).max()) > 1e-3
    assert bool(jnp.isfinite(a).all())


def test_integrator_parity_spheres():
    scene = sphere_scene(tilt_map())
    cfg = PTConfig(width=24, height=24, max_bounces=2, rng="threefry")
    a, _ = render_pt(cfg, scene, POS, QUAT, 2, jax.random.PRNGKey(3))
    b, _ = render_pt_fast(cfg, scene, POS, QUAT, 2, jax.random.PRNGKey(3))
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-5)


# ---------------------------------------------------- tangent emission

def test_cluster_sweep_emits_world_tangent():
    """cluster_intersect(tan=True) emits d(u_tex)/dp — for the analytic
    quad (u = (x+h)/2h) that is exactly (1/2h, 0, 0) at every hit."""
    from raytracing_engine_tpu.accel.clusters import build_clusters
    from raytracing_engine_tpu.ops.pallas.cluster_intersect import (
        cluster_intersect)

    tris, uvs = quad(half=2.0)
    cs = build_clusters(tris, vertex_uvs=uvs)
    h, w = 8, 128
    rng = np.random.RandomState(0)
    tx = rng.uniform(-1.9, 1.9, (h, w)).astype(np.float32)
    tz = rng.uniform(-1.9, 1.9, (h, w)).astype(np.float32)
    o = tuple(jnp.zeros((h, w), jnp.float32) for _ in range(3))
    dn = np.sqrt(tx**2 + 25.0 + tz**2)
    d = (jnp.asarray(tx / dn), jnp.asarray(5.0 / dn), jnp.asarray(tz / dn))
    res = cluster_intersect(cs, o, d, 1e9, attrs=True, tan=True)
    assert len(res) == 12, "tan=True must add 3 tangent planes"
    assert bool(jnp.all(res[1] >= 0))
    gx, gy, gz = (np.asarray(r) for r in res[9:12])
    np.testing.assert_allclose(gx, 0.25, atol=1e-6)
    np.testing.assert_allclose(gy, 0.0, atol=1e-6)
    np.testing.assert_allclose(gz, 0.0, atol=1e-6)
    # tan=False keeps the 9-plane UV program
    assert len(cluster_intersect(cs, o, d, 1e9, attrs=True)) == 9


def test_sphere_tangent_is_azimuthal():
    from raytracing_engine_tpu.pathtracer.wavefront import _sphere_tan

    n = (jnp.asarray([1.0, 0.0]), jnp.asarray([0.0, 1.0]),
         jnp.asarray([0.0, 0.0]))
    tx, ty, tz = _sphere_tan(n)
    np.testing.assert_allclose(np.asarray(tx), [0.0, -1.0])
    np.testing.assert_allclose(np.asarray(ty), [1.0, 0.0])
    np.testing.assert_allclose(np.asarray(tz), [0.0, 0.0])


# ------------------------------------------------------- mesh + instanced

def mesh_scene(nmap):
    tris, uvs = quad(half=2.0)
    return tris, uvs, build_pt_scene(
        spheres=[((0.0, 14.0, -103.0), 100.0, 1)],
        triangles=tris, tri_mats=np.zeros(2, np.int32), tri_uvs=uvs,
        materials=[
            {"albedo": (0.6, 0.6, 0.6), "kind": DIFFUSE,
             "normal": {"pixels": nmap, "scale": 1.0}},
            {"albedo": (0, 0, 0), "emission": (30.0,) * 3, "kind": DIFFUSE},
        ])


def test_mesh_integrator_parity():
    _, _, scene = mesh_scene(tilt_map())
    cfg = PTConfig(width=24, height=24, max_bounces=2, rng="threefry")
    a, _ = render_pt(cfg, scene, POS, QUAT, 2, jax.random.PRNGKey(3))
    b, _ = render_pt_fast(cfg, scene, POS, QUAT, 2, jax.random.PRNGKey(3))
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-5)


# ------------------------------------------------------------ AOV + IO

def test_aov_normal_uses_shading_normal():
    from raytracing_engine_tpu.pathtracer import render_aovs

    cfg = PTConfig(width=32, height=32)
    a = render_aovs(cfg, sphere_scene(tilt_map()), POS, QUAT, 1, KEY)
    b = render_aovs(cfg, sphere_scene(None), POS, QUAT, 1, KEY)
    d = np.abs(np.asarray(a["normal"]) - np.asarray(b["normal"])).max()
    assert d > 0.1  # the guide shows the perturbed (shading) normal


def test_sceneio_normal_key(tmp_path):
    import json

    from raytracing_engine_tpu.pathtracer.sceneio import load_scene_json

    np.save(str(tmp_path / "nrm.npy"), tilt_map())
    p = tmp_path / "scene.json"
    p.write_text(json.dumps({
        "materials": [{"albedo": [0.6, 0.6, 0.6],
                       "normal": {"npy": "nrm.npy", "scale": 3.0}}],
        "spheres": [{"center": [0, 8, 0], "radius": 2, "mat": 0}],
    }))
    b = load_scene_json(str(p))
    assert b.scene.has_normal_map and b.scene.needs_uv
    assert float(b.scene.mat_nrm_scale[0]) == 3.0
    np.testing.assert_allclose(np.asarray(b.scene.mat_nrm_rect)[0, 2:],
                               8.0)

    with pytest.raises(ValueError, match="exactly one of png/npy"):
        p.write_text(json.dumps({
            "materials": [{"albedo": [1, 1, 1], "normal": {}}],
        }))
        load_scene_json(str(p))
