"""UV texturing: atlas packing, sphere/mesh UVs, image textures, OBJ vt.

The reference shades untextured analytic SDFs (fragment.glsl has no
samplers); UV/image texturing is a north-star extension. The (3K, 128)
channel-major atlas makes the fetch a lane-axis take_along_axis plus a
K-row select chain (pathtracer.wavefront._atlas_fetch), shared
bit-identically by both integrators.
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
from raytracing_engine_tpu.pathtracer.scene import (
    DIFFUSE,
    build_pt_scene,
    pack_texture_atlas,
)

KEY = jax.random.PRNGKey(7)
QUAT = jnp.array([0.0, 0.0, 0.0, 1.0])
POS = jnp.zeros(3)


# ---------------------------------------------------------------- atlas

def test_atlas_shelf_pack_roundtrip():
    rng = np.random.RandomState(0)
    imgs = [rng.rand(8, 16, 3), rng.rand(4, 120, 3), rng.rand(16, 32, 3)]
    atlas, rects = pack_texture_atlas(imgs)
    assert atlas.shape[1] == 128 and atlas.shape[0] % 3 == 0
    K = atlas.shape[0] // 3
    for n, img in enumerate(imgs):
        x0, y0, w, h = map(int, rects[n])
        assert (w, h) == (img.shape[1], img.shape[0])
        for c in range(3):
            np.testing.assert_array_equal(
                atlas[c * K + y0:c * K + y0 + h, x0:x0 + w],
                img[:, :, c].astype(np.float32))


def test_atlas_budget_and_width_errors():
    with pytest.raises(ValueError, match="wide"):
        pack_texture_atlas([np.zeros((4, 129, 3), np.float32)])
    with pytest.raises(ValueError, match="budget"):
        pack_texture_atlas([np.zeros((33, 128, 3), np.float32)])
    with pytest.raises(ValueError, match="must be"):
        pack_texture_atlas([np.zeros((4, 4), np.float32)])


# ------------------------------------------------- kernel-safe trig

def test_poly_trig_accuracy():
    """The kernel-safe atan2/acos polynomials (Mosaic lowers neither
    primitive) stay within the documented error bounds everywhere."""
    from raytracing_engine_tpu.pathtracer.wavefront import (
        _poly_acos, _poly_atan2)

    rng = np.random.RandomState(1)
    y = rng.uniform(-3, 3, 4096).astype(np.float32)
    x = rng.uniform(-3, 3, 4096).astype(np.float32)
    got = np.asarray(_poly_atan2(jnp.asarray(y), jnp.asarray(x)))
    want = np.arctan2(y, x)
    assert np.abs(got - want).max() < 2e-5

    c = rng.uniform(-1, 1, 4096).astype(np.float32)
    got = np.asarray(_poly_acos(jnp.asarray(c)))
    assert np.abs(got - np.arccos(c)).max() < 1e-4


# --------------------------------------------- geometry UV emission

def quad_with_uvs():
    """Unit quad at y=5 spanning x,z in [-1,1]; uv = ((x+1)/2, (z+1)/2)."""
    v = lambda x, z: (x, 5.0, z)  # noqa: E731
    tris = np.array([
        [v(-1, -1), v(1, -1), v(1, 1)],
        [v(-1, -1), v(1, 1), v(-1, 1)],
    ], np.float32)
    uv = lambda x, z: ((x + 1) / 2, (z + 1) / 2)  # noqa: E731
    uvs = np.array([
        [uv(-1, -1), uv(1, -1), uv(1, 1)],
        [uv(-1, -1), uv(1, 1), uv(-1, 1)],
    ], np.float32)
    return tris, uvs


def test_cluster_sweep_emits_interpolated_uv():
    """UV cluster tables (rows 32-37) make cluster_intersect emit the
    barycentric-interpolated texture UV — checked against the quad's
    analytic parametrization at scattered hit points."""
    from raytracing_engine_tpu.accel.clusters import ROWS_UV, build_clusters
    from raytracing_engine_tpu.ops.pallas.cluster_intersect import (
        cluster_intersect)

    tris, uvs = quad_with_uvs()
    cs = build_clusters(tris, vertex_uvs=uvs)
    assert cs.has_uv and cs.tri.shape[0] == ROWS_UV

    h, w = 8, 128
    rng = np.random.RandomState(0)
    tx = rng.uniform(-0.95, 0.95, (h, w)).astype(np.float32)
    tz = rng.uniform(-0.95, 0.95, (h, w)).astype(np.float32)
    o = tuple(jnp.zeros((h, w), jnp.float32) for _ in range(3))
    dn = np.sqrt(tx**2 + 25.0 + tz**2)
    d = (jnp.asarray(tx / dn), jnp.asarray(5.0 / dn), jnp.asarray(tz / dn))
    res = cluster_intersect(cs, o, d, 1e9, attrs=True)
    assert len(res) == 9, "UV table must add (u, v) output planes"
    t, idx, nx, ny, nz, mat, area, uu, vv = res
    assert bool(jnp.all(idx >= 0)), "some rays missed the quad"
    np.testing.assert_allclose(np.asarray(uu), (tx + 1) / 2, atol=1e-5)
    np.testing.assert_allclose(np.asarray(vv), (tz + 1) / 2, atol=1e-5)


def test_flat_table_has_no_uv_planes():
    from raytracing_engine_tpu.accel.clusters import build_clusters
    from raytracing_engine_tpu.ops.pallas.cluster_intersect import (
        cluster_intersect)

    tris, _ = quad_with_uvs()
    cs = build_clusters(tris)
    assert not cs.has_uv
    o = tuple(jnp.zeros((8, 128), jnp.float32) for _ in range(3))
    d = (o[0], jnp.ones((8, 128), jnp.float32), o[2])
    assert len(cluster_intersect(cs, o, d, 1e9, attrs=True)) == 7


# ------------------------------------------------ textured renders

def textured_sphere_scene():
    """Half-red/half-blue image texture on a floor sphere + UV checker on
    a second sphere, lit by an emissive sphere."""
    tex = np.zeros((8, 8, 3), np.float32)
    tex[:4, :, 0] = 1.0
    tex[4:, :, 2] = 1.0
    return build_pt_scene(
        spheres=[((0.0, 4.0, 0.0), 1.0, 0), ((0.0, 14.0, -103.0), 100.0, 1),
                 ((4.0, 6.0, 6.0), 1.5, 2)],
        materials=[
            {"albedo": (0.5, 0.5, 0.5), "kind": DIFFUSE,
             "image": {"pixels": tex, "scale": 1.0}},
            {"albedo": (0, 0, 0), "emission": (30.0, 30.0, 30.0),
             "kind": DIFFUSE},
            {"albedo": (0.9, 0.2, 0.2), "kind": DIFFUSE,
             "checker": {"color": (0.1, 0.9, 0.1), "scale": 4.0,
                         "space": "uv"}},
        ])


def test_image_textured_scene_flags():
    s = textured_sphere_scene()
    assert s.has_image and s.needs_uv and s.has_texture
    assert s.mat_tex_rect is not None and s.tex_atlas.shape[1] == 128


def test_image_texture_integrator_parity():
    """The stacked cross-check integrator agrees with the SoA wavefront
    on a UV-textured mesh + sphere scene (same sampling decisions)."""
    tris, uvs = quad_with_uvs()
    tex = np.zeros((8, 8, 3), np.float32)
    tex[:, :4, 0] = 1.0
    tex[:, 4:, 1] = 1.0
    scene = build_pt_scene(
        spheres=[((0.0, 14.0, -103.0), 100.0, 1), ((3.0, 7.0, 1.0), 1.0, 2)],
        triangles=tris, tri_mats=np.zeros(2, np.int32), tri_uvs=uvs,
        materials=[
            {"albedo": (0.5, 0.5, 0.5), "kind": DIFFUSE,
             "image": {"pixels": tex, "scale": 1.0}},
            {"albedo": (0, 0, 0), "emission": (30.0, 30.0, 30.0),
             "kind": DIFFUSE},
            {"albedo": (0.8, 0.8, 0.2), "kind": DIFFUSE,
             "checker": {"color": (0.2, 0.2, 0.9), "scale": 6.0,
                         "space": "uv"}},
        ])
    cfg = PTConfig(width=48, height=48, max_bounces=3, rng="threefry")
    a, _ = render_pt(cfg, scene, POS, QUAT, 4, jax.random.PRNGKey(3))
    b, _ = render_pt_fast(cfg, scene, POS, QUAT, 4, jax.random.PRNGKey(3))
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-5)


def test_mesh_uv_cluster_path_matches_stacked():
    """Cluster-table UVs (the Triton kernel's rows 32-37, interpolated by
    the wavefront's row gathers) against the stacked reference integrator
    on the same scene and threefry stream: the same image up to f32
    rounding (Baldwin-Weber rows vs Moller-Trumbore barycentrics)."""
    from raytracing_engine_tpu.accel.clusters import build_clusters

    tris, uvs = quad_with_uvs()
    tex = np.zeros((8, 8, 3), np.float32)
    tex[:, :4, 0] = 1.0
    tex[:, 4:, 1] = 1.0
    scene = build_pt_scene(
        spheres=[((0.0, 14.0, -103.0), 100.0, 1)],
        triangles=tris, tri_mats=np.zeros(2, np.int32), tri_uvs=uvs,
        materials=[
            {"albedo": (0.5, 0.5, 0.5), "kind": DIFFUSE,
             "image": {"pixels": tex, "scale": 1.0}},
            {"albedo": (0, 0, 0), "emission": (30.0, 30.0, 30.0),
             "kind": DIFFUSE},
        ])
    cs = build_clusters(tris, tri_mats=np.zeros(2, np.int32),
                        vertex_uvs=uvs)
    cfg = PTConfig(width=48, height=40, max_bounces=2, rng="threefry")
    key = jax.random.PRNGKey(3)
    a, _ = render_pt(cfg, scene, POS, QUAT, 4, key)
    b, _ = render_pt_fast(cfg, scene, POS, QUAT, 4, key, bvh=cs)
    a, b = np.asarray(a), np.asarray(b)
    assert float(a.mean()) > 1e-3
    d = np.abs(a - b).max(-1)
    assert (d > 1e-3).mean() < 0.02
    assert abs(float(a.mean()) - float(b.mean())) < 1e-3


def test_image_texture_colors_sampled():
    """The rendered floor actually shows the texel colors: the image is
    half red (v<0.5, near the +z pole) / half blue — both channels must
    dominate somewhere on the sphere, asymmetrically."""
    from raytracing_engine_tpu.pathtracer import render_aovs

    tex = np.zeros((4, 4, 3), np.float32)
    tex[:2, :, 0] = 1.0
    tex[2:, :, 2] = 1.0
    # scale=100 tiles the texture ~100x across UV space: the visible
    # patch of the giant sphere (a tiny UV window near the +z pole)
    # still cycles through both texel colors
    scene = build_pt_scene(
        spheres=[((0.0, 8.0, -1001.0), 1000.0, 0)],
        materials=[{"albedo": (0.5, 0.5, 0.5), "kind": DIFFUSE,
                    "image": {"pixels": tex, "scale": 100.0}}],
        env=(1.0, 1.0, 1.0))
    cfg = PTConfig(width=64, height=48)
    # spp=1: one sample per pixel reads ONE texel exactly (nearest
    # fetch); more samples would AA-average across the tiled stripes
    aovs = render_aovs(cfg, scene, POS, QUAT, 1, KEY)
    alb = np.asarray(aovs["albedo"])
    hit = np.asarray(aovs["depth"]) > 0
    reds = (alb[..., 0] > 0.9) & (alb[..., 2] < 0.1) & hit
    blues = (alb[..., 2] > 0.9) & (alb[..., 0] < 0.1) & hit
    assert reds.any() and blues.any()
    # texel colors are exact (nearest fetch, no filtering)
    assert np.isin(alb[hit].round(4), [0.0, 1.0]).all()


def test_untextured_scene_has_no_uv_cost():
    """UV-free scenes keep needs_uv False: the intersectors emit no uv
    planes and the compiled program is the pre-texture one."""
    s = build_pt_scene(
        spheres=[((0.0, 6.0, 0.0), 1.0, 0)],
        materials=[{"albedo": (0.5, 0.5, 0.5), "kind": DIFFUSE,
                    "checker": {"color": (0.1, 0.1, 0.1), "scale": 2.0}}],
        env=(1.0, 1.0, 1.0))
    assert s.has_texture and not s.needs_uv and not s.has_image


# ------------------------------------------------------ OBJ + sceneio

def test_obj_vt_roundtrip(tmp_path):
    from raytracing_engine_tpu.accel import load_obj, save_obj

    tris, uvs = quad_with_uvs()
    p = str(tmp_path / "quad.obj")
    save_obj(p, tris, uvs=uvs)
    tris2, uv2 = load_obj(p, uvs=True)
    assert uv2 is not None and uv2.shape == (2, 3, 2)
    # triangle order may change under vertex dedup; compare as sets of
    # (corner-position, corner-uv) rows
    a = np.concatenate([tris.reshape(-1, 3), uvs.reshape(-1, 2)], 1)
    b = np.concatenate([tris2.reshape(-1, 3), uv2.reshape(-1, 2)], 1)
    a = a[np.lexsort(a.T)]
    b = b[np.lexsort(b.T)]
    np.testing.assert_allclose(a, b, atol=1e-6)


def test_obj_without_vt_returns_none(tmp_path):
    from raytracing_engine_tpu.accel import load_obj, save_obj

    tris, _ = quad_with_uvs()
    p = str(tmp_path / "plain.obj")
    save_obj(p, tris)
    t2, uv2 = load_obj(p, uvs=True)
    assert uv2 is None and t2.shape == tris.shape


def test_sceneio_image_and_uvs(tmp_path):
    import json

    from raytracing_engine_tpu.accel import save_obj
    from raytracing_engine_tpu.pathtracer.sceneio import load_scene_json
    from raytracing_engine_tpu.utils.image import write_png

    tris, uvs = quad_with_uvs()
    save_obj(str(tmp_path / "quad.obj"), tris, uvs=uvs)
    tex = np.zeros((4, 4, 3), np.float32)
    tex[:, :2, 0] = 1.0
    write_png(str(tmp_path / "tex.png"), tex)
    np.save(str(tmp_path / "tex.npy"), tex)

    p = tmp_path / "scene.json"
    p.write_text(json.dumps({
        "materials": [
            {"albedo": [0.5, 0.5, 0.5], "image": {"png": "tex.png"}},
            {"albedo": [0.4, 0.4, 0.4], "image": {"npy": "tex.npy",
                                                  "scale": 2.0}},
            {"albedo": [0.8, 0.2, 0.2],
             "checker": {"color": [0.2, 0.8, 0.2], "scale": 3.0,
                         "space": "uv"}},
        ],
        "meshes": [{"obj": "quad.obj", "mat": 0, "uvs": True}],
        "spheres": [{"center": [0, 8, -1001], "radius": 1000, "mat": 2}],
    }))
    b = load_scene_json(str(p))
    assert b.scene.has_image and b.scene.needs_uv
    assert b.tri_uvs is not None and b.tri_uvs.shape == (2, 3, 2)
    # png texels decode as UNORM u8/255 linear; npy passes through
    np.testing.assert_allclose(np.asarray(b.scene.mat_tex_rect)[0, 2:], 4.0)
    assert float(b.scene.mat_tex_scale[1]) == 2.0
    assert float(b.scene.mat_tex_space[2]) == 1.0


def test_sceneio_uv_errors(tmp_path):
    import json

    from raytracing_engine_tpu.accel import save_obj
    from raytracing_engine_tpu.pathtracer.sceneio import load_scene_json

    tris, _ = quad_with_uvs()
    save_obj(str(tmp_path / "plain.obj"), tris)

    def _load(spec):
        p = tmp_path / "s.json"
        p.write_text(json.dumps(spec))
        return load_scene_json(str(p))

    with pytest.raises(ValueError, match="vt"):
        _load({"materials": [{"albedo": [1, 1, 1]}],
               "meshes": [{"obj": "plain.obj", "mat": 0, "uvs": True}]})
    with pytest.raises(ValueError, match="obj source"):
        _load({"materials": [{"albedo": [1, 1, 1]}],
               "meshes": [{"icosphere": {"subdivisions": 1}, "mat": 0,
                           "uvs": True}]})
    with pytest.raises(ValueError, match="exactly one of png/npy"):
        _load({"materials": [{"albedo": [1, 1, 1], "image": {}}]})
    with pytest.raises(ValueError, match="space"):
        _load({"materials": [{"albedo": [1, 1, 1],
                              "checker": {"scale": 1.0, "space": "bad"}}]})


# ------------------------------------------------- bilinear filtering

def test_sample_rect_bilinear_matches_manual_lerp():
    """_sample_rect(bilinear=True) equals the hand-computed 4-corner lerp
    with texel centers at (i + 0.5)/n and rect-clamped corners."""
    from raytracing_engine_tpu.pathtracer.scene import pack_texture_atlas
    from raytracing_engine_tpu.pathtracer.wavefront import _sample_rect

    rng = np.random.RandomState(3)
    img = rng.rand(4, 4, 3).astype(np.float32)
    atlas, rects = pack_texture_atlas([img])
    x0, y0, tw, th = rects[0]
    uu = rng.rand(8, 128).astype(np.float32)
    vv = rng.rand(8, 128).astype(np.float32)
    like = jnp.asarray(uu)
    got = _sample_rect(jnp.asarray(atlas),
                       jnp.full_like(like, x0), jnp.full_like(like, y0),
                       jnp.full_like(like, tw), jnp.full_like(like, th),
                       (jnp.asarray(uu), jnp.asarray(vv)),
                       jnp.ones_like(like), bilinear=True)
    got = np.stack([np.asarray(c) for c in got], -1)

    fx = uu * 4 - 0.5
    fy = vv * 4 - 0.5
    xa = np.clip(np.floor(fx), 0, 3).astype(int)
    xb = np.clip(np.floor(fx) + 1, 0, 3).astype(int)
    ya = np.clip(np.floor(fy), 0, 3).astype(int)
    yb = np.clip(np.floor(fy) + 1, 0, 3).astype(int)
    wx = (fx - np.floor(fx))[..., None]
    wy = (fy - np.floor(fy))[..., None]
    want = ((img[ya, xa] * (1 - wx) + img[ya, xb] * wx) * (1 - wy)
            + (img[yb, xa] * (1 - wx) + img[yb, xb] * wx) * wy)
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_bilinear_integrator_parity():
    tris, uvs = quad_with_uvs()
    tex = np.zeros((8, 8, 3), np.float32)
    tex[:, :4, 0] = 1.0
    tex[:, 4:, 1] = 1.0
    scene = build_pt_scene(
        spheres=[((0.0, 14.0, -103.0), 100.0, 1)],
        triangles=tris, tri_mats=np.zeros(2, np.int32), tri_uvs=uvs,
        materials=[
            {"albedo": (0.5, 0.5, 0.5), "kind": DIFFUSE,
             "image": {"pixels": tex, "scale": 1.0}},
            {"albedo": (0, 0, 0), "emission": (30.0, 30.0, 30.0),
             "kind": DIFFUSE},
        ])
    cfg = PTConfig(width=32, height=32, max_bounces=2, rng="threefry",
                   tex_filter="bilinear")
    a, _ = render_pt(cfg, scene, POS, QUAT, 2, jax.random.PRNGKey(3))
    b, _ = render_pt_fast(cfg, scene, POS, QUAT, 2, jax.random.PRNGKey(3))
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-5)
