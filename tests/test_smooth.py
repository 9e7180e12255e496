"""Vertex-normal smooth shading (Gouraud-interpolated normals).

The reference shades with continuous analytic SDF-gradient normals
(/root/reference/shaders/utilities.glsl sceneSDF); triangle meshes are the
north-star extension, so the parity analog is barycentric interpolation of
per-corner vertex normals. Coverage: the host builder (smooth cluster
tables, rows 21-29), the in-kernel sweep attrs, the XLA gather path, mesh
utilities (welded-normal computation, OBJ vn records), and the JSON scene
flag — including the invariant that a smooth table loaded with face
normals reproduces flat shading exactly.
"""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from raytracing_engine_tpu.accel import icosphere, load_obj, smooth_vertex_normals
from raytracing_engine_tpu.accel.clusters import (
    ROWS, ROWS_SMOOTH, build_clusters)
from raytracing_engine_tpu.ops.pallas.cluster_intersect import cluster_intersect
from raytracing_engine_tpu.pathtracer import PTConfig
from raytracing_engine_tpu.pathtracer.scene import DIFFUSE, build_pt_scene
from raytracing_engine_tpu.pathtracer.wavefront import render_pt_fast

CENTER = np.array([0.0, 5.0, 0.0], np.float32)
KEY = jax.random.PRNGKey(13)
QUAT = jnp.array([0.0, 0.0, 0.0, 1.0])


def _sphere_mesh(subdivisions=2):
    radius = 1.2
    tris = icosphere(subdivisions=subdivisions, radius=radius, center=CENTER)
    # exact analytic vertex normals: radial directions
    vn = (tris - CENTER) / radius
    return tris, vn.astype(np.float32)


def _ray_grid(h=8, w=128):
    """Rays from a camera plane at the origin toward the sphere at CENTER."""
    ix = np.linspace(-0.25, 0.25, w, dtype=np.float32)
    iy = np.linspace(-0.25, 0.25, h, dtype=np.float32)
    dx, dz = np.meshgrid(ix, iy)
    d = np.stack([dx, np.ones_like(dx), dz], 0)
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    o = np.zeros_like(d)
    return (tuple(jnp.asarray(o[k]) for k in range(3)),
            tuple(jnp.asarray(d[k]) for k in range(3)))


def test_smooth_vertex_normals_are_radial_on_icosphere():
    tris, _ = _sphere_mesh()
    vn = smooth_vertex_normals(tris)
    radial = (tris - CENTER) / np.linalg.norm(tris - CENTER, axis=-1,
                                              keepdims=True)
    dots = np.sum(vn * radial, axis=-1)
    assert dots.min() > 0.97, f"min corner dot {dots.min():.4f}"
    np.testing.assert_allclose(np.linalg.norm(vn, axis=-1), 1.0, atol=1e-5)


def test_table_layout_flat_vs_smooth():
    tris, vn = _sphere_mesh()
    flat = build_clusters(tris)
    smooth = build_clusters(tris, vertex_normals=vn)
    assert flat.tri.shape[0] == ROWS and not flat.smooth
    assert smooth.tri.shape[0] == ROWS_SMOOTH and smooth.smooth
    # rows 0-20 are identical — the smooth build only appends
    np.testing.assert_array_equal(np.asarray(smooth.tri[:ROWS - 3]),
                                  np.asarray(flat.tri[:ROWS - 3]))
    with pytest.raises(ValueError):
        build_clusters(tris, vertex_normals=vn[:10])


@pytest.mark.slow
def test_sweep_emits_interpolated_normals():
    """Kernel attrs on a smooth table ~= the analytic sphere normal at the
    hit point; the flat table's face normals are measurably worse."""
    tris, vn = _sphere_mesh()
    o, d = _ray_grid()

    def hit_dots(cs):
        res = cluster_intersect(cs, o, d, jnp.inf, t_min=1e-3, attrs=True,
                                interpret=True)
        t, sidx, nx, ny, nz = (np.asarray(r) for r in res[:5])
        hit = sidx >= 0
        assert hit.mean() > 0.5  # the grid mostly covers the sphere
        p = np.stack([np.asarray(o[k]) + t * np.asarray(d[k])
                      for k in range(3)], -1)
        # hit points lie on the flat facets (inside the sphere), so the
        # radial direction must be normalized, not divided by the radius
        exact = p - CENTER
        exact /= np.maximum(np.linalg.norm(exact, axis=-1, keepdims=True),
                            1e-20)
        n = np.stack([nx, ny, nz], -1)
        n /= np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-20)
        return np.sum(n * exact, axis=-1)[hit]

    smooth_dots = hit_dots(build_clusters(tris, vertex_normals=vn))
    flat_dots = hit_dots(build_clusters(tris))
    # radial corner normals interpolate to EXACTLY the radial direction
    # of the (flat-facet) hit point: n ~ sum w_i (v_i - C) = p - C
    assert smooth_dots.min() > 0.9999, f"min {smooth_dots.min():.4f}"
    # flat facet normals are a measurably worse fit
    assert flat_dots.mean() < smooth_dots.mean() - 0.002


@pytest.mark.slow
def test_gather_path_matches_analytic_normals():
    """The XLA gather path (_tri_hits on a smooth ClusterSet) recomputes
    barycentrics at the hit point — same interpolation as in-kernel."""
    from raytracing_engine_tpu.pathtracer.wavefront import _intersect

    tris, vn = _sphere_mesh()
    cs = build_clusters(tris, vertex_normals=vn)
    scene = build_pt_scene(
        spheres=[], triangles=tris[:1], tri_mats=np.zeros(1, np.int32),
        materials=[{"albedo": (0.5,) * 3, "kind": DIFFUSE}])
    o, d = _ray_grid()
    isect = _intersect(scene, o, d, 1e-3, cs)
    hit = np.asarray(isect["is_tri"])
    p = np.stack([np.asarray(c) for c in isect["p"]], -1)
    n = np.stack([np.asarray(c) for c in isect["n"]], -1)
    exact = p - CENTER
    exact /= np.maximum(np.linalg.norm(exact, axis=-1, keepdims=True), 1e-20)
    # _intersect flips n to face the ray (two-sided convention): grazing
    # silhouette hits may carry the negated normal — compare |dot|
    dots = np.abs(np.sum(n * exact, axis=-1))[hit]
    assert hit.mean() > 0.5
    assert dots.min() > 0.995, f"min {dots.min():.4f}"


@pytest.mark.slow
def test_face_normals_in_smooth_table_reproduce_flat_render():
    """A smooth table whose corners all carry the face normal interpolates
    back to flat shading: the render must match the flat table closely
    (only normalization provenance differs)."""
    tris, _ = _sphere_mesh()
    fn = np.cross(tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0])
    fn /= np.maximum(np.linalg.norm(fn, axis=-1, keepdims=True), 1e-30)
    vn_flat = np.repeat(fn[:, None, :], 3, axis=1).astype(np.float32)

    mats = [{"albedo": (0.6, 0.5, 0.4), "kind": DIFFUSE},
            {"albedo": (0, 0, 0), "emission": (8.0,) * 3, "kind": DIFFUSE}]
    scene = build_pt_scene(
        spheres=[((3.0, 3.0, 3.0), 1.0, 1)], triangles=tris,
        tri_mats=np.zeros(len(tris), np.int32), materials=mats)
    cfg = PTConfig(width=32, height=16, max_bounces=2, rng="pcg")
    pos = jnp.zeros(3)
    want, _ = render_pt_fast(cfg, scene, pos, QUAT, 2, KEY,
                             bvh=build_clusters(tris))
    got, _ = render_pt_fast(cfg, scene, pos, QUAT, 2, KEY,
                            bvh=build_clusters(tris, vertex_normals=vn_flat))
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.slow
def test_instanced_smooth_normals_rotate():
    """A smooth cluster table inside an instanced scene: the sweep
    interpolates in OBJECT space and the instance transform rotates the
    result to world — hit normals on a rotated unit-sphere instance must
    still be radial about the instance's world center."""
    from raytracing_engine_tpu.accel import build_bvh
    from raytracing_engine_tpu.accel.instancing import (
        make_instanced_clusters, make_instances)
    from raytracing_engine_tpu.pathtracer.wavefront import _intersect

    mesh = icosphere(subdivisions=2, radius=1.0, center=(0.0, 0.0, 0.0))
    vn = mesh.copy()  # unit sphere at the origin: corner position = normal
    bvh = build_bvh(mesh)
    cs = build_clusters(mesh, bvh=bvh,
                        tri_mats=np.zeros(len(mesh), np.int32),
                        vertex_normals=vn)
    rz = np.array([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
                  np.float32)
    trans = np.asarray(CENTER, np.float32)
    inst = make_instances(bvh, [(rz, trans, 1.0)],
                          mats=np.zeros(1, np.int32))
    scene = build_pt_scene(
        spheres=[], materials=[{"albedo": (0.5,) * 3, "kind": DIFFUSE}])
    ic = make_instanced_clusters(inst, cs, scene=scene)
    o, d = _ray_grid()
    isect = _intersect(scene, o, d, 1e-3, ic)
    hit = np.asarray(isect["is_tri"])
    assert hit.mean() > 0.4  # unit sphere covers ~half the ray grid
    p = np.stack([np.asarray(c) for c in isect["p"]], -1)
    n = np.stack([np.asarray(c) for c in isect["n"]], -1)
    exact = p - CENTER
    exact /= np.maximum(np.linalg.norm(exact, axis=-1, keepdims=True), 1e-20)
    # |dot|: the two-sided facing flip may negate silhouette normals
    dots = np.abs(np.sum(n * exact, axis=-1))[hit]
    assert dots.min() > 0.99, f"min {dots.min():.4f}"


def test_load_obj_vn_records(tmp_path):
    p = tmp_path / "tri.obj"
    p.write_text(
        "v 0 0 0\nv 1 0 0\nv 0 1 0\n"
        "vn 0 0 1\nvn 0.7071 0 0.7071\nvn 0 0.7071 0.7071\n"
        "f 1//1 2//2 3//3\n")
    tris, vn = load_obj(str(p), normals=True)
    assert tris.shape == (1, 3, 3) and vn.shape == (1, 3, 3)
    np.testing.assert_allclose(vn[0, 0], [0, 0, 1])
    np.testing.assert_allclose(vn[0, 1], [0.7071, 0, 0.7071])
    # files without vn records yield None
    q = tmp_path / "flat.obj"
    q.write_text("v 0 0 0\nv 1 0 0\nv 0 1 0\nf 1 2 3\n")
    tris2, vn2 = load_obj(str(q), normals=True)
    assert tris2.shape == (1, 3, 3) and vn2 is None


def test_scene_json_smooth_flag(tmp_path):
    from raytracing_engine_tpu.pathtracer.sceneio import load_scene_json

    spec = """{
      "materials": [{"albedo": [0.5, 0.5, 0.5]}],
      "meshes": [
        {"icosphere": {"subdivisions": 1, "radius": 1.0}, "mat": 0,
         "smooth": true},
        {"knot": {"segments": 16, "sides": 4}, "mat": 0}
      ]
    }"""
    p = tmp_path / "s.json"
    p.write_text(spec)
    b = load_scene_json(str(p))
    tris, tri_normals = b.tris, b.tri_normals
    assert tris is not None and tri_normals is not None
    assert tri_normals.shape == tris.shape
    np.testing.assert_allclose(np.linalg.norm(tri_normals, axis=-1), 1.0,
                               atol=1e-4)
    # the flat knot part carries its face normals (exact flat shading)
    T_sphere = 20 * 4
    fn = np.cross(tris[T_sphere:, 1] - tris[T_sphere:, 0],
                  tris[T_sphere:, 2] - tris[T_sphere:, 0])
    fn /= np.maximum(np.linalg.norm(fn, axis=-1, keepdims=True), 1e-30)
    np.testing.assert_allclose(tri_normals[T_sphere:, 0], fn, atol=1e-5)
    # all-flat scenes keep tri_normals=None (ROWS=24 tables, zero cost)
    q = tmp_path / "flat.json"
    q.write_text("""{
      "materials": [{"albedo": [0.5, 0.5, 0.5]}],
      "meshes": [{"knot": {"segments": 16, "sides": 4}, "mat": 0}]
    }""")
    assert load_scene_json(str(q)).tri_normals is None
