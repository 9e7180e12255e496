"""Cluster intersector (interpret mode) vs brute force, and in the integrator."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

pytestmark = pytest.mark.slow  # interpret-mode kernels: compile-heavy

from raytracing_engine_tpu.accel import build_bvh, icosphere
from raytracing_engine_tpu.accel.clusters import CLUSTER, ClusterSet, build_clusters
from raytracing_engine_tpu.ops.pallas.cluster_intersect import cluster_intersect
from raytracing_engine_tpu.pathtracer.intersect import ray_triangle


@pytest.fixture(scope="module")
def setup():
    mesh = icosphere(subdivisions=2, radius=1.2, center=(0.0, 5.0, 0.0))  # 320
    return mesh, build_clusters(mesh)


def _ray_grid(h, w, seed=0):
    rng = np.random.default_rng(seed)
    o = tuple(jnp.zeros((h, w)) for _ in range(3))
    tx = rng.normal(0.0, 1.6, size=(h, w)).astype(np.float32)
    ty = np.full((h, w), 5.0, np.float32)
    tz = rng.normal(0.0, 1.6, size=(h, w)).astype(np.float32)
    n = np.sqrt(tx * tx + ty * ty + tz * tz)
    return o, (jnp.asarray(tx / n), jnp.asarray(ty / n), jnp.asarray(tz / n))


def test_cluster_layout(setup):
    mesh, cs = setup
    assert cs.padded_tris % CLUSTER == 0
    assert cs.num_clusters == cs.padded_tris // CLUSTER
    perm = np.asarray(cs.perm)
    live = perm[perm >= 0]
    assert sorted(live.tolist()) == list(range(mesh.shape[0]))
    boxes = np.asarray(cs.boxes)
    assert (boxes[:, :3][np.isfinite(boxes[:, 0])]
            <= boxes[:, 3:6][np.isfinite(boxes[:, 0])] + 1e-6).all()


def test_cluster_method_invariance(setup):
    """SAH-ordered and median-ordered cluster sets must agree on every hit:
    the partitioner only changes WHICH clusters exist, never what the sweep
    returns (closest hit is order-independent)."""
    mesh, _ = setup
    o, d = _ray_grid(16, 128, seed=2)
    cs_med = build_clusters(mesh, method="median")
    cs_sah = build_clusters(mesh, method="sah")
    t_m, idx_m = cluster_intersect(cs_med, o, d, jnp.inf, interpret=True)
    t_s, idx_s = cluster_intersect(cs_sah, o, d, jnp.inf, interpret=True)
    np.testing.assert_allclose(np.asarray(t_s), np.asarray(t_m),
                               rtol=1e-5, atol=1e-6)
    # hit the same original triangle wherever the hit is unambiguous
    pm = np.asarray(cs_med.perm)[np.asarray(idx_m).ravel()]
    ps = np.asarray(cs_sah.perm)[np.asarray(idx_s).ravel()]
    agree = (pm == ps).mean()
    assert agree > 0.99, f"only {agree:.4f} of hit ids agree"


def test_cluster_matches_bruteforce(setup):
    mesh, cs = setup
    o, d = _ray_grid(16, 128)
    t_c, idx_c = cluster_intersect(cs, o, d, jnp.inf, interpret=True)

    o3 = jnp.stack(o, -1).reshape(-1, 3)
    d3 = jnp.stack(d, -1).reshape(-1, 3)
    v0 = jnp.asarray(mesh[:, 0])
    e1 = jnp.asarray(mesh[:, 1] - mesh[:, 0])
    e2 = jnp.asarray(mesh[:, 2] - mesh[:, 0])
    tt, _, _ = ray_triangle(o3, d3, v0, e1, e2)
    t_b = jnp.min(tt, axis=-1)
    np.testing.assert_allclose(
        np.asarray(t_c).ravel(), np.asarray(t_b), rtol=1e-5, atol=1e-6
    )
    hit = np.isfinite(np.asarray(t_b))
    assert hit.mean() > 0.2
    # hit slots map back to real triangles
    perm = np.asarray(cs.perm)
    slots = np.asarray(idx_c).ravel()[hit]
    assert (perm[slots] >= 0).all()


def test_cluster_any_hit_and_tmax(setup):
    mesh, cs = setup
    o, d = _ray_grid(16, 128, seed=3)
    t_c, idx_c = cluster_intersect(cs, o, d, jnp.inf, interpret=True)
    _, idx_a = cluster_intersect(cs, o, d, jnp.inf, any_hit=True, interpret=True)
    np.testing.assert_array_equal(
        np.isfinite(np.asarray(t_c)), np.asarray(idx_a) >= 0
    )
    _, idx_cut = cluster_intersect(cs, o, d, 2.0, any_hit=True, interpret=True)
    assert (np.asarray(idx_cut) == -1).all()


def test_integrator_with_clusters_matches_bvh_mode():
    from raytracing_engine_tpu.pathtracer import PTConfig
    from raytracing_engine_tpu.pathtracer.scene import DIFFUSE, build_pt_scene
    from raytracing_engine_tpu.pathtracer.wavefront import render_pt_fast

    tris = icosphere(subdivisions=2, radius=1.2, center=(0.0, 5.0, 0.0))
    mats = [
        {"albedo": (0.7, 0.5, 0.3), "kind": DIFFUSE},
        {"albedo": (0.0, 0.0, 0.0), "emission": (6.0, 6.0, 6.0), "kind": DIFFUSE},
    ]
    scene = build_pt_scene(
        spheres=[((3.0, 3.0, 3.0), 1.0, 1)],
        triangles=tris,
        tri_mats=np.zeros((tris.shape[0],), np.int32),
        materials=mats,
    )
    bvh = build_bvh(tris)
    cs = build_clusters(tris, bvh)
    cfg = PTConfig(width=24, height=16, max_bounces=2, rng="pcg")
    key = jax.random.PRNGKey(11)
    pos = jnp.zeros(3)
    quat = jnp.array([0.0, 0.0, 0.0, 1.0])
    a, _ = render_pt_fast(cfg, scene, pos, quat, 4, key, bvh=bvh)
    b, _ = render_pt_fast(cfg, scene, pos, quat, 4, key, bvh=cs)
    d = np.abs(np.asarray(b) - np.asarray(a)).max(-1)
    assert (d > 1e-3).mean() < 0.02
    assert d.mean() < 2e-4


def test_visit_order_is_permutation_and_order_independent(setup):
    from raytracing_engine_tpu.accel.clusters import visit_order

    mesh, cs = setup
    order = visit_order(cs, jnp.array([0.0, 0.0, 0.0]))
    assert sorted(np.asarray(order).tolist()) == list(range(cs.num_super))

    o, d = _ray_grid(16, 128, seed=7)
    t_a, idx_a = cluster_intersect(cs, o, d, jnp.inf, interpret=True)
    t_b, idx_b = cluster_intersect(cs, o, d, jnp.inf, interpret=True,
                                   order=order)
    np.testing.assert_allclose(np.asarray(t_b), np.asarray(t_a), rtol=1e-6)


def test_subtree_ranges_partition_and_fill():
    """Subtree-aligned clustering: ranges exactly partition the reordered
    triangle list, each fits one cluster, boxes are no looser than the
    fixed packing's (tightness is the point), and both alignments render
    identical intersections."""
    from raytracing_engine_tpu.accel.clusters import _subtree_ranges

    mesh = icosphere(subdivisions=3, radius=1.2, center=(0.0, 5.0, 0.0))
    bvh = build_bvh(mesh)
    ranges = _subtree_ranges(bvh, CLUSTER)
    flat = sorted(ranges)
    assert flat[0][0] == 0 and flat[-1][1] == mesh.shape[0]
    assert all(flat[i][1] == flat[i + 1][0] for i in range(len(flat) - 1))
    assert all(0 < e - s <= CLUSTER for s, e in ranges)

    cs_s = build_clusters(mesh, bvh=bvh, align="subtree")
    cs_f = build_clusters(mesh, bvh=bvh, align="fixed")

    def area(cs):
        b = np.asarray(cs.boxes)
        fin = np.isfinite(b[:, 0])
        d = b[fin, 3:6] - b[fin, :3]
        return (d[:, 0] * d[:, 1] + d[:, 1] * d[:, 2] + d[:, 0] * d[:, 2]).sum()

    assert area(cs_s) <= area(cs_f) * 1.05, "subtree boxes should be tighter"

    o, d = _ray_grid(8, 128, seed=9)
    t_s, i_s = cluster_intersect(cs_s, o, d, jnp.inf, interpret=True)
    t_f, i_f = cluster_intersect(cs_f, o, d, jnp.inf, interpret=True)
    np.testing.assert_allclose(np.asarray(t_s), np.asarray(t_f),
                               rtol=1e-5, atol=1e-5)
    # slot ids differ (different packing) but must map to the same triangle
    # (rays grazing a shared edge may tie-break differently: allow 0.5%)
    hit = np.asarray(i_s) >= 0
    perm_s = np.asarray(cs_s.perm)[np.maximum(np.asarray(i_s), 0)]
    perm_f = np.asarray(cs_f.perm)[np.maximum(np.asarray(i_f), 0)]
    assert (perm_s[hit] != perm_f[hit]).mean() <= 5e-3


def test_descend_depth_partitions_and_agrees():
    """The subtree-pack descend knob (how deep to cut before repacking)
    changes cluster count/fill but must still exactly partition the mesh
    and return identical intersections."""
    from raytracing_engine_tpu.accel.clusters import _subtree_ranges

    mesh = icosphere(subdivisions=3, radius=1.2, center=(0.0, 5.0, 0.0))
    bvh = build_bvh(mesh)
    for descend in (CLUSTER // 4, CLUSTER // 2, CLUSTER):
        ranges = sorted(_subtree_ranges(bvh, CLUSTER, descend=descend))
        assert ranges[0][0] == 0 and ranges[-1][1] == mesh.shape[0]
        assert all(ranges[i][1] == ranges[i + 1][0]
                   for i in range(len(ranges) - 1))
        assert all(0 < e - s <= CLUSTER for s, e in ranges)

    cs_half = build_clusters(mesh, bvh=bvh, descend=CLUSTER // 2)
    cs_full = build_clusters(mesh, bvh=bvh)  # default descend = CLUSTER
    o, d = _ray_grid(8, 128, seed=17)
    t_h, i_h = cluster_intersect(cs_half, o, d, jnp.inf, interpret=True)
    t_f, i_f = cluster_intersect(cs_full, o, d, jnp.inf, interpret=True)
    np.testing.assert_allclose(np.asarray(t_f), np.asarray(t_h),
                               rtol=1e-5, atol=1e-5)
    hit = np.asarray(i_h) >= 0
    p_h = np.asarray(cs_half.perm)[np.maximum(np.asarray(i_h), 0)]
    p_f = np.asarray(cs_full.perm)[np.maximum(np.asarray(i_f), 0)]
    assert (p_h[hit] != p_f[hit]).mean() <= 5e-3


def test_dp_partition_and_agrees():
    """align='dp' (optimal contiguous partition of the leaf order under
    the lane-ops cost model) must exactly partition the mesh into <=128
    segments and return identical intersections to the subtree packing."""
    from raytracing_engine_tpu.accel.clusters import _dp_ranges

    mesh = icosphere(subdivisions=3, radius=1.2, center=(0.0, 5.0, 0.0))
    bvh = build_bvh(mesh)
    ordered = np.asarray(mesh)[np.asarray(bvh.perm)]
    ranges = _dp_ranges(ordered, CLUSTER)
    assert ranges[0][0] == 0 and ranges[-1][1] == mesh.shape[0]
    assert all(ranges[i][1] == ranges[i + 1][0]
               for i in range(len(ranges) - 1))
    assert all(0 < e - s <= CLUSTER for s, e in ranges)

    cs_sub = build_clusters(mesh, bvh=bvh)
    cs_dp = build_clusters(mesh, bvh=bvh, align="dp")
    o, d = _ray_grid(8, 128, seed=17)
    t_s, i_s = cluster_intersect(cs_sub, o, d, jnp.inf, interpret=True)
    t_d, i_d = cluster_intersect(cs_dp, o, d, jnp.inf, interpret=True)
    np.testing.assert_allclose(np.asarray(t_d), np.asarray(t_s),
                               rtol=1e-5, atol=1e-5)
    hit = np.asarray(i_s) >= 0
    p_s = np.asarray(cs_sub.perm)[np.maximum(np.asarray(i_s), 0)]
    p_d = np.asarray(cs_dp.perm)[np.maximum(np.asarray(i_d), 0)]
    assert (p_s[hit] != p_d[hit]).mean() <= 5e-3


def test_translation_invariance_of_intersection():
    """The Baldwin–Weber rows are rebased to each cluster's box center, so
    intersecting a far-from-origin copy of a scene (camera translated
    equally) must produce near-identical hit t/idx — with absolute-frame
    affine rows the barycentrics would lose ~1e-2 precision at |p|~1e4
    and edge pixels would crack."""
    mesh = icosphere(subdivisions=2, radius=1.2, center=(0.0, 5.0, 0.0))
    shift = np.array([8192.0, -4096.0, 2048.0], np.float32)  # exact in f32
    cs0 = build_clusters(mesh)
    cs1 = build_clusters(mesh + shift)

    o, d = _ray_grid(8, 128, seed=11)
    t0, i0 = cluster_intersect(cs0, o, d, jnp.inf, interpret=True)
    o1 = tuple(o[k] + shift[k] for k in range(3))
    t1, i1 = cluster_intersect(cs1, o1, d, jnp.inf, interpret=True)

    t0, t1 = np.asarray(t0), np.asarray(t1)
    hit0, hit1 = np.isfinite(t0), np.isfinite(t1)
    # identical hit sets up to a sliver of edge pixels
    assert (hit0 != hit1).mean() <= 2e-3, (hit0 != hit1).mean()
    both = hit0 & hit1
    # tolerance floor is set by the INPUT quantization: translating the
    # vertices rounds each coordinate at ulp(8192) ~ 5e-4, so hit t's of
    # grazing rays legitimately move by a few 1e-3
    np.testing.assert_allclose(t0[both], t1[both], rtol=2e-3, atol=1e-2)
    p0 = np.asarray(cs0.perm)[np.maximum(np.asarray(i0), 0)]
    p1 = np.asarray(cs1.perm)[np.maximum(np.asarray(i1), 0)]
    assert (p0[both] != p1[both]).mean() <= 5e-3
