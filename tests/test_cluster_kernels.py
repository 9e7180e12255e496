"""Cluster and instanced Triton kernels in the Pallas interpreter (CPU) vs
the plain references: `accel.bvh.bvh_intersect`, brute-force
`ray_triangle` and `accel.instancing.instanced_intersect`. Ray grids of
awkward shapes exercise the padding of partial blocks."""

import numpy as np
import jax.numpy as jnp
import pytest

from raytracing_engine_tpu.accel import build_bvh, icosphere
from raytracing_engine_tpu.accel.bvh import bvh_intersect
from raytracing_engine_tpu.accel.clusters import build_clusters
from raytracing_engine_tpu.ops.pallas.cluster_intersect import (
    cluster_intersect, pad_rays)
from raytracing_engine_tpu.pathtracer.intersect import ray_triangle


@pytest.fixture(scope="module")
def ball():
    mesh = icosphere(subdivisions=2, radius=1.2, center=(0.0, 5.0, 0.0))
    bvh = build_bvh(mesh)
    return mesh, bvh, build_clusters(mesh, bvh=bvh)


def _rays(h, w, seed=0, target_y=5.0, spread=1.6):
    rng = np.random.default_rng(seed)
    tx = rng.normal(0.0, spread, (h, w)).astype(np.float32)
    ty = np.full((h, w), target_y, np.float32)
    tz = rng.normal(0.0, spread, (h, w)).astype(np.float32)
    n = np.sqrt(tx * tx + ty * ty + tz * tz)
    o = tuple(jnp.zeros((h, w), jnp.float32) for _ in range(3))
    return o, (jnp.asarray(tx / n), jnp.asarray(ty / n), jnp.asarray(tz / n))


@pytest.mark.parametrize("shape", [(12, 40), (8, 16)])
def test_cluster_matches_bvh_and_bruteforce(ball, shape):
    mesh, bvh, cs = ball
    o, d = _rays(*shape)
    t_c, slot = cluster_intersect(cs, o, d, jnp.inf)
    assert t_c.shape == shape and slot.shape == shape
    o3, d3 = jnp.stack(o, -1), jnp.stack(d, -1)
    tt, _, _ = ray_triangle(o3.reshape(-1, 3), d3.reshape(-1, 3),
                            jnp.asarray(mesh[:, 0]),
                            jnp.asarray(mesh[:, 1] - mesh[:, 0]),
                            jnp.asarray(mesh[:, 2] - mesh[:, 0]))
    t_brute = np.asarray(jnp.min(tt, -1)).reshape(shape)
    np.testing.assert_allclose(np.asarray(t_c), t_brute, rtol=1e-5,
                               atol=1e-6)
    t_b, ridx, _, _ = bvh_intersect(bvh, o3, d3)
    hit = np.isfinite(np.asarray(t_b))
    assert hit.mean() > 0.2
    tri_c = np.asarray(cs.perm)[np.asarray(slot)[hit]]
    tri_b = np.asarray(bvh.perm)[np.asarray(ridx)[hit]]
    assert (tri_c == tri_b).mean() > 0.99


def test_cluster_anyhit_agrees_with_closest(ball):
    _, _, cs = ball
    o, d = _rays(12, 40, seed=3)
    t_c, _ = cluster_intersect(cs, o, d, jnp.inf)
    _, idx_a = cluster_intersect(cs, o, d, jnp.inf, any_hit=True)
    np.testing.assert_array_equal(np.isfinite(np.asarray(t_c)),
                                  np.asarray(idx_a) >= 0)
    _, idx_cut = cluster_intersect(cs, o, d, 2.0, any_hit=True)
    assert (np.asarray(idx_cut) == -1).all()


def test_instanced_matches_plain_two_level():
    from raytracing_engine_tpu.accel.instancing import (
        grid_instances, instanced_intersect)
    from raytracing_engine_tpu.ops.pallas.instanced_intersect import (
        instanced_cluster_intersect, pack_instances)

    mesh = icosphere(subdivisions=1, radius=0.8)
    bvh = build_bvh(mesh)
    inst = grid_instances(bvh, nx=3, ny=2, spacing=2.5, base=(0.0, 8.0, 0.0))
    cs = build_clusters(mesh, bvh=bvh)
    o, d = _rays(12, 24, seed=1, target_y=9.0, spread=3.0)
    t_k, code = instanced_cluster_intersect(pack_instances(inst), cs, o, d,
                                            origin=jnp.zeros(3))
    t_g, gi, _, _ = instanced_intersect(inst, jnp.stack(o, -1),
                                        jnp.stack(d, -1))
    t_k, t_g = np.asarray(t_k), np.asarray(t_g)
    hit = np.isfinite(t_g)
    assert hit.any()
    np.testing.assert_allclose(t_k, t_g, rtol=2e-4, atol=2e-4)
    np.testing.assert_array_equal(np.asarray(code)[hit] // cs.padded_tris,
                                  np.asarray(gi)[hit])


def test_pad_rays_parks_partial_blocks():
    o, d = _rays(12, 40)
    po, pd, tmax, (bh, bw), (hp, wp) = pad_rays(o, d, 7.0, (8, 16))
    assert (bh, bw) == (8, 16) and (hp, wp) == (16, 48)
    assert po[0].shape == (16, 48) and tmax.shape == (16, 48)
    np.testing.assert_array_equal(np.asarray(po[1])[:12, :40],
                                  np.asarray(o[1]))
    assert float(np.asarray(po[0])[12:].min()) >= 1e17   # parked origins
    assert float(np.asarray(pd[2])[:, 40:].min()) > 0.0  # all-positive dirs
    # tiny grids shrink the block to the next power of two
    _, _, _, blk, padded = pad_rays(*_rays(3, 5), 1.0, (8, 16))
    assert blk == (4, 8) and padded == (4, 8)


def test_conemarch_block_dims_cover_every_level():
    from raytracing_engine_tpu.config import RenderConfig
    from raytracing_engine_tpu.ops.pallas.depth import block_dims, padded_dims

    cfg = RenderConfig(width=1920, height=1088)
    for w, h in cfg.level_dims:
        bh, bw = block_dims(h, w, cfg.tile_h, cfg.tile_w)
        assert bh & (bh - 1) == 0 and bw & (bw - 1) == 0
        hp, wp = padded_dims(h, w, bh, bw)
        assert hp >= h and wp >= w and hp % bh == 0 and wp % bw == 0
        assert hp - h < bh and wp - w < bw
    with pytest.raises(ValueError):
        RenderConfig(width=64, height=64, tile_w=24)
