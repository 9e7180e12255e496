"""Every Triton kernel lowers for CUDA at the widths it runs at.

Pallas' Triton lowering runs without a card: tracing a kernel with
`interpret=False` and lowering with `lowering_platforms=("cuda",)` raises
the same errors the GPU build would (power-of-two blocks, primitives the
route does not implement, literals in loop carries). Covered: every level
of the 1920x1088 cone-march pyramid, the fused finest level, the shade
kernel, the 70k-triangle knot's cluster sweeps and the config-5 instanced
sweeps (1.06M triangles at 1920x1088). Each lowered module must call the
kernel through the Triton custom call.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import raytracing_engine_tpu as rt
from raytracing_engine_tpu.config import RenderConfig

HD = RenderConfig(width=1920, height=1088)
TRITON_CALL = "__gpu$xla.gpu.triton"


def _lower(fn, *args):
    text = jax.jit(fn).trace(*args).lower(
        lowering_platforms=("cuda",)).as_text()
    assert TRITON_CALL in text, "kernel did not lower to a Triton call"
    return text


@functools.lru_cache(maxsize=None)
def _knot(smooth=False, uv=False):
    from raytracing_engine_tpu.accel import smooth_vertex_normals, torus_knot
    from raytracing_engine_tpu.accel.clusters import build_clusters

    mesh = torus_knot(segments=1100, sides=32, center=(0.0, 8.0, 0.0))
    normals = smooth_vertex_normals(mesh) if smooth else None
    uvs = (np.zeros(mesh.shape[:2] + (2,), np.float32) if uv else None)
    return build_clusters(mesh, tri_mats=np.zeros(mesh.shape[0], np.int32),
                          vertex_normals=normals, vertex_uvs=uvs)


@functools.lru_cache(maxsize=None)
def _config5():
    from raytracing_engine_tpu.accel import build_bvh, torus_knot
    from raytracing_engine_tpu.accel.clusters import build_clusters
    from raytracing_engine_tpu.accel.instancing import grid_instances
    from raytracing_engine_tpu.ops.pallas.instanced_intersect import (
        pack_instances)

    mesh = torus_knot(segments=550, sides=32)
    bvh = build_bvh(mesh)
    inst = grid_instances(bvh, nx=6, ny=5, spacing=4.0, base=(0.0, 14.0, 0.0))
    assert inst.total_triangles == 1_056_000
    return pack_instances(inst), build_clusters(mesh, bvh=bvh)


def _planes(h, w):
    o = tuple(jnp.zeros((h, w), jnp.float32) for _ in range(3))
    d = tuple(jnp.full((h, w), 0.5, jnp.float32) for _ in range(3))
    return o, d


@pytest.mark.parametrize("level", range(HD.level_count - 1))
def test_depth_level_lowers_1080p(level):
    from raytracing_engine_tpu.ops.pallas.depth import depth_level_pallas

    scene, cam = rt.default_scene(), rt.Camera.initial()
    w, h = HD.level_dims[level]
    _lower(lambda s, p, q, seed: depth_level_pallas(
        HD, level, s, p, q, seed, interpret=False, n_obj=2),
        scene, cam.position, cam.quat(), jnp.ones((h, w), jnp.float32))


@pytest.mark.parametrize("kernel", ["fused", "shade"])
def test_finest_level_lowers_1080p(kernel):
    from raytracing_engine_tpu.ops.pallas.fused import depth_shade_fused
    from raytracing_engine_tpu.ops.pallas.shade import shade_pallas

    fn = depth_shade_fused if kernel == "fused" else shade_pallas
    scene, cam = rt.default_scene(), rt.Camera.initial()
    _lower(lambda s, p, q, x: fn(HD, s, p, q, x, interpret=False),
           scene, cam.position, cam.quat(),
           jnp.ones((HD.height, HD.width), jnp.float32))


@pytest.mark.parametrize("table,kw", [
    ("flat", dict()),
    ("flat", dict(any_hit=True)),
    ("flat", dict(attrs=True)),
    ("smooth", dict(attrs=True)),
    ("uv", dict(attrs=True, tan=True)),
])
def test_cluster_sweep_lowers_knot_512(table, kw):
    from raytracing_engine_tpu.ops.pallas.cluster_intersect import (
        cluster_intersect)

    cs = _knot(smooth=table == "smooth", uv=table == "uv")
    o, d = _planes(512, 512)
    _lower(lambda c, o, d: cluster_intersect(c, o, d, jnp.inf,
                                             interpret=False, **kw), cs, o, d)


@pytest.mark.parametrize("kw", [dict(attrs=True, origin=jnp.zeros(3)),
                                dict(any_hit=True, t_max=50.0)])
def test_instanced_sweep_lowers_config5_1080p(kw):
    from raytracing_engine_tpu.ops.pallas.instanced_intersect import (
        instanced_cluster_intersect)

    tab, cs = _config5()
    o, d = _planes(1088, 1920)
    _lower(lambda t, c, o, d: instanced_cluster_intersect(
        t, c, o, d, interpret=False, **kw), tab, cs, o, d)
