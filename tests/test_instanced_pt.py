"""Path tracing over instanced (two-level) scenes — VERDICT round-2 item 2.

The full NEE+MIS bounce loop runs over an InstancedClusters scene: the
XLA path launches the instanced Pallas intersector per bounce. A 1-instance identity scene must match the single-mesh
ClusterSet path (same Baldwin-Weber tests, exact identity transform).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

pytestmark = pytest.mark.slow  # interpret-mode kernels: compile-heavy

from raytracing_engine_tpu.accel import build_bvh, icosphere
from raytracing_engine_tpu.accel.clusters import build_clusters
from raytracing_engine_tpu.accel.instancing import (
    make_instanced_clusters,
    make_instances,
)
from raytracing_engine_tpu.pathtracer import PTConfig
from raytracing_engine_tpu.pathtracer.scene import DIFFUSE, build_pt_scene
from raytracing_engine_tpu.pathtracer.wavefront import render_pt_fast

_MATS = [
    {"albedo": (0.7, 0.55, 0.4), "kind": DIFFUSE},
    {"albedo": (0, 0, 0), "emission": (12.0, 11.0, 10.0), "kind": DIFFUSE},
    {"albedo": (0.5, 0.5, 0.65), "kind": DIFFUSE},
]


def _scene():
    """Emissive sphere light + big ground sphere; mesh comes via bvh."""
    return build_pt_scene(
        spheres=[((3.0, 5.0, 4.0), 1.0, 1), ((0.0, 6.0, -52.0), 50.0, 2)],
        materials=_MATS,
    )


def _mesh():
    return icosphere(subdivisions=2, radius=1.2, center=(0.0, 0.0, 0.0))


def _cam():
    return jnp.array([0.0, -2.0, 0.3]), jnp.array([0.0, 0.0, 0.0, 1.0])


def test_single_identity_instance_matches_single_mesh():
    mesh = _mesh() + np.array([0.0, 6.0, 0.0], np.float32)  # world position
    cs = build_clusters(mesh, tri_mats=np.zeros(mesh.shape[0], np.int32))
    bvh = build_bvh(mesh)
    inst = make_instances(bvh, [(np.eye(3, dtype=np.float32),
                                 np.zeros(3, np.float32), 1.0)],
                          mats=np.zeros(1, np.int32))
    ic = make_instanced_clusters(inst, cs, scene=_scene())

    cfg = PTConfig(width=24, height=16, max_bounces=2, rng="pcg")
    pos, quat = _cam()
    key = jax.random.PRNGKey(2)
    img_single, _ = render_pt_fast(cfg, _scene(), pos, quat, 2, key, bvh=cs)
    img_inst, _ = render_pt_fast(cfg, _scene(), pos, quat, 2, key, bvh=ic)
    np.testing.assert_allclose(np.asarray(img_inst), np.asarray(img_single),
                               rtol=1e-5, atol=1e-6)
    assert float(jnp.max(img_single)) > 0.0


def test_refuses_emissive_instances():
    mesh = _mesh()
    cs = build_clusters(mesh)
    bvh = build_bvh(mesh)
    inst = make_instances(bvh, [(np.eye(3, dtype=np.float32),
                                 np.zeros(3, np.float32), 1.0)],
                          mats=np.array([1], np.int32))  # emissive material
    with pytest.raises(ValueError, match="emissive"):
        make_instanced_clusters(inst, cs, scene=_scene())


def test_instanced_glass_material():
    """A glass (DIELECTRIC) INSTANCE refracts: per-instance material ids
    flow through the two-level sweep into the shared scatter, and the
    instanced render must match the single-mesh ClusterSet render on the
    identity instance (same geometry, same glass)."""
    from raytracing_engine_tpu.pathtracer.scene import DIELECTRIC

    mats = _MATS + [{"kind": DIELECTRIC, "ior": 1.5}]
    mesh = _mesh() + np.array([0.0, 6.0, 0.0], np.float32)
    # the XLA ClusterSet path gathers materials from scene.tri_mat (the
    # scene carries the mesh); the instanced path reads per-instance mats
    scene = build_pt_scene(
        spheres=[((3.0, 5.0, 4.0), 1.0, 1), ((0.0, 6.0, -52.0), 50.0, 2)],
        triangles=mesh, tri_mats=np.full(mesh.shape[0], 3, np.int32),
        materials=mats, env=(0.2, 0.25, 0.3))
    cs = build_clusters(mesh, tri_mats=np.full(mesh.shape[0], 3, np.int32))
    bvh = build_bvh(mesh)
    inst = make_instances(bvh, [(np.eye(3, dtype=np.float32),
                                 np.zeros(3, np.float32), 1.0)],
                          mats=np.full(1, 3, np.int32))
    ic = make_instanced_clusters(inst, cs, scene=scene)

    cfg = PTConfig(width=24, height=16, max_bounces=4, rng="pcg")
    pos, quat = _cam()
    key = jax.random.PRNGKey(4)
    img_single, _ = render_pt_fast(cfg, scene, pos, quat, 2, key, bvh=cs)
    img_inst, _ = render_pt_fast(cfg, scene, pos, quat, 2, key, bvh=ic)
    np.testing.assert_allclose(np.asarray(img_inst), np.asarray(img_single),
                               rtol=1e-5, atol=1e-5)
    assert float(jnp.max(img_single)) > 0.0
