"""Two-level acceleration: instanced meshes (TLAS over a shared BLAS).

BASELINE config 5: 1M+ triangles as N instances of a base mesh, each with a
rigid transform + uniform scale. The BLAS is the shared per-mesh BVH
(accel/bvh.py); the top level is a static loop over instances — each lane
transforms the ray into object space and runs the stackless BLAS traversal
bounded by its current best hit (the BLAS root test rejects missed instances
in one step, so the loop's cost tracks the instances a ray actually
overlaps). Instance world-AABBs are precomputed for external culling.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp

from raytracing_engine_tpu.accel.bvh import BVH, bvh_intersect

# f32 ray transforms: keep full precision where a card would use TF32
HIGHEST = jax.lax.Precision.HIGHEST


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class InstancedMesh:
    bvh: BVH
    rot: jax.Array        # (N, 3, 3) object->world rotation
    inv_rot: jax.Array    # (N, 3, 3) world->object rotation
    trans: jax.Array      # (N, 3) world translation
    scale: jax.Array      # (N,) uniform scale
    mat: jax.Array        # (N,) int32 material per instance
    aabb_min: jax.Array   # (N, 3) world-space instance bounds
    aabb_max: jax.Array   # (N, 3)

    @property
    def num_instances(self) -> int:
        return self.trans.shape[0]

    @property
    def total_triangles(self) -> int:
        return self.num_instances * self.bvh.v0.shape[0]


def _rotation_z(theta):
    c, s = np.cos(theta), np.sin(theta)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]], np.float32)


def make_instances(bvh: BVH, transforms, mats=None) -> InstancedMesh:
    """transforms: sequence of (rotation (3,3), translation (3,), scale).
    Precomputes inverses and world AABBs (transform of the BLAS root box)."""
    rots = np.stack([np.asarray(r, np.float32) for r, _, _ in transforms])
    trans = np.stack([np.asarray(t, np.float32) for _, t, _ in transforms])
    scales = np.array([s for _, _, s in transforms], np.float32)
    inv = np.transpose(rots, (0, 2, 1))  # orthonormal
    n = len(transforms)
    mats = np.zeros((n,), np.int32) if mats is None else np.asarray(mats, np.int32)

    root_lo = np.asarray(bvh.bb_min[0])
    root_hi = np.asarray(bvh.bb_max[0])
    cs = np.array(np.meshgrid(
        [root_lo[0], root_hi[0]], [root_lo[1], root_hi[1]],
        [root_lo[2], root_hi[2]],
    )).T.reshape(-1, 3)  # (8, 3) object-space corners
    world = (
        np.einsum("nij,kj->nki", rots, cs) * scales[:, None, None]
        + trans[:, None, :]
    )
    return InstancedMesh(
        bvh=bvh,
        rot=jnp.asarray(rots),
        inv_rot=jnp.asarray(inv),
        trans=jnp.asarray(trans),
        scale=jnp.asarray(scales),
        mat=jnp.asarray(mats),
        aabb_min=jnp.asarray(world.min(axis=1)),
        aabb_max=jnp.asarray(world.max(axis=1)),
    )


def grid_instances(bvh: BVH, nx: int, ny: int, spacing: float = 3.0,
                   base=(0.0, 10.0, 0.0), mats=None) -> InstancedMesh:
    """nx*ny instances in a rotated grid — the config-5 scene generator."""
    transforms = []
    for i in range(nx):
        for j in range(ny):
            theta = 0.7 * (i * ny + j)
            t = (
                base[0] + (i - (nx - 1) / 2) * spacing,
                base[1] + j * spacing,
                base[2] + 0.4 * ((i + j) % 3),
            )
            transforms.append((_rotation_z(theta), t, 1.0))
    return make_instances(bvh, transforms, mats)


def instanced_intersect(inst: InstancedMesh, o3, d3, t_min=1e-3):
    """Closest hit over all instances.

    Returns (t_world, instance_idx, tri_idx, normal (..., 3)) — t=inf,
    idx=-1 on miss. Normals are geometric, world-space, unoriented.
    """
    n = inst.num_instances
    batch = o3.shape[:-1]

    best_t = jnp.full(batch, jnp.inf)
    best_inst = jnp.full(batch, -1, jnp.int32)
    best_tri = jnp.full(batch, -1, jnp.int32)
    best_n = jnp.zeros(batch + (3,), jnp.float32)

    for k in range(n):
        inv = inst.inv_rot[k]
        s = inst.scale[k]
        oo = jnp.einsum("ij,...j->...i", inv, o3 - inst.trans[k],
                        precision=HIGHEST) / s
        dd = jnp.einsum("ij,...j->...i", inv, d3, precision=HIGHEST)

        t_obj, ridx, _, _ = bvh_intersect(
            inst.bvh, oo, dd, t_min=t_min / s, t_max=best_t / s
        )
        t_w = t_obj * s
        ok = (ridx >= 0) & (t_w < best_t)

        safe = jnp.maximum(ridx, 0)
        n_obj = jnp.cross(inst.bvh.e1[safe], inst.bvh.e2[safe])
        n_w = jnp.einsum("ij,...j->...i", inst.rot[k], n_obj,
                         precision=HIGHEST)

        best_t = jnp.where(ok, t_w, best_t)
        best_inst = jnp.where(ok, k, best_inst)
        best_tri = jnp.where(ok, ridx, best_tri)
        best_n = jnp.where(ok[..., None], n_w, best_n)

    nl = jnp.maximum(jnp.linalg.norm(best_n, axis=-1, keepdims=True), 1e-20)
    return best_t, best_inst, best_tri, best_n / nl


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class InstancedClusters:
    """Two-level PT scene container: the shared base-mesh ClusterSet plus
    the packed instance table (ops.pallas.instanced_intersect.
    pack_instances layout; col 19 = per-instance material id).

    Pass as `bvh` to render_pt_fast: the FULL NEE+MIS
    bounce loop then runs over the instanced scene (config 5 as a
    first-class path-traced citizen — the reference shades everything it
    draws, /root/reference/shaders/fragment.glsl:127-187)."""
    inst_tab: jax.Array   # (N, 24) f32
    cs: object            # accel.clusters.ClusterSet

    @property
    def num_instances(self) -> int:
        return self.inst_tab.shape[0]


def make_instanced_clusters(inst: InstancedMesh, cs, scene=None
                            ) -> InstancedClusters:
    """Build the PT container from an InstancedMesh + its base ClusterSet.

    scene: optional PTScene — when given, refuses per-instance materials
    whose emission is nonzero: instanced emissive surfaces have no NEE
    light-table entry and no MIS pdf, so they would silently lose energy.
    Area lights in instanced scenes are emissive SPHERES or unrolled-slot
    triangles."""
    from raytracing_engine_tpu.ops.pallas.instanced_intersect import (
        pack_instances,
    )

    if scene is not None:
        mats = np.asarray(inst.mat)
        emiss = np.asarray(scene.mat_emission)
        bad = [int(k) for k in range(mats.shape[0])
               if np.any(emiss[mats[k]] > 0)]
        if bad:
            raise ValueError(
                f"instances {bad} use emissive materials: instanced "
                f"emissive surfaces are not NEE-sampleable (no light-table "
                f"entry / MIS pdf). Use emissive spheres or unrolled-slot "
                f"triangles as area lights in instanced scenes.")
    return InstancedClusters(inst_tab=pack_instances(inst), cs=cs)
