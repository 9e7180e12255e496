"""SoA wavefront path tracer — the production integrator.

Same estimator as pathtracer/integrator.py (NEE + power-heuristic MIS
with power-weighted light selection; Lambertian / mirror / dielectric
materials, checker textures, env lights, fog, DOF camera, optional
Russian roulette) and the SAME RNG stream (identical keys/shapes/
slicing), but every per-ray quantity is a component plane (H, W) and
every <= 8-slot scene table is unrolled into scalar selects — no
(..., 3) or (..., K) trailing axes anywhere on the hot path, so XLA
fuses the bounce loop into elementwise kernels. This is the production path;
the stacked-layout integrator remains the readable cross-check
reference. Optional features are STATICALLY gated on config fields /
pytree None-ness, so a scene not using one compiles the exact program
from before that feature existed.

Triangles: unrolled scalar Möller-Trumbore up to ``TRI_UNROLL_MAX`` slots;
bigger meshes use the BVH (mesh *area lights* must live in the unrolled
range — true for the bench scenes; the reference integrator has no limit).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax, random

from raytracing_engine_tpu.ops import vec3 as v3
from raytracing_engine_tpu.pathtracer import sampler
from raytracing_engine_tpu.pathtracer.integrator import PTConfig
from raytracing_engine_tpu.pathtracer.scene import (
    DIELECTRIC,
    DIFFUSE,
    LIGHT_MESH,
    METAL,
    MIRROR,
    TRI_UNROLL_MAX,
    PTScene,
)

_PI = float(jnp.pi)
import numpy as _np

BIG = _np.float32(3.4e38)  # numpy scalar: traces as a literal inside Pallas
_DEAD_O = _np.float32(1e18)       # parked-dead-ray origin (squares finitely)
_INV_SQRT3 = _np.float32(0.5773502691896258)


def _sel(idx, table_col, n):
    """Select-chain gather: out[lane] = table_col[idx[lane]] for idx < n."""
    out = jnp.zeros_like(idx, dtype=table_col.dtype) * table_col[0]
    for k in range(n):
        out = jnp.where(idx == k, table_col[k], out)
    return out


def _camera_rays(cfg: PTConfig, cam_pos, cam_quat, u1, u2, row0=0, col0=0,
                 coords=None, lens=None):
    """Primary rays; `lens=(u3, u4)` plus cfg.aperture>0 turns the pinhole
    into a thin lens: sample a disk of radius `aperture` on the sensor
    plane and aim every lens point at the pixel's focal point on the
    y=focus_dist camera-space plane — objects on that plane stay sharp,
    blur radius grows ∝ aperture * |depth - focus| / depth."""
    bh, bw = u1.shape
    if coords is not None:  # explicit global pixel-coordinate planes
        iy, ix = (coords[0].astype(jnp.float32), coords[1].astype(jnp.float32))
    else:
        ix = jax.lax.broadcasted_iota(jnp.int32, (bh, bw), 1).astype(jnp.float32) + col0
        iy = jax.lax.broadcasted_iota(jnp.int32, (bh, bw), 0).astype(jnp.float32) + row0
    ncx = ((ix + u1) * 2.0 / cfg.width - 1.0) * cfg.ratio[0]
    ncy = ((iy + u2) * 2.0 / cfg.height - 1.0) * cfg.ratio[1]
    qx, qy, qz, qw = cam_quat[0], cam_quat[1], cam_quat[2], cam_quat[3]
    vx, vy, vz = ncx, jnp.ones_like(ncx), ncy
    lx = lz = None
    if lens is not None and cfg.aperture > 0.0:
        r = cfg.aperture * jnp.sqrt(lens[0])
        phi = (2.0 * _PI) * lens[1]
        lx, lz = r * jnp.cos(phi), r * jnp.sin(phi)
        fd = jnp.float32(cfg.focus_dist)
        vx, vy, vz = ncx * fd - lx, jnp.zeros_like(ncx) + fd, ncy * fd - lz

    def rot(vx, vy, vz):
        tx = qy * vz - qz * vy + qw * vx
        ty = qz * vx - qx * vz + qw * vy
        tz = qx * vy - qy * vx + qw * vz
        return (vx + 2.0 * (qy * tz - qz * ty),
                vy + 2.0 * (qz * tx - qx * tz),
                vz + 2.0 * (qx * ty - qy * tx))

    dx, dy, dz = rot(vx, vy, vz)
    n = jnp.sqrt(dx * dx + dy * dy + dz * dz)
    d = (dx / n, dy / n, dz / n)
    if lx is not None:
        ox, oy, oz = rot(lx, jnp.zeros_like(lx), lz)
        o = (cam_pos[0] + ox, cam_pos[1] + oy, cam_pos[2] + oz)
    else:
        o = (cam_pos[0] + dx * 0.0, cam_pos[1] + dy * 0.0,
             cam_pos[2] + dz * 0.0)
    return o, d


def _sphere_hits(scene: PTScene, o, d, t_min):
    """Unrolled nearest sphere: (t, idx) planes; t=BIG on miss."""
    S = scene.sph_pos.shape[0]
    best_t = jnp.full_like(o[0], BIG)
    best_i = jnp.full_like(o[0], -1.0)
    for k in range(S):
        cx, cy, cz = scene.sph_pos[k, 0], scene.sph_pos[k, 1], scene.sph_pos[k, 2]
        r = scene.sph_radius[k]
        ocx, ocy, ocz = o[0] - cx, o[1] - cy, o[2] - cz
        b = ocx * d[0] + ocy * d[1] + ocz * d[2]
        c0 = ocx * ocx + ocy * ocy + ocz * ocz - r * r
        disc = b * b - c0
        sq = jnp.sqrt(jnp.maximum(disc, 0.0))
        t0 = -b - sq
        t1 = -b + sq
        t = jnp.where(t0 > t_min, t0, t1)
        ok = (disc > 0.0) & (t > t_min) & (k < scene.sph_count) & (t < best_t)
        best_t = jnp.where(ok, t, best_t)
        best_i = jnp.where(ok, float(k), best_i)
    return best_t, best_i.astype(jnp.int32)


def _tri_hits_unrolled(scene: PTScene, o, d, t_min):
    """Unrolled nearest triangle over the (small) padded slots."""
    T = scene.tri_v0.shape[0]
    best_t = jnp.full_like(o[0], BIG)
    best_i = jnp.full_like(o[0], -1.0)
    for k in range(T):
        v0x, v0y, v0z = scene.tri_v0[k, 0], scene.tri_v0[k, 1], scene.tri_v0[k, 2]
        e1x, e1y, e1z = scene.tri_e1[k, 0], scene.tri_e1[k, 1], scene.tri_e1[k, 2]
        e2x, e2y, e2z = scene.tri_e2[k, 0], scene.tri_e2[k, 1], scene.tri_e2[k, 2]
        # pvec = d x e2
        px = d[1] * e2z - d[2] * e2y
        py = d[2] * e2x - d[0] * e2z
        pz = d[0] * e2y - d[1] * e2x
        det = e1x * px + e1y * py + e1z * pz
        inv = 1.0 / jnp.where(jnp.abs(det) < 1e-9, 1.0, det)
        tvx, tvy, tvz = o[0] - v0x, o[1] - v0y, o[2] - v0z
        u = (tvx * px + tvy * py + tvz * pz) * inv
        # qvec = tvec x e1
        qx = tvy * e1z - tvz * e1y
        qy = tvz * e1x - tvx * e1z
        qz = tvx * e1y - tvy * e1x
        vv = (d[0] * qx + d[1] * qy + d[2] * qz) * inv
        t = (e2x * qx + e2y * qy + e2z * qz) * inv
        ok = (
            (jnp.abs(det) >= 1e-9) & (u >= 0.0) & (vv >= 0.0)
            & (u + vv <= 1.0) & (t > t_min) & (k < scene.tri_count)
            & (t < best_t)
        )
        best_t = jnp.where(ok, t, best_t)
        best_i = jnp.where(ok, float(k), best_i)
    return best_t, best_i.astype(jnp.int32)


def _mean_live_origin(o):
    """Mean ray origin over non-parked lanes (visit-order perf hint)."""
    live = jnp.abs(o[0]) < 1e17
    n = jnp.maximum(jnp.sum(live.astype(jnp.float32)), 1.0)
    return jnp.stack([jnp.sum(jnp.where(live, c, 0.0)) / n for c in o])


def _tri_hits(scene: PTScene, o, d, t_min, bvh):
    """(t, original tri index, n V3 unnormalized, 2*area, uv) of the
    nearest triangle hit. uv is the interpolated texture-(u, v) pair when
    the ClusterSet carries UV rows, else None (callers fall back to
    scene.tri_uv or zeros).

    `bvh` may be an accel.bvh.BVH (skip-link traversal in XLA) or an
    accel.clusters.ClusterSet (the Triton cluster kernel; normal and area
    are direct row gathers from the Baldwin–Weber table, no cross product).
    """
    from raytracing_engine_tpu.accel.clusters import ClusterSet

    T = scene.tri_v0.shape[0]
    if isinstance(bvh, ClusterSet):
        from raytracing_engine_tpu.ops.pallas.cluster_intersect import (
            cluster_intersect,
        )

        from raytracing_engine_tpu.accel.clusters import visit_order

        cs = bvh
        # near-to-far visit order from the mean ray origin (perf hint);
        # parked dead rays (origin ~1e18) are excluded from the mean
        mean_o = _mean_live_origin(o)
        t, sidx = cluster_intersect(cs, o, d, BIG, t_min=t_min,
                                    order=visit_order(cs, mean_o))
        safe = jnp.maximum(sidx, 0)
        idx = jnp.maximum(cs.perm[safe], 0)
        n = (cs.tri[0, safe], cs.tri[1, safe], cs.tri[2, safe])
        nlen2 = cs.tri[13, safe]
        tuv = ttan = None
        if cs.smooth:
            # smooth table (rows 21-29): recompute the hit barycentrics
            # from the affine rows at the hit point (cluster-local, row
            # 20 origin) and interpolate the per-corner shading normals —
            # the gather-path analog of the sweep's in-kernel smooth
            # attrs; misses produce garbage planes that are masked by
            # sidx/use_tri downstream exactly like the flat gathers.
            from raytracing_engine_tpu.accel.clusters import CLUSTER

            base = (safe // CLUSTER) * CLUSTER
            px = o[0] + t * d[0] - cs.tri[20, base]
            py = o[1] + t * d[1] - cs.tri[20, base + 1]
            pz = o[2] + t * d[2] - cs.tri[20, base + 2]
            u = (cs.tri[4, safe] * px + cs.tri[5, safe] * py
                 + cs.tri[6, safe] * pz + cs.tri[7, safe])
            v = (cs.tri[8, safe] * px + cs.tri[9, safe] * py
                 + cs.tri[10, safe] * pz + cs.tri[11, safe])
            n = tuple(cs.tri[21 + a, safe] + u * cs.tri[24 + a, safe]
                      + v * cs.tri[27 + a, safe] for a in range(3))
            if cs.has_uv:  # rows 32-37: interpolated texture UV
                tuv = tuple(cs.tri[32 + a, safe] + u * cs.tri[34 + a, safe]
                            + v * cs.tri[36 + a, safe] for a in range(2))
                if scene.needs_tan:
                    # world texture-u tangent from the barycentric
                    # gradient rows: d(u_tex)/dp = du1*r1 + du2*r2
                    # (translation-invariant — rebasing shifts only the
                    # affine constants c1/c2, never the gradients)
                    du1, du2 = cs.tri[34, safe], cs.tri[36, safe]
                    ttan = tuple(du1 * cs.tri[4 + a, safe]
                                 + du2 * cs.tri[8 + a, safe]
                                 for a in range(3))
        return jnp.where(sidx >= 0, t, BIG), idx, n, nlen2, tuv, ttan
    if bvh is not None:
        from raytracing_engine_tpu.accel.bvh import bvh_intersect

        t, ridx, _, _ = bvh_intersect(bvh, v3.stack(o), v3.stack(d),
                                      t_min=t_min)
        safe = jnp.maximum(ridx, 0)
        idx = bvh.perm[safe]
        e1 = v3.unstack(bvh.e1[safe])
        e2 = v3.unstack(bvh.e2[safe])
        n = v3.cross(e1, e2)
        return jnp.where(ridx >= 0, t, BIG), idx, n, v3.length(n), None, None
    if T <= TRI_UNROLL_MAX:
        t, idx = _tri_hits_unrolled(scene, o, d, t_min)
        safe = jnp.maximum(idx, 0)
        e1c = (_sel(safe, scene.tri_e1[:, 0], T),
               _sel(safe, scene.tri_e1[:, 1], T),
               _sel(safe, scene.tri_e1[:, 2], T))
        e2c = (_sel(safe, scene.tri_e2[:, 0], T),
               _sel(safe, scene.tri_e2[:, 1], T),
               _sel(safe, scene.tri_e2[:, 2], T))
        n = v3.cross(e1c, e2c)
        return t, safe, n, v3.length(n), None, None
    # big mesh without a BVH: stacked fallback (slow — build a BVH instead)
    from raytracing_engine_tpu.pathtracer.intersect import ray_triangle

    o3 = v3.stack(o)
    d3 = v3.stack(d)
    tmask = jnp.arange(T) < scene.tri_count
    tt, _, _ = ray_triangle(o3, d3, scene.tri_v0, scene.tri_e1, scene.tri_e2, t_min)
    tt = jnp.where(tmask, tt, BIG)
    t = jnp.min(tt, axis=-1)
    idx = jnp.argmin(tt, axis=-1)
    e1 = v3.unstack(scene.tri_e1[idx])
    e2 = v3.unstack(scene.tri_e2[idx])
    n = v3.cross(e1, e2)
    return t, idx, n, v3.length(n), None, None


def _intersect_instanced(scene: PTScene, o, d, t_min, bvh):
    """Two-level (instanced) closest hit for the PT bounce loop.

    bvh: an accel.instancing.InstancedClusters (one Triton instanced-sweep
    launch per bounce). Materials are PER INSTANCE
    (inst table col 19). Emissive instanced materials are NOT supported
    (no NEE entry / MIS pdf for them — make_instanced_clusters refuses);
    area lights in instanced scenes are emissive spheres or unrolled-slot
    triangles, so light_area for mesh hits is never read and stays 1."""
    from raytracing_engine_tpu.ops.pallas.instanced_intersect import (
        instanced_cluster_intersect,
    )

    t_s, i_s = _sphere_hits(scene, o, d, t_min)
    cuu = cvv = ctan = None
    res = instanced_cluster_intersect(
        bvh.inst_tab, bvh.cs, o, d, t_min=t_min, attrs=True,
        tan=scene.needs_tan)
    t_w, code_i, cnx, cny, cnz = res[:5]
    if len(res) >= 7:
        cuu, cvv = res[5], res[6]
    if len(res) == 10:
        ctan = res[7:10]
    n_inst = bvh.inst_tab.shape[0]
    inst_id = jnp.maximum(code_i, 0) // bvh.cs.padded_tris
    inst_mat = _sel(inst_id, bvh.inst_tab[:, 19], n_inst)
    hit_tri = code_i >= 0
    t_t = jnp.where(hit_tri, t_w, BIG)

    use_tri = t_t < t_s
    t = jnp.minimum(t_s, t_t)
    hit = t < BIG
    p = v3.add(o, v3.scale(d, t))

    S = scene.sph_pos.shape[0]
    si = jnp.maximum(i_s, 0)
    scx = _sel(si, scene.sph_pos[:, 0], S)
    scy = _sel(si, scene.sph_pos[:, 1], S)
    scz = _sel(si, scene.sph_pos[:, 2], S)
    n_sph = (p[0] - scx, p[1] - scy, p[2] - scz)
    n = v3.where(use_tri, (cnx, cny, cnz), n_sph)
    nlen = jnp.maximum(v3.length(n), 1e-20)
    n = v3.scale(n, 1.0 / nlen)
    flip = v3.dot(n, d) > 0.0
    n = v3.where(flip, v3.neg(n), n)  # two-sided; `front` = geometric side

    sph_mat = _sel(si, scene.sph_mat, S)
    mat_id = jnp.where(use_tri, inst_mat.astype(jnp.int32), sph_mat)

    sr = _sel(si, scene.sph_radius, S)
    sph_area = 4.0 * _PI * sr * sr
    light_area = jnp.where(use_tri, 1.0, sph_area)

    out = dict(t=t, hit=hit, p=p, n=n, mat_id=mat_id, light_area=light_area,
               is_tri=use_tri, front=~flip)
    if scene.has_light_tree:
        # Instanced replicas can never be identified with a scene tri
        # slot (the mesh is replicated); _trace_core rejects tree + tri
        # slot lights over this path, so -1 here is always a non-light.
        out["prim"] = jnp.where(use_tri, -1, si)
    if scene.needs_uv:  # static: UV-free scenes compile the prior program
        su, sv = _sphere_uv(n_sph)
        if cuu is None:
            cuu = cvv = jnp.zeros_like(t)
        out["uv"] = (jnp.where(use_tri, cuu, su),
                     jnp.where(use_tri, cvv, sv))
    if scene.needs_tan:  # static: raw texture-u tangent plane triple
        if ctan is None:
            ctan = (jnp.zeros_like(t),) * 3
        out["tan"] = v3.where(use_tri, ctan, _sphere_tan(n_sph))
    return out


def _intersect(scene: PTScene, o, d, t_min, bvh):
    from raytracing_engine_tpu.accel.instancing import InstancedClusters

    if isinstance(bvh, InstancedClusters):
        return _intersect_instanced(scene, o, d, t_min, bvh)
    t_s, i_s = _sphere_hits(scene, o, d, t_min)
    t_t, i_t, n_tri, nlen2, tuv, ttan = _tri_hits(scene, o, d, t_min, bvh)

    use_tri = t_t < t_s
    t = jnp.minimum(t_s, t_t)
    hit = t < BIG

    p = v3.add(o, v3.scale(d, t))

    S = scene.sph_pos.shape[0]
    si = jnp.maximum(i_s, 0)
    scx = _sel(si, scene.sph_pos[:, 0], S)
    scy = _sel(si, scene.sph_pos[:, 1], S)
    scz = _sel(si, scene.sph_pos[:, 2], S)
    n_sph = (p[0] - scx, p[1] - scy, p[2] - scz)
    n = v3.where(use_tri, n_tri, n_sph)
    nlen = jnp.maximum(v3.length(n), 1e-20)
    n = v3.scale(n, 1.0 / nlen)
    flip = v3.dot(n, d) > 0.0
    n = v3.where(flip, v3.neg(n), n)  # two-sided; `front` = geometric side

    sph_mat = _sel(si, scene.sph_mat, S)
    T = scene.tri_v0.shape[0]
    if bvh is not None or T > TRI_UNROLL_MAX:
        tri_mat = scene.tri_mat[i_t]  # gather — T too large to unroll
    else:
        tri_mat = _sel(i_t, scene.tri_mat, T)
    mat_id = jnp.where(use_tri, tri_mat, sph_mat)

    sr = _sel(si, scene.sph_radius, S)
    sph_area = 4.0 * _PI * sr * sr
    tri_area = 0.5 * nlen2
    light_area = jnp.where(use_tri, tri_area, sph_area)

    out = dict(t=t, hit=hit, p=p, n=n, mat_id=mat_id, light_area=light_area,
               is_tri=use_tri, front=~flip)
    if scene.has_light_tree:  # slot index of the hit primitive
        out["prim"] = jnp.where(use_tri, i_t, si)
    if scene.needs_uv:  # static: UV-free scenes compile the prior program
        su, sv = _sphere_uv(n_sph)
        if tuv is None and scene.tri_uv is not None:
            # recompute the hit barycentrics from the gathered triangle
            # (Baldwin–Weber rows on the fly) and interpolate tri_uv
            v0g = v3.unstack(scene.tri_v0[i_t])
            e1g = v3.unstack(scene.tri_e1[i_t])
            e2g = v3.unstack(scene.tri_e2[i_t])
            ng = v3.cross(e1g, e2g)
            nn = jnp.maximum(v3.dot(ng, ng), 1e-30)
            rel = v3.sub(p, v0g)
            gu = v3.scale(v3.cross(e2g, ng), 1.0 / nn)  # grad of bary u
            gv = v3.scale(v3.cross(ng, e1g), 1.0 / nn)  # grad of bary v
            ub = v3.dot(gu, rel)
            vb = v3.dot(gv, rel)
            uv6 = scene.tri_uv[i_t]
            du1 = uv6[..., 2] - uv6[..., 0]
            du2 = uv6[..., 4] - uv6[..., 0]
            tuv = (uv6[..., 0] + ub * du1 + vb * du2,
                   uv6[..., 1] + ub * (uv6[..., 3] - uv6[..., 1])
                   + vb * (uv6[..., 5] - uv6[..., 1]))
            if scene.needs_tan:
                # world texture-u tangent: d(u_tex)/dp = du1*∇ub + du2*∇vb
                ttan = v3.add(v3.scale(gu, du1), v3.scale(gv, du2))
        if tuv is None:
            tuv = (jnp.zeros_like(t), jnp.zeros_like(t))
        out["uv"] = (jnp.where(use_tri, tuv[0], su),
                     jnp.where(use_tri, tuv[1], sv))
    if scene.needs_tan:  # static: raw texture-u tangent plane triple
        if ttan is None:
            ttan = (jnp.zeros_like(t),) * 3
        out["tan"] = v3.where(use_tri, ttan, _sphere_tan(n_sph))
    return out


def _occluded(scene: PTScene, o, d, max_t, t_min, bvh):
    S = scene.sph_pos.shape[0]
    blocked = jnp.zeros_like(o[0], dtype=bool)
    for k in range(S):
        cx, cy, cz = scene.sph_pos[k, 0], scene.sph_pos[k, 1], scene.sph_pos[k, 2]
        r = scene.sph_radius[k]
        ocx, ocy, ocz = o[0] - cx, o[1] - cy, o[2] - cz
        b = ocx * d[0] + ocy * d[1] + ocz * d[2]
        c0 = ocx * ocx + ocy * ocy + ocz * ocz - r * r
        disc = b * b - c0
        sq = jnp.sqrt(jnp.maximum(disc, 0.0))
        t0 = -b - sq
        t1 = -b + sq
        t = jnp.where(t0 > t_min, t0, t1)
        ok = (disc > 0.0) & (t > t_min) & (t < max_t) & (k < scene.sph_count)
        blocked = blocked | ok

    from raytracing_engine_tpu.accel.clusters import ClusterSet
    from raytracing_engine_tpu.accel.instancing import InstancedClusters
    from raytracing_engine_tpu.ops.pallas.instanced_intersect import (
        instanced_cluster_intersect,
    )

    T = scene.tri_v0.shape[0]
    if isinstance(bvh, InstancedClusters):
        _, code_i = instanced_cluster_intersect(
            bvh.inst_tab, bvh.cs, o, d, t_min=t_min, any_hit=True,
            t_max=max_t)
        blocked = blocked | (code_i >= 0)
    elif isinstance(bvh, ClusterSet):
        from raytracing_engine_tpu.accel.clusters import visit_order
        from raytracing_engine_tpu.ops.pallas.cluster_intersect import (
            cluster_intersect,
        )

        mean_o = _mean_live_origin(o)
        _, idx = cluster_intersect(bvh, o, d, max_t, t_min=t_min,
                                   any_hit=True, order=visit_order(bvh, mean_o))
        blocked = blocked | (idx >= 0)
    elif bvh is not None:
        from raytracing_engine_tpu.accel.bvh import bvh_intersect

        _, idx, _, _ = bvh_intersect(
            bvh, v3.stack(o), v3.stack(d), t_min=t_min, t_max=max_t,
            any_hit=True,
        )
        blocked = blocked | (idx >= 0)
    elif T <= TRI_UNROLL_MAX:
        t_t, i_t = _tri_hits_unrolled(scene, o, d, t_min)
        blocked = blocked | (t_t < max_t)
    else:
        from raytracing_engine_tpu.pathtracer.intersect import ray_triangle

        tmask = jnp.arange(T) < scene.tri_count
        tt, _, _ = ray_triangle(
            v3.stack(o), v3.stack(d), scene.tri_v0, scene.tri_e1, scene.tri_e2, t_min
        )
        tt = jnp.where(tmask, tt, BIG)
        blocked = blocked | (jnp.min(tt, axis=-1) < max_t)
    return blocked


def _tree_cluster_weights(scene: PTScene, p):
    """Per-lane light-tree cluster importances at shading point p:
    w_c = power_c / max(dist(p, center_c)^2, radius_c^2). The radius
    clamp keeps the weight finite (and conservative) for points inside a
    cluster's bounding sphere — the standard lightcuts-style bound. Pure
    mul/add/max over a STATIC C axis: kernel-safe, no gathers. Returns
    the per-cluster weight list and its sum."""
    C = scene.lt_center.shape[0]
    ws = []
    for c in range(C):
        dx = p[0] - scene.lt_center[c, 0]
        dy = p[1] - scene.lt_center[c, 1]
        dz = p[2] - scene.lt_center[c, 2]
        d2 = dx * dx + dy * dy + dz * dz
        r2 = scene.lt_radius[c] * scene.lt_radius[c]
        ws.append(scene.lt_power[c]
                  / jnp.maximum(jnp.maximum(d2, r2), 1e-12))
    total = ws[0]
    for c in range(1, C):
        total = total + ws[c]
    return ws, total


def _sample_light(scene: PTScene, u_sel, u1, u2, mesh_light=None,
                  uniform=False, tree_p=None, u_tri=None):
    """Plane-native NEE light sample (see integrator.sample_light_point).

    mesh_light: optional tuple of 14 SCALARS [v0(3), e1(3), e2(3), Le(3),
    total_area, pick] — this pass's area-weighted emissive-mesh triangle
    (see scene.mesh_light_rows). Slots with kind==LIGHT_MESH sample a
    point on it with per-lane barycentric jitter; the pseudo-slot's
    stored area is the TOTAL emissive area, so pick/area (or
    1/(area*count) for uniform selection) is already the marginal pdf of
    the whole scheme.

    tree_p: optional V3 shading point — two-level LIGHT-TREE selection
    (scene must carry lt_* tables; see scene._build_light_tree). Pick a
    cluster by distance-discounted power (per-lane CDF over the static C
    axis), rescale u_sel into the chosen interval (standard CDF-inversion
    reuse — no extra random number), then walk the ORIGINAL slot axis
    for the first slot of that cluster whose within-cluster power CDF
    exceeds the rescaled u. Callers that pass tree_p MUST evaluate it at
    the NEXT segment's origin (p + eps*n) so the hit-side MIS pdf —
    computed from st["o"] one bounce later — matches bit-for-bit."""
    L = scene.light_kind.shape[0]
    count = jnp.maximum(scene.light_count, 1)
    tree_pick = None
    if tree_p is not None:
        ws, wtot = _tree_cluster_weights(scene, tree_p)
        C = len(ws)
        uw = u_sel * wtot
        # inclusive running-CDF walk over the static cluster axis,
        # tracking the chosen cluster's weight and CDF floor as we go
        cum = ws[0]
        cl = jnp.zeros(jnp.shape(u_sel), jnp.float32)
        lo = jnp.zeros(jnp.shape(u_sel), jnp.float32)
        w_sel = ws[0]
        for c in range(1, C):
            step = uw >= cum
            cl = cl + jnp.where(step, 1.0, 0.0)
            lo = jnp.where(step, cum, lo)
            w_sel = jnp.where(step, ws[c], w_sel)
            cum = cum + ws[c]
        p_cl = w_sel / jnp.maximum(wtot, 1e-30)
        u_in = jnp.clip((uw - lo) / jnp.maximum(w_sel, 1e-30),
                        0.0, 1.0 - 1e-7)
        # masked first-hit walk over the original slot axis: the first
        # slot of cluster `cl` whose within-cluster CDF exceeds u_in
        # (each cluster's last member is pinned to 1.0 at build, so the
        # walk always terminates before the zero-pick padding)
        found = jnp.zeros(jnp.shape(u_sel), jnp.float32)
        idxf = jnp.zeros(jnp.shape(u_sel), jnp.float32)
        for k in range(L):
            passed = ((scene.lt_cluster[k] == cl)
                      & (u_in < scene.lt_cdf_intra[k]))
            idxf = idxf + jnp.where((found > 0.0) | passed, 0.0, 1.0)
            found = jnp.maximum(found, jnp.where(passed, 1.0, 0.0))
        idx = jnp.minimum(idxf, float(L - 1)).astype(jnp.int32)
        tree_pick = p_cl * _sel(idx, scene.lt_pick_intra, L)
    elif uniform:
        idx = jnp.minimum((u_sel * count).astype(jnp.int32), count - 1)
    else:
        # power-weighted: inclusive-CDF walk, unrolled over the static
        # slot count (padded slots pinned to 1 -> never chosen)
        idx = jnp.zeros(jnp.shape(u_sel), jnp.int32)
        for k in range(L - 1):
            idx = idx + (u_sel >= scene.light_cdf[k]).astype(jnp.int32)

    kind = _sel(idx, scene.light_kind, L)
    prim = _sel(idx, scene.light_prim, L)
    area = _sel(idx, scene.light_area, L)
    le = (_sel(idx, scene.light_le[:, 0], L),
          _sel(idx, scene.light_le[:, 1], L),
          _sel(idx, scene.light_le[:, 2], L))

    S = scene.sph_pos.shape[0]
    c = (_sel(prim, scene.sph_pos[:, 0], S),
         _sel(prim, scene.sph_pos[:, 1], S),
         _sel(prim, scene.sph_pos[:, 2], S))
    r = _sel(prim, scene.sph_radius, S)
    z = 1.0 - 2.0 * u1
    rr = jnp.sqrt(jnp.maximum(1.0 - z * z, 0.0))
    phi = 2.0 * _PI * u2
    n_s = (rr * jnp.cos(phi), rr * jnp.sin(phi), z)
    p_s = v3.add(c, v3.scale(n_s, r))

    Tn = min(scene.tri_v0.shape[0], TRI_UNROLL_MAX)
    v0 = (_sel(prim, scene.tri_v0[:, 0], Tn),
          _sel(prim, scene.tri_v0[:, 1], Tn),
          _sel(prim, scene.tri_v0[:, 2], Tn))
    e1 = (_sel(prim, scene.tri_e1[:, 0], Tn),
          _sel(prim, scene.tri_e1[:, 1], Tn),
          _sel(prim, scene.tri_e1[:, 2], Tn))
    e2 = (_sel(prim, scene.tri_e2[:, 0], Tn),
          _sel(prim, scene.tri_e2[:, 1], Tn),
          _sel(prim, scene.tri_e2[:, 2], Tn))
    su = jnp.sqrt(u1)
    b1 = su * (1.0 - u2)
    b2 = su * u2
    p_t = v3.add(v0, v3.add(v3.scale(e1, b1), v3.scale(e2, b2)))
    n_t = v3.cross(e1, e2)
    n_t = v3.scale(n_t, 1.0 / jnp.maximum(v3.length(n_t), 1e-20))

    is_tri = kind == 1
    point = v3.where(is_tri, p_t, p_s)
    normal = v3.where(is_tri, n_t, n_s)

    if scene.has_lane_mesh_light:
        # per-lane emissive-triangle selection (u_tri is this draw's
        # dedicated dim — see the bounce's nu extension); barycentrics
        # reuse the b1/b2 sqrt warp above exactly like the per-pass scheme
        p_m, n_m, le_m = _sample_mesh_tri_lane(scene, u_tri, b1, b2)
        is_mesh = kind == LIGHT_MESH
        point = v3.where(is_mesh, p_m, point)
        normal = v3.where(is_mesh, n_m, normal)
        le = v3.where(is_mesh, le_m, le)
    elif mesh_light is not None:
        mv0 = mesh_light[0:3]
        me1 = mesh_light[3:6]
        me2 = mesh_light[6:9]
        mle = mesh_light[9:12]
        # same sqrt barycentric mapping as the per-slot triangles
        p_m = (mv0[0] + me1[0] * b1 + me2[0] * b2,
               mv0[1] + me1[1] * b1 + me2[1] * b2,
               mv0[2] + me1[2] * b1 + me2[2] * b2)
        ncx = me1[1] * me2[2] - me1[2] * me2[1]  # scalar cross product
        ncy = me1[2] * me2[0] - me1[0] * me2[2]
        ncz = me1[0] * me2[1] - me1[1] * me2[0]
        ninv = 1.0 / jnp.maximum(
            jnp.sqrt(ncx * ncx + ncy * ncy + ncz * ncz), 1e-20)
        is_mesh = kind == LIGHT_MESH
        point = v3.where(is_mesh, p_m, point)
        normal = v3.where(is_mesh, (ncx * ninv + 0.0 * b1,
                                    ncy * ninv + 0.0 * b1,
                                    ncz * ninv + 0.0 * b1), normal)
        le = (jnp.where(is_mesh, mle[0], le[0]),
              jnp.where(is_mesh, mle[1], le[1]),
              jnp.where(is_mesh, mle[2], le[2]))

    if tree_pick is not None:
        pdf_area = tree_pick / jnp.maximum(area, 1e-20)
    elif uniform:
        pdf_area = 1.0 / (area * count)
    else:
        pick = _sel(idx, scene.light_pick, L)
        pdf_area = pick / jnp.maximum(area, 1e-20)
    return point, normal, le, pdf_area


def _mat_lookup(scene: PTScene, mat_id):
    M = scene.mat_albedo.shape[0]
    albedo = (_sel(mat_id, scene.mat_albedo[:, 0], M),
              _sel(mat_id, scene.mat_albedo[:, 1], M),
              _sel(mat_id, scene.mat_albedo[:, 2], M))
    emission = (_sel(mat_id, scene.mat_emission[:, 0], M),
                _sel(mat_id, scene.mat_emission[:, 1], M),
                _sel(mat_id, scene.mat_emission[:, 2], M))
    kind = _sel(mat_id, scene.mat_kind, M)
    ior = _sel(mat_id, scene.mat_ior, M)
    return albedo, emission, kind, ior


def _poly_atan2(y, x):
    """atan2 from mul/add/select only:
    octant-reduced Hastings polynomial, |err| < 1e-5 rad. Every engine
    shares this implementation, so sphere UVs stay parity-exact."""
    ax = jnp.abs(x)
    ay = jnp.abs(y)
    hi = jnp.maximum(ax, ay)
    a = jnp.minimum(ax, ay) / jnp.maximum(hi, 1e-30)
    s = a * a
    r = a * (0.9998660 + s * (-0.3302995 + s * (0.1801410
             + s * (-0.0851330 + s * 0.0208351))))
    r = jnp.where(ay > ax, 0.5 * _PI - r, r)
    r = jnp.where(x < 0.0, _PI - r, r)
    return jnp.where(y < 0.0, -r, r)


def _poly_acos(x):
    """acos via the Hastings sqrt approximation (|err| < 7e-5 rad) —
    kernel-safe (sqrt/mul/add/select)."""
    ax = jnp.clip(jnp.abs(x), 0.0, 1.0)
    r = jnp.sqrt(1.0 - ax) * (1.5707288 + ax * (-0.2121144
        + ax * (0.0742610 - ax * 0.0187293)))
    return jnp.where(x < 0.0, _PI - r, r)


def _sphere_uv(n_sph):
    """Analytic spherical parametrization from the unnormalized OUTWARD
    normal (p - center): u = azimuth/2pi + 0.5, v = polar/pi (Z-up).
    Elementwise with polynomial inverse-trig — kernel-safe; gives spheres
    UVs with no stored data."""
    ln = jnp.maximum(v3.length(n_sph), 1e-20)
    u = _poly_atan2(n_sph[1], n_sph[0]) * (0.5 / _PI) + 0.5
    v = _poly_acos(jnp.clip(n_sph[2] / ln, -1.0, 1.0)) * (1.0 / _PI)
    return u, v


def _sphere_tan(n_sph):
    """Raw texture-u tangent of the spherical parametrization: the
    azimuthal direction d p/d u ∝ (-y, x, 0) of the outward normal.
    Degenerates at the poles (handled by _perturb_normal's fallback)."""
    return (-n_sph[1], n_sph[0], jnp.zeros_like(n_sph[0]))


def _atlas_fetch(atlas, ty, tx):
    """Per-lane nearest-texel fetch from the (3K, 128) channel-major atlas.

    ty/tx: int32 planes (atlas row / texel column). The column fetch is a
    lane-axis `take_along_axis` on a broadcast atlas row and the row
    dimension is a K-row select chain, so one implementation serves both
    integrators bit-identically at ~3K vector ops per fetch
    (K <= scene.ATLAS_MAX_ROWS = 32)."""
    K = atlas.shape[0] // 3
    out = []
    for c in range(3):
        acc = jnp.zeros(tx.shape, jnp.float32)
        for k in range(K):
            row = atlas[c * K + k]  # (128,) static-row read
            tab = jnp.broadcast_to(row[None, :],
                                   tx.shape[:-1] + row.shape)
            vals = jnp.take_along_axis(tab, tx, axis=-1)
            acc = jnp.where(ty == k, vals, acc)
        out.append(acc)
    return tuple(out)


def _fetch_row_block(tab, nblocks, block, ty, tx):
    """Per-lane fetch of ONE component block from an (nblocks*K, 128)
    lane-row table (K-row select chain + lane-axis take_along_axis — the
    atlas/env fetch machinery, one channel at a time)."""
    K = tab.shape[0] // nblocks
    acc = jnp.zeros(tx.shape, jnp.float32)
    for k in range(K):
        row = tab[block * K + k]
        vals = jnp.take_along_axis(
            jnp.broadcast_to(row[None, :], tx.shape[:-1] + row.shape),
            tx, axis=-1)
        acc = jnp.where(ty == k, vals, acc)
    return acc


def _sample_mesh_tri_lane(scene: PTScene, u_tri, b1, b2):
    """Per-lane emissive-triangle sample (mesh_lights='lane').

    Alias-samples a triangle from the area pmf (two table fetches), then
    interpolates the point with the caller's sqrt-warp barycentrics and
    fetches Le. Returns (point V3, unit normal V3, le V3). The marginal
    point pdf is (area_t/total) * (1/area_t) = 1/total — identical to the
    per-pass scheme, so callers' pdf/MIS handling is unchanged."""
    K_m = scene.mlt_rows.shape[0] // 12
    N = float(K_m * 128)
    x = u_tri * N
    j = jnp.clip(jnp.floor(x), 0.0, N - 1.0)
    f = x - j
    ty0 = jnp.floor(j / 128.0)
    tx0 = (j - ty0 * 128.0).astype(jnp.int32)
    ty0 = ty0.astype(jnp.int32)
    ap = _fetch_row_block(scene.mlt_smp, 2, 0, ty0, tx0)
    ai = _fetch_row_block(scene.mlt_smp, 2, 1, ty0, tx0)
    t = jnp.where(f < ap, j, ai)
    ty = jnp.floor(t / 128.0)
    tx = (t - ty * 128.0).astype(jnp.int32)
    ty = ty.astype(jnp.int32)
    comp = [_fetch_row_block(scene.mlt_rows, 12, b, ty, tx)
            for b in range(12)]
    v0m, e1m, e2m, lem = (tuple(comp[0:3]), tuple(comp[3:6]),
                          tuple(comp[6:9]), tuple(comp[9:12]))
    p_m = v3.add(v0m, v3.add(v3.scale(e1m, b1), v3.scale(e2m, b2)))
    n_m = v3.cross(e1m, e2m)
    n_m = v3.scale(n_m, 1.0 / jnp.maximum(v3.length(n_m), 1e-20))
    return p_m, n_m, lem


def _env_texel_of(d, K):
    """(ty, tx) int32 texel planes of direction d under the equirect map —
    the exact inverse convention of _sample_env (u = azimuth/2π + 0.5 with
    +x at u=0.5, v = polar/π, Z-up; same parametrization as _sphere_uv).
    Polynomial inverse-trig keeps it kernel-safe and engine-identical."""
    u = _poly_atan2(d[1], d[0]) * (0.5 / _PI) + 0.5
    v = _poly_acos(jnp.clip(d[2], -1.0, 1.0)) * (1.0 / _PI)
    tx = jnp.clip(jnp.floor(u * 128.0), 0.0, 127.0).astype(jnp.int32)
    ty = jnp.clip(jnp.floor(v * K), 0.0, float(K - 1)).astype(jnp.int32)
    return ty, tx


def _env_pdf_w(scene: PTScene, ty, tx, sin_t):
    """Solid-angle pdf of the env NEE sampler for the direction in texel
    (ty, tx) with polar sine sin_t: within the chosen texel the sampler is
    uniform in (u, v), so pdf_w = p_sel * N / (2π² sinθ) (dω = 2π² sinθ
    du dv). env_smp's three K-row blocks are exactly _atlas_fetch's
    channel layout — block 0 is p_sel."""
    K = scene.env_img.shape[0] // 3
    psel, _, _ = _atlas_fetch(scene.env_smp, ty, tx)
    return psel * (K * 128.0) / jnp.maximum(2.0 * _PI * _PI * sin_t, 1e-8)


def _sample_env(scene: PTScene, s, j1, j2):
    """Alias-sample an env-map texel and jitter inside it.

    s: the (rescaled) selection uniform; j1/j2: in-texel jitter (the same
    draws the light branch uses for its surface point — the branches are
    mutually exclusive, so the streams never collide). Returns
    (dir V3, pdf_w, le V3). Two per-lane table fetches (alias row, then
    the chosen texel's p_sel + radiance) — O(1) per sample regardless of
    map energy distribution."""
    K = scene.env_img.shape[0] // 3
    N = float(K * 128)
    x = s * N
    j = jnp.clip(jnp.floor(x), 0.0, N - 1.0)
    f = x - j
    ty0 = jnp.floor(j / 128.0)
    tx0 = j - ty0 * 128.0
    _, ap, ai = _atlas_fetch(scene.env_smp,
                             ty0.astype(jnp.int32), tx0.astype(jnp.int32))
    t = jnp.where(f < ap, j, ai)
    ty = jnp.floor(t / 128.0)
    tx = t - ty * 128.0
    u = (tx + j1) / 128.0
    v = (ty + j2) / K
    theta = v * _PI
    phi = (u - 0.5) * (2.0 * _PI)
    sin_t = jnp.sin(theta)
    d = (sin_t * jnp.cos(phi), sin_t * jnp.sin(phi), jnp.cos(theta))
    tyi, txi = ty.astype(jnp.int32), tx.astype(jnp.int32)
    psel, _, _ = _atlas_fetch(scene.env_smp, tyi, txi)
    le = _atlas_fetch(scene.env_img, tyi, txi)
    pdf = psel * N / jnp.maximum(2.0 * _PI * _PI * sin_t, 1e-8)
    return d, pdf, le


def _rect_texel(x0, y0, tw, th, uv, s):
    """Scale-tiled UV -> (ty, tx) int32 texel coordinates inside the
    [x0, y0, tw, th] atlas rect (wrap addressing, nearest texel).
    Kernel-safe: floor/clip/max only."""
    fu = uv[0] * s
    fv = uv[1] * s
    fu = fu - jnp.floor(fu)  # wrap (tile) addressing
    fv = fv - jnp.floor(fv)
    # max(..., 0) also guards untextured lanes (tw=0 -> clip hi = -1)
    tx = jnp.maximum(
        x0 + jnp.clip(jnp.floor(fu * tw), 0.0, tw - 1.0), 0.0
    ).astype(jnp.int32)
    ty = jnp.maximum(
        y0 + jnp.clip(jnp.floor(fv * th), 0.0, th - 1.0), 0.0
    ).astype(jnp.int32)
    return ty, tx


def _sample_rect(atlas, x0, y0, tw, th, uv, s, bilinear=False):
    """Sample the [x0, y0, tw, th] atlas rect at scale-tiled UV.

    nearest (default): one texel read — exact, the pre-filtering program.
    bilinear: texel centers at (i + 0.5)/w; 4 _atlas_fetch reads with
    rect-CLAMPED corner coordinates + 2D lerp — kernel-safe (the corner
    fetches are the same lane-axis gather), shared by planes and stacked
    callers (shapes broadcast identically)."""
    if not bilinear:
        ty, tx = _rect_texel(x0, y0, tw, th, uv, s)
        return _atlas_fetch(atlas, ty, tx)
    fu = uv[0] * s
    fv = uv[1] * s
    fu = fu - jnp.floor(fu)  # wrap (tile) addressing
    fv = fv - jnp.floor(fv)
    fx = fu * tw - 0.5
    fy = fv * th - 0.5
    xf = jnp.floor(fx)
    yf = jnp.floor(fy)
    wx = fx - xf
    wy = fy - yf
    # clamp corners to the rect (no cross-rect bleeding at edges)
    xa = jnp.clip(xf, 0.0, tw - 1.0)
    xb = jnp.clip(xf + 1.0, 0.0, tw - 1.0)
    ya = jnp.clip(yf, 0.0, th - 1.0)
    yb = jnp.clip(yf + 1.0, 0.0, th - 1.0)
    toi = lambda base, c: jnp.maximum(base + c, 0.0).astype(jnp.int32)
    c00 = _atlas_fetch(atlas, toi(y0, ya), toi(x0, xa))
    c10 = _atlas_fetch(atlas, toi(y0, ya), toi(x0, xb))
    c01 = _atlas_fetch(atlas, toi(y0, yb), toi(x0, xa))
    c11 = _atlas_fetch(atlas, toi(y0, yb), toi(x0, xb))
    return tuple(
        (c00[c] * (1.0 - wx) + c10[c] * wx) * (1.0 - wy)
        + (c01[c] * (1.0 - wx) + c11[c] * wx) * wy
        for c in range(3))


def _mip_lod_footprint(cfg: PTConfig, scene: PTScene, isect, d, tacc):
    """Ray-cone texture footprint at the hit, in UV units (the `fp_uv`
    input of _sample_rect_tri).

    The cone: every pixel subtends ~2*fov/width radians on the image
    plane (see _camera_rays: ncx spans ±fov across `width` pixels, both
    axes share the per-pixel step), so after total path distance `tacc`
    the cone's world width is tacc * alpha — the basic Akenine-Moller
    ray cone, no curvature/roughness growth (secondary bounces only
    accumulate distance; diffuse blur beyond that is not modeled).
    Projection onto the surface divides by sqrt(|d.n|) (footprint AREA
    scales with 1/|d.n|; the side length with its sqrt). The world->UV
    conversion uses the MAX UV density over the two texture axes (an
    under-selected LOD aliases; over-selected only blurs):

    - spheres: azimuthal density 1/(2*pi*|tan|) (|tan| = r*sin(theta)
      from the (-y, x, 0) unnormalized-normal tangent — blowing up to
      the coarsest mip at the poles, where equirect texels degenerate)
      maxed with the POLAR density 1/(pi*r); v-texels are twice as dense
      as u-texels at the equator, so azimuthal-only under-selected LOD
      by one level there. r comes for free from the carried
      light_area = 4*pi*r^2 — no extra intersector plane.
    - triangles: the GRADIENT d(u_tex)/dp (units 1/length, |tan| = UV
      per world unit). The v-gradient is not emitted by the sweeps
      (3 more attr planes per test); strongly v-anisotropic triangle
      UVs can still under-select — known approximation."""
    tl = v3.length(isect["tan"])
    sph_r = jnp.sqrt(isect["light_area"] * (0.25 / _PI))
    sph_dens = jnp.maximum(1.0 / (2.0 * _PI * jnp.maximum(tl, 1e-8)),
                           1.0 / (_PI * jnp.maximum(sph_r, 1e-8)))
    inv_du = jnp.where(isect["is_tri"], tl, sph_dens)
    alpha = 2.0 * cfg.fov / cfg.width
    cosw = jnp.abs(v3.dot(d, isect["n"]))
    width = tacc * alpha / jnp.sqrt(jnp.maximum(cosw, 1e-2))
    return width * inv_du


def _sample_rect_tri(scene: PTScene, mat_id, uv, s, fp_uv):
    """Trilinear mip sample of a material's albedo image: pick the LOD
    whose texel size matches the ray-cone footprint, bilinear-sample the
    two bracketing levels from the per-(material, level) rect table
    (mat_tex_mips), and lerp.

    fp_uv: footprint in (tiled) UV units; in level-0 texels that is
    fp_uv * s * tw0, and lod = log2 of it, clamped to the chain. Level
    rects are selected by an unrolled chain over the STATIC level axis —
    the same scalar-table discipline as every other per-material read,
    kernel-safe. Cost: 2 bilinear taps = 8 _atlas_fetch reads."""
    M = scene.mat_albedo.shape[0]
    L = scene.n_mip_levels
    mips = scene.mat_tex_mips
    tw0 = _sel(mat_id, mips[:, 2], M)
    texels = fp_uv * s * jnp.maximum(tw0, 1.0)
    lod = jnp.log2(jnp.clip(texels, 1.0, float(1 << (L - 1))))
    l0 = jnp.floor(lod)
    fr = lod - l0

    def level_rect(lev):
        x0 = jnp.zeros_like(lod)
        y0 = jnp.zeros_like(lod)
        tw = jnp.zeros_like(lod)
        th = jnp.zeros_like(lod)
        for l in range(L):
            m = lev == l
            x0 = jnp.where(m, _sel(mat_id, mips[:, 4 * l + 0], M), x0)
            y0 = jnp.where(m, _sel(mat_id, mips[:, 4 * l + 1], M), y0)
            tw = jnp.where(m, _sel(mat_id, mips[:, 4 * l + 2], M), tw)
            th = jnp.where(m, _sel(mat_id, mips[:, 4 * l + 3], M), th)
        return x0, y0, tw, th

    ra = level_rect(l0)
    rb = level_rect(jnp.minimum(l0 + 1.0, float(L - 1)))
    ca = _sample_rect(scene.tex_atlas, *ra, uv, s, bilinear=True)
    cb = _sample_rect(scene.tex_atlas, *rb, uv, s, bilinear=True)
    return tuple(ca[c] * (1.0 - fr) + cb[c] * fr for c in range(3))


def _perturb_normal(scene: PTScene, mat_id, n, tan, uv, bilinear=False):
    """Tangent-space normal mapping: fetch the map texel from the shared
    atlas, decode n_t = 2*rgb - 1, and rotate it into the world frame
    (T, B=n×T, n) built from the geometry's texture-u tangent direction.

    `n` is the unit (already ray-facing) shading normal; `tan` the RAW
    world-space texture-u gradient from the intersector (unnormalized,
    possibly degenerate — poles, UV-less geometry). Degenerate tangents
    fall back to an arbitrary axis orthogonal to n, and unmapped
    materials (rect w=0) keep `n` exactly. Kernel-safe throughout; the
    reference shades analytic SDF normals only (shaders/fragment.glsl) —
    normal maps are a north-star material extension."""
    M = scene.mat_albedo.shape[0]
    x0 = _sel(mat_id, scene.mat_nrm_rect[:, 0], M)
    y0 = _sel(mat_id, scene.mat_nrm_rect[:, 1], M)
    tw = _sel(mat_id, scene.mat_nrm_rect[:, 2], M)
    th = _sel(mat_id, scene.mat_nrm_rect[:, 3], M)
    s = _sel(mat_id, scene.mat_nrm_scale, M)
    rgb = _sample_rect(scene.tex_atlas, x0, y0, tw, th, uv, s,
                       bilinear=bilinear)
    ntx = 2.0 * rgb[0] - 1.0
    nty = 2.0 * rgb[1] - 1.0
    ntz = 2.0 * rgb[2] - 1.0
    # orthonormalize the tangent against n; degenerate -> any axis ⊥ n
    tp = v3.sub(tan, v3.scale(n, v3.dot(n, tan)))
    fb_x = v3.cross((jnp.zeros_like(n[0]), jnp.zeros_like(n[0]),
                     jnp.ones_like(n[0])), n)      # z × n
    fb_y = v3.cross((jnp.ones_like(n[0]), jnp.zeros_like(n[0]),
                     jnp.zeros_like(n[0])), n)     # x × n (n ~ ±z)
    fb = v3.where(jnp.abs(n[2]) < 0.9, fb_x, fb_y)
    tp = v3.where(v3.dot(tp, tp) > 1e-12, tp, fb)
    T = v3.scale(tp, 1.0 / jnp.maximum(v3.length(tp), 1e-20))
    B = v3.cross(n, T)
    np_ = (ntx * T[0] + nty * B[0] + ntz * n[0],
           ntx * T[1] + nty * B[1] + ntz * n[1],
           ntx * T[2] + nty * B[2] + ntz * n[2])
    # guard an all-zero decoded texel (rgb = 0.5): fall back to n
    ln = v3.length(np_)
    np_ = v3.where(ln > 1e-6, v3.scale(np_, 1.0 / jnp.maximum(ln, 1e-20)), n)
    return v3.where(tw > 0.0, np_, n)  # unmapped materials keep n exactly


def _textured_albedo(scene: PTScene, mat_id, albedo, p, uv=None,
                     bilinear=False, fp_uv=None):
    """Procedural checker + image-atlas textures. Checker cells of size
    1/scale alternate albedo and mat_albedo2 (scale 0 = flat), evaluated
    in world space or — for mat_tex_space=1 materials — texture-UV space.
    Image-textured materials (mat_tex_rect w > 0) then sample the shared
    atlas at the scale-tiled hit UV — trilinearly across the mip chain
    when a ray-cone footprint `fp_uv` is provided (tex_filter=
    "trilinear" + a tex_mips=True scene). Kernel-safe throughout."""
    M = scene.mat_albedo.shape[0]
    s = _sel(mat_id, scene.mat_tex_scale, M)
    a2 = (_sel(mat_id, scene.mat_albedo2[:, 0], M),
          _sel(mat_id, scene.mat_albedo2[:, 1], M),
          _sel(mat_id, scene.mat_albedo2[:, 2], M))
    cells = (jnp.floor(p[0] * s) + jnp.floor(p[1] * s) + jnp.floor(p[2] * s))
    if uv is not None and scene.mat_tex_space is not None:
        space = _sel(mat_id, scene.mat_tex_space, M)
        cells_uv = jnp.floor(uv[0] * s) + jnp.floor(uv[1] * s)
        cells = jnp.where(space > 0.5, cells_uv, cells)
    odd = jnp.mod(cells, 2.0) >= 1.0  # mod handles negative cells
    out = v3.where((s > 0.0) & odd, a2, albedo)
    if scene.mat_tex_rect is not None and uv is not None:
        tw = _sel(mat_id, scene.mat_tex_rect[:, 2], M)
        if fp_uv is not None and scene.has_mips:
            rgb = _sample_rect_tri(scene, mat_id, uv, s, fp_uv)
        else:
            x0 = _sel(mat_id, scene.mat_tex_rect[:, 0], M)
            y0 = _sel(mat_id, scene.mat_tex_rect[:, 1], M)
            th = _sel(mat_id, scene.mat_tex_rect[:, 3], M)
            rgb = _sample_rect(scene.tex_atlas, x0, y0, tw, th, uv, s,
                               bilinear=bilinear)
        out = v3.where(tw > 0.0, rgb, out)
    return out


def _trace_core(cfg: PTConfig, scene: PTScene, cam_pos, cam_quat, key=None,
                bvh=None, row0=0, band_h=None, col0=0, band_w=None,
                seed0=None, mesh_light=None, gpass=None, seed_base=None):
    """One sample per pixel, plane layout. Returns (rad V3 planes, nrays).

    row0/band_h (and col0/band_w) restrict to a window of the image —
    tile-sharded rendering. The threefry RNG draws image-wide and slices
    (bit-identical sharding); the pcg RNG is counter-based on GLOBAL pixel
    coords, so a window natively draws its own identical numbers. With
    rng=pcg, `seed0` (int32 scalar) may replace `key`.
    """
    h, w = (band_h or cfg.height), (band_w or cfg.width)

    if cfg.fog_scatter > 0.0 and not (0.0 < cfg.fog_scatter
                                      <= cfg.fog_density):
        raise ValueError(
            f"fog_scatter (sigma_s={cfg.fog_scatter}) needs "
            f"0 < sigma_s <= fog_density (sigma_t={cfg.fog_density})")
    if cfg.tex_filter == "trilinear" and not scene.has_mips:
        raise ValueError(
            "tex_filter='trilinear' needs packed mip chains — build the "
            "scene with build_pt_scene(tex_mips=True)")
    if cfg.light_sampling == "tree" and not scene.has_light_tree:
        raise ValueError(
            "light_sampling='tree' needs the scene's light-tree tables — "
            "build it with build_pt_scene(..., light_tree=C)")
    if cfg.light_sampling == "tree" and scene.n_tri_slot_lights:
        from raytracing_engine_tpu.accel.instancing import InstancedClusters

        if isinstance(bvh, InstancedClusters):
            raise ValueError(
                "light_sampling='tree' with triangle slot lights cannot "
                "run over the instanced intersector: it cannot recover a "
                "hit triangle's original "
                "slot, so its hit-side MIS density reads 0 while NEE also "
                "samples the light (double-counted direct lighting). Use "
                "sphere lights, the gather BVH path, or "
                "light_sampling='power'.")
    if cfg.rng == "pcg":
        from raytracing_engine_tpu.ops.rng_pcg import uniform_pcg, uniform_pcg_coords

        if seed0 is None:
            from raytracing_engine_tpu.ops.rng_pcg import key_to_seed

            seed0 = key_to_seed(key)

        def draw_b(b, n):
            return uniform_pcg(seed0, b, n, h, w, row0=row0, col0=col0)
    else:
        def draw_b(b, n):
            full = random.uniform(random.fold_in(key, b), (n, cfg.height, cfg.width))
            if band_h is not None:
                full = lax.dynamic_slice_in_dim(full, row0, band_h, axis=1)
            if band_w is not None:
                full = lax.dynamic_slice_in_dim(full, col0, band_w, axis=2)
            return full

    use_r2 = cfg.sampler == "r2"
    if use_r2:
        if cfg.rng != "pcg" or gpass is None:
            raise ValueError(
                "sampler='r2' needs rng='pcg' and a global pass index "
                "(render via render_pt_fast)")
        from raytracing_engine_tpu.ops.rng_pcg import r2_planes

        r2px = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1) + col0
        r2py = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0) + row0
        _r2_seed = seed_base if seed_base is not None else seed0

        def draw_r2(n, channel):
            return r2_planes(_r2_seed, gpass, n, r2px, r2py, channel=channel)

    n_cam = 4 if cfg.aperture > 0.0 else 2  # +2 lens dims when DOF is on
    u = draw_r2(n_cam, 0x52AD1A7E) if use_r2 else draw_b(0, n_cam)
    o, d = _camera_rays(cfg, cam_pos, cam_quat, u[0], u[1], row0=row0,
                        col0=col0,
                        lens=(u[2], u[3]) if n_cam == 4 else None)

    zero = d[0] * 0.0
    o = v3.add(o, v3.scale(d, 0.0))  # make o device-varying like d
    # masks carried as f32 0/1 planes
    st = dict(
        o=o, d=d,
        thr=(zero + 1.0, zero + 1.0, zero + 1.0),
        rad=(zero, zero, zero),
        alive=zero + 1.0,
        prev_did_nee=zero,
        prev_pdf=zero,
        nrays=jnp.sum(zero),
    )
    if scene.has_dispersion:
        # committed color channel per lane (-1 = achromatic so far);
        # set at the first dispersive-glass hit — see scene.mat_dispersion
        st["chan"] = zero - 1.0
    if scene.has_mips and cfg.tex_filter == "trilinear":
        # ray-cone LOD state: total path distance so far (the cone
        # width is tacc * 2*fov/width — see _mip_lod_footprint)
        st["tacc"] = zero

    def bounce(b, st):
        st = dict(st)
        nu = 6 if cfg.rr_start > 0 else 5  # [5] = roulette coin
        # lane mesh lights append one dedicated per-lane triangle-selection
        # dim AFTER the fixed layout (streams of other scenes unchanged)
        mlt_dim = nu if scene.has_lane_mesh_light else None
        nu = nu + (1 if scene.has_lane_mesh_light else 0)
        # single-scatter media appends its own light-sample + distance
        # dims after that (same stream-extension contract)
        media_dim = None
        if cfg.fog_scatter > 0.0:
            media_dim = nu
            nu = nu + (5 if scene.has_lane_mesh_light else 4)
        u = draw_b(b + 1, nu)
        if use_r2 and cfg.use_nee:
            # bounce-0 NEE light dims (area-light penumbras — the direct-
            # lighting integral): 3D R_d sequence on an independent
            # rotation channel; deeper bounces stay random
            r2u = draw_r2(3, 0x1D0C0FFE)
            first = b == 0
            u = tuple(jnp.where(first, r2u[k - 2], u[k]) if 2 <= k <= 4
                      else u[k] for k in range(nu))
        st["nrays"] = st["nrays"] + jnp.sum(st["alive"])

        isect = _intersect(scene, st["o"], st["d"], cfg.t_min, bvh)
        if cfg.fog_density > 0.0:  # static: fog-free scenes pay nothing
            # Beer-Lambert over this segment (escapes = infinite); the
            # absorbed energy re-emerges as constant in-scatter fog_color
            # (same math as integrator.py)
            seg = jnp.where(isect["hit"], isect["t"], 1e4)
            trans = jnp.exp(-cfg.fog_density * seg)
            inscat = 1.0 - trans
            fc = cfg.fog_color
            st["rad"] = v3.add(st["rad"], (st["thr"][0] * inscat * fc[0],
                                           st["thr"][1] * inscat * fc[1],
                                           st["thr"][2] * inscat * fc[2]))
            if cfg.fog_scatter > 0.0:
                # EQUIANGULAR single-scatter NEE inside the medium: pick
                # a light point first, then sample the scatter distance t
                # by the angle subtended at it — pdf_t ∝ 1/(D² + (t-Δ)²)
                # cancels the geometric 1/r² spike that makes uniform-t
                # sampling explode near in-medium lights. Isotropic phase
                # (1/4π), both segments medium-attenuated. Single scatter:
                # indirect in-scatter is not simulated (documented; the
                # fog_color ambient above remains for it). Light selection
                # uses the power/uniform CDF (never the position-dependent
                # tree — the scatter vertex doesn't exist until the light
                # is chosen). Same math as integrator.py.
                m0 = media_dim
                u_tri_m = (u[m0 + 4] if scene.has_lane_mesh_light
                           else None)
                lp_m, ln_m, le_m, pdfa_m = _sample_light(
                    scene, u[m0], u[m0 + 1], u[m0 + 2],
                    mesh_light=mesh_light,
                    uniform=cfg.light_sampling == "uniform",
                    u_tri=u_tri_m)
                rel = v3.sub(lp_m, st["o"])
                delta = v3.dot(rel, st["d"])
                perp = v3.sub(rel, v3.scale(st["d"], delta))
                d_m = jnp.sqrt(jnp.maximum(v3.dot(perp, perp), 1e-12))
                tha = _poly_atan2(-delta, d_m)
                thb = _poly_atan2(seg - delta, d_m)
                th = tha + (thb - tha) * u[m0 + 3]
                tt = delta + d_m * (jnp.sin(th)
                                    / jnp.maximum(jnp.cos(th), 1e-9))
                tt = jnp.clip(tt, 0.0, seg)
                pdf_t = d_m / jnp.maximum(
                    (thb - tha) * (d_m * d_m + (tt - delta) ** 2), 1e-12)
                xm = v3.add(st["o"], v3.scale(st["d"], tt))
                tol = v3.sub(lp_m, xm)
                rdist = v3.length(tol)
                wim = v3.scale(tol, 1.0 / jnp.maximum(rdist, 1e-20))
                cos_lm = jnp.abs(v3.dot(ln_m, wim))
                cand_m = ((st["alive"] != 0.0) & (scene.light_count > 0)
                          & (rdist > cfg.eps) & (thb > tha + 1e-7))
                st["nrays"] = st["nrays"] + jnp.sum(cand_m)
                dead_o_m = (zero + _DEAD_O,) * 3
                dead_d_m = (zero + _INV_SQRT3,) * 3
                sh_om = v3.where(cand_m, xm, dead_o_m)
                sh_dm = v3.where(cand_m, wim, dead_d_m)
                blocked_m = _occluded(scene, sh_om, sh_dm,
                                      rdist * (1.0 - 1e-3), cfg.t_min,
                                      bvh)
                gain = (jnp.float32(cfg.fog_scatter)
                        * jnp.exp(-cfg.fog_density * tt)
                        * (1.0 / (4.0 * _PI)) * cos_lm
                        * jnp.exp(-cfg.fog_density * rdist)
                        / jnp.maximum(pdfa_m * rdist * rdist * pdf_t,
                                      1e-20))
                gain = jnp.where(cand_m & ~blocked_m, gain, 0.0)
                st["rad"] = v3.add(
                    st["rad"], v3.mul(st["thr"], v3.scale(le_m, gain)))
            st["thr"] = v3.scale(st["thr"], trans)
        alive_b = st["alive"] != 0.0
        hit = isect["hit"] & alive_b
        albedo, emission, kind, ior = _mat_lookup(scene, isect["mat_id"])
        alpha = alpha_y = onb_t = onb_s = None
        if scene.has_metal:  # static: metal-free scenes pay nothing
            Mn = scene.mat_albedo.shape[0]
            rough = _sel(isect["mat_id"], scene.mat_rough, Mn)
            alpha = jnp.maximum(rough * rough, 1e-4)  # Disney remap
            if scene.has_aniso:  # static: second roughness axis
                rough2 = _sel(isect["mat_id"], scene.mat_rough2, Mn)
                alpha_y = jnp.maximum(rough2 * rough2, 1e-4)
        n = isect["n"]
        p = isect["p"]
        if scene.has_normal_map:  # static: unmapped scenes pay nothing
            # every downstream consumer (MIS cos, NEE, BSDF scatter) sees
            # the perturbed shading normal, matching integrator.py
            # normal maps stay bilinear under trilinear albedo filtering
            # (no mip chain is packed for them) — but they must not drop
            # to NEAREST, so any filtering mode enables the bilinear tap
            n = _perturb_normal(scene, isect["mat_id"], n, isect["tan"],
                                isect["uv"],
                                bilinear=cfg.tex_filter in ("bilinear",
                                                            "trilinear"))
        fp_uv = None
        if scene.has_mips and cfg.tex_filter == "trilinear":
            # grow the cone by this segment BEFORE shading (the width at
            # the hit includes the segment that reached it); carry it on
            st["tacc"] = st["tacc"] + jnp.where(hit, isect["t"], 0.0)
            fp_uv = _mip_lod_footprint(cfg, scene, isect, st["d"],
                                       st["tacc"])
        if scene.has_texture:  # static: untextured scenes pay nothing
            albedo = _textured_albedo(scene, isect["mat_id"], albedo, p,
                                      uv=isect.get("uv"),
                                      bilinear=cfg.tex_filter in (
                                          "bilinear", "trilinear"),
                                      fp_uv=fp_uv)
        if scene.has_metal and scene.has_aniso:
            # deterministic per-normal tangent frame: the anisotropy axes
            # (and the aniso NDF sampler/eval) live in it — built from
            # the FINAL shading normal so normal maps rotate the frame
            onb_t, onb_s = sampler.build_onb(n)

        # --- emission (MIS vs NEE of the previous vertex) ------------------
        emissive = (emission[0] > 0.0) | (emission[1] > 0.0) | (emission[2] > 0.0)
        cos_l = jnp.abs(v3.dot(n, st["d"]))
        if cfg.light_sampling == "uniform":
            light_area = isect["light_area"]
            if mesh_light is not None:
                # emissive mesh-tri hits: MIS must use the same MARGINAL
                # pdf the sampler used, 1/(total_area*count)
                light_area = jnp.where(isect["is_tri"], mesh_light[12],
                                       light_area)
            elif scene.has_lane_mesh_light:  # same 1/total marginal
                light_area = jnp.where(isect["is_tri"],
                                       scene.mesh_light_area, light_area)
            sel_density = 1.0 / jnp.maximum(
                light_area * jnp.maximum(scene.light_count, 1), 1e-20)
        elif cfg.light_sampling == "tree":
            # exact tree-selection pdf of THIS light as seen from the
            # previous vertex: st["o"] for a prev-NEE (diffuse/metal)
            # lane is exactly the p + eps*n the sampler used, so the
            # MIS weights sum to one bit-for-bit. The hit's light slot
            # is recovered by an unrolled (prim, kind) match over the
            # static slot axis — zero-pick padding keeps non-lights
            # (and lights NEE can't address, e.g. cluster-mesh
            # emitters) at density 0 = full BSDF weight, which is the
            # correct MIS for a light the other strategy can't sample.
            Ln = scene.light_kind.shape[0]
            clh = zero
            pick_h = zero
            for k in range(Ln):
                match = ((isect["prim"] == scene.light_prim[k])
                         & (isect["is_tri"] == (scene.light_kind[k] == 1)))
                clh = clh + jnp.where(match, scene.lt_cluster[k], 0.0)
                pick_h = pick_h + jnp.where(match, scene.lt_pick_intra[k],
                                            0.0)
            ws, wtot = _tree_cluster_weights(scene, st["o"])
            w_sel = jnp.zeros_like(wtot)
            for c in range(len(ws)):
                w_sel = w_sel + jnp.where(clh == float(c), ws[c], 0.0)
            p_cl = w_sel / jnp.maximum(wtot, 1e-30)
            sel_density = (p_cl * pick_h
                           / jnp.maximum(isect["light_area"], 1e-20))
        else:
            # power-weighted selection: pick/area = lum(Le)/total_power
            # for slot lights; the mesh pseudo-slot's marginal is its
            # pick over its TOTAL area (per-tri selection is area-CDF)
            lum_e = (0.2126 * emission[0] + 0.7152 * emission[1]
                     + 0.0722 * emission[2])
            sel_density = lum_e / jnp.maximum(scene.light_total_power,
                                              1e-20)
            if mesh_light is not None:
                sel_density = jnp.where(
                    isect["is_tri"],
                    mesh_light[13] / jnp.maximum(mesh_light[12], 1e-20),
                    sel_density)
            elif scene.has_lane_mesh_light:
                # per-lane scheme: identical pick/total_area marginal
                sel_density = jnp.where(
                    isect["is_tri"],
                    scene.mesh_light_pick
                    / jnp.maximum(scene.mesh_light_area, 1e-20),
                    sel_density)
        if scene.has_env_map and cfg.use_nee:
            # the light-table branch runs with probability 1 - env_pick;
            # the hit-side MIS density must carry the same marginal
            sel_density = sel_density * (1.0 - scene.env_pick)
        pdf_light_w = (sel_density * isect["t"] ** 2
                       / jnp.maximum(cos_l, 1e-6))
        w_b = jnp.where(
            st["prev_did_nee"] != 0.0,
            sampler.power_heuristic(st["prev_pdf"], pdf_light_w),
            1.0,
        )
        gate = jnp.where(hit & emissive, w_b, 0.0)
        st["rad"] = v3.add(st["rad"], v3.mul(st["thr"], v3.scale(emission, gate)))

        if scene.has_env_map:  # static: map-free scenes pay nothing
            # escaped rays fetch the env-map texel of their direction and
            # MIS-weight against the env NEE strategy of the PREVIOUS
            # vertex (pick * pdf_env of this direction); delta-bounce
            # lanes (prev_did_nee = 0) read it at full weight
            esc = jnp.where(alive_b & ~isect["hit"], 1.0, 0.0)
            K_env = scene.env_img.shape[0] // 3
            e_ty, e_tx = _env_texel_of(st["d"], K_env)
            e_rad = _atlas_fetch(scene.env_img, e_ty, e_tx)
            sin_t = jnp.sqrt(jnp.maximum(1.0 - st["d"][2] * st["d"][2],
                                         1e-12))
            pdf_env_h = _env_pdf_w(scene, e_ty, e_tx, sin_t)
            w_esc = jnp.where(
                (st["prev_did_nee"] != 0.0) & jnp.bool_(cfg.use_nee),
                sampler.power_heuristic(st["prev_pdf"],
                                        scene.env_pick * pdf_env_h),
                1.0)
            st["rad"] = v3.add(st["rad"],
                               v3.mul(st["thr"], v3.scale(e_rad, esc * w_esc)))

        if scene.env is not None:  # static: env-free scenes pay nothing
            # escaped rays read the gradient sky at FULL weight (the env is
            # never NEE-sampled — see scene.py `env`); the lane then dies
            # via cont = hit & ..., so this adds exactly once
            esc = jnp.where(alive_b & ~isect["hit"], 1.0, 0.0)
            tz = 0.5 * (st["d"][2] + 1.0)
            env = tuple(
                scene.env[0, c] + (scene.env[1, c] - scene.env[0, c]) * tz
                for c in range(3))
            st["rad"] = v3.add(st["rad"],
                               v3.mul(st["thr"], v3.scale(env, esc)))

        # --- NEE ------------------------------------------------------------
        if cfg.use_nee:
            u_sel = u[2]
            if scene.has_env_map:
                # one-coin split between the env map and the light table;
                # the selection uniform is rescaled into the chosen branch
                # (standard CDF reuse — no extra random number)
                pick = scene.env_pick
                sel_env = u[2] < pick
                u_sel = jnp.clip((u[2] - pick)
                                 / jnp.maximum(1.0 - pick, 1e-6),
                                 0.0, 1.0 - 1e-7)
            lp, ln, le, pdf_area = _sample_light(
                scene, u_sel, u[3], u[4], mesh_light=mesh_light,
                uniform=cfg.light_sampling == "uniform",
                # tree weights are evaluated at p + eps*n — the exact
                # origin the next segment carries in st["o"], so the
                # hit-side MIS pdf above reproduces this pdf exactly
                tree_p=(v3.add(p, v3.scale(n, cfg.eps))
                        if cfg.light_sampling == "tree" else None),
                u_tri=None if mlt_dim is None else u[mlt_dim])
            to_l = v3.sub(lp, p)
            dist = v3.length(to_l)
            wi = v3.scale(to_l, 1.0 / jnp.maximum(dist, 1e-20))
            cos_ll = jnp.abs(v3.dot(ln, wi))
            light_ok = ((scene.light_count > 0) & (cos_ll > 1e-6)
                        & (dist > cfg.eps))
            if scene.has_env_map:
                e_d, e_pdf, e_le = _sample_env(
                    scene,
                    jnp.clip(u[2] / jnp.maximum(pick, 1e-6),
                             0.0, 1.0 - 1e-7), u[3], u[4])
                wi = v3.where(sel_env, e_d, wi)
                le = v3.where(sel_env, e_le, le)
                # env lanes have no light-surface terms; their shadow
                # segment runs to the fog horizon (1e4 — the same segment
                # the escape path attenuates over), and the occlusion
                # t_max is unbounded
                light_ok = sel_env | light_ok
                dist = jnp.where(sel_env, 1e4, dist)
            cos_s = v3.dot(n, wi)

            nee_kind = kind == DIFFUSE
            if scene.has_metal:  # GGX surfaces are NEE-sampled too
                nee_kind = nee_kind | (kind == METAL)
            cand = hit & nee_kind & light_ok & (cos_s > 0.0)
            st["nrays"] = st["nrays"] + jnp.sum(cand)
            sh_o = v3.add(p, v3.scale(n, cfg.eps))
            # park non-candidate shadow rays (mirror hits, misses, dead
            # lanes) far away so they don't gate cluster work in the
            # occlusion sweep; `vis` is cand-gated, results unchanged
            dead_o = (zero + _DEAD_O, zero + _DEAD_O, zero + _DEAD_O)
            dead_d = (zero + _INV_SQRT3,) * 3
            sh_o = v3.where(cand, sh_o, dead_o)
            sh_d = v3.where(cand, wi, dead_d)
            max_t = dist * (1.0 - 1e-3)
            if scene.has_env_map:
                max_t = jnp.where(sel_env, BIG, max_t)
            blocked = _occluded(scene, sh_o, sh_d, max_t, cfg.t_min, bvh)
            vis = cand & ~blocked

            pdf_w = pdf_area * dist**2 / jnp.maximum(cos_ll, 1e-6)
            if scene.has_env_map:
                # fold each branch's selection probability into its pdf —
                # the same marginals the hit-/escape-side MIS uses
                pdf_w = jnp.where(sel_env, pick * e_pdf,
                                  (1.0 - pick) * pdf_w)
            if scene.has_metal:
                # general form: f = albedo/π (diffuse) or the GGX
                # conductor BRDF (metal); the MIS counter-pdf follows
                if scene.has_aniso:
                    f_m, pdf_m = sampler.ggx_eval_aniso(
                        n, onb_t, onb_s, v3.neg(st["d"]), wi, albedo,
                        alpha, alpha_y)
                else:
                    f_m, pdf_m = sampler.ggx_eval(n, v3.neg(st["d"]), wi,
                                                  albedo, alpha)
                is_met = kind == METAL
                pdf_b = jnp.where(is_met, pdf_m, cos_s / _PI)
                f_nee = v3.where(is_met, f_m,
                                 v3.scale(albedo, 1.0 / _PI))
                w_nee = sampler.power_heuristic(pdf_w, pdf_b)
                scale = jnp.where(
                    vis, cos_s / jnp.maximum(pdf_w, 1e-20) * w_nee, 0.0)
                if cfg.fog_density > 0.0:  # shadow segment transmittance
                    scale = scale * jnp.exp(-cfg.fog_density * dist)
                contrib = v3.mul(v3.mul(st["thr"], f_nee),
                                 v3.scale(le, scale))
            else:  # metal-free: the exact prior program (bit-identical)
                w_nee = sampler.power_heuristic(pdf_w, cos_s / _PI)
                scale = jnp.where(
                    vis, cos_s / jnp.maximum(pdf_w, 1e-20) * w_nee / _PI,
                    0.0)
                if cfg.fog_density > 0.0:  # shadow segment transmittance
                    scale = scale * jnp.exp(-cfg.fog_density * dist)
                contrib = v3.mul(v3.mul(st["thr"], albedo),
                                 v3.scale(le, scale))
            st["rad"] = v3.add(st["rad"], contrib)

        # --- scatter ----------------------------------------------------------
        diff_d, pdf_cos = sampler.cosine_hemisphere(u[0], u[1], n)
        mirr_d = v3.sub(st["d"], v3.scale(n, 2.0 * v3.dot(st["d"], n)))

        is_mirror = kind == MIRROR
        new_d = v3.where(is_mirror, mirr_d, diff_d)
        new_o = v3.add(p, v3.scale(n, cfg.eps))
        if scene.has_dielectric:  # static: glass-free scenes pay nothing
            # dielectric: exact unpolarized Fresnel split between reflection
            # and Snell refraction; one-sample R/(1-R) selection cancels the
            # Fresnel factor from throughput (see scene.py DIELECTRIC; same
            # math as integrator.py — the three integrators must agree)
            if scene.has_dispersion:
                # spectral dispersion: the first dispersive hit commits
                # the lane to one channel (3x one-hot throughput —
                # unbiased) and shifts its ior; u[1] is free on glass
                # lanes (no hemisphere sample consumed)
                M = scene.mat_albedo.shape[0]
                dispm = _sel(isect["mat_id"], scene.mat_dispersion, M)
                pick = (hit & (kind == DIELECTRIC) & (dispm > 0.0)
                        & (st["chan"] < 0.0))
                c = jnp.clip(jnp.floor(u[1] * 3.0), 0.0, 2.0)
                chan = jnp.where(pick, c, st["chan"])
                st["thr"] = tuple(
                    st["thr"][k] * jnp.where(
                        pick, 3.0 * (chan == float(k)), 1.0)
                    for k in range(3))
                st["chan"] = chan
                shift = jnp.where(chan >= 0.0, (chan - 1.0) * 0.5, 0.0)
                ior = ior + dispm * shift
            eta = jnp.where(isect["front"], 1.0 / ior, ior)
            cosi = -v3.dot(st["d"], n)  # n faces the ray: >= 0
            kk = 1.0 - eta * eta * (1.0 - cosi * cosi)
            cost = jnp.sqrt(jnp.maximum(kk, 0.0))
            rs = (eta * cosi - cost) / jnp.maximum(eta * cosi + cost, 1e-20)
            rp = (eta * cost - cosi) / jnp.maximum(eta * cost + cosi, 1e-20)
            refl_p = jnp.where(kk <= 0.0, 1.0, 0.5 * (rs * rs + rp * rp))
            refr_d = v3.add(v3.scale(st["d"], eta),
                            v3.scale(n, eta * cosi - cost))
            # u[0] doubles as the R/T coin: a dielectric lane never consumes
            # its cosine-hemisphere sample, so the streams never collide
            reflect = u[0] < refl_p
            is_diel = kind == DIELECTRIC
            diel_w = None
            if scene.has_rough_dielectric:
                # GGX rough dielectric (Walter 2007): sample an NDF
                # half-vector (u[3]/u[4] are free on glass lanes — NEE
                # never touches them), run the SAME Fresnel coin about h,
                # reflect/refract about h, and weight the path by
                # |d·h|·G/(cos_o·cos_h) — the microfacet-refraction
                # throughput for D·cos_h half-vector sampling (the
                # Fresnel factor still cancels via the coin). Smooth
                # (roughness 0) glass lanes keep the exact prior math.
                h_d, cos_hd = sampler.sample_ggx_h(u[3], u[4], n, alpha)
                cosi_h = -v3.dot(st["d"], h_d)
                kk_h = 1.0 - eta * eta * (1.0 - cosi_h * cosi_h)
                cost_h = jnp.sqrt(jnp.maximum(kk_h, 0.0))
                rs_h = ((eta * cosi_h - cost_h)
                        / jnp.maximum(eta * cosi_h + cost_h, 1e-20))
                rp_h = ((eta * cost_h - cosi_h)
                        / jnp.maximum(eta * cost_h + cosi_h, 1e-20))
                reflp_h = jnp.where(kk_h <= 0.0, 1.0,
                                    0.5 * (rs_h * rs_h + rp_h * rp_h))
                refl_h = u[0] < reflp_h
                mirr_h = sampler.reflect(st["d"], h_d)
                refr_h = v3.add(v3.scale(st["d"], eta),
                                v3.scale(h_d, eta * cosi_h - cost_h))
                d_r = v3.where(refl_h, mirr_h, refr_h)
                cos_i_r = v3.dot(d_r, n)
                g_r = (sampler.ggx_smith_g1(cosi, alpha)
                       * sampler.ggx_smith_g1(jnp.abs(cos_i_r), alpha))
                w_g = (jnp.abs(cosi_h) * g_r
                       / jnp.maximum(cosi * jnp.maximum(cos_hd, 1e-6),
                                     1e-6))
                # h must face the ray, and the outgoing direction must
                # land on its branch's side of the surface; invalid
                # samples get weight 0 (standard NDF rejection — the
                # throughput gate kills the lane, as for metal).
                ok_r = ((cosi_h > 0.0)
                        & ((refl_h & (cos_i_r > 0.0))
                           | (~refl_h & (cos_i_r < 0.0))))
                w_g = jnp.where(ok_r, w_g, 0.0)
                Mr = scene.mat_albedo.shape[0]
                rough_d = _sel(isect["mat_id"], scene.mat_rough, Mr)
                is_rough_d = is_diel & (rough_d > 0.0)
                reflect = ((is_rough_d & refl_h)
                           | (~is_rough_d & reflect))
                diel_w = jnp.where(is_rough_d, w_g, 1.0)
                mirr_d = v3.where(is_rough_d, d_r, mirr_d)   # reflect slot
                refr_d = v3.where(is_rough_d, d_r, refr_d)   # refract slot
            new_d = v3.where(is_diel, v3.where(reflect, mirr_d, refr_d),
                             new_d)
            # refracted rays continue THROUGH the surface: offset inward
            off = jnp.where(is_diel & ~reflect, -cfg.eps, cfg.eps)
            new_o = v3.add(p, v3.scale(n, off))
        if scene.has_metal:  # static: metal-free scenes pay nothing
            # GGX conductor: sample an NDF half-vector (u[0]/u[1] are free
            # on metal lanes — no cosine-hemisphere sample, the same
            # non-collision argument as the dielectric R/T coin), reflect,
            # and weight by f·cos/pdf. Under-surface samples get f=pdf=0
            # from ggx_eval, so their throughput dies at the cont gate —
            # the standard NDF-sampling rejection, consistent across all
            # engines.
            if scene.has_aniso:
                h_vec = sampler.sample_ggx_h_aniso(u[0], u[1], onb_t,
                                                   onb_s, n, alpha, alpha_y)
                met_d = sampler.reflect(st["d"], h_vec)
                f_s, pdf_s = sampler.ggx_eval_aniso(
                    n, onb_t, onb_s, v3.neg(st["d"]), met_d, albedo,
                    alpha, alpha_y)
            else:
                h_vec, _ = sampler.sample_ggx_h(u[0], u[1], n, alpha)
                met_d = sampler.reflect(st["d"], h_vec)
                f_s, pdf_s = sampler.ggx_eval(n, v3.neg(st["d"]), met_d,
                                              albedo, alpha)
            w_met = v3.scale(
                f_s, jnp.where(pdf_s > 0.0,
                               v3.dot(n, met_d)
                               / jnp.maximum(pdf_s, 1e-12), 0.0))
            is_metal = kind == METAL
            new_d = v3.where(is_metal, met_d, new_d)
            w_mat = v3.where(is_metal, w_met, albedo)
            new_thr = v3.mul(st["thr"], w_mat)
            pdf_bsdf = jnp.where(is_metal, pdf_s, pdf_cos)
        else:
            new_thr = v3.mul(st["thr"], albedo)
            pdf_bsdf = pdf_cos
        if scene.has_rough_dielectric:  # Walter weight on rough-glass lanes
            new_thr = v3.scale(new_thr, diel_w)

        cont = hit & (
            jnp.maximum(new_thr[0], jnp.maximum(new_thr[1], new_thr[2])) > 0.0
        )
        if cfg.rr_start > 0:  # static: RR-off keeps the 5-plane stream
            # Russian roulette: survive w.p. p, divide throughput by p —
            # E[thr] unchanged (unbiased); same math as integrator.py
            p_c = jnp.clip(
                jnp.maximum(new_thr[0],
                            jnp.maximum(new_thr[1], new_thr[2])), 0.05, 1.0)
            rr_on = jnp.bool_(b >= cfg.rr_start)
            cont = cont & (~rr_on | (u[5] < p_c))
            inv_p = jnp.where(rr_on, 1.0 / p_c, 1.0)
            new_thr = v3.scale(new_thr, inv_p)
        st["thr"] = v3.where(cont, new_thr, (zero, zero, zero))
        # park dead rays far away with an all-positive direction: every slab
        # test then fails (all t < 0), so dead lanes stop dragging cluster /
        # triangle work into their tile's sweep. Their results are already
        # gated by `alive`; only the wasted work disappears.
        dead_o = (zero + _DEAD_O, zero + _DEAD_O, zero + _DEAD_O)
        dead_d = (zero + _INV_SQRT3, zero + _INV_SQRT3, zero + _INV_SQRT3)
        st["o"] = v3.where(cont, new_o, dead_o)
        st["d"] = v3.where(cont, new_d, dead_d)
        st["alive"] = jnp.where(cont, 1.0, 0.0)
        nee_kinds = kind == DIFFUSE
        if scene.has_metal:
            nee_kinds = nee_kinds | (kind == METAL)
        # the env map is an NEE target too: a vertex with no slot lights
        # still "did NEE" when a map exists, so the next segment's
        # emission/escape reads get MIS-weighted, not full weight
        nee_avail = (jnp.bool_(True) if scene.has_env_map
                     else scene.light_count > 0)
        did_nee = hit & nee_kinds & nee_avail & jnp.bool_(cfg.use_nee)
        st["prev_did_nee"] = jnp.where(did_nee, 1.0, 0.0)
        st["prev_pdf"] = pdf_bsdf

        return st

    st = lax.fori_loop(0, cfg.max_bounces + 1, bounce, st)
    return st["rad"], st["nrays"]


def trace_pass_soa(cfg: PTConfig, scene: PTScene, cam_pos, cam_quat, key=None,
                   bvh=None, row0=0, band_h=None, col0=0, band_w=None,
                   seed0=None, mesh_light=None, gpass=None, seed_base=None):
    """One sample per pixel. Returns ((h, w, 3) image, nrays) — see
    _trace_core for the window semantics."""
    rad, nrays = _trace_core(cfg, scene, cam_pos, cam_quat, key, bvh, row0,
                             band_h, col0, band_w, seed0,
                             mesh_light=mesh_light, gpass=gpass,
                             seed_base=seed_base)
    return jnp.stack([rad[0], rad[1], rad[2]], axis=-1), nrays


@partial(jax.jit, static_argnums=(0, 4))
def render_pt_fast(cfg: PTConfig, scene: PTScene, cam_pos, cam_quat, spp: int,
                   key=None, bvh=None, spp_offset=0):
    """SoA render: average spp passes (same sample stream as render_pt)."""
    if key is None:
        key = random.PRNGKey(0)

    from raytracing_engine_tpu.ops.rng_pcg import key_to_seed

    def _mlt(i):
        if not scene.has_mesh_light:
            return None
        from raytracing_engine_tpu.pathtracer.scene import mesh_light_rows

        row = mesh_light_rows(scene, key_to_seed(key), spp_offset + i)[0]
        return tuple(row[c] for c in range(14))

    if cfg.rng == "pcg":
        # derive one base seed; pass i's stream = base + global_pass * prime
        base = key_to_seed(key)

        def body(i, carry):
            acc, nrays = carry
            seed_pass = base + (spp_offset + i) * jnp.int32(-1640531527)
            img, nr = trace_pass_soa(cfg, scene, cam_pos, cam_quat, None,
                                     bvh=bvh, seed0=seed_pass,
                                     mesh_light=_mlt(i),
                                     gpass=spp_offset + i, seed_base=base)
            return acc + img, nrays + nr
    else:
        def body(i, carry):
            acc, nrays = carry
            img, nr = trace_pass_soa(cfg, scene, cam_pos, cam_quat,
                                     random.fold_in(key, spp_offset + i),
                                     bvh=bvh, mesh_light=_mlt(i))
            return acc + img, nrays + nr

    acc, nrays = lax.fori_loop(
        0, spp, body,
        (jnp.zeros((cfg.height, cfg.width, 3), jnp.float32), jnp.float32(0.0)),
    )
    return acc / spp, nrays
