"""Shaded rendering of instanced scenes (BASELINE config 5).

The reference shades everything it draws (/root/reference/shaders/
fragment.glsl:127-187: per-light diffuse + specular + ambient with
sphere-traced shadows); this module gives the instanced cluster path the
same treatment: the attrs-emitting instanced kernel returns (t, code,
world normal), instance materials resolve with a small select chain
(code // padded_tris -> instance -> material), lighting is reference-style
Blinn/Phong planes math, and shadows come from a second any-hit launch of
the same instanced kernel toward the light.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from raytracing_engine_tpu.ops.pallas.instanced_intersect import (
    instanced_cluster_intersect,
)


def _sel(idx, table, n):
    out = jnp.zeros_like(idx, dtype=table.dtype) * table[0]
    for k in range(n):
        out = jnp.where(idx == k, table[k], out)
    return out


def instanced_camera_rays(cam_pos, yaw, width, height, fov=1.0, row0=0,
                          band_h=None):
    """Pinhole camera rays of the instanced frame as (o, d) plane triples:
    position + yaw about +Z looking +Y (reference convention,
    src/main.rs:402-414). row0/band_h select a horizontal band."""
    bh = band_h or height
    iy = jax.lax.broadcasted_iota(jnp.int32, (bh, width), 0) + row0
    ix = jax.lax.broadcasted_iota(jnp.int32, (bh, width), 1)
    ncx = ((ix.astype(jnp.float32) + 0.5) * 2.0 / width - 1.0) * fov
    ncy = ((iy.astype(jnp.float32) + 0.5) * 2.0 / height - 1.0) * (
        fov * height / width)

    cy, sy = jnp.cos(yaw), jnp.sin(yaw)
    dx = ncx * cy - sy
    dy = ncx * sy + cy
    dz = ncy
    inv = 1.0 / jnp.sqrt(dx * dx + dy * dy + dz * dz)
    d = (dx * inv, dy * inv, dz * inv)
    o = tuple(jnp.broadcast_to(cam_pos[i], d[0].shape) + 0.0 * d[0]
              for i in range(3))
    return o, d


@partial(jax.jit, static_argnames=("width", "height", "shadows", "interpret",
                                   "fov", "shadow_samples", "light_radius",
                                   "band_h"))
def render_instanced_phong(inst_tab, cs, inst_mat, mat_albedo,
                           cam_pos, yaw, light_pos,
                           width=1920, height=1088, fov=1.0,
                           light_color=(300.0, 300.0, 290.0),
                           ambient=0.08, shininess=32.0, eps=1e-2,
                           shadows=True, interpret=None,
                           light_radius=0.0, shadow_samples=1, seed=0,
                           sample_offset=0, row0=0, band_h=None):
    """Phong-shaded frame of an instanced scene: (H, W, 3) f32.

    inst_tab: pack_instances(...); cs: the base-mesh ClusterSet;
    inst_mat: (N,) int32 per-instance material id; mat_albedo: (M, 3).
    Camera: position + yaw about +Z looking +Y (reference convention,
    src/main.rs:402-414). Lighting follows fragment.glsl:162-185 semantics:
    diffuse = max(dot(n,l),0), Blinn specular, 0.01*d^2 light falloff,
    camera-distance falloff, ambient.

    Shadows: one any-hit instanced launch per shadow sample. The
    reference's penumbrae come from sphere tracing an SDF
    (shaders/utilities.glsl shadowRay) — triangles have no distance field,
    so the triangle-native analog is AREA-light sampling: with
    light_radius > 0 and shadow_samples = N, visibility is averaged over N
    pcg-jittered points on the light sphere (deterministic per pixel for a
    given seed; N any-hit launches). light_radius=0 is the hard-shadow
    fast path; any positive radius samples the area light, even at N=1.

    row0/band_h: render only a horizontal band (the multi-chip sharded
    form renders one band per device — parallel/instanced_sharding.py).
    The camera projection and the shadow-sample RNG stay keyed on FULL
    image coordinates, so band renders are bit-identical to the same rows
    of the full-image render.
    """
    bh = band_h or height
    o, d = instanced_camera_rays(cam_pos, yaw, width, height, fov, row0,
                                 band_h)

    t, code, nx, ny, nz = instanced_cluster_intersect(
        inst_tab, cs, o, d, attrs=True, interpret=interpret, origin=cam_pos)
    hit = code >= 0

    nl = jnp.maximum(jnp.sqrt(nx * nx + ny * ny + nz * nz), 1e-20)
    nx, ny, nz = nx / nl, ny / nl, nz / nl
    flip = jnp.where(nx * d[0] + ny * d[1] + nz * d[2] > 0.0, -1.0, 1.0)
    nx, ny, nz = nx * flip, ny * flip, nz * flip

    px = o[0] + d[0] * jnp.where(hit, t, 0.0)
    py = o[1] + d[1] * jnp.where(hit, t, 0.0)
    pz = o[2] + d[2] * jnp.where(hit, t, 0.0)

    n_inst = inst_tab.shape[0]
    inst_id = jnp.where(hit, code // cs.padded_tris, 0)
    mat_id = _sel(inst_id, inst_mat, n_inst)
    M = mat_albedo.shape[0]
    alb = (_sel(mat_id, mat_albedo[:, 0], M),
           _sel(mat_id, mat_albedo[:, 1], M),
           _sel(mat_id, mat_albedo[:, 2], M))

    lx = light_pos[0] - px
    ly = light_pos[1] - py
    lz = light_pos[2] - pz
    ldist = jnp.sqrt(lx * lx + ly * ly + lz * lz)
    linv = 1.0 / jnp.maximum(ldist, 1e-20)
    lx, ly, lz = lx * linv, ly * linv, lz * linv

    ndotl = jnp.maximum(nx * lx + ny * ly + nz * lz, 0.0)
    # Blinn half-vector spec (view dir = -d)
    hx, hy, hz = lx - d[0], ly - d[1], lz - d[2]
    hn = jnp.maximum(jnp.sqrt(hx * hx + hy * hy + hz * hz), 1e-20)
    spec = jnp.maximum((nx * hx + ny * hy + nz * hz) / hn, 0.0) ** shininess
    spec = jnp.where(ndotl > 0.0, spec, 0.0)

    if shadows:
        # park lanes whose lighting can't change with occlusion — misses
        # AND back-facing hits (ndotl <= 0 zeroes both diffuse and spec, so
        # `lit` is irrelevant there): the sentinel origin fails every slab
        # test and seeds the any-hit early-exit (see instanced_intersect /
        # cluster_sweep), so these lanes stop dragging cluster work
        cand = hit & (ndotl > 0.0)
        dead = jnp.float32(1e18)
        so = (jnp.where(cand, px + nx * eps, dead),
              jnp.where(cand, py + ny * eps, dead),
              jnp.where(cand, pz + nz * eps, dead))

        def occluded(sdir, sdist):
            # near-to-far from the camera ~ near the shadowed surfaces:
            # finds occluders sooner so the any-hit gate kills lanes earlier
            _, scode = instanced_cluster_intersect(
                inst_tab, cs, so, sdir, any_hit=True,
                t_max=sdist * (1.0 - 1e-3), interpret=interpret,
                origin=cam_pos)
            return jnp.where(scode >= 0, 0.0, 1.0)

        # any positive light_radius takes the area-sampling path, even with
        # a single sample — so a sharded render whose samples axis leaves
        # local shadow_samples == 1 still draws its jittered slice of the
        # global sample set instead of degrading to the hard central ray
        if light_radius > 0.0:
            from raytracing_engine_tpu.ops.rng_pcg import uniform_pcg

            vis = jnp.zeros_like(ldist)
            for s in range(shadow_samples):
                # sample_offset shifts the draw counter so a sharded
                # render's devices each take a slice of the SAME global
                # sample set (parallel/instanced_sharding.py)
                u1, u2 = uniform_pcg(jnp.int32(seed),
                                     jnp.int32(sample_offset) + s, 2, bh,
                                     width, row0=row0)
                z = 1.0 - 2.0 * u1
                rr = jnp.sqrt(jnp.maximum(1.0 - z * z, 0.0))
                phi = 2.0 * np.pi * u2
                sx = light_pos[0] + light_radius * rr * jnp.cos(phi) - px
                sy_ = light_pos[1] + light_radius * rr * jnp.sin(phi) - py
                sz = light_pos[2] + light_radius * z - pz
                sdist = jnp.sqrt(sx * sx + sy_ * sy_ + sz * sz)
                sinv = 1.0 / jnp.maximum(sdist, 1e-20)
                vis = vis + occluded((sx * sinv, sy_ * sinv, sz * sinv),
                                     sdist)
            lit = vis / shadow_samples
        else:
            lit = occluded((lx, ly, lz), ldist)
    else:
        lit = 1.0

    # fragment.glsl:162-185 falloffs
    light_fall = jnp.maximum(0.01 * ldist * ldist, 1.0)
    cam_fall = jnp.maximum(0.01 * (t * t + 1.0), 1.0)
    cam_fall = jnp.where(hit, cam_fall, 1.0)
    norm_fall = jnp.maximum(-(nx * d[0] + ny * d[1] + nz * d[2]), 0.0)

    out = []
    for ch, lc in zip(alb, light_color):
        c = (ambient + (ndotl + spec) * lc / light_fall * lit) \
            / cam_fall * norm_fall * ch
        out.append(jnp.where(hit, c, 0.0))
    return jnp.stack(out, axis=-1)
