"""Pallas shading kernel — Phong + sphere-traced soft shadows.

Block-local re-design of reference shaders/fragment.glsl:127-187 (a
per-pixel fragment shader): each program owns one block of pixels,
reconstructs the hit point from the finest depth level, picks the nearest
object (materials paired by index — :148-156) with an unrolled argmin over
scalar sphere params, then runs one shadow march per light slot (:89-121,
dead lights exit immediately via end=0) that stops when the block's own
rays are done. Output is planar (3, H, W).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from raytracing_engine_tpu.config import (
    CAM_FALL_OFF,
    LIGHT_FALL_OFF,
    MAX_LIGHTS,
    MAX_OBJECTS,
    RAY_RADIUS,
    RenderConfig,
)
from raytracing_engine_tpu.ops.pallas.common import (
    any_true,
    dead_slot_mask,
    pad_to,
    read_rows,
    resolve_interpret,
    sphere_sdf_plane,
    triton_call,
    whole,
)
from raytracing_engine_tpu.ops.pallas.depth import (
    block_dims,
    block_rays,
    padded_dims,
    scene_tables,
)


def _shadow_march_tile(ox, oy, oz, dx, dy, dz, end, objs, obj_count,
                       render_dist, max_steps, masked=True):
    """fragment.glsl:89-121 on planes; returns the soft-shadow factor.
    objs: list of (cx, cy, cz, radius) scalars (see depth._march_tile)."""
    big = jnp.float32(render_dist)
    ray_r = jnp.float32(RAY_RADIUS)

    live = dead_slot_mask(obj_count, big, masked)

    cache0 = tuple(live(k, sphere_sdf_plane(ox, oy, oz, cx, cy, cz, cr))
                   for k, (cx, cy, cz, cr) in enumerate(objs))
    zeros = jnp.zeros_like(ox)
    # `occluded` carried as an f32 0/1 plane
    state0 = (zeros, zeros, zeros + 1.0, zeros, jnp.int32(0), cache0)

    def cond(state):
        length, last, nearest, occluded, it, cache = state
        return (it < max_steps) & any_true((occluded == 0.0) & (length < end))

    def body(state):
        length, last, nearest, occluded, it, cache = state
        active = (occluded == 0.0) & (length < end)

        px = ox + dx * length
        py = oy + dy * length
        pz = oz + dz * length

        dist = end
        new_cache = []
        for k, (cx, cy, cz, cr) in enumerate(objs):
            bound = cache[k] - last
            ddx = px - cx
            ddy = py - cy
            ddz = pz - cz
            fresh = jnp.sqrt(ddx * ddx + ddy * ddy + ddz * ddz) - cr
            upd = live(k, jnp.where(bound <= nearest, fresh, bound))
            new_cache.append(upd)
            dist = jnp.minimum(dist, upd)

        hit = dist <= ray_r
        new_last = jnp.maximum(dist, 0.0)
        new_nearest = jnp.minimum(nearest, dist)
        new_length = length + new_last + ray_r

        advance = active & ~hit
        length = jnp.where(advance, new_length, length)
        last = jnp.where(advance, new_last, last)
        nearest = jnp.where(advance, new_nearest, nearest)
        cache = tuple(
            jnp.where(active, nc, oc) for nc, oc in zip(new_cache, cache)
        )
        occluded = jnp.where(active & hit, 1.0, occluded)
        return (length, last, nearest, occluded, it + 1, cache)

    _, _, nearest, occluded, _, _ = jax.lax.while_loop(cond, body, state0)
    return jnp.where(occluded != 0.0, 0.0, nearest)


def shade_tile_planes(dx, dy, dz, depth, cam_x, cam_y, cam_z,
                      objs, mats, lights, obj_count, light_count,
                      render_dist, max_steps, masked):
    """Phong + soft-shadow shading of one block given ray dirs and depth.
    objs/mats/lights: per-slot scalar rows (read_rows). Returns (r, g, b)
    planes. Shared by the standalone shade kernel and the fused
    finest-depth+shade kernel (ops/pallas/fused.py)."""
    big = jnp.float32(render_dist)
    hit_mask = depth < big  # fragment.glsl:137-140

    px = cam_x + dx * depth
    py = cam_y + dy * depth
    pz = cam_z + dz * depth

    # nearest object + index-paired material — fragment.glsl:144-156
    best = jnp.full_like(depth, jnp.inf)
    ox_b = jnp.zeros_like(depth)
    oy_b = jnp.zeros_like(depth)
    oz_b = jnp.zeros_like(depth)
    m_r = jnp.zeros_like(depth)
    m_g = jnp.zeros_like(depth)
    m_b = jnp.zeros_like(depth)
    m_shine = jnp.zeros_like(depth)
    m_amb = jnp.zeros_like(depth)
    for k, ((cx, cy, cz, cr), mat) in enumerate(zip(objs, mats)):
        ddx = px - cx
        ddy = py - cy
        ddz = pz - cz
        d = jnp.sqrt(ddx * ddx + ddy * ddy + ddz * ddz) - cr
        take = (d < best) & (k < obj_count) if masked else (d < best)
        best = jnp.where(take, d, best)
        ox_b = jnp.where(take, cx, ox_b)
        oy_b = jnp.where(take, cy, oy_b)
        oz_b = jnp.where(take, cz, oz_b)
        m_r = jnp.where(take, mat[0], m_r)
        m_g = jnp.where(take, mat[1], m_g)
        m_b = jnp.where(take, mat[2], m_b)
        m_shine = jnp.where(take, mat[5], m_shine)
        m_amb = jnp.where(take, mat[6], m_amb)

    # camera falloff — fragment.glsl:162-163
    cdx = px - cam_x
    cdy = py - cam_y
    cdz = pz - cam_z
    cam_dist2 = cdx * cdx + cdy * cdy + cdz * cdz
    cam_fall = jnp.maximum(CAM_FALL_OFF * (cam_dist2 + 1.0), 1.0)

    # normal + falloff — fragment.glsl:166-167
    nx = px - ox_b
    ny = py - oy_b
    nz = pz - oz_b
    nlen = jnp.sqrt(nx * nx + ny * ny + nz * nz)
    nx, ny, nz = nx / nlen, ny / nlen, nz / nlen
    normal_fall = jnp.maximum(nx * -dx + ny * -dy + nz * -dz, 0.0)

    col_r = jnp.zeros_like(depth)
    col_g = jnp.zeros_like(depth)
    col_b = jnp.zeros_like(depth)
    for li, (lx, ly, lz, _, lr, lg, lb, _) in enumerate(lights):
        live = (li < light_count) if masked else True

        tlx = lx - px
        tly = ly - py
        tlz = lz - pz
        light_dist = jnp.sqrt(tlx * tlx + tly * tly + tlz * tlz)
        ldx, ldy, ldz = tlx / light_dist, tly / light_dist, tlz / light_dist

        # dead lights / missed rays: end=0 -> the march exits instantly
        end = jnp.where(live & hit_mask, light_dist, 0.0)
        soft = _shadow_march_tile(
            px + ldx, py + ldy, pz + ldz,  # +1.0 offset — fragment.glsl:176
            ldx, ldy, ldz, end, objs, obj_count, render_dist, max_steps,
            masked,
        )
        soft = jnp.minimum(soft, 1.0)

        light_fall = jnp.maximum(LIGHT_FALL_OFF * light_dist * light_dist, 1.0)
        diffuse = jnp.maximum(nx * ldx + ny * ldy + nz * ldz, 0.0)
        # reflect(-l, n) = -l - 2*dot(n,-l)*n
        dln = nx * -ldx + ny * -ldy + nz * -ldz
        rx = -ldx - 2.0 * dln * nx
        ry = -ldy - 2.0 * dln * ny
        rz = -ldz - 2.0 * dln * nz
        base = jnp.maximum(rx * -dx + ry * -dy + rz * -dz, 0.0)
        spec = jnp.maximum(diffuse * jnp.power(base, m_shine), 0.0)

        ds = jnp.maximum(diffuse + spec, 0.0) / light_fall * soft
        scale = 1.0 / cam_fall * normal_fall
        if masked:
            scale = jnp.where(live, scale, 0.0)
        col_r += (m_amb + ds * lr) * scale * m_r
        col_g += (m_amb + ds * lg) * scale * m_g
        col_b += (m_amb + ds * lb) * scale * m_b

    return (jnp.where(hit_mask, col_r, 0.0),
            jnp.where(hit_mask, col_g, 0.0),
            jnp.where(hit_mask, col_b, 0.0))


def shade_tables(scene):
    """(mat (MAX_MATERIALS, 8), light (MAX_LIGHTS, 8)) scalar tables.
    mat row: [r, g, b, diffuse, specular, shine, ambient, pad];
    light row: [px, py, pz, pad, r, g, b, pad]."""
    mat = jnp.concatenate(
        [
            scene.mat_color,
            scene.mat_diffuse[:, None],
            scene.mat_specular[:, None],
            scene.mat_shine[:, None],
            scene.mat_ambient[:, None],
            jnp.zeros((scene.mat_color.shape[0], 1), jnp.float32),
        ],
        axis=1,
    ).astype(jnp.float32)
    zero = jnp.zeros((scene.light_pos.shape[0], 1), jnp.float32)
    light = jnp.concatenate(
        [scene.light_pos, zero, scene.light_color, zero], axis=1
    ).astype(jnp.float32)
    return mat, light


def _shade_kernel(params_ref, count_ref, obj_ref, mat_ref, light_ref,
                  depth_ref, out_ref, *, block_h, block_w, render_dist,
                  max_steps, n_obj=MAX_OBJECTS, n_light=MAX_LIGHTS,
                  masked=True):
    (cx, cy, cz), (dx, dy, dz) = block_rays(params_ref, block_h, block_w)
    r, g, b = shade_tile_planes(
        dx, dy, dz, depth_ref[...], cx, cy, cz,
        read_rows(obj_ref, n_obj, 4), read_rows(mat_ref, n_obj, 8),
        read_rows(light_ref, n_light, 8), count_ref[0], count_ref[1],
        render_dist, max_steps, masked,
    )
    out_ref[0] = r
    out_ref[1] = g
    out_ref[2] = b


def planar_block(bh: int, bw: int):
    """(3, bh, bw) output block of a planar RGB image."""
    return pl.BlockSpec((3, bh, bw), lambda i, j: (0, i, j))


@functools.partial(jax.jit, static_argnames=("cfg", "interpret", "n_obj", "n_light"))
def shade_pallas(cfg: RenderConfig, scene, cam_pos, cam_quat, depth,
                 interpret=None, n_obj=None, n_light=None):
    """Shade the finest depth level. Returns (H, W, 3) float32.

    n_obj/n_light: STATIC counts — specialize the kernel to exactly the
    live slots (no dead-slot masking, no dead shadow loops); None = generic
    masked kernel. Both must be given together for the unmasked path.
    """
    h, w = cfg.height, cfg.width
    bh, bw = block_dims(h, w, cfg.tile_h, cfg.tile_w)
    hp, wp = padded_dims(h, w, bh, bw)
    params, counts, obj = scene_tables(cfg, cfg.level_count - 1, scene,
                                       cam_pos, cam_quat)
    mat, light = shade_tables(scene)

    static = n_obj is not None and n_light is not None
    kernel = functools.partial(
        _shade_kernel,
        block_h=bh,
        block_w=bw,
        render_dist=cfg.render_dist,
        max_steps=cfg.max_shadow_steps,
        n_obj=n_obj if static else MAX_OBJECTS,
        n_light=n_light if static else MAX_LIGHTS,
        masked=not static,
    )
    out = triton_call(
        kernel,
        out_shape=jax.ShapeDtypeStruct((3, hp, wp), jnp.float32),
        grid=(hp // bh, wp // bw),
        in_specs=[whole(params.shape), whole(counts.shape), whole(obj.shape),
                  whole(mat.shape), whole(light.shape),
                  pl.BlockSpec((bh, bw), lambda i, j: (i, j))],
        out_specs=planar_block(bh, bw),
        interpret=resolve_interpret(interpret),
        name="conemarch_shade",
    )(params, counts, obj, mat, light, pad_to(depth, (hp, wp)))
    return jnp.moveaxis(out[:, :h, :w], 0, -1)
