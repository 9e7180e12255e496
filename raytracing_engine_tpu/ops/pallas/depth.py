"""Pallas depth kernel — one pyramid level of algorithm-3 cone marching.

Block-local re-design of reference shaders/compute.glsl:34-87, which runs
one thread per pixel in 8x8 workgroups, each thread marching until its own
ray converges:

- each Triton program owns one (block_h, block_w) block of pixels; the
  march state lives in registers and the block's `while_loop` stops as soon
  as all of its own pixels have converged — unlike the whole-image XLA loop
  (models/conemarch.py), which iterates until the worst pixel of the frame
  converges and writes the per-pixel state back to memory every iteration;
- the <= MAX_OBJECTS spheres are unrolled at compile time, their centers
  read once as scalars — the lazy algorithm-3 cache becomes per-object
  bound planes + selects;
- the coarse-to-fine seed (compute.glsl:79-82) arrives as a pre-upsampled
  full-res seed image (the 2x-nearest upsample is a cheap XLA gather
  between kernels), so the kernel is uniform across levels.

Level sizes need not divide into blocks (1080p has 120x72 and 240x136
levels): the wrapper pads the seed up to whole blocks and crops the result.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from raytracing_engine_tpu.config import MAX_OBJECTS, RenderConfig
from raytracing_engine_tpu.ops.pallas.common import (
    any_true,
    block2d,
    cdiv,
    dead_slot_mask,
    pad_to,
    ray_dir_planes,
    read_rows,
    resolve_interpret,
    sphere_sdf_plane,
    tile_pixel_planes,
    triton_call,
    whole,
)


def block_dims(h: int, w: int, block_h: int, block_w: int):
    """Power-of-two block no larger than the (power-of-two-rounded) image."""
    bh = min(block_h, 1 << max(h - 1, 0).bit_length())
    bw = min(block_w, 1 << max(w - 1, 0).bit_length())
    return bh, bw


def padded_dims(h: int, w: int, bh: int, bw: int):
    return cdiv(h, bh) * bh, cdiv(w, bw) * bw


def _march_tile(ox, oy, oz, dx, dy, dz, threshold, objs, obj_count,
                render_dist, max_steps, masked=True):
    """Algorithm-3 cone march on one block; returns the marched-length plane.

    objs: list of (cx, cy, cz, radius) scalars, one per unrolled slot.
    masked: mask slots >= obj_count (generic kernel); False when the caller
    specialised the kernel to exactly the live slots."""
    big = jnp.float32(render_dist)

    live = dead_slot_mask(obj_count, big, masked)

    cache0 = tuple(live(k, sphere_sdf_plane(ox, oy, oz, cx, cy, cz, cr))
                   for k, (cx, cy, cz, cr) in enumerate(objs))
    zeros = jnp.zeros_like(ox)
    state0 = (zeros, zeros, zeros, jnp.int32(0), cache0)

    def cond(state):
        length, last, done, it, cache = state
        return (it < max_steps) & any_true((done == 0.0) & (length < big))

    def body(state):
        length, last, done, it, cache = state
        active = (done == 0.0) & (length < big)

        px = ox + dx * length
        py = oy + dy * length
        pz = oz + dz * length
        radius = (length + 1.0) * threshold

        dist = big
        new_cache = []
        for k, (cx, cy, cz, cr) in enumerate(objs):
            bound = cache[k] - last
            # re-evaluate the true SDF only where the 1-Lipschitz lower
            # bound dips to the cone radius — compute.glsl:51-57
            ddx = px - cx
            ddy = py - cy
            ddz = pz - cz
            fresh = jnp.sqrt(ddx * ddx + ddy * ddy + ddz * ddz) - cr
            upd = live(k, jnp.where(bound <= radius, fresh, bound))
            new_cache.append(upd)
            dist = jnp.minimum(dist, upd)

        new_last = jnp.maximum(dist, 0.0)
        new_length = length + new_last
        hit = dist <= radius
        new_length = jnp.where(hit, new_length - radius, new_length)

        length = jnp.where(active, new_length, length)
        last = jnp.where(active, new_last, last)
        cache = tuple(
            jnp.where(active, nc, oc) for nc, oc in zip(new_cache, cache)
        )
        done = jnp.where(active & hit, 1.0, done)
        return (length, last, done, it + 1, cache)

    length, _, _, _, _ = jax.lax.while_loop(cond, body, state0)
    return length


def block_rays(params_ref, block_h, block_w):
    """Camera position, quaternion and per-pixel ray directions of this
    program's block. params: [pos(3), quat(4), imageSize(2), ratio(2), ...]."""
    cam = (params_ref[0], params_ref[1], params_ref[2])
    qx, qy, qz, qw = (params_ref[3], params_ref[4], params_ref[5], params_ref[6])
    img_sx, img_sy = params_ref[7], params_ref[8]
    ratio_x, ratio_y = params_ref[9], params_ref[10]
    rows, cols = tile_pixel_planes(
        (pl.program_id(0) * block_h).astype(jnp.float32),
        (pl.program_id(1) * block_w).astype(jnp.float32), block_h, block_w)
    # normCoord = ((id*2+1)*imageSize - 1) * ratio — compute.glsl:71-72
    ncx = ((cols * 2.0 + 1.0) * img_sx - 1.0) * ratio_x
    ncy = ((rows * 2.0 + 1.0) * img_sy - 1.0) * ratio_y
    return cam, ray_dir_planes(ncx, ncy, qx, qy, qz, qw)


def _depth_kernel(params_ref, count_ref, obj_ref, seed_ref, out_ref,
                  *, block_h, block_w, render_dist, max_steps,
                  n_obj=MAX_OBJECTS, masked=True):
    (cx, cy, cz), (dx, dy, dz) = block_rays(params_ref, block_h, block_w)
    threshold = params_ref[11]
    objs = read_rows(obj_ref, n_obj, 4)

    seed = seed_ref[...]
    length = _march_tile(
        cx + dx * seed, cy + dy * seed, cz + dz * seed, dx, dy, dz,
        threshold, objs, count_ref[0], render_dist, max_steps, masked,
    )
    out_ref[...] = jnp.maximum(seed + length, 0.0)  # compute.glsl:86


def scene_tables(cfg: RenderConfig, level: int, scene, cam_pos, cam_quat):
    """(params (12,), counts (2,) int32, obj (MAX_OBJECTS, 4)) of a level."""
    img_s = cfg.level_image_size(level)
    params = jnp.concatenate([
        jnp.asarray(cam_pos, jnp.float32),
        jnp.asarray(cam_quat, jnp.float32),
        jnp.array([img_s[0], img_s[1], cfg.ratio[0], cfg.ratio[1],
                   cfg.level_threshold(level)], jnp.float32),
    ])
    counts = jnp.stack([scene.obj_count, scene.light_count]).astype(jnp.int32)
    obj = jnp.concatenate(
        [scene.obj_pos, scene.obj_radius[:, None]], axis=1
    ).astype(jnp.float32)  # (MAX_OBJECTS, 4)
    return params, counts, obj


@functools.partial(
    jax.jit,
    static_argnames=("cfg", "level", "interpret", "n_obj"),
)
def depth_level_pallas(cfg: RenderConfig, level: int, scene, cam_pos, cam_quat,
                       seed, interpret=None, n_obj=None):
    """One depth level. seed: (h, w) full-res seed depths (ones at level 0,
    else the 2x-nearest upsample of the previous level). Returns (h, w).

    n_obj: STATIC object count — when the caller knows the live count
    (host-side scenes always do), the kernel unrolls exactly that many
    spheres with no dead-slot masking; None keeps the generic masked kernel.
    """
    w, h = cfg.level_dims[level]
    bh, bw = block_dims(h, w, cfg.tile_h, cfg.tile_w)
    hp, wp = padded_dims(h, w, bh, bw)
    params, counts, obj = scene_tables(cfg, level, scene, cam_pos, cam_quat)

    kernel = functools.partial(
        _depth_kernel,
        block_h=bh,
        block_w=bw,
        render_dist=cfg.render_dist,
        max_steps=cfg.max_march_steps,
        n_obj=MAX_OBJECTS if n_obj is None else n_obj,
        masked=n_obj is None,
    )
    blk = block2d(bh, bw)
    out = triton_call(
        kernel,
        out_shape=jax.ShapeDtypeStruct((hp, wp), jnp.float32),
        grid=(hp // bh, wp // bw),
        in_specs=[whole(params.shape), whole(counts.shape), whole(obj.shape),
                  blk],
        out_specs=blk,
        interpret=resolve_interpret(interpret),
        name=f"conemarch_depth_l{level}",
    )(params, counts, obj, pad_to(seed, (hp, wp)))
    return out[:h, :w]


def upsample_seed(prev_depth, h: int, w: int):
    """Nearest 2x upsample: seed[y, x] = prev[y//2, x//2] — compute.glsl:81."""
    rows = jnp.arange(h) // 2
    cols = jnp.arange(w) // 2
    return prev_depth[rows][:, cols]
