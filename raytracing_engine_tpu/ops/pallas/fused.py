"""Fused finest-depth + shade kernel.

The finest pyramid level and the shading pass share the same block, the
same ray directions, and the same scene tables; running them as separate
kernels costs a launch, a full-resolution depth round trip through device
memory, and a duplicate ray-gen. This kernel marches the finest level from
its seed and shades in registers — the same output as the two-kernel
pipeline (enforced by test).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from raytracing_engine_tpu.config import MAX_LIGHTS, MAX_OBJECTS, RenderConfig
from raytracing_engine_tpu.ops.pallas.common import (
    pad_to,
    read_rows,
    resolve_interpret,
    triton_call,
    whole,
)
from raytracing_engine_tpu.ops.pallas.depth import (
    _march_tile,
    block_dims,
    block_rays,
    padded_dims,
    scene_tables,
)
from raytracing_engine_tpu.ops.pallas.shade import (
    planar_block,
    shade_tables,
    shade_tile_planes,
)


def _fused_kernel(params_ref, count_ref, obj_ref, mat_ref, light_ref,
                  seed_ref, out_ref, *, block_h, block_w, render_dist,
                  max_march_steps, max_shadow_steps,
                  n_obj=MAX_OBJECTS, n_light=MAX_LIGHTS, masked=True):
    (cx, cy, cz), (dx, dy, dz) = block_rays(params_ref, block_h, block_w)
    threshold = params_ref[11]
    obj_count = count_ref[0]
    objs = read_rows(obj_ref, n_obj, 4)

    # finest-level cone march — compute.glsl main()
    seed = seed_ref[...]
    length = _march_tile(
        cx + dx * seed, cy + dy * seed, cz + dz * seed, dx, dy, dz,
        threshold, objs, obj_count, render_dist, max_march_steps, masked,
    )
    depth = jnp.maximum(seed + length, 0.0)

    # shading — fragment.glsl main(), depth stays in registers
    r, g, b = shade_tile_planes(
        dx, dy, dz, depth, cx, cy, cz,
        objs, read_rows(mat_ref, n_obj, 8), read_rows(light_ref, n_light, 8),
        obj_count, count_ref[1], render_dist, max_shadow_steps, masked,
    )
    out_ref[0] = r
    out_ref[1] = g
    out_ref[2] = b


@functools.partial(
    jax.jit, static_argnames=("cfg", "interpret", "n_obj", "n_light")
)
def depth_shade_fused(cfg: RenderConfig, scene, cam_pos, cam_quat, seed,
                      interpret=None, n_obj=None, n_light=None):
    """March the finest level from `seed` and shade: (H, W, 3) float32."""
    h, w = cfg.height, cfg.width
    bh, bw = block_dims(h, w, cfg.tile_h, cfg.tile_w)
    hp, wp = padded_dims(h, w, bh, bw)
    params, counts, obj = scene_tables(cfg, cfg.level_count - 1, scene,
                                       cam_pos, cam_quat)
    mat, light = shade_tables(scene)

    static = n_obj is not None and n_light is not None
    kernel = functools.partial(
        _fused_kernel,
        block_h=bh,
        block_w=bw,
        render_dist=cfg.render_dist,
        max_march_steps=cfg.max_march_steps,
        max_shadow_steps=cfg.max_shadow_steps,
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
        name="conemarch_fused_depth_shade",
    )(params, counts, obj, mat, light, pad_to(seed, (hp, wp)))
    return jnp.moveaxis(out[:, :h, :w], 0, -1)
