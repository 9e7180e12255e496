"""Pallas renderer — the production cone-march pipeline (Triton kernels).

Same math as models/conemarch.py (and the golden reference), but the hot
loops run in Pallas kernels with per-block convergence (ops/pallas/). The
pyramid driver mirrors the reference's per-level dispatch loop
(src/main.rs:300-316); the 2x seed upsample between levels is a cheap XLA
gather.

``n_obj``/``n_light`` statically specialize the kernels to the scene's live
slot counts (the host always knows them): dead-slot masking and dead shadow
loops disappear. Results are identical to the generic masked kernels —
enforced by tests.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from raytracing_engine_tpu.config import RenderConfig
from raytracing_engine_tpu.ops.pallas.depth import depth_level_pallas, upsample_seed
from raytracing_engine_tpu.ops.pallas.shade import shade_pallas


def render_depth_pyramid(cfg: RenderConfig, scene, cam_pos, cam_quat,
                         interpret=None, n_obj=None):
    levels = []
    prev = None
    for i in range(cfg.level_count):
        w, h = cfg.level_dims[i]
        if prev is None:
            seed = jnp.ones((h, w), jnp.float32)
        else:
            seed = upsample_seed(prev, h, w)
        prev = depth_level_pallas(cfg, i, scene, cam_pos, cam_quat, seed,
                                  interpret=interpret, n_obj=n_obj)
        levels.append(prev)
    return tuple(levels)


def render(cfg: RenderConfig, scene, cam_pos, cam_quat, interpret=None,
           n_obj=None, n_light=None, fused=True):
    """Full frame via Pallas kernels → (H, W, 3) float32.

    fused=True (default) marches the finest level and shades in ONE kernel
    (ops/pallas/fused.py) — bitwise-identical to the two-kernel pipeline.
    """
    if fused:
        from raytracing_engine_tpu.ops.pallas.fused import depth_shade_fused

        prev = None
        for i in range(cfg.level_count - 1):
            w, h = cfg.level_dims[i]
            seed = (jnp.ones((h, w), jnp.float32) if prev is None
                    else upsample_seed(prev, h, w))
            prev = depth_level_pallas(cfg, i, scene, cam_pos, cam_quat, seed,
                                      interpret=interpret, n_obj=n_obj)
        seed = upsample_seed(prev, cfg.height, cfg.width) if prev is not None \
            else jnp.ones((cfg.height, cfg.width), jnp.float32)
        return depth_shade_fused(cfg, scene, cam_pos, cam_quat, seed,
                                 interpret=interpret, n_obj=n_obj,
                                 n_light=n_light)
    depth = render_depth_pyramid(cfg, scene, cam_pos, cam_quat, interpret,
                                 n_obj)[-1]
    return shade_pallas(cfg, scene, cam_pos, cam_quat, depth,
                        interpret=interpret, n_obj=n_obj, n_light=n_light)


@partial(jax.jit, static_argnums=0,
         static_argnames=("interpret", "n_obj", "n_light", "fused"))
def render_jit(cfg: RenderConfig, scene, cam_pos, cam_quat, interpret=None,
               n_obj=None, n_light=None, fused=True):
    return render(cfg, scene, cam_pos, cam_quat, interpret, n_obj, n_light,
                  fused)


def render_jit_for(cfg: RenderConfig, scene):
    """Convenience: a jitted render specialized to `scene`'s live counts."""
    n_obj = int(scene.obj_count)
    n_light = int(scene.light_count)
    return lambda s, pos, quat: render_jit(cfg, s, pos, quat,
                                           n_obj=n_obj, n_light=n_light)
