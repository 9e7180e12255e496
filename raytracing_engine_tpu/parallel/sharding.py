"""Tile + sample sharding over a device mesh.

The reference is single-GPU (one queue, src/main.rs:450-460); "scaling" in
this build is renderer-native SPMD (SURVEY.md §2.5): a 2D mesh
(``tiles`` × ``samples``) where

- the ``tiles`` axis shards image rows: every pyramid level is computed in
  horizontal bands, and the just-finished level is all-gathered so each
  device can seed its next-level band from any parent row (the coarse levels
  are tiny — the largest gather is half the output image). Zero redundant
  marching, near-ideal compute scaling; collectives ride ICI.
- the ``samples`` axis shards shadow-ray work across light slots in the
  parity renderer (a psum over the axis reassembles the per-light additive
  sum — fragment.glsl:183-185), and is the spp axis for the wavefront path
  tracer (psum over sample accumulation).

Constraints (checked): every pyramid level height must divide by the tiles
axis (heights are multiples of 8, so tiles <= 8 always works) and MAX_LIGHTS
must divide by the samples axis.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

from raytracing_engine_tpu.config import MAX_LIGHTS, RenderConfig
from raytracing_engine_tpu.models.conemarch import render_depth_level
from raytracing_engine_tpu.ops.raygen import pixel_norm_coords, ray_directions
from raytracing_engine_tpu.ops.shade import phong_shade

TILE_AXIS = "tiles"
SAMPLE_AXIS = "samples"


def make_mesh(n_tiles: int, n_samples: int = 1, devices=None) -> Mesh:
    """Build a (tiles, samples) mesh from the available devices."""
    if devices is None:
        devices = jax.devices()
    n = n_tiles * n_samples
    if len(devices) < n:
        raise ValueError(f"need {n} devices, have {len(devices)}")
    import numpy as np

    grid = np.asarray(devices[:n]).reshape(n_tiles, n_samples)
    return Mesh(grid, (TILE_AXIS, SAMPLE_AXIS))


def _check_divisibility(cfg: RenderConfig, n_tiles: int, n_samples: int):
    for i, (_, h) in enumerate(cfg.level_dims):
        if h % n_tiles:
            raise ValueError(
                f"pyramid level {i} height {h} not divisible by tiles={n_tiles}"
            )
    if cfg.height % n_tiles:
        raise ValueError(f"height {cfg.height} not divisible by tiles={n_tiles}")
    if MAX_LIGHTS % n_samples:
        raise ValueError(f"MAX_LIGHTS={MAX_LIGHTS} not divisible by samples={n_samples}")


def _render_body(cfg: RenderConfig, n_tiles: int, n_samples: int,
                 scene, cam_pos, cam_quat):
    """Per-device SPMD body (runs under shard_map)."""
    tile = lax.axis_index(TILE_AXIS)

    # --- depth pyramid: banded march + all-gather between levels ---------
    prev_full = None
    for i in range(cfg.level_count):
        _, h = cfg.level_dims[i]
        band_h = h // n_tiles
        band = render_depth_level(
            cfg, i, scene, cam_pos, cam_quat, prev_full,
            row0=tile * band_h, band_h=band_h,
        )
        if i + 1 < cfg.level_count:
            # reassemble the full level for next-level seeding; coarse levels
            # are tiny so this rides ICI cheaply. tiled=True concatenates the
            # bands along rows.
            prev_full = lax.all_gather(band, TILE_AXIS, axis=0, tiled=True)
        else:
            depth_band = band  # finest level stays sharded

    # --- shading: band of rows × shard of light slots ---------------------
    out_band_h = cfg.height // n_tiles
    image_size = jnp.array(cfg.level_image_size(cfg.level_count - 1), jnp.float32)
    ratio = jnp.array(cfg.ratio, jnp.float32)
    nc = pixel_norm_coords(cfg.width, out_band_h, image_size, ratio,
                           row0=tile * out_band_h)
    direction = ray_directions(nc, cam_quat)

    slots = MAX_LIGHTS // n_samples
    sample = lax.axis_index(SAMPLE_AXIS)
    partial_color = phong_shade(
        depth_band, direction, cam_pos, scene,
        cfg.render_dist, cfg.max_shadow_steps,
        light_offset=sample * slots, num_light_slots=slots,
    )
    # additive per-light accumulation → psum over the samples axis
    return lax.psum(partial_color, SAMPLE_AXIS)


def render_sharded(cfg: RenderConfig, scene, cam_pos, cam_quat, mesh: Mesh):
    """Render one frame SPMD over `mesh`. Returns (H, W, 3), row-sharded."""
    n_tiles = mesh.shape[TILE_AXIS]
    n_samples = mesh.shape[SAMPLE_AXIS]
    _check_divisibility(cfg, n_tiles, n_samples)

    body = partial(_render_body, cfg, n_tiles, n_samples)
    return jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(P(), P(), P()),                 # scene + camera replicated
        out_specs=P(TILE_AXIS, None, None),       # image sharded by rows
    )(scene, cam_pos, cam_quat)


def sharded_render_step(cfg: RenderConfig, mesh: Mesh):
    """A jitted sharded frame function: (scene, pos, quat) -> image."""
    fn = partial(render_sharded, cfg, mesh=mesh)
    return jax.jit(lambda scene, pos, quat: fn(scene, pos, quat))
