"""Batched frame serving: many frames per dispatch.

One jitted call scans over K camera poses on the device and returns all K
frames at once, so the host's per-dispatch overhead is paid once per batch.
Frames are independent (a batch of requests, an orbit).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax

from raytracing_engine_tpu.config import RenderConfig
from raytracing_engine_tpu.models import pallas_renderer


@functools.partial(jax.jit, static_argnums=(0,), static_argnames=("fn",))
def render_sequence(cfg: RenderConfig, scene, positions, quats, fn=None):
    """Render K frames in ONE dispatch: (K, 3) positions + (K, 4) quats ->
    (K, 3, H, W) channel-plane frames. fn: optional render function
    (cfg, scene, pos, quat) -> (H, W, 3) image; defaults to the production
    cone-march route (models/pallas_renderer).

    The output is channel-major (K, 3, H, W); convert after fetching with
    ``np.moveaxis(np.asarray(frames), 1, -1)`` (a free view on host)."""
    render = fn if fn is not None else pallas_renderer.render
    positions = jnp.asarray(positions, jnp.float32)
    quats = jnp.asarray(quats, jnp.float32)

    def step(_, pose):
        img = render(cfg, scene, pose[0][:3], pose[1])
        return None, jnp.moveaxis(img, -1, 0)

    _, imgs = lax.scan(step, None, (positions, quats))
    return imgs
