"""Signed distance functions over the SoA sphere scene.

Reference: ``sphereSDF(p, s) = distance(p, s.pos) - s.size``
(shaders/utilities.glsl:36-38). Here we evaluate ALL object SDFs
vectorized along the trailing object axis — with <= MAX_OBJECTS objects this
beats the reference's per-thread lazy branching, while the march itself still
carries the algorithm-3 cache (see ops/march.py) so trajectories match the
reference exactly.
"""

from __future__ import annotations

import jax.numpy as jnp


def sphere_sdf(p, center, radius):
    """SDF of one sphere. p: (..., 3); center: (3,) or broadcastable; radius scalar."""
    return jnp.sqrt(jnp.sum((p - center) ** 2, axis=-1)) - radius


def scene_sdf_all(p, obj_pos, obj_radius):
    """SDF of every scene object at p.

    p: (..., 3); obj_pos: (K, 3); obj_radius: (K,).
    Returns (..., K) distances (unmasked — callers mask by obj_count).
    """
    d = p[..., None, :] - obj_pos  # (..., K, 3)
    return jnp.sqrt(jnp.sum(d * d, axis=-1)) - obj_radius
