"""Scene as a structure-of-arrays pytree.

The reference packs the scene into one std140 UBO of AoS structs with fixed
capacities and counts (``MutableData`` — reference shaders/compute.glsl:17-24,
host assembly src/main.rs:593-601). Here the layout is SoA with
static shapes: positions (MAX_OBJECTS, 3), radii (MAX_OBJECTS,), etc., padded
to capacity and masked by counts. Counts are traced int32 scalars (the
reference treats them as uniforms, not specialization constants), so one
compiled renderer serves any scene up to capacity.

Material semantics (reference shaders/utilities.glsl:8-14): ``diffuse`` and
``specular`` are uploaded by the host but never read by any shader — we keep
them for interface parity. Material i shades object i (pairing strictly by
index — reference fragment.glsl:148-156). ``length(light_color)`` is the
light strength (utilities.glsl:23).
"""

from __future__ import annotations

import dataclasses

import jax
import numpy as np
import jax.numpy as jnp

from raytracing_engine_tpu.config import MAX_LIGHTS, MAX_MATERIALS, MAX_OBJECTS


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class Scene:
    # objects
    obj_pos: jax.Array      # (MAX_OBJECTS, 3) f32
    obj_radius: jax.Array   # (MAX_OBJECTS,)   f32
    obj_count: jax.Array    # () int32
    # materials (index-paired with objects)
    mat_color: jax.Array    # (MAX_MATERIALS, 3) f32
    mat_diffuse: jax.Array  # (MAX_MATERIALS,) f32  [uploaded, unused — parity]
    mat_specular: jax.Array # (MAX_MATERIALS,) f32  [uploaded, unused — parity]
    mat_shine: jax.Array    # (MAX_MATERIALS,) f32
    mat_ambient: jax.Array  # (MAX_MATERIALS,) f32
    mat_count: jax.Array    # () int32
    # point lights
    light_pos: jax.Array    # (MAX_LIGHTS, 3) f32
    light_color: jax.Array  # (MAX_LIGHTS, 3) f32
    light_count: jax.Array  # () int32


def make_scene(
    objects,          # sequence of (pos(3,), radius)
    materials,        # sequence of dicts: color(3,), diffuse, specular, shine, ambient
    lights,           # sequence of (pos(3,), color(3,))
    dtype=jnp.float32,
) -> Scene:
    """Build a padded SoA Scene from Python-level lists."""
    n_obj, n_mat, n_light = len(objects), len(materials), len(lights)
    if n_obj > MAX_OBJECTS or n_mat > MAX_MATERIALS or n_light > MAX_LIGHTS:
        raise ValueError(
            f"scene exceeds fixed capacities "
            f"({n_obj}/{MAX_OBJECTS} objects, {n_mat}/{MAX_MATERIALS} "
            f"materials, {n_light}/{MAX_LIGHTS} lights)"
        )

    obj_pos = np.zeros((MAX_OBJECTS, 3), np.float32)
    obj_radius = np.zeros((MAX_OBJECTS,), np.float32)
    for i, (pos, r) in enumerate(objects):
        obj_pos[i] = pos
        obj_radius[i] = r

    mat_color = np.zeros((MAX_MATERIALS, 3), np.float32)
    mat_diffuse = np.zeros((MAX_MATERIALS,), np.float32)
    mat_specular = np.zeros((MAX_MATERIALS,), np.float32)
    mat_shine = np.ones((MAX_MATERIALS,), np.float32)
    mat_ambient = np.zeros((MAX_MATERIALS,), np.float32)
    for i, m in enumerate(materials):
        mat_color[i] = m["color"]
        mat_diffuse[i] = m.get("diffuse", 1.0)
        mat_specular[i] = m.get("specular", 1.0)
        mat_shine[i] = m.get("shine", 1.0)
        mat_ambient[i] = m.get("ambient", 0.0)

    light_pos = np.zeros((MAX_LIGHTS, 3), np.float32)
    light_color = np.zeros((MAX_LIGHTS, 3), np.float32)
    for i, (pos, color) in enumerate(lights):
        light_pos[i] = pos
        light_color[i] = color

    as_dt = lambda a: jnp.asarray(a, dtype)
    return Scene(
        obj_pos=as_dt(obj_pos),
        obj_radius=as_dt(obj_radius),
        obj_count=jnp.int32(n_obj),
        mat_color=as_dt(mat_color),
        mat_diffuse=as_dt(mat_diffuse),
        mat_specular=as_dt(mat_specular),
        mat_shine=as_dt(mat_shine),
        mat_ambient=as_dt(mat_ambient),
        mat_count=jnp.int32(n_mat),
        light_pos=as_dt(light_pos),
        light_color=as_dt(light_color),
        light_count=jnp.int32(n_light),
    )
