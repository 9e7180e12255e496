"""Multi-chip sharding for the instanced (config-5) renderer.

Embarrassingly parallel over the image: the ``tiles`` mesh axis shards
rows (each device renders a horizontal band via
models.instanced.render_instanced_phong's row0/band_h window), and the
``samples`` axis shards area-light shadow samples (each sample-device
traces its own pcg-jittered light points; a psum averages visibility-
weighted radiance). Scene tables (instance table + base-mesh
ClusterSet) are replicated — each device holds one base mesh, exactly
like the single-device kernel.

The camera projection and shadow-sample RNG are keyed on global pixel
coordinates and global sample indices, so the sharded render computes
exactly the single-device sample set. Results match to ulp level (not
bitwise: each mesh shape is a separate XLA program with its own
fusion/FMA choices, and sample-sharding reassociates one float sum) —
tests/test_sharding.py.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

from raytracing_engine_tpu.parallel.sharding import SAMPLE_AXIS, TILE_AXIS


def render_instanced_sharded(inst_tab, cs, inst_mat, mat_albedo,
                             cam_pos, yaw, light_pos, *, mesh: Mesh,
                             width=1920, height=1088,
                             light_radius=0.0, shadow_samples=1,
                             interpret=None, **kw):
    """Sharded shaded instanced frame: (H, W, 3) f32, rows sharded over
    the ``tiles`` axis, shadow samples over ``samples``.

    With light_radius == 0 (hard shadows) the samples-axis devices render
    identical bands and the psum-average is exact replication; with a
    positive radius shadow_samples must divide by the samples axis size
    (local shadow_samples == 1 is fine — each device draws its single
    jittered sample of the global set).
    """
    from raytracing_engine_tpu.models.instanced import render_instanced_phong

    n_t = mesh.shape[TILE_AXIS]
    n_s = mesh.shape[SAMPLE_AXIS]
    if height % n_t:
        raise ValueError(f"height {height} not divisible by tiles={n_t}")
    soft = light_radius > 0.0
    if soft and shadow_samples % n_s:
        raise ValueError(
            f"shadow_samples {shadow_samples} not divisible by "
            f"samples={n_s}")
    band_h = height // n_t
    local_samples = shadow_samples // n_s if soft else shadow_samples

    def body(inst_tab, inst_mat, mat_albedo, cam_pos, yaw, light_pos):
        t = lax.axis_index(TILE_AXIS)
        s = lax.axis_index(SAMPLE_AXIS)
        # each sample-device draws its own slice of the global sample set:
        # pcg streams are keyed by (pixel, draw counter), and the draw
        # counter below offsets by the device's global first sample, so the
        # union over devices is exactly the single-device sample set
        img = render_instanced_phong(
            inst_tab, cs, inst_mat, mat_albedo, cam_pos, yaw, light_pos,
            width=width, height=height, interpret=interpret,
            light_radius=light_radius, shadow_samples=local_samples,
            sample_offset=s * local_samples if soft else 0,
            row0=t * band_h, band_h=band_h, **kw)
        return lax.psum(img * jnp.float32(1.0 / n_s), SAMPLE_AXIS)

    return jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(P(), P(), P(), P(), P(), P()),
        out_specs=P(TILE_AXIS, None, None),
        # pallas_call out_shapes carry no vma annotation (see pt_sharding)
        check_vma=False,
    )(inst_tab, inst_mat, mat_albedo, jnp.asarray(cam_pos, jnp.float32),
      jnp.asarray(yaw, jnp.float32), jnp.asarray(light_pos, jnp.float32))
