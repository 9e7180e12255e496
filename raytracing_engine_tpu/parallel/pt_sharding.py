"""Multi-chip path tracing: image-row tiles × spp samples over the mesh.

The wavefront path tracer's natural SPMD axes (SURVEY.md §2.5):
- ``tiles``: each device traces a horizontal band of the image — zero
  communication until final assembly,
- ``samples``: spp split across devices; a psum over the axis averages the
  independent estimates (the renderer analog of data parallelism).

Per-pass RNG is image-wide-then-sliced and keyed by GLOBAL pass index, so
the sharded result is bit-identical to the single-device render with the
same key and total spp.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax, random
from jax.sharding import PartitionSpec as P

from raytracing_engine_tpu.parallel.sharding import SAMPLE_AXIS, TILE_AXIS
from raytracing_engine_tpu.pathtracer.integrator import PTConfig, trace_pass


def render_pt_sharded(cfg: PTConfig, scene, cam_pos, cam_quat, spp: int,
                      key, mesh, bvh=None, soa: bool = False, spp_offset=0):
    """SPMD progressive pass over `mesh`. Returns ((H, W, 3) image, nrays).
    soa=True uses the plane-layout wavefront integrator (production speed;
    the same passes as render_pt_fast); the default uses the stacked
    reference integrator (bit-matched tests).

    spp_offset: global pass index of this call's first pass — every pass's
    stream is keyed by its GLOBAL index, so chunked progressive renders
    (runtime.checkpoint.progressive_render(mesh=...)) accumulate the same
    sample set regardless of chunking or device count."""
    if soa:
        from raytracing_engine_tpu.pathtracer.wavefront import trace_pass_soa
        pass_fn = trace_pass_soa
    else:
        pass_fn = trace_pass
    n_t = mesh.shape[TILE_AXIS]
    n_s = mesh.shape[SAMPLE_AXIS]
    if cfg.height % n_t:
        raise ValueError(f"height {cfg.height} not divisible by tiles={n_t}")
    if spp % n_s:
        raise ValueError(f"spp {spp} not divisible by samples={n_s}")
    band_h = cfg.height // n_t
    local_spp = spp // n_s

    def body(scene, cam_pos, cam_quat, key):
        t = lax.axis_index(TILE_AXIS)
        s = lax.axis_index(SAMPLE_AXIS)

        if soa and cfg.rng == "pcg":
            # must match render_pt_fast's scheme (base + pass * prime) so
            # sharded == unsharded bit-for-bit on the counter-based stream
            import numpy as _np

            from raytracing_engine_tpu.ops.rng_pcg import key_to_seed

            base = key_to_seed(key)

            def pass_body(i, carry):
                acc, nrays = carry
                gpass = spp_offset + s * local_spp + i
                rad, nr = pass_fn(
                    cfg, scene, cam_pos, cam_quat, None, bvh=bvh,
                    row0=t * band_h, band_h=band_h,
                    seed0=base + gpass * _np.int32(-1640531527),
                )
                return acc + rad, nrays + nr
        else:
            def pass_body(i, carry):
                acc, nrays = carry
                gpass = spp_offset + s * local_spp + i  # global pass index
                rad, nr = pass_fn(
                    cfg, scene, cam_pos, cam_quat, random.fold_in(key, gpass),
                    bvh=bvh, row0=t * band_h, band_h=band_h,
                )
                return acc + rad, nrays + nr

        # initial carries must be marked device-varying to match the body
        axes = (TILE_AXIS, SAMPLE_AXIS)
        acc0 = lax.pcast(jnp.zeros((band_h, cfg.width, 3), jnp.float32),
                         axes, to="varying")
        nr0 = lax.pcast(jnp.float32(0.0), axes, to="varying")
        acc, nrays = lax.fori_loop(0, local_spp, pass_body, (acc0, nr0))
        acc = lax.psum(acc, SAMPLE_AXIS) / spp
        nrays = lax.psum(nrays, SAMPLE_AXIS)
        nrays = lax.psum(nrays, TILE_AXIS)
        return acc, nrays

    from raytracing_engine_tpu.accel.clusters import ClusterSet
    from raytracing_engine_tpu.accel.instancing import InstancedClusters

    return jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(P(), P(), P(), P()),
        out_specs=(P(TILE_AXIS, None, None), P()),
        # pallas_call out_shapes (the cluster kernels) carry no vma
        # annotation; sharded == unsharded is covered by tests instead
        check_vma=not isinstance(bvh, (ClusterSet, InstancedClusters)),
    )(scene, cam_pos, cam_quat, key)


def sharded_pt_step(cfg: PTConfig, spp: int, mesh, bvh=None):
    """Jitted sharded path-trace step: (scene, pos, quat, key) -> (img, nrays)."""
    fn = partial(render_pt_sharded, cfg, spp=spp, mesh=mesh, bvh=bvh)
    return jax.jit(
        lambda scene, pos, quat, key: fn(scene, pos, quat, key=key)
    )
