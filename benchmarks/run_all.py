"""Time the BASELINE.json configurations on one NVIDIA GPU.

Each cell renders through the production path (the CLI's engines), checks
its output (finite, the expected shape, not black), and times `frames`
calls after two warm-up calls, each from dispatch to `block_until_ready`.
Every result names the device and the card's power limit. The script
refuses to run without a GPU.

Cells:
  headline_1080p_conemarch  1920x1088 cone-march (bench.py)
  config1_512_conemarch     512x512 cone-march
  config2_spheres           800x608, 4 bounces, 4 spp per frame
  config3_knot_512 / _1080p 70k-triangle knot, skip-link BVH, 2 bounces + NEE
  config4_cornell_nee       Cornell box, 4 bounces + NEE, 512x512, 16 spp
  config5_instanced_hard / _soft  1.06M instanced triangles at 1920x1088
  config5pt_instanced_512   instanced scene path traced, 2 bounces + NEE

Usage: python benchmarks/run_all.py [--frames N] [--only CELL ...]
       [--out FILE]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def _check_image(img, shape):
    img = np.asarray(img)
    if img.shape != shape or not np.isfinite(img).all() or img.max() <= 0:
        raise AssertionError(f"bad image: shape {img.shape}, "
                             f"max {img.max() if img.size else None}")


def _measure(fn, make_args, frames, shape, rays=None):
    """Check one output, then time `frames` calls (2 warm-up calls)."""
    from raytracing_engine_tpu.utils.timing import summarize_ms, time_frames

    out = fn(*make_args(-1))
    _check_image(out, shape)
    stats = summarize_ms(time_frames(fn, [make_args(i)
                                          for i in range(frames + 2)]))
    if rays is not None:
        stats["mrays_per_s"] = rays / (stats["median_ms"] * 1e-3) / 1e6
    return stats


def conemarch_cell(width, height, frames):
    import jax.numpy as jnp

    import raytracing_engine_tpu as rt
    from raytracing_engine_tpu.models import pallas_renderer
    from raytracing_engine_tpu.ops.quaternion import quat_from_rotation_z
    from raytracing_engine_tpu.utils.timing import conemarch_ray_count

    cfg = rt.RenderConfig(width=width, height=height)
    scene = rt.default_scene()
    render = pallas_renderer.render_jit_for(cfg, scene)
    rays = sum(conemarch_ray_count(cfg, int(scene.light_count)))
    return _measure(
        render, lambda i: (scene, jnp.zeros(3),
                           quat_from_rotation_z(jnp.float32(0.05 * i))),
        frames, (height, width, 3), rays)


def pt_cell(cfg, scene, pos, spp, frames, bvh=None):
    import jax
    import jax.numpy as jnp

    from raytracing_engine_tpu.pathtracer import render_pt_fast

    quat = jnp.array([0.0, 0.0, 0.0, 1.0])
    fn = jax.jit(lambda k: render_pt_fast(cfg, scene, pos, quat, spp, k,
                                          bvh=bvh)[0])
    _, nrays = render_pt_fast(cfg, scene, pos, quat, spp,
                              jax.random.PRNGKey(0), bvh=bvh)
    return _measure(fn, lambda i: (jax.random.PRNGKey(i + 1),), frames,
                    (cfg.height, cfg.width, 3), float(nrays))


def knot_cell(size, frames):
    import jax.numpy as jnp

    from raytracing_engine_tpu.accel import build_bvh, torus_knot
    from raytracing_engine_tpu.pathtracer import PTConfig
    from raytracing_engine_tpu.pathtracer.scenes import mesh_lit_scene

    mesh = torus_knot(segments=1100, sides=32, center=(0.0, 8.0, 0.0))
    cfg = PTConfig(width=size[0], height=size[1], max_bounces=2, rng="pcg")
    return pt_cell(cfg, mesh_lit_scene(mesh), jnp.zeros(3), 1, frames,
                   bvh=build_bvh(mesh))


def config5_scene():
    from raytracing_engine_tpu.accel import build_bvh, torus_knot
    from raytracing_engine_tpu.accel.clusters import build_clusters
    from raytracing_engine_tpu.accel.instancing import grid_instances

    mesh = torus_knot(segments=550, sides=32)  # 35,200 triangles
    bvh = build_bvh(mesh)
    inst = grid_instances(bvh, nx=6, ny=5, spacing=4.0, base=(0.0, 14.0, 0.0),
                          mats=np.arange(30, dtype=np.int32) % 3)
    return inst, build_clusters(mesh, bvh=bvh)


def instanced_cell(frames, soft):
    import jax.numpy as jnp

    from raytracing_engine_tpu.models.instanced import render_instanced_phong
    from raytracing_engine_tpu.ops.pallas.instanced_intersect import (
        pack_instances)

    inst, cs = config5_scene()
    tab = pack_instances(inst)
    albedo = jnp.asarray([[0.8, 0.5, 0.3], [0.4, 0.7, 0.5], [0.5, 0.5, 0.8]],
                         jnp.float32)
    light = jnp.asarray([6.0, 2.0, 8.0])
    kw = dict(light_radius=1.5, shadow_samples=4) if soft else {}

    def fn(yaw):
        return render_instanced_phong(tab, cs, inst.mat, albedo, jnp.zeros(3),
                                      yaw, light, width=1920, height=1088,
                                      **kw)

    return {"triangles": int(inst.total_triangles),
            **_measure(fn, lambda i: (jnp.float32(0.01 * i),), frames,
                       (1088, 1920, 3))}


def instanced_pt_cell(frames):
    import jax.numpy as jnp

    from raytracing_engine_tpu.accel.instancing import make_instanced_clusters
    from raytracing_engine_tpu.pathtracer import PTConfig
    from raytracing_engine_tpu.pathtracer.scene import DIFFUSE, build_pt_scene

    inst, cs = config5_scene()
    scene = build_pt_scene(
        spheres=[((8.0, 2.0, 10.0), 2.0, 3), ((0.0, 14.0, -103.0), 100.0, 4)],
        materials=[
            {"albedo": (0.75, 0.5, 0.3), "kind": DIFFUSE},
            {"albedo": (0.4, 0.7, 0.5), "kind": DIFFUSE},
            {"albedo": (0.5, 0.5, 0.8), "kind": DIFFUSE},
            {"albedo": (0, 0, 0), "emission": (40.0, 38.0, 34.0),
             "kind": DIFFUSE},
            {"albedo": (0.55, 0.55, 0.5), "kind": DIFFUSE},
        ])
    ic = make_instanced_clusters(inst, cs, scene=scene)
    cfg = PTConfig(width=512, height=512, max_bounces=2, rng="pcg")
    return pt_cell(cfg, scene, jnp.zeros(3), 1, frames, bvh=ic)


def cells(frames):
    import jax.numpy as jnp

    from raytracing_engine_tpu.pathtracer import PTConfig
    from raytracing_engine_tpu.pathtracer import scenes as pt_scenes

    return {
        "headline_1080p_conemarch": lambda: conemarch_cell(1920, 1088, frames),
        "config1_512_conemarch": lambda: conemarch_cell(512, 512, frames),
        "config2_spheres": lambda: pt_cell(
            PTConfig(width=800, height=608, max_bounces=4, rng="pcg"),
            pt_scenes.material_spheres(), jnp.zeros(3), 4, frames),
        "config3_knot_512": lambda: knot_cell((512, 512), frames),
        "config3_knot_1080p": lambda: knot_cell((1920, 1088), frames),
        "config4_cornell_nee": lambda: pt_cell(
            PTConfig(width=512, height=512, max_bounces=4, rng="pcg"),
            pt_scenes.cornell_box(), jnp.array([0.0, 0.2, 0.0]), 16, frames),
        "config5_instanced_hard": lambda: instanced_cell(frames, soft=False),
        "config5_instanced_soft": lambda: instanced_cell(frames, soft=True),
        "config5pt_instanced_512": lambda: instanced_pt_cell(frames),
    }


def run(names=None, frames=20):
    """{cell: result} for the named cells (all by default)."""
    table = cells(frames)
    return {name: table[name]() for name in (names or table)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--frames", type=int, default=20)
    ap.add_argument("--only", nargs="*", default=None)
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args(argv)

    from raytracing_engine_tpu.utils.devices import (
        card_name_power, device_record, require_gpu)

    require_gpu()
    from raytracing_engine_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    record = {"device": device_record(), "card": card_name_power(),
              "frames": args.frames, "cells": run(args.only, args.frames)}
    text = json.dumps(record, indent=1)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
    print(text)
    return record


if __name__ == "__main__":
    main()
