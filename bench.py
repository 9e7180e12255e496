"""Headline benchmark: the 1080p cone-march frame on one NVIDIA GPU.

Prints ONE JSON line: {"metric", "value", "unit", "median_ms", "p90_ms",
"n", "device", "card"}. The value is Mrays/s (primary + secondary rays,
utils/timing.conemarch_ray_count) at the median frame time.

Method: the production cone-march route (models/pallas_renderer, Triton
kernels) renders `frames` frames of the default scene, each from its own
camera pose, each timed on the host clock from dispatch to
`block_until_ready`. Two warm-up frames (the first compiles) are not
timed. The script refuses to run without a GPU: a time taken on the CPU
backend says nothing about the card.

Usage: python bench.py [--frames N] [--size WxH]
"""

from __future__ import annotations

import argparse
import json

import numpy as np


def bench_conemarch(width=1920, height=1088, frames=30):
    """Per-frame times (ms) and ray count of the production cone-march."""
    import jax.numpy as jnp

    from raytracing_engine_tpu.config import RenderConfig
    from raytracing_engine_tpu.models import pallas_renderer
    from raytracing_engine_tpu.ops.quaternion import quat_from_rotation_z
    from raytracing_engine_tpu.scene import default_scene
    from raytracing_engine_tpu.utils.timing import (
        conemarch_ray_count,
        time_frames,
    )

    cfg = RenderConfig(width=width, height=height)
    scene = default_scene()
    render = pallas_renderer.render_jit_for(cfg, scene)
    pos = jnp.zeros(3, jnp.float32)
    yaws = np.linspace(0.0, 2.0 * np.pi, frames + 2, endpoint=False)
    poses = [(scene, pos, quat_from_rotation_z(jnp.float32(y))) for y in yaws]
    samples = time_frames(render, poses, warmup=2)
    primary, secondary = conemarch_ray_count(cfg, int(scene.light_count))
    return samples, primary + secondary


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--frames", type=int, default=30)
    ap.add_argument("--size", default="1920x1088")
    args = ap.parse_args(argv)

    from raytracing_engine_tpu.utils.devices import (
        card_name_power,
        device_record,
        require_gpu,
    )

    require_gpu()
    from raytracing_engine_tpu.utils.compile_cache import enable_compile_cache
    from raytracing_engine_tpu.utils.timing import summarize_ms

    enable_compile_cache()
    w, h = (int(v) for v in args.size.lower().split("x"))
    samples, rays = bench_conemarch(w, h, args.frames)
    stats = summarize_ms(samples)
    record = {
        "metric": f"Mrays/s (primary+secondary), {w}x{h} cone-march",
        "value": rays / (stats["median_ms"] * 1e-3) / 1e6,
        "unit": "Mrays/s",
        **stats,
        "device": device_record(),
        "card": card_name_power(),
    }
    print(json.dumps(record))
    return record


if __name__ == "__main__":
    main()
