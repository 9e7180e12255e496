"""Frame timing and throughput metrics.

The reference's only observability is a per-frame FPS print
(src/main.rs:719,730). Here we keep structured per-frame stats: wall time per
stage, rays traced (primary = every pyramid-level pixel + shading pixel;
secondary = shadow rays), and derived Mrays/s — the driver-set primary metric
(BASELINE.json:2).
"""

from __future__ import annotations

import dataclasses
import time
from collections import defaultdict

import numpy as np


class Timer:
    """Wall-clock stage timer. Callers must block_until_ready() before stop
    when timing device work (JAX dispatch is async)."""

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)
        self._start = {}

    def start(self, name: str):
        self._start[name] = time.perf_counter()

    def stop(self, name: str) -> float:
        dt = time.perf_counter() - self._start.pop(name)
        self.totals[name] += dt
        self.counts[name] += 1
        return dt

    def mean(self, name: str) -> float:
        return self.totals[name] / max(self.counts[name], 1)

    def summary(self) -> dict:
        return {k: self.mean(k) for k in self.totals}


@dataclasses.dataclass
class FrameStats:
    """Ray accounting for one rendered frame."""

    primary_rays: int      # pyramid pixels (all levels) + shading reads
    secondary_rays: int    # shadow rays actually launched
    seconds: float

    @property
    def total_rays(self) -> int:
        return self.primary_rays + self.secondary_rays

    @property
    def mrays_per_sec(self) -> float:
        return self.total_rays / self.seconds / 1e6

    @property
    def fps(self) -> float:
        return 1.0 / self.seconds


def conemarch_ray_count(cfg, num_lights: int) -> tuple[int, int]:
    """(primary, secondary) rays per frame for the cone-march renderer.

    Primary: one march per pixel per pyramid level (each level re-marches
    from its seed — reference dispatches all levels every frame,
    src/main.rs:300-316). Secondary: one shadow ray per live light per
    output pixel (fragment.glsl:170-176).
    """
    primary = sum(w * h for (w, h) in cfg.level_dims)
    secondary = cfg.width * cfg.height * num_lights
    return primary, secondary


def time_frames(fn, args_list, warmup: int = 2):
    """Wall time of `fn(*args)` for each argument tuple, each call ending in
    `jax.block_until_ready`. The first `warmup` tuples are run untimed (the
    first one compiles). Returns the timed samples in milliseconds."""
    import jax

    for args in args_list[:warmup]:
        jax.block_until_ready(fn(*args))
    out = []
    for args in args_list[warmup:]:
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def summarize_ms(samples) -> dict:
    """Median, p90 and count of a list of millisecond samples."""
    a = np.asarray(samples, np.float64)
    return {"median_ms": float(np.median(a)),
            "p90_ms": float(np.percentile(a, 90)), "n": int(a.size)}
