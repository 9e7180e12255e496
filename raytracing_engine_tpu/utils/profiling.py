"""Profiling / tracing hooks.

The reference's only instrumentation is an FPS print (src/main.rs:730).
Here: a jax.profiler trace context for device timelines (view in
TensorBoard / Perfetto), named stage annotations, and a frame-stat recorder
that produces structured per-frame reports (rays, ms, Mrays/s).

Wall-clock numbers end each timed call in `jax.block_until_ready`
(utils/timing.time_frames); the profiler trace is the ground truth for
device time.
"""

from __future__ import annotations

import contextlib
import json
import time


@contextlib.contextmanager
def device_trace(logdir: str):
    """Capture a jax.profiler trace (TensorBoard/Perfetto viewable)."""
    import jax

    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


@contextlib.contextmanager
def stage(name: str):
    """Annotate a named stage inside a device_trace."""
    import jax

    with jax.profiler.TraceAnnotation(name):
        yield


class FrameRecorder:
    """Structured per-frame stats: the FPS print, grown up."""

    def __init__(self, primary_rays: int, secondary_rays: int):
        self.primary = primary_rays
        self.secondary = secondary_rays
        self.frames = []

    @contextlib.contextmanager
    def frame(self):
        t0 = time.perf_counter()
        yield
        dt = time.perf_counter() - t0
        self.frames.append(dt)

    def report(self) -> dict:
        if not self.frames:
            return {}
        total = self.primary + self.secondary
        best = min(self.frames)
        mean = sum(self.frames) / len(self.frames)
        return {
            "frames": len(self.frames),
            "best_ms": round(best * 1e3, 3),
            "mean_ms": round(mean * 1e3, 3),
            "fps_best": round(1.0 / best, 1),
            "mrays_best": round(total / best / 1e6, 1),
            "primary_rays": self.primary,
            "secondary_rays": self.secondary,
        }

    def dump(self, path: str):
        with open(path, "w") as f:
            json.dump(self.report(), f, indent=2)
