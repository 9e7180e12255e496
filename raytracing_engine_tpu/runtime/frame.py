"""Headless frame loop — the counterpart of the reference's winit event loop.

The reference's per-frame loop (src/main.rs:721-928) does: input integration
→ push-constant update (position ACCUMULATES across frames, rotation is
absolute yaw/pitch) → re-record command buffer → submit → present, with
per-swapchain-image fences so the CPU records frame N+1 while the GPU renders
frame N. Here:

- input integration is the same math (camera.integrate_input),
- "re-record + submit" is one jitted call — XLA async dispatch gives the
  frames-in-flight pipelining for free (we only block when reading a frame
  back, the analog of present),
- the swapchain is a host-side frame sink (PNG directory / in-memory ring).

There is no window system; interaction is an InputEvent stream (scripted or
replayed), preserving the reference's WASD/QE + mouse-look semantics so
interactive behavior is testable (SURVEY.md §5/§7).
"""

from __future__ import annotations

import functools

import dataclasses
import time
from typing import Callable, Iterable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from raytracing_engine_tpu.camera import Camera, integrate_input
from raytracing_engine_tpu.config import RenderConfig
from raytracing_engine_tpu.models import pallas_renderer
from raytracing_engine_tpu.utils.timing import FrameStats, conemarch_ray_count


@dataclasses.dataclass
class InputEvent:
    """One frame's worth of input, mirroring the reference's key/mouse state.

    move:   [right(D-A), forward(W-S), up(Q-E)] each in {-1, 0, 1}
            (src/main.rs:751-768)
    rot:    [yaw(Right-Left), pitch(Down-Up)] each in {-1, 0, 1}
            (src/main.rs:738-749)
    cursor: raw mouse delta in px (src/main.rs:686,732)
    dt:     seconds since last update
    """

    move: tuple = (0.0, 0.0, 0.0)
    rot: tuple = (0.0, 0.0)
    cursor: tuple = (0.0, 0.0)
    dt: float = 1.0 / 60.0
    resize: tuple | None = None  # (width, height) — swapchain-recreate analog
    # window-system events (src/main.rs:682-717):
    quit: bool = False                 # Escape / close-requested (:684-694)
    fullscreen_toggle: bool = False    # F11 borderless toggle (:689-696)
    focus: bool | None = None          # focus gained/lost -> unfreeze/freeze
    #                                    + cursor grab toggle (:711-717)


class FrameLoop:
    """Drives camera state + jitted rendering over an input-event stream."""

    def __init__(
        self,
        cfg: RenderConfig,
        scene,
        render_fn: Optional[Callable] = None,
        camera: Optional[Camera] = None,
        monitor: tuple = (1920, 1080),
    ):
        self.cfg = cfg
        self.scene = scene
        self.camera = camera if camera is not None else Camera.initial()
        if render_fn is None:
            # the production cone-march, specialized to the scene's live
            # object/light counts (the generic masked kernels are slower)
            render_fn = functools.partial(
                pallas_renderer.render_jit, n_obj=int(scene.obj_count),
                n_light=int(scene.light_count))
        self._render = render_fn
        self._primary, self._secondary = conemarch_ray_count(
            cfg, int(scene.light_count)
        )
        # window-system state (src/main.rs:366-383 Data flags)
        self.quit = False
        self.frozen = False          # focus lost -> skip frames (:726)
        self.cursor_grabbed = True   # grabbed while focused (:711-717)
        self.fullscreen = False
        # borderless-fullscreen resolution (the reference reads the actual
        # monitor's mode, src/main.rs:689-696; headless callers pass theirs)
        self.monitor = monitor
        self._windowed = (cfg.width, cfg.height)
        self._last = None

    def _set_size(self, w: int, h: int):
        # reference enforces width >= height on resize (src/main.rs:702-706)
        if h > w:
            h = w
        self.cfg = dataclasses.replace(self.cfg, width=w, height=h)
        self._primary, self._secondary = conemarch_ray_count(
            self.cfg, int(self.scene.light_count)
        )

    def _advance(self, event: InputEvent) -> bool:
        """Integrate one input event into loop/camera state WITHOUT
        rendering. Returns True when this event produces a frame — the
        separation lets `run(chunk=...)` precompute a whole pose sequence
        (replay events are known ahead of time) and render it in batched
        dispatches."""
        if event.quit:
            # Escape / close (src/main.rs:684-694): stop rendering
            self.quit = True
            return False
        if event.focus is not None:
            # focus change: freeze when unfocused + cursor grab toggle
            # (src/main.rs:711-717; frozen loop skips at :726)
            self.frozen = not event.focus
            self.cursor_grabbed = event.focus
        # window-state events apply even while frozen — the reference's
        # handlers set resize/fullscreen flags regardless of focus and only
        # the render-loop body is skipped (src/main.rs:682-717 vs :726)
        if event.fullscreen_toggle:
            # F11 borderless fullscreen (src/main.rs:689-696): headless
            # analog = switch to the monitor resolution and back
            self.fullscreen = not self.fullscreen
            if self.fullscreen:
                self._windowed = (self.cfg.width, self.cfg.height)
                self._set_size(*self.monitor)
            else:
                self._set_size(*self._windowed)
        if event.resize is not None:
            # resize = new RenderConfig; jit respecializes (the analog of the
            # reference's swapchain/pipeline/pyramid rebuild,
            # src/main.rs:778-870)
            self._set_size(*event.resize)
        if self.frozen:
            return False
        self.camera = integrate_input(
            self.camera,
            jnp.asarray(event.move, jnp.float32),
            jnp.asarray(event.rot, jnp.float32),
            jnp.asarray(event.cursor, jnp.float32),
            jnp.float32(event.dt),
            jnp.float32(self.cfg.width),
        )
        return True

    def step(self, event: InputEvent):
        """Integrate one input event and render. Returns the device image
        (async — not blocked on) like the reference's submit-without-wait."""
        if not self._advance(event):
            return self._last
        self._last = self._render(
            self.cfg, self.scene, self.camera.position, self.camera.quat()
        )
        return self._last

    def run(
        self,
        events: Iterable[InputEvent],
        sink: Optional[Callable[[int, np.ndarray], None]] = None,
        stats: bool = False,
        chunk: Optional[int] = None,
    ):
        """Render a sequence of frames. With a sink, each frame is pulled to
        host (the 'present'); otherwise frames stay on device and only the
        last is synchronized. Returns per-frame FrameStats when stats=True.

        chunk=K: replay-style serving — events are integrated ahead of
        time (they are known, unlike live input) and frames render K per
        dispatch via runtime.serve.render_sequence, so per-dispatch host
        overhead is paid once per chunk. Identical images to the per-frame path:
        same (cfg, pose) sequence through the same render fn, grouped at
        resize/fullscreen boundaries (cfg changes force a new dispatch).
        Per-frame stats report the amortized chunk time."""
        if chunk:
            return self._run_chunked(events, sink, stats, chunk)
        frame_stats = []
        img = None
        for i, ev in enumerate(events):
            t0 = time.perf_counter()
            img = self.step(ev)
            if self.quit:
                break
            if img is None:  # frozen frame: nothing rendered
                continue
            if sink is not None or stats:
                img = jax.block_until_ready(img)
            dt = time.perf_counter() - t0
            if sink is not None:
                sink(i, np.asarray(img))
            if stats:
                frame_stats.append(
                    FrameStats(self._primary, self._secondary, dt)
                )
        if img is not None:
            jax.block_until_ready(img)
        return frame_stats if stats else img

    def _run_chunked(self, events, sink, stats, chunk):
        from raytracing_engine_tpu.runtime import serve

        # phase 1: pure host-side event integration -> pose sequence,
        # grouped by RenderConfig (resize/fullscreen breaks a group)
        groups = []  # [(cfg, [(event_idx, pos, quat), ...])]
        for i, ev in enumerate(events):
            rendered = self._advance(ev)
            if self.quit:
                break
            if not rendered:
                continue
            if not groups or groups[-1][0] != self.cfg:
                groups.append((self.cfg, []))
            groups[-1][1].append((i, np.asarray(self.camera.position),
                                  np.asarray(self.camera.quat())))

        # phase 2: K frames per dispatch, one fetch per chunk
        frame_stats = []
        last = None
        for cfg, poses in groups:
            primary, secondary = conemarch_ray_count(
                cfg, int(self.scene.light_count))
            for k0 in range(0, len(poses), chunk):
                sub = poses[k0:k0 + chunk]
                t0 = time.perf_counter()
                frames = serve.render_sequence(
                    cfg, self.scene,
                    jnp.asarray(np.stack([p for _, p, _ in sub])),
                    jnp.asarray(np.stack([q for _, _, q in sub])),
                    fn=self._render)
                frames = np.moveaxis(np.asarray(frames), 1, -1)
                dt = (time.perf_counter() - t0) / len(sub)
                for (idx, _, _), img in zip(sub, frames):
                    if sink is not None:
                        sink(idx, img)
                    if stats:
                        frame_stats.append(FrameStats(primary, secondary, dt))
                last = frames[-1]
        return frame_stats if stats else last
