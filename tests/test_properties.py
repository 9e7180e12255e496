"""Property tests (SURVEY.md §4.5): invariants the renderer must keep
regardless of scene or camera."""

import numpy as np
import jax
import jax.numpy as jnp

from raytracing_engine_tpu.camera import Camera, integrate_input
from raytracing_engine_tpu.config import RenderConfig
from raytracing_engine_tpu.models import conemarch
from raytracing_engine_tpu.ops.march import shadow_march
from raytracing_engine_tpu.ops.sdf import scene_sdf_all


def _random_pose(seed):
    rng = np.random.default_rng(seed)
    pos = jnp.asarray(rng.normal(size=3).astype(np.float32) * 3)
    q = rng.normal(size=4).astype(np.float32)
    q /= np.linalg.norm(q)
    return pos, jnp.asarray(q)


def test_shadow_factor_in_unit_interval(scene):
    rng = np.random.default_rng(0)
    o = jnp.asarray(rng.normal(size=(128, 3)).astype(np.float32) * 5)
    d = rng.normal(size=(128, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    end = jnp.asarray(rng.uniform(0.1, 30, size=128).astype(np.float32))
    obj_mask = jnp.arange(scene.obj_pos.shape[0]) < scene.obj_count
    s = shadow_march(o, jnp.asarray(d), end, scene.obj_pos, scene.obj_radius,
                     obj_mask, 256)
    s = np.asarray(jnp.minimum(s, 1.0))
    assert (s >= 0).all() and (s <= 1).all()


def test_depth_nonnegative_all_levels(small_cfg, scene):
    for seed in (1, 2):
        pos, quat = _random_pose(seed)
        levels = conemarch.render_depth_pyramid(small_cfg, scene, pos, quat)
        for lvl in levels:
            assert (np.asarray(lvl) >= 0).all()


def test_hit_surface_consistency(small_cfg, scene):
    """Where the finest level reports a hit, the scene SDF at the hit point
    must be within the cone-termination slack (radius back-off + one step)."""
    pos, quat = _random_pose(3)
    depth = np.asarray(
        conemarch.render_depth_pyramid(small_cfg, scene, pos, quat)[-1]
    )
    from raytracing_engine_tpu.ops.raygen import pixel_norm_coords, ray_directions

    n = small_cfg.level_count - 1
    nc = pixel_norm_coords(
        small_cfg.width, small_cfg.height,
        jnp.array(small_cfg.level_image_size(n)), jnp.array(small_cfg.ratio),
    )
    d = np.asarray(ray_directions(nc, quat))
    hit = depth < small_cfg.render_dist * 0.9
    pts = np.asarray(pos)[None, None] + d * depth[..., None]
    sdf = np.asarray(
        scene_sdf_all(jnp.asarray(pts), scene.obj_pos, scene.obj_radius)
    )
    sdf = np.where(
        np.arange(scene.obj_pos.shape[0]) < int(scene.obj_count), sdf, np.inf
    ).min(-1)
    # termination: dist <= radius = (len+1)*threshold, then len -= radius,
    # so |sdf| at the stored point is bounded by ~2*radius of that distance
    slack = 2.0 * (depth + 1.0) * small_cfg.level_threshold(n) + 1e-2
    assert (np.abs(sdf[hit]) <= slack[hit]).mean() > 0.99


def test_image_nonnegative_finite(small_cfg, scene):
    pos, quat = _random_pose(4)
    img = np.asarray(conemarch.render_jit(small_cfg, scene, pos, quat))
    assert np.isfinite(img).all()
    assert (img >= 0).all()


def test_pitch_always_clamped():
    cam = Camera.initial()
    for _ in range(50):
        cam = integrate_input(
            cam,
            jnp.zeros(3),
            jnp.array([0.0, 1.0]),          # pitch key held hard
            jnp.array([0.0, 500.0]),        # plus violent mouse
            jnp.float32(0.1),
            jnp.float32(512.0),
        )
    assert abs(float(cam.rotation[1])) <= np.pi / 2 + 1e-6


def test_resize_respecializes(scene):
    """Rendering works across a resize (jit respecializes per config)."""
    from raytracing_engine_tpu.runtime import FrameLoop, InputEvent

    loop = FrameLoop(RenderConfig(width=64, height=64), scene)
    a = loop.step(InputEvent())
    assert a.shape == (64, 64, 3)
    b = loop.step(InputEvent(resize=(128, 64)))
    assert b.shape == (64, 128, 3)
    c = loop.step(InputEvent(resize=(64, 128)))  # width>=height enforced
    assert c.shape == (64, 64, 3)


def test_frameloop_window_events(scene):
    """quit / focus-freeze / F11 fullscreen semantics (src/main.rs:682-717)."""
    import numpy as np
    from raytracing_engine_tpu.runtime import FrameLoop, InputEvent

    loop = FrameLoop(RenderConfig(width=64, height=64), scene)
    loop.monitor = (128, 64)  # tiny "monitor" keeps the test fast

    a = loop.step(InputEvent())
    assert loop.cursor_grabbed and not loop.frozen

    # focus lost -> frozen: no integration, no render, cursor released
    pos_before = np.asarray(loop.camera.position).copy()
    f = loop.step(InputEvent(focus=False))
    assert loop.frozen and not loop.cursor_grabbed
    assert f is a  # frozen frame returns the last image, renders nothing
    loop.step(InputEvent(move=(0, 1, 0), dt=1.0))  # ignored while frozen
    np.testing.assert_array_equal(np.asarray(loop.camera.position), pos_before)

    # window-state events apply even while frozen (reference sets flags
    # regardless of focus; only rendering is skipped)
    loop.step(InputEvent(focus=False))
    loop.step(InputEvent(resize=(96, 64)))
    assert loop.cfg.width == 96 and loop.frozen

    # focus regained -> unfreeze + grab; next frame uses the frozen resize
    loop.step(InputEvent(focus=True))
    assert not loop.frozen and loop.cursor_grabbed
    r = loop.step(InputEvent())
    assert r.shape == (64, 96, 3)
    loop.step(InputEvent(resize=(64, 64)))  # restore for the rest

    # F11 -> monitor resolution; F11 again -> windowed size restored
    b = loop.step(InputEvent(fullscreen_toggle=True))
    assert loop.fullscreen and b.shape == (64, 128, 3)
    c = loop.step(InputEvent(fullscreen_toggle=True))
    assert not loop.fullscreen and c.shape == (64, 64, 3)

    # Escape -> quit; run() stops consuming events
    loop.step(InputEvent(quit=True))
    assert loop.quit
    loop2 = FrameLoop(RenderConfig(width=64, height=64), scene)
    seen = []
    events = [InputEvent(), InputEvent(quit=True), InputEvent()]
    loop2.run(events, sink=lambda i, im: seen.append(i))
    assert seen == [0] and loop2.quit


def test_progressive_accumulate_donation(scene):
    """The donated accumulator produces the same sums as a plain add."""
    import jax.numpy as jnp
    import numpy as np
    from raytracing_engine_tpu.runtime.checkpoint import _accumulate

    acc = jnp.ones((8, 8, 3))
    img = jnp.full((8, 8, 3), 0.5)
    out = _accumulate(acc, img, jnp.float32(4))
    np.testing.assert_allclose(np.asarray(out), 3.0)


def test_render_sequence_matches_per_frame(scene):
    """One-dispatch K-frame serving equals K individual renders.

    Compile cache off for the same reason as the chunked-run test below:
    the chained conemarch-sequence executables crash jaxlib's XLA:CPU AOT
    cache path — observed on WRITE (put_executable_and_time, 3x) and on
    READ of a sibling artifact (get_executable_and_time) — taking the
    xdist worker down with a fatal signal.
    """
    import jax

    jax.config.update("jax_enable_compilation_cache", False)
    try:
        _render_sequence_case(scene)
    finally:
        jax.config.update("jax_enable_compilation_cache", True)


def _render_sequence_case(scene):
    import jax.numpy as jnp
    import numpy as np
    from raytracing_engine_tpu.models import conemarch
    from raytracing_engine_tpu.runtime import render_sequence

    cfg = RenderConfig(width=64, height=64)
    positions = jnp.asarray(np.array(
        [[0.0, 0.0, 0.0], [0.0, -1.0, 0.5], [0.5, -2.0, 0.0]], np.float32))
    quats = jnp.asarray(np.array(
        [[0, 0, 0, 1.0], [0.05, 0, 0, 0.9987], [0, 0, 0.05, 0.9987]],
        np.float32))
    seq = render_sequence(cfg, scene, positions, quats, fn=conemarch.render)
    assert seq.shape == (3, 3, 64, 64)  # (K, channel, H, W) — see docstring
    frames = np.moveaxis(np.asarray(seq), 1, -1)
    for i in range(3):
        want = conemarch.render(cfg, scene, positions[i], quats[i])
        np.testing.assert_allclose(frames[i], np.asarray(want),
                                   rtol=1e-6, atol=1e-6)


def test_frameloop_chunked_run_matches_per_frame(scene):
    """run(chunk=K) — batched replay serving — produces the same frames at
    the same event indices as the per-frame loop, across a resize (cfg
    change = chunk-group boundary).

    The persistent compile cache is disabled for this test: serializing
    THIS test's executables for the cache dies inside jaxlib's XLA:CPU
    AOT export ("Fatal Python error: Segmentation fault/Aborted" in
    compilation_cache.put_executable_and_time — reproduced three times,
    always this test, killing the whole xdist worker). Every other test
    keeps the cache.
    """
    import jax
    import numpy as np
    from raytracing_engine_tpu.runtime import FrameLoop, InputEvent

    jax.config.update("jax_enable_compilation_cache", False)
    try:
        _run_chunked_case(scene)
    finally:
        jax.config.update("jax_enable_compilation_cache", True)


def _run_chunked_case(scene):
    import numpy as np
    from raytracing_engine_tpu.runtime import FrameLoop, InputEvent

    cfg = RenderConfig(width=64, height=64)
    events = (
        [InputEvent(move=(1.0, 0.5, 0.0), cursor=(3.0, 1.0), dt=0.02)] * 4
        + [InputEvent(resize=(72, 48))]
        + [InputEvent(rot=(1.0, 0.0), dt=0.03)] * 3
    )

    a, b = {}, {}
    FrameLoop(cfg, scene).run(events, sink=lambda i, im: a.__setitem__(i, im))
    FrameLoop(cfg, scene).run(events, sink=lambda i, im: b.__setitem__(i, im),
                              chunk=3)
    assert set(a) == set(b)
    for i in a:
        np.testing.assert_allclose(b[i], a[i], rtol=1e-6, atol=1e-6)
