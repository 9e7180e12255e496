"""Pallas kernels (interpreter mode on CPU) vs the jnp renderer vs golden.

On the GPU these compile through Triton; on the CPU test backend they run in
the Pallas interpreter (ops/pallas/common.interpret_mode). Parity must hold
pixelwise.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from raytracing_engine_tpu.models import conemarch, pallas_renderer


def _pose(camera_pose):
    pos, quat = camera_pose
    return jnp.asarray(pos), jnp.asarray(quat)


def test_pallas_depth_matches_jnp(small_cfg, scene, camera_pose):
    pos, quat = _pose(camera_pose)
    want = conemarch.render_depth_pyramid(small_cfg, scene, pos, quat)
    got = pallas_renderer.render_depth_pyramid(small_cfg, scene, pos, quat)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape
        np.testing.assert_allclose(
            np.asarray(g), np.asarray(w), rtol=1e-4, atol=1e-3,
            err_msg=f"level {i}",
        )


def test_pallas_full_frame_matches_jnp(small_cfg, scene, camera_pose):
    pos, quat = _pose(camera_pose)
    want = np.asarray(conemarch.render_jit(small_cfg, scene, pos, quat))
    got = np.asarray(pallas_renderer.render_jit(small_cfg, scene, pos, quat))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=2e-3)


def test_pallas_matches_golden(small_cfg, scene, camera_pose, golden_image):
    pos, quat = _pose(camera_pose)
    got = np.asarray(pallas_renderer.render_jit(small_cfg, scene, pos, quat))
    np.testing.assert_allclose(got, golden_image, rtol=1e-3, atol=2e-3)


def test_static_count_specialization_matches(small_cfg, scene, camera_pose):
    """Kernels specialized to the live counts must match the masked kernels."""
    pos, quat = _pose(camera_pose)
    want = np.asarray(pallas_renderer.render_jit(small_cfg, scene, pos, quat))
    got = np.asarray(
        pallas_renderer.render_jit(
            small_cfg, scene, pos, quat,
            n_obj=int(scene.obj_count), n_light=int(scene.light_count),
        )
    )
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_fused_matches_two_kernel(small_cfg, scene, camera_pose):
    """Fused finest-depth+shade must equal the separate kernels bitwise."""
    pos, quat = _pose(camera_pose)
    want = np.asarray(
        pallas_renderer.render_jit(small_cfg, scene, pos, quat, fused=False)
    )
    got = np.asarray(
        pallas_renderer.render_jit(small_cfg, scene, pos, quat, fused=True)
    )
    np.testing.assert_array_equal(got, want)


def _frac_off(got, want, rtol, atol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    return (np.abs(got - want) > atol + rtol * np.abs(want)).mean()


@pytest.mark.parametrize("size", [(120, 72), (240, 136), (56, 40)])
def test_pallas_awkward_level_sizes(size, scene, camera_pose):
    """Frame sizes whose levels do not divide into power-of-two blocks
    (the 1080p pyramid has 120x72 and 240x136 levels): the padded edge
    blocks must render every column and row, matching the jnp renderer.
    A silhouette ray that grazes a sphere can converge one step apart
    under a different f32 rounding order, so a few pixels in ten thousand
    may differ; a lost edge row or column would be hundreds."""
    from raytracing_engine_tpu.config import RenderConfig

    cfg = RenderConfig(width=size[0], height=size[1])
    pos, quat = _pose(camera_pose)
    want = conemarch.render_depth_pyramid(cfg, scene, pos, quat)
    got = pallas_renderer.render_depth_pyramid(cfg, scene, pos, quat)
    for i, (g, w) in enumerate(zip(got, want)):
        assert _frac_off(g, w, 1e-4, 1e-3) < 5e-4, f"level {i}"
    img = pallas_renderer.render_jit(cfg, scene, pos, quat)
    ref = conemarch.render_jit(cfg, scene, pos, quat)
    assert _frac_off(img, ref, 1e-3, 2e-3) < 5e-4
