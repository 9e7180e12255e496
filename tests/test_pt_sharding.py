"""Sharded path tracing vs single-device (8 virtual CPU devices)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from raytracing_engine_tpu.parallel import make_mesh
from raytracing_engine_tpu.parallel.pt_sharding import render_pt_sharded, sharded_pt_step
from raytracing_engine_tpu.pathtracer import PTConfig, render_pt
from raytracing_engine_tpu.pathtracer.scenes import material_spheres

KEY = jax.random.PRNGKey(21)


@pytest.fixture(scope="module")
def setup():
    cfg = PTConfig(width=32, height=24, max_bounces=2)
    scene = material_spheres()
    pos = jnp.zeros(3)
    quat = jnp.array([0.0, 0.0, 0.0, 1.0])
    want, want_rays = render_pt(cfg, scene, pos, quat, 8, KEY)
    return cfg, scene, pos, quat, np.asarray(want), float(want_rays)


@pytest.mark.parametrize("tiles,samples", [(8, 1), (4, 2), (2, 4), (1, 8)])
def test_sharded_pt_matches_single(setup, tiles, samples):
    cfg, scene, pos, quat, want, want_rays = setup
    mesh = make_mesh(tiles, samples)
    got, nrays = render_pt_sharded(cfg, scene, pos, quat, 8, KEY, mesh)
    # same sample set; only float summation order differs across shardings
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-5, atol=1e-6)
    assert abs(float(nrays) - want_rays) < 1e-3


def test_sharded_pt_step_jits(setup):
    cfg, scene, pos, quat, want, _ = setup
    step = sharded_pt_step(cfg, 8, make_mesh(4, 2))
    img, _ = step(scene, pos, quat, KEY)
    np.testing.assert_allclose(np.asarray(img), want, rtol=1e-5, atol=1e-6)


def test_spp_divisibility_error(setup):
    cfg, scene, pos, quat, _, _ = setup
    with pytest.raises(ValueError):
        render_pt_sharded(cfg, scene, pos, quat, 7, KEY, make_mesh(1, 8))


def test_sharded_soa_pcg_matches_unsharded(setup):
    """Counter-based RNG: sharded soa render equals render_pt_fast exactly
    (up to psum reassociation)."""
    from raytracing_engine_tpu.pathtracer.wavefront import render_pt_fast
    import dataclasses

    cfg, scene, pos, quat, _, _ = setup
    cfg = dataclasses.replace(cfg, rng="pcg")
    want, _ = render_pt_fast(cfg, scene, pos, quat, 8, KEY)
    got, _ = render_pt_sharded(cfg, scene, pos, quat, 8, KEY,
                               make_mesh(4, 2), soa=True)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-5, atol=1e-6)


def test_progressive_sharded_resume_across_mesh_shapes(setup, tmp_path):
    """A multi-chip progressive job checkpointed on one mesh shape resumes
    on ANOTHER shape (preemption/reshape survival) and reproduces the
    single-device render: passes are keyed by GLOBAL index, so the sample
    set is chunking- and device-count-invariant (VERDICT round-2 item 6)."""
    import dataclasses

    from raytracing_engine_tpu.pathtracer.wavefront import render_pt_fast
    from raytracing_engine_tpu.runtime.checkpoint import (
        ProgressiveState,
        load_checkpoint,
        progressive_render,
    )

    cfg, scene, pos, quat, _, _ = setup
    cfg = dataclasses.replace(cfg, rng="pcg")
    want, _ = render_pt_fast(cfg, scene, pos, quat, 8, KEY)

    path = str(tmp_path / "prog.npz")
    state = ProgressiveState(
        accum=jnp.zeros((cfg.height, cfg.width, 3), jnp.float32),
        spp_done=0, key=KEY, cam_pos=pos, cam_quat=quat)
    # first 4 spp on a (2 tiles x 2 samples) mesh, wavefront per band
    for state in progressive_render(cfg, scene, state, 4,
                                    passes_per_chunk=4, mesh=make_mesh(2, 2),
                                    checkpoint_path=path):
        pass
    assert state.spp_done == 4
    # resume from disk on a DIFFERENT mesh shape for the remaining 4
    state = load_checkpoint(path)
    for state in progressive_render(cfg, scene, state, 8,
                                    passes_per_chunk=4, mesh=make_mesh(4, 1),
                                    checkpoint_path=path):
        pass
    assert state.spp_done == 8
    np.testing.assert_allclose(state.image, np.asarray(want),
                               rtol=1e-5, atol=1e-6)


def test_sharded_glass_env_dof_matches_single():
    """Round-3 features (dielectric + env light + DOF + RR) compose with
    tile/sample sharding: the sharded render equals the single-device one
    (the front-face and env planes are ordinary device-varying planes
    under shard_map; the lens/roulette randoms are drawn image-wide and
    sliced)."""
    from raytracing_engine_tpu.pathtracer.scene import (
        DIELECTRIC,
        DIFFUSE,
        build_pt_scene,
    )

    mats = [
        {"albedo": (0.6, 0.6, 0.6), "kind": DIFFUSE},
        {"kind": DIELECTRIC, "ior": 1.5},
        {"albedo": (0, 0, 0), "emission": (10.0,) * 3, "kind": DIFFUSE},
    ]
    scene = build_pt_scene(
        spheres=[((0.0, 6.0, -101.5), 100.0, 0),
                 ((0.0, 6.0, 0.0), 1.0, 1),
                 ((3.0, 4.0, 4.0), 0.8, 2)],
        materials=mats, env=((0.1, 0.1, 0.2), (0.5, 0.6, 0.9)))
    cfg = PTConfig(width=32, height=24, max_bounces=4, aperture=0.2,
                   focus_dist=6.0, rr_start=2)
    pos = jnp.zeros(3)
    quat = jnp.array([0.0, 0.0, 0.0, 1.0])
    want, want_rays = render_pt(cfg, scene, pos, quat, 8, KEY)
    got, nrays = render_pt_sharded(cfg, scene, pos, quat, 8, KEY,
                                   make_mesh(4, 2))
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-5, atol=1e-6)
    assert abs(float(nrays) - float(want_rays)) < 1e-3
