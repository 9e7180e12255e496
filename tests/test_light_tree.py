"""Two-level light tree: build invariants, sampler parity across the
independently-written engines, unbiasedness (NEE + hit-side MIS must use
the exact same position-dependent pdf), and the variance win on a
many-light scene that motivates the feature.

The reference shades every light it has (a flat loop,
/root/reference/shaders/fragment.glsl:170-185); at 8 lights that is fine.
The tree is the north-star many-light answer: selection cost stays a
static C-axis + L-axis walk of vector ops (no pointer chasing, no
gathers), which is the gather-free reading of a light BVH.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from raytracing_engine_tpu.pathtracer import PTConfig, render_pt_fast
from raytracing_engine_tpu.pathtracer import integrator as ig
from raytracing_engine_tpu.pathtracer import wavefront as wf
from raytracing_engine_tpu.pathtracer.scene import DIFFUSE, build_pt_scene

KEY = jax.random.PRNGKey(11)
QUAT = jnp.array([0.0, 0.0, 0.0, 1.0])


def grid_light_scene(light_tree=0, n=4):
    """A big diffuse floor under an n x n grid of EQUAL emissive spheres
    spread far apart. Power-weighted selection degenerates to uniform
    (all powers equal); with inverse-square falloff only the nearest
    light matters at any floor point, so the tree's distance term is
    the whole game."""
    mats = [{"albedo": (0.6, 0.6, 0.6), "kind": DIFFUSE}] + [
        {"albedo": (0, 0, 0), "emission": (40.0, 32.0, 24.0)}
        for _ in range(n * n)
    ]
    spheres = [((0.0, 30.0, -1001.0), 1000.0, 0)]  # floor, ahead + below
    k = 1
    for i in range(n):
        for j in range(n):
            spheres.append(((i * 16.0 - 24.0, 14.0 + j * 16.0, 2.0),
                            0.4, k))
            k += 1
    return build_pt_scene(spheres=spheres, materials=mats,
                          light_tree=light_tree)


def test_tree_tables():
    s = grid_light_scene(light_tree=4)
    L = int(s.light_count)
    cl = np.asarray(s.lt_cluster)
    pick = np.asarray(s.lt_pick_intra)
    cdf = np.asarray(s.lt_cdf_intra)
    power = np.asarray(s.lt_power)
    assert s.has_light_tree
    assert s.lt_center.shape == (4, 3)
    # every cluster non-empty, picks sum to 1 within each, CDF ends at 1
    for c in range(4):
        m = cl[:L] == c
        assert m.any()
        np.testing.assert_allclose(pick[:L][m].sum(), 1.0, rtol=1e-5)
        assert cdf[:L][m].max() == 1.0
    # padding is inert: zero pick, CDF pinned to 1, cluster 0
    assert (pick[L:] == 0).all() and (cdf[L:] == 1).all()
    # cluster powers partition the total
    np.testing.assert_allclose(power.sum(), float(s.light_total_power),
                               rtol=1e-5)
    # every member light sits inside its cluster's bounding sphere
    centers = np.asarray(s.lt_center)
    radii = np.asarray(s.lt_radius)
    pos = np.asarray(s.sph_pos)[np.asarray(s.light_prim)[:L]]
    for k in range(L):
        c = int(cl[k])
        assert np.linalg.norm(pos[k] - centers[c]) <= radii[c] + 1e-4


def test_build_raises():
    mats = [{"albedo": (0.6,) * 3},
            {"albedo": (0, 0, 0), "emission": (5.0,) * 3}]
    tris = np.array([[[-1, 5, 2], [1, 5, 2], [0, 5, 3]]], np.float32)
    with pytest.raises(ValueError, match="light_tree is incompatible"):
        build_pt_scene(triangles=tris, tri_mats=[1], materials=mats,
                       mesh_lights=True, light_tree=2)
    with pytest.raises(ValueError, match="no emissive"):
        build_pt_scene(spheres=[((0, 5, 0), 1.0, 0)], materials=mats[:1],
                       light_tree=2)


def test_render_requires_tables():
    scene = grid_light_scene(light_tree=0)
    cfg = PTConfig(width=8, height=8, max_bounces=1, rng="pcg",
                   light_sampling="tree")
    with pytest.raises(ValueError, match="light_tree=C"):
        render_pt_fast(cfg, scene, jnp.zeros(3), QUAT, 1, KEY)
    with pytest.raises(ValueError, match="light_tree=C"):
        ig.render_pt(dataclasses.replace(cfg, rng="threefry"), scene,
                     jnp.zeros(3), QUAT, 1, KEY)


def test_sampler_parity_integrator_vs_wavefront():
    """The unrolled plane-native walk (wavefront) and the vectorized
    gather/argmax formulation (integrator) must select the same light
    with the same pdf for the same (u, p) — two independent derivations
    of one distribution."""
    s = grid_light_scene(light_tree=4)
    rng = np.random.default_rng(0)
    N = 2048
    u_sel = jnp.asarray(rng.random(N, dtype=np.float32))
    u1 = jnp.asarray(rng.random(N, dtype=np.float32))
    u2 = jnp.asarray(rng.random(N, dtype=np.float32))
    p3 = jnp.asarray(rng.uniform(-40, 60, (N, 3)).astype(np.float32))
    pt_i, n_i, le_i, pdf_i = ig.sample_light_point(s, u_sel, u1, u2,
                                                   tree_p3=p3)
    pt_w, n_w, le_w, pdf_w = wf._sample_light(
        s, u_sel, u1, u2, tree_p=(p3[:, 0], p3[:, 1], p3[:, 2]))
    np.testing.assert_allclose(np.asarray(pt_i), np.asarray(jnp.stack(pt_w, -1)),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np.asarray(pdf_i), np.asarray(pdf_w),
                               rtol=1e-4)
    np.testing.assert_allclose(np.asarray(le_i),
                               np.asarray(jnp.stack(le_w, -1)), rtol=1e-5)


def test_selection_frequency_matches_pdf():
    """MC frequencies of the chosen light match the analytic two-level
    probabilities at a fixed shading point."""
    s = grid_light_scene(light_tree=4)
    L = int(s.light_count)
    p0 = np.array([-24.0, 14.0, 1.0], np.float32)  # next to light (0, 0)
    N = 200_000
    rng = np.random.default_rng(1)
    us = jnp.asarray(rng.random(N, dtype=np.float32))
    half = jnp.full((N,), 0.5, jnp.float32)
    pt, _, _, _ = ig.sample_light_point(
        s, us, half, half, tree_p3=jnp.broadcast_to(jnp.asarray(p0), (N, 3)))
    centers = np.asarray(s.sph_pos)[np.asarray(s.light_prim)[:L]]
    picked = np.argmin(
        np.linalg.norm(np.asarray(pt)[:, None, :] - centers, axis=-1),
        axis=1)
    freq = np.bincount(picked, minlength=L) / N
    # analytic: cluster weight = power / max(d^2, r^2), then power CDF
    w, wtot = ig.tree_cluster_weights(s, jnp.asarray(p0))
    pcl = np.asarray(w) / float(wtot)
    want = pcl[np.asarray(s.lt_cluster)[:L].astype(int)] * \
        np.asarray(s.lt_pick_intra)[:L]
    np.testing.assert_allclose(freq, want, atol=0.01)
    # the near cluster must beat blind (uniform/power) selection even at
    # this coarse C=4 (the bounding-radius clamp flattens weights inside
    # a cluster's sphere — per-light clusters sharpen it, see the MSE
    # test)
    assert want.max() > 1.5 / L


def test_tree_unbiased_and_lower_mse():
    """Tree and power renders converge to the same image (NEE pdf and
    hit-side MIS pdf agree — any mismatch would bias, not just add
    noise), and the tree cuts MSE on the equal-power grid where power
    selection is blind.

    Two calibration notes (both verified by high-spp sweeps):
    - Mean checks run at 128 spp: the per-pixel estimator is heavy-tailed
      (a power-blind pick of the near light carries weight L), so 16-spp
      image means swing ~15% around the truth while 128-spp means sit
      within ~3% across seeds.
    - The MSE comparison is restricted to FLOOR pixels (ref < 1): the
      r=0.4 Le=40 emissive spheres subtend a fraction of a pixel at this
      resolution, so directly-visible-light pixels are binary AA noise
      identical under both samplers, and at full-image scale that noise
      (~40² per miss) swamps the light-selection variance the tree
      actually removes. Summed over 3 seeds the floor-MSE ratio measures
      0.56-0.68; asserted < 0.85."""
    cfg = PTConfig(width=32, height=24, max_bounces=1, rng="pcg")
    cfg_tree = dataclasses.replace(cfg, light_sampling="tree")
    pos = jnp.array([0.0, 0.0, 1.0])
    s_pow = grid_light_scene()
    # per-light clusters (C = L): the finest tree — the weight loop is
    # still a static 16-iteration vector sweep, no gathers
    s_tree = grid_light_scene(light_tree=16)

    ref, _ = render_pt_fast(cfg, s_pow, pos, QUAT, 3072,
                            jax.random.PRNGKey(7))
    ref = np.asarray(ref)
    floor = ref.max(-1) < 1.0
    assert floor.mean() > 0.9  # scene sanity: lights are sub-pixel

    t128, _ = render_pt_fast(cfg_tree, s_tree, pos, QUAT, 128, KEY)
    p128, _ = render_pt_fast(cfg, s_pow, pos, QUAT, 128, KEY)
    t128, p128 = np.asarray(t128), np.asarray(p128)
    assert abs(t128.mean() - ref.mean()) / ref.mean() < 0.05
    assert abs(p128.mean() - ref.mean()) / ref.mean() < 0.05

    mse_t = mse_p = 0.0
    for seed in (0, 1, 11):
        k = jax.random.PRNGKey(seed)
        t, _ = render_pt_fast(cfg_tree, s_tree, pos, QUAT, 64, k)
        p, _ = render_pt_fast(cfg, s_pow, pos, QUAT, 64, k)
        t, p = np.asarray(t), np.asarray(p)
        mse_t += float(((t - ref) ** 2)[floor].mean())
        mse_p += float(((p - ref) ** 2)[floor].mean())
    # the headline: nearest-light-aware selection on a 16-equal-light
    # scene, on the pixels where selection is the estimator.
    assert mse_t < 0.85 * mse_p, (mse_t, mse_p)


def test_tree_unbiased_with_bsdf_hits():
    """Deeper bounces + directly visible lights: exercises the hit-side
    tree MIS pdf (computed from the PREVIOUS vertex via st['o']) against
    the stacked reference integrator as an independent estimator.

    Compared on floor pixels: the two engines draw independent RNG
    streams, so sub-pixel direct views of the Le=40 spheres differ by
    pure AA noise (~7% of the image mean at 384 spp) that no estimator
    controls; the hit-side MIS under test only contributes to floor
    pixels (bounce-0 light hits carry MIS weight 1). Floor means agree
    to ~0.6% at 384 spp."""
    cfg = PTConfig(width=24, height=16, max_bounces=2, rng="pcg",
                   light_sampling="tree")
    pos = jnp.array([0.0, 0.0, 1.0])
    s = grid_light_scene(light_tree=4)
    a, _ = render_pt_fast(cfg, s, pos, QUAT, 384, KEY)
    b, _ = ig.render_pt(dataclasses.replace(cfg, rng="threefry"), s, pos,
                        QUAT, 384, jax.random.PRNGKey(3))
    a, b = np.asarray(a), np.asarray(b)
    floor = np.minimum(a, b).max(-1) < 1.0
    assert floor.mean() > 0.9
    am, bm = float(a[floor].mean()), float(b[floor].mean())
    assert abs(am - bm) / bm < 0.05
