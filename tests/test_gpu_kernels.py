"""Card-only tests: the Triton kernels as compiled for the GPU.

Each test requests the `gpu` fixture (tests/conftest.py), so it skips on the
CPU suite and runs on the card through `python chip_smoke.py`. The CPU
suite covers the same kernels in the Pallas interpreter and checks that
they lower for CUDA (tests/test_triton_lowering.py).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

pytestmark = pytest.mark.gpu


def _rays(h, w, target_y, spread, seed=0):
    rng = np.random.default_rng(seed)
    tx = rng.normal(0.0, spread, (h, w)).astype(np.float32)
    ty = np.full((h, w), target_y, np.float32)
    tz = rng.normal(0.0, spread, (h, w)).astype(np.float32)
    n = np.sqrt(tx * tx + ty * ty + tz * tz)
    o = tuple(jnp.zeros((h, w), jnp.float32) for _ in range(3))
    return o, (jnp.asarray(tx / n), jnp.asarray(ty / n), jnp.asarray(tz / n))


def test_interpret_mode_is_off_on_the_card(gpu):
    from raytracing_engine_tpu.ops.pallas.common import interpret_mode

    assert interpret_mode() is False


@pytest.mark.parametrize("size", [(64, 64), (120, 72), (512, 512)])
def test_conemarch_compiled_matches_xla(gpu, size, scene, camera_pose):
    from raytracing_engine_tpu.config import RenderConfig
    from raytracing_engine_tpu.models import conemarch, pallas_renderer

    cfg = RenderConfig(width=size[0], height=size[1])
    pos, quat = (jnp.asarray(x) for x in camera_pose)
    want = np.asarray(conemarch.render_jit(cfg, scene, pos, quat))
    got = np.asarray(pallas_renderer.render_jit(cfg, scene, pos, quat))
    assert got.shape == want.shape and np.isfinite(got).all()
    # the card's approximate f32 division moves a few marches by an ulp:
    # compare per pixel, allow a small share of pixels to differ
    bad = np.abs(got - want).max(-1) > 2e-3
    assert bad.mean() < 5e-3, f"{bad.mean():.4%} of pixels differ"


def test_cluster_compiled_matches_bvh(gpu):
    from raytracing_engine_tpu.accel import build_bvh, icosphere
    from raytracing_engine_tpu.accel.bvh import bvh_intersect
    from raytracing_engine_tpu.accel.clusters import build_clusters
    from raytracing_engine_tpu.ops.pallas.cluster_intersect import (
        cluster_intersect)

    mesh = icosphere(subdivisions=4, radius=1.2, center=(0.0, 5.0, 0.0))
    cs, bvh = build_clusters(mesh), build_bvh(mesh)
    o, d = _rays(96, 160, 5.0, 1.6)
    t_c, slot = cluster_intersect(cs, o, d, jnp.inf)
    t_b, ridx, _, _ = bvh_intersect(bvh, jnp.stack(o, -1), jnp.stack(d, -1))
    t_c, t_b = np.asarray(t_c), np.asarray(t_b)
    hit = np.isfinite(t_b)
    assert hit.mean() > 0.2
    np.testing.assert_array_equal(np.isfinite(t_c), hit)
    np.testing.assert_allclose(t_c[hit], t_b[hit], rtol=1e-4)
    tri_c = np.asarray(cs.perm)[np.asarray(slot)[hit]]
    tri_b = np.asarray(bvh.perm)[np.asarray(ridx)[hit]]
    assert (tri_c == tri_b).mean() > 0.995


def test_instanced_compiled_matches_plain(gpu):
    from raytracing_engine_tpu.accel import build_bvh, icosphere
    from raytracing_engine_tpu.accel.clusters import build_clusters
    from raytracing_engine_tpu.accel.instancing import (
        grid_instances, instanced_intersect)
    from raytracing_engine_tpu.ops.pallas.instanced_intersect import (
        instanced_cluster_intersect, pack_instances)

    mesh = icosphere(subdivisions=3, radius=0.8)
    bvh = build_bvh(mesh)
    inst = grid_instances(bvh, nx=4, ny=3, spacing=2.5, base=(0.0, 8.0, 0.0))
    cs = build_clusters(mesh, bvh=bvh)
    o, d = _rays(64, 128, 9.0, 3.0, seed=1)
    t_k, code = instanced_cluster_intersect(pack_instances(inst), cs, o, d)
    t_g, gi, _, _ = instanced_intersect(inst, jnp.stack(o, -1),
                                        jnp.stack(d, -1))
    t_k, t_g = np.asarray(t_k), np.asarray(t_g)
    hit = np.isfinite(t_g)
    assert hit.any()
    np.testing.assert_array_equal(np.isfinite(t_k), hit)
    np.testing.assert_allclose(t_k[hit], t_g[hit], rtol=2e-4, atol=2e-4)
    inst_k = np.asarray(code)[hit] // cs.padded_tris
    assert (inst_k == np.asarray(gi)[hit]).mean() > 0.995


def test_cluster_anyhit_compiled_agrees_with_closest(gpu):
    from raytracing_engine_tpu.accel import icosphere
    from raytracing_engine_tpu.accel.clusters import build_clusters
    from raytracing_engine_tpu.ops.pallas.cluster_intersect import (
        cluster_intersect)

    cs = build_clusters(icosphere(subdivisions=3, radius=1.2,
                                  center=(0.0, 5.0, 0.0)))
    o, d = _rays(40, 72, 5.0, 1.6, seed=2)
    t_c, _ = cluster_intersect(cs, o, d, jnp.inf)
    _, idx_a = cluster_intersect(cs, o, d, jnp.inf, any_hit=True)
    np.testing.assert_array_equal(np.isfinite(np.asarray(t_c)),
                                  np.asarray(idx_a) >= 0)
    _, idx_cut = cluster_intersect(cs, o, d, 2.0, any_hit=True)
    assert (np.asarray(idx_cut) == -1).all()
    jax.block_until_ready(idx_cut)
