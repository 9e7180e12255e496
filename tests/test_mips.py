"""Trilinear mip filtering (ray-cone LOD over packed mip chains).

Covers VERDICT round-3 item 10: mip-chain atlas packing, LOD from ray
spread, and the None-gated off-state (a tex_mips scene renders
bit-identically to an unmipped one under nearest/bilinear — level 0 IS
the image).

The reference renders analytic SDF colors with no textures at all
(/root/reference/shaders/fragment.glsl); texture filtering is a
north-star material extension, so the anchor here is internal
consistency + the filtering math itself.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from raytracing_engine_tpu.pathtracer import PTConfig
from raytracing_engine_tpu.pathtracer.scene import (
    DIFFUSE,
    build_mip_chain,
    build_pt_scene,
)
from raytracing_engine_tpu.pathtracer.wavefront import render_pt_fast

KEY = jax.random.PRNGKey(7)
QUAT = jnp.array([0.0, 0.0, 0.0, 1.0])


def _checker_img(n=16):
    img = np.zeros((n, n, 3), np.float32)
    img[::2, ::2] = (1.0, 0.2, 0.1)
    img[1::2, 1::2] = (0.1, 0.2, 1.0)
    return img


def _textured_scene(mips, img=None, scale=8.0):
    img = _checker_img() if img is None else img
    mats = [{"albedo": (1, 1, 1), "kind": DIFFUSE,
             "image": {"pixels": img, "scale": scale}},
            {"albedo": (0, 0, 0), "emission": (10.0,) * 3, "kind": DIFFUSE}]
    return build_pt_scene(
        spheres=[((0.0, 8.0, -51.0), 50.0, 0), ((0.0, 8.0, 4.0), 1.0, 1)],
        materials=mats, env=((0.3, 0.3, 0.3), (0.5, 0.5, 0.5)),
        tex_mips=mips)


# ---------------------------------------------------------------------------
# packing
# ---------------------------------------------------------------------------

def test_mip_chain_box_filter():
    rng = np.random.RandomState(0)
    img = rng.rand(8, 8, 3).astype(np.float32)
    ch = build_mip_chain(img)
    assert [c.shape[:2] for c in ch] == [(8, 8), (4, 4), (2, 2), (1, 1)]
    # level 1 is the exact 2x2 box average of level 0
    want = 0.25 * (img[0::2, 0::2] + img[1::2, 0::2]
                   + img[0::2, 1::2] + img[1::2, 1::2])
    np.testing.assert_allclose(ch[1], want, rtol=1e-6)
    # the 1x1 tail is the global mean (box filters preserve the mean)
    np.testing.assert_allclose(ch[-1][0, 0], img.mean(axis=(0, 1)),
                               rtol=1e-5)


def test_mip_chain_odd_dims():
    img = np.arange(5 * 3 * 3, dtype=np.float32).reshape(5, 3, 3)
    ch = build_mip_chain(img)
    assert ch[1].shape[:2] == (3, 2) and ch[-1].shape[:2] == (1, 1)


def test_mip_table_level0_is_base_rect():
    sc = _textured_scene(True)
    mips = np.asarray(sc.mat_tex_mips)
    rect = np.asarray(sc.mat_tex_rect)
    assert sc.has_mips and sc.n_mip_levels == 5  # 16 -> 8 -> 4 -> 2 -> 1
    np.testing.assert_array_equal(mips[0, :4], rect[0])
    # per-level widths halve; the table pads short chains with the tail
    assert list(mips[0, 2::4]) == [16.0, 8.0, 4.0, 2.0, 1.0]
    # level-0 texels in the mipped atlas match the unmipped atlas
    sc0 = _textured_scene(False)
    a, a0 = np.asarray(sc.tex_atlas), np.asarray(sc0.tex_atlas)
    K, K0 = a.shape[0] // 3, a0.shape[0] // 3
    x0, y0, w, h = rect[0].astype(int)
    for c in range(3):
        np.testing.assert_array_equal(a[c * K + y0:c * K + y0 + h,
                                        x0:x0 + w],
                                      a0[c * K0:c * K0 + h, :w])


# ---------------------------------------------------------------------------
# LOD selection (direct sampler probe)
# ---------------------------------------------------------------------------

def test_sampler_picks_levels_by_footprint():
    """A single white texel at (0,0) halves in value per mip level
    (8x8: level k averages it over 4^k texels). Sampling at that texel's
    center with a footprint of 2^k level-0 texels must return level k's
    value — the direct probe of the ray-cone -> LOD mapping."""
    from raytracing_engine_tpu.pathtracer.wavefront import _sample_rect_tri

    img = np.zeros((8, 8, 3), np.float32)
    img[0, 0] = 1.0
    sc = _textured_scene(True, img=img, scale=1.0)
    mat = jnp.zeros((1, 8), jnp.int32)
    # uv at the (0,0) texel center of every level (u=v=1/16 hits texel
    # centers at levels 0/1 via rect-clamped bilinear corners)
    uv = (jnp.full((1, 8), 1.0 / 16.0), jnp.full((1, 8), 1.0 / 16.0))
    s = jnp.ones((1, 8))
    for k, want in [(0, 1.0), (1, 0.25), (2, 1.0 / 16.0), (3, 1.0 / 64.0)]:
        fp = jnp.full((1, 8), (2.0 ** k) / 8.0)  # 2^k level-0 texels
        r, g, b = _sample_rect_tri(sc, mat, uv, s, fp)
        got = float(r[0, 0])
        assert got == pytest.approx(want, rel=1e-4), (k, got, want)
    # footprints between levels lerp the two bracketing levels
    fp = jnp.full((1, 8), (2.0 ** 0.5) / 8.0)  # lod = 0.5
    r, _, _ = _sample_rect_tri(sc, mat, uv, s, fp)
    assert float(r[0, 0]) == pytest.approx(0.5 * 1.0 + 0.5 * 0.25, rel=1e-3)
    # past the chain it clamps to the 1x1 mean
    fp = jnp.full((1, 8), 100.0)
    r, _, _ = _sample_rect_tri(sc, mat, uv, s, fp)
    assert float(r[0, 0]) == pytest.approx(1.0 / 64.0, rel=1e-3)


# ---------------------------------------------------------------------------
# renders
# ---------------------------------------------------------------------------

def _cfg(**kw):
    return PTConfig(width=64, height=32, max_bounces=2, rng="pcg", **kw)


def test_nearest_bit_identical_on_mipped_scene():
    """tex_mips=True must not change nearest/bilinear renders at all:
    level 0 is packed first, so mat_tex_rect addresses the same texels."""
    pos = jnp.zeros(3)
    for f in ("nearest", "bilinear"):
        cfg = _cfg(tex_filter=f)
        a0, _ = render_pt_fast(cfg, _textured_scene(False), pos, QUAT, 2, KEY)
        a1, _ = render_pt_fast(cfg, _textured_scene(True), pos, QUAT, 2, KEY)
        np.testing.assert_array_equal(np.asarray(a0), np.asarray(a1))


def test_trilinear_requires_mips():
    with pytest.raises(ValueError, match="tex_mips"):
        render_pt_fast(_cfg(tex_filter="trilinear"), _textured_scene(False),
                       jnp.zeros(3), QUAT, 1, KEY)


def test_trilinear_reduces_minification_variance():
    """The anti-aliasing claim itself: on a distant high-frequency
    checker texture the trilinear render's pixel-to-pixel variance must
    collapse toward the texture mean vs nearest (which aliases)."""
    pos = jnp.zeros(3)
    sc = _textured_scene(True, scale=64.0)  # extreme minification
    a_n, _ = render_pt_fast(_cfg(), sc, pos, QUAT, 4, KEY)
    a_t, _ = render_pt_fast(_cfg(tex_filter="trilinear"), sc, pos, QUAT,
                            4, KEY)
    # rows 0..9 look down (vz<0) onto the distant textured floor sphere
    # (measured: nearest var 0.011-0.026/row there, trilinear 0.0005-0.001)
    band_n = np.asarray(a_n)[:10, :, 0]
    band_t = np.asarray(a_t)[:10, :, 0]
    assert band_t.var() < 0.35 * band_n.var(), (band_t.var(), band_n.var())
    # and the local means agree (pre-filtering, not darkening/brightening)
    assert abs(band_t.mean() - band_n.mean()) < 0.08


def test_sceneio_tex_mips(tmp_path):
    import json

    from raytracing_engine_tpu.pathtracer.sceneio import load_scene_json

    np.save(tmp_path / "tex.npy", _checker_img(8))
    spec = {
        "tex_mips": True,
        "materials": [
            {"albedo": [1, 1, 1],
             "image": {"npy": "tex.npy", "scale": 2.0}},
            {"albedo": [0, 0, 0], "emission": [9, 9, 9]},
        ],
        "spheres": [
            {"center": [0, 8, -51], "radius": 50.0, "mat": 0},
            {"center": [0, 8, 4], "radius": 1.0, "mat": 1},
        ],
    }
    path = tmp_path / "mips.json"
    path.write_text(json.dumps(spec))
    bundle = load_scene_json(str(path))
    assert bundle.scene.has_mips and bundle.scene.n_mip_levels == 4
