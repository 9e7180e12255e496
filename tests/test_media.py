"""Single-scatter participating media (cfg.fog_scatter) with equiangular NEE.

The homogeneous fog (round 3) absorbed and re-emitted a constant ambient;
fog_scatter adds the real thing: one equiangularly-sampled scatter vertex
per path segment, isotropic phase, light NEE with medium-attenuated
shadow rays. Verified against an INDEPENDENT dense quadrature of the
single-scatter integral (including the light sphere's self-occlusion),
plus engine/kernel parity."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from raytracing_engine_tpu.pathtracer import PTConfig
from raytracing_engine_tpu.pathtracer.integrator import render_pt
from raytracing_engine_tpu.pathtracer.scene import DIFFUSE, build_pt_scene
from raytracing_engine_tpu.pathtracer.wavefront import render_pt_fast

KEY = jax.random.PRNGKey(23)
QUAT = jnp.array([0.0, 0.0, 0.0, 1.0])
POS = jnp.zeros(3)

C = np.array([0.0, 6.0, 0.0])   # light sphere center
R = 2.0   # big silhouette: comparison pixels sit fully inside/outside it
LE = 5.0
SIG_T, SIG_S = 0.15, 0.12


def _scene():
    return build_pt_scene(
        spheres=[((C[0], C[1], C[2]), R, 0)],
        materials=[{"albedo": (0, 0, 0), "emission": (LE,) * 3,
                    "kind": DIFFUSE}])


def _cfg(**kw):
    return PTConfig(width=32, height=32, max_bounces=0,
                    fog_density=SIG_T, fog_scatter=SIG_S, **kw)


def _quad_pixel(o, d, n_t=4000, n_l=400, far=1e4):
    """Dense quadrature of L = Le·T(t_hit) [direct] + ∫ σs T(t) (1/4π)
    E_light[|cos|·Le/(pdf_area·r²)·T(r)·vis] dt for the single-sphere
    scene — fully independent of the renderer's sampling machinery."""
    # direct hit of the emissive sphere
    oc = o - C
    b = oc @ d
    disc = b * b - (oc @ oc - R * R)
    t_hit = far
    if disc > 0:
        t0 = -b - np.sqrt(disc)
        if t0 > 1e-3:
            t_hit = t0
    L = LE * np.exp(-SIG_T * t_hit) if t_hit < far else 0.0

    # fibonacci sphere points (uniform area) = the renderer's light sampler
    k = np.arange(n_l) + 0.5
    z = 1.0 - 2.0 * k / n_l
    phi = np.pi * (1 + 5 ** 0.5) * k
    nrm = np.stack([np.sqrt(1 - z * z) * np.cos(phi),
                    np.sqrt(1 - z * z) * np.sin(phi), z], -1)
    lp = C + R * nrm  # (n_l, 3)

    # media integral over t in [0, min(t_hit, far)] — log-spaced near 0
    # plus linear coverage (the integrand peaks near the light's closest
    # approach; dense uniform sampling suffices at n_t=4000)
    seg = min(t_hit, far)
    tmax = min(seg, 60.0)  # e^(-0.15*60) ~ 1e-4: tail negligible
    ts = (np.arange(n_t) + 0.5) / n_t * tmax
    dt = tmax / n_t
    x = o[None, :] + d[None, :] * ts[:, None]          # (n_t, 3)
    to_l = lp[None, :, :] - x[:, None, :]              # (n_t, n_l, 3)
    r = np.linalg.norm(to_l, axis=-1)
    wi = to_l / np.maximum(r[..., None], 1e-20)
    cosl = np.abs(np.sum(nrm[None] * wi, axis=-1))
    # visibility: the segment x -> lp must not hit the sphere EARLIER
    # (far-side light points are self-occluded)
    oc2 = x[:, None, :] - C
    bq = np.sum(oc2 * wi, axis=-1)
    dq = bq * bq - (np.sum(oc2 * oc2, axis=-1) - R * R)
    tq = -bq - np.sqrt(np.maximum(dq, 0.0))
    blocked = (dq > 0) & (tq > 1e-3) & (tq < r * (1.0 - 1e-3))
    vis = ~blocked
    pdf_area = 1.0 / (4.0 * np.pi * R * R)  # single light: pick = 1
    # the renderer's estimator at scatter vertex x:
    #   E_uniform-area-point[ |cos|·Le / (pdf_area·r²) · T(r) · vis ]
    # approximated by the Fibonacci mean; times σs·T(t)·phase, over t
    integrand = (SIG_S * np.exp(-SIG_T * ts)[:, None] / (4.0 * np.pi)
                 * LE * cosl / (pdf_area * r * r)
                 * np.exp(-SIG_T * r) * vis)
    L += float(integrand.mean(axis=1).sum() * dt)
    return L


def test_validation():
    with pytest.raises(ValueError, match="fog_scatter"):
        render_pt_fast(PTConfig(width=8, height=8, fog_scatter=0.1,
                                fog_density=0.0, rng="pcg"),
                       _scene(), POS, QUAT, 1, KEY)


def test_matches_independent_quadrature():
    """Central pixel (ray hits the light through fog) and an off-axis
    pixel (pure in-scatter) against the dense quadrature reference."""
    cfg = _cfg(rng="pcg", use_nee=False)
    img, _ = render_pt_fast(cfg, _scene(), POS, QUAT, 4096, KEY)
    img = np.asarray(img)

    def ray(px, py):
        ncx = (px + 0.5) * 2.0 / cfg.width - 1.0
        ncy = (py + 0.5) * 2.0 / cfg.height - 1.0
        d = np.array([ncx * cfg.ratio[0], 1.0, ncy * cfg.ratio[1]])
        return d / np.linalg.norm(d)

    for (px, py) in [(16, 16), (16, 14), (4, 16), (16, 4), (27, 27)]:
        want = _quad_pixel(np.zeros(3), ray(px, py))
        # 4096 spp with AA jitter: compare the pixel-mean against the
        # center-ray quadrature with a tolerance covering both MC noise
        # and the intra-pixel variation
        got = float(img[py, px].mean())
        assert abs(got - want) / max(want, 1e-3) < 0.12, (px, py, got, want)


def test_engines_agree():
    scene = _scene()
    cfg = _cfg()
    a, na = render_pt(cfg, scene, POS, QUAT, 16, KEY)
    b, nb = render_pt_fast(cfg, scene, POS, QUAT, 16, KEY)
    a, b = np.asarray(a), np.asarray(b)
    assert np.abs(a - b).max() < 2e-3
    assert abs(a.mean() - b.mean()) < 1e-5
    assert float(na) == float(nb)


def test_equiangular_noise_is_bounded():
    """The equiangular pdf cancels the 1/r² spike, so in-scatter noise is
    BOUNDED: no firefly tail even for rays passing close to the light
    (uniform-t sampling's failure mode). Median AND tail of the relative
    error at 256 spp — per-sample relative std measures ~1.7 for this
    estimator (half the uniform-area light samples are self-occluded),
    so median ~0.105 and a tight p99 are the calibrated expectations."""
    cfg = _cfg(rng="pcg", use_nee=False)
    ref, _ = render_pt_fast(cfg, _scene(), POS, QUAT, 4096, KEY)
    low, _ = render_pt_fast(cfg, _scene(), POS, QUAT, 256,
                            jax.random.PRNGKey(1))
    ref, low = np.asarray(ref), np.asarray(low)
    glow = ref.max(-1) < LE / 2  # in-scatter pixels (not direct views)
    rel = np.abs(low - ref)[glow] / np.maximum(ref[glow], 1e-3)
    assert np.median(rel) < 0.2, np.median(rel)
    assert np.percentile(rel, 99) < 0.8, np.percentile(rel, 99)
