"""Canonical path-tracer scenes: benchmarks (BASELINE configs 2/4) and
physically-checkable test scenes (furnace, Cornell box)."""

from __future__ import annotations

import numpy as np

from raytracing_engine_tpu.pathtracer.scene import (
    DIELECTRIC,
    DIFFUSE,
    MIRROR,
    build_pt_scene,
)


def furnace_scene(albedo=0.5, le=1.0):
    """A diffuse sphere at the origin inside a big emissive enclosure sphere.

    Furnace test: a convex Lambertian surface in a uniform radiance field Le
    reflects exactly albedo * Le; pixels seeing the enclosure directly read
    Le. Analytic anchor for integrator unbiasedness.
    """
    mats = [
        {"albedo": (albedo,) * 3, "kind": DIFFUSE},
        {"albedo": (0.0,) * 3, "emission": (le,) * 3, "kind": DIFFUSE},
    ]
    spheres = [
        ((0.0, 4.0, 0.0), 1.0, 0),     # diffuse test sphere
        ((0.0, 0.0, 0.0), 100.0, 1),   # emissive enclosure (seen from inside)
    ]
    return build_pt_scene(spheres=spheres, materials=mats)


def quad(p0, p1, p2, p3):
    """Two triangles for the quad p0-p1-p2-p3 (counter-clockwise)."""
    return [np.array([p0, p1, p2], np.float32), np.array([p0, p2, p3], np.float32)]


def cornell_box(glass=False):
    """Cornell-style box (Z-up, camera looks +Y): red left wall, green right,
    white floor/ceiling/back, area light at the ceiling, one diffuse and one
    mirror sphere. The NEE/area-light benchmark scene (BASELINE config 4).

    glass=True swaps the mirror sphere for a clear ior-1.5 dielectric (the
    classic glass-ball Cornell: refracted color bleed + a caustic spot under
    the ball). Default False keeps the benchmark scene byte-identical."""
    W_, WHITE, RED, GREEN, LIGHT, MIRR, DIFF = 2.0, 0, 1, 2, 3, 4, 5
    mats = [
        {"albedo": (0.73, 0.73, 0.73), "kind": DIFFUSE},
        {"albedo": (0.65, 0.05, 0.05), "kind": DIFFUSE},
        {"albedo": (0.12, 0.45, 0.15), "kind": DIFFUSE},
        {"albedo": (0.0, 0.0, 0.0), "emission": (15.0, 15.0, 15.0), "kind": DIFFUSE},
        ({"kind": DIELECTRIC, "ior": 1.5} if glass
         else {"albedo": (0.9, 0.9, 0.9), "kind": MIRROR}),
        {"albedo": (0.5, 0.5, 0.8), "kind": DIFFUSE},
    ]
    W = W_
    tris, tmat = [], []

    def add(ts, m):
        tris.extend(ts)
        tmat.extend([m] * len(ts))

    # box interior from y in [0, 2W], x in [-W, W], z in [-W, W]
    add(quad((-W, 0, -W), (W, 0, -W), (W, 2 * W, -W), (-W, 2 * W, -W)), WHITE)   # floor z=-W
    add(quad((-W, 0, W), (-W, 2 * W, W), (W, 2 * W, W), (W, 0, W)), WHITE)       # ceiling z=W
    add(quad((-W, 2 * W, -W), (W, 2 * W, -W), (W, 2 * W, W), (-W, 2 * W, W)), WHITE)  # back y=2W
    add(quad((-W, 0, -W), (-W, 2 * W, -W), (-W, 2 * W, W), (-W, 0, W)), RED)     # left x=-W
    add(quad((W, 0, -W), (W, 0, W), (W, 2 * W, W), (W, 2 * W, -W)), GREEN)       # right x=W
    # ceiling light: small quad just below the ceiling
    s = 0.5 * W
    zl = W - 1e-3
    add(quad((-s, W - s, zl), (-s, W + s, zl), (s, W + s, zl), (s, W - s, zl)), LIGHT)

    spheres = [
        ((-0.8, 2.6, -W + 0.6), 0.6, MIRR),
        ((0.9, 1.9, -W + 0.5), 0.5, DIFF),
    ]
    return build_pt_scene(
        spheres=spheres,
        triangles=np.stack(tris),
        tri_mats=np.array(tmat, np.int32),
        materials=mats,
    )


def material_spheres():
    """Multi-material sphere field: diffuse/mirror/emissive spheres + ground
    (BASELINE config 2: 4-bounce path tracing, 4 spp, 800x600)."""
    mats = [
        {"albedo": (0.8, 0.8, 0.8), "kind": DIFFUSE},            # 0 ground
        {"albedo": (0.2, 0.3, 0.9), "kind": DIFFUSE},            # 1
        {"albedo": (0.9, 0.9, 0.9), "kind": MIRROR},             # 2
        {"albedo": (0.0, 0.0, 0.0), "emission": (8.0, 7.0, 6.0), "kind": DIFFUSE},  # 3
        {"albedo": (0.9, 0.4, 0.2), "kind": DIFFUSE},            # 4
        {"albedo": (0.7, 0.9, 0.7), "kind": MIRROR},             # 5
    ]
    spheres = [
        ((0.0, 6.0, -101.0), 100.0, 0),   # ground
        ((-2.2, 6.0, 0.0), 1.0, 1),
        ((0.0, 6.5, 0.0), 1.0, 2),
        ((2.2, 6.0, 0.0), 1.0, 4),
        ((-1.0, 4.5, -0.6), 0.4, 5),
        ((0.0, 5.0, 3.0), 0.8, 3),        # emissive "sun"
    ]
    return build_pt_scene(spheres=spheres, materials=mats)


def mesh_lit_scene(mesh):
    """A triangle mesh (material 0, diffuse) lit by one emissive sphere over
    a large diffuse ground sphere — the `cli pt --scene knot/obj` scene
    (BASELINE config 3 with the torus knot). Camera: origin, looking +Y."""
    mats = [
        {"albedo": (0.7, 0.6, 0.4), "kind": DIFFUSE},
        {"albedo": (0, 0, 0), "emission": (10.0, 10.0, 10.0), "kind": DIFFUSE},
        {"albedo": (0.5, 0.5, 0.6), "kind": DIFFUSE},
    ]
    return build_pt_scene(
        spheres=[((6.0, 4.0, 6.0), 1.5, 1), ((0.0, 8.0, -103.0), 100.0, 2)],
        triangles=mesh,
        tri_mats=np.zeros(mesh.shape[0], np.int32),
        materials=mats,
    )
