"""Wavefront path-tracing integrator with next-event estimation + MIS.

The bounce loop is a ``lax.fori_loop`` over static max_bounces; all per-ray
state is component planes (H, W) — SoA ray buffers in HBM, stage barriers
between intersect/shade exactly as in a wavefront tracer (the north star's
architecture). Dead lanes are masked, not compacted (compaction is a sort —
a later optimization; the estimator is already correct).

Estimator: unidirectional path tracing, cosine-sampled Lambertian +
perfect mirrors + smooth dielectrics, NEE toward power-weighted
area-sampled emissive primitives, combined with BSDF sampling via the
power heuristic (MIS). Delta (mirror/dielectric) bounces skip NEE and
take emission hits at full weight. Fixed path length by default
(truncation at max_bounces, standard for real-time); opt-in Russian
roulette from cfg.rr_start. Env lights, homogeneous fog, checker
textures and thin-lens DOF are statically-gated extensions shared with
the production wavefront core.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
from jax import lax, random

from raytracing_engine_tpu.pathtracer import sampler
from raytracing_engine_tpu.pathtracer.intersect import ray_sphere, ray_triangle
from raytracing_engine_tpu.pathtracer.scene import (
    DIELECTRIC,
    DIFFUSE,
    LIGHT_MESH,
    METAL,
    MIRROR,
    PTScene,
)

INF = jnp.float32(jnp.inf)
_PI = float(jnp.pi)


@dataclasses.dataclass(frozen=True)
class PTConfig:
    width: int = 800
    height: int = 600
    fov: float = 1.0
    max_bounces: int = 4
    t_min: float = 1e-3
    eps: float = 1e-3          # shadow/scatter origin offset along the normal
    use_nee: bool = True
    # thin-lens depth of field: aperture = lens radius in world units
    # (0 = pinhole, the default — zero cost, bit-identical streams);
    # focus_dist = distance of the sharp plane along the view axis
    aperture: float = 0.0
    focus_dist: float = 10.0
    # Russian roulette: from bounce index rr_start on, continue with
    # probability p = clamp(max(throughput), 0.05, 1) and divide the
    # throughput by p — unbiased path termination that prunes dim deep
    # paths. 0 (default) = off: fixed path length, bit-identical streams.
    rr_start: int = 0
    # "random" (default) or "r2": low-discrepancy (R_d additive
    # recurrence + per-pixel Cranley-Patterson rotation) sampling of the
    # camera dims (AA jitter + lens) and the bounce-0 NEE light dims —
    # the pixel-space integrals where quasirandom sequences converge
    # near-linearly in spp. Production (rng="pcg") paths only; the
    # stacked reference integrator raises (it is the random-sampling
    # cross-check). See ops/rng_pcg.r2_planes.
    sampler: str = "random"
    # NEE light selection: "power" (default) picks lights with probability
    # proportional to area * luminance(Le) — a dim big light stops eating
    # samples a bright small one needs; "uniform" is the classic 1/count;
    # "tree" is the two-level light tree (distance-discounted cluster
    # pick, then within-cluster power CDF — scene must be built with
    # build_pt_scene(light_tree=C)) for many-light scenes where the
    # nearest lights matter most. All are unbiased (the MIS pdfs follow
    # the selection); single-light scenes are identical either way.
    light_sampling: str = "power"
    # homogeneous fog: every path segment (camera, bounce, NEE shadow)
    # is attenuated by Beer-Lambert exp(-fog_density * length), and the
    # lost energy is replaced by fog_color (constant ambient in-scatter —
    # the classic production fog, exact for absorption, artistic for
    # scatter). Escaped rays are fully fogged (infinite segment).
    # 0 (default) = off, zero cost, bit-identical.
    fog_density: float = 0.0
    fog_color: tuple = (0.0, 0.0, 0.0)
    # single-scatter in-scattering from the scene's NEE lights inside the
    # fog_density medium: fog_scatter = the scattering coefficient
    # sigma_s <= sigma_t (= fog_density); the remainder is absorption.
    # Each path segment adds one EQUIANGULARLY-sampled scatter vertex
    # (t chosen by angle subtended at a sampled light point — the classic
    # variance killer for lights inside media), isotropic phase, with a
    # medium-attenuated shadow ray. Single scatter: in-scattered INDIRECT
    # light is not simulated (standard real-time approximation; the
    # constant fog_color ambient term remains available for it).
    # 0 (default) = off: zero cost, bit-identical streams.
    fog_scatter: float = 0.0
    # RNG implementation for the SoA integrator:
    #   "threefry" — jax.random; portable, matches the reference integrator
    #                bit-for-bit (the default for reproducible tests)
    #   "pcg"      — counter-based PCG4D hash keyed by global pixel coords;
    #                fuses into consumers, sharding/tiling-invariant (the
    #                production choice)
    rng: str = "threefry"
    # atlas texture filtering: "nearest" (default — exact texel reads,
    # bit-identical to the pre-filtering program), "bilinear" (4-texel
    # lerp with rect-clamped corners; ~4x the per-hit fetch cost, still
    # the same lane-axis gather — kernel-safe everywhere), or
    # "trilinear" (ray-cone mip LOD + two bilinear taps lerped across
    # the bracketing mip levels — kills minification aliasing; needs a
    # build_pt_scene(tex_mips=True) scene, production engines only).
    # nearest/bilinear apply to image textures AND normal maps;
    # trilinear mips apply to image textures (normal maps stay
    # bilinear — naive normal averaging denormalizes).
    tex_filter: str = "nearest"

    @property
    def ratio(self):
        return (self.fov, self.fov * self.height / self.width)


# ---------------------------------------------------------------------------
# scene intersection (brute force; accel/bvh.py provides the culled variant)
# ---------------------------------------------------------------------------

def _sphere_nearest(scene, o3, d3, t_min):
    smask = jnp.arange(scene.sph_pos.shape[0]) < scene.sph_count
    ts = ray_sphere(o3, d3, scene.sph_pos, scene.sph_radius, t_min)
    ts = jnp.where(smask, ts, INF)
    return jnp.min(ts, axis=-1), jnp.argmin(ts, axis=-1)


def _triangle_nearest(scene, bvh, o3, d3, t_min):
    """(t, original-tri-index, e1, e2) of the nearest triangle hit.

    bvh=None → brute force over the padded SoA; else stackless traversal
    (accel/bvh.py) with index mapped back through bvh.perm."""
    if bvh is None:
        tmask = jnp.arange(scene.tri_v0.shape[0]) < scene.tri_count
        tt, _, _ = ray_triangle(
            o3, d3, scene.tri_v0, scene.tri_e1, scene.tri_e2, t_min
        )
        tt = jnp.where(tmask, tt, INF)
        t_t = jnp.min(tt, axis=-1)
        i_t = jnp.argmin(tt, axis=-1)
        return t_t, i_t, scene.tri_e1[i_t], scene.tri_e2[i_t]
    from raytracing_engine_tpu.accel.bvh import bvh_intersect

    t_t, ridx, _, _ = bvh_intersect(bvh, o3, d3, t_min=t_min)
    safe = jnp.maximum(ridx, 0)
    i_t = bvh.perm[safe]
    return t_t, i_t, bvh.e1[safe], bvh.e2[safe]


def intersect_scene(scene: PTScene, o3, d3, t_min, bvh=None):
    """Nearest hit over all primitives.

    o3/d3: (..., 3). Returns dict of planes: t, hit, normal (V3, oriented
    against the ray), mat_id, light_area (area of the hit primitive if its
    material emits, for MIS pdf), all shaped (...,).
    """
    t_s, i_s = _sphere_nearest(scene, o3, d3, t_min)
    t_t, i_t, e1_t, e2_t = _triangle_nearest(scene, bvh, o3, d3, t_min)

    use_tri = t_t < t_s
    t = jnp.minimum(t_s, t_t)
    hit = jnp.isfinite(t)

    p3 = o3 + d3 * t[..., None]
    n_sph = p3 - scene.sph_pos[i_s]
    cr = jnp.cross(e1_t, e2_t)
    n3 = jnp.where(use_tri[..., None], cr, n_sph)
    n3 = n3 / jnp.maximum(
        jnp.linalg.norm(n3, axis=-1, keepdims=True), 1e-20
    )
    # two-sided shading: orient against the incoming ray; `front` records
    # whether the GEOMETRIC normal already faced the ray (entering a closed
    # primitive) — the dielectric scatter needs it to orient eta
    flip = jnp.sum(n3 * d3, axis=-1) > 0.0
    n3 = jnp.where(flip[..., None], -n3, n3)

    mat_id = jnp.where(use_tri, scene.tri_mat[i_t], scene.sph_mat[i_s])

    sph_area = 4.0 * _PI * scene.sph_radius[i_s] ** 2
    tri_area = 0.5 * jnp.linalg.norm(cr, axis=-1)
    light_area = jnp.where(use_tri, tri_area, sph_area)

    out = dict(
        t=t,
        hit=hit,
        p3=p3,
        n3=n3,
        mat_id=mat_id,
        light_area=light_area,
        front=~flip,
    )
    if scene.has_light_tree:  # slot index of the hit primitive (tree MIS)
        out["prim"] = jnp.where(use_tri, i_t, i_s)
    if scene.has_light_tree or scene.has_lane_mesh_light:
        out["is_tri"] = use_tri  # lane-mesh hit-side MIS needs it too
    if scene.needs_uv:  # static: UV-free scenes compile the prior program
        # sphere: analytic spherical parametrization (Z-up); triangle:
        # barycentrics recomputed at the hit, interpolating scene.tri_uv
        # (SAME implementation as wavefront for parity)
        from raytracing_engine_tpu.pathtracer.wavefront import _sphere_uv

        su, sv = _sphere_uv(
            (n_sph[..., 0], n_sph[..., 1], n_sph[..., 2]))
        tan3 = None
        if scene.tri_uv is not None:
            nn = jnp.maximum(jnp.sum(cr * cr, axis=-1), 1e-30)[..., None]
            rel = p3 - scene.tri_v0[i_t]
            gu = jnp.cross(e2_t, cr) / nn  # grad of barycentric u
            gv = jnp.cross(cr, e1_t) / nn  # grad of barycentric v
            ub = jnp.sum(gu * rel, axis=-1)
            vb = jnp.sum(gv * rel, axis=-1)
            uv6 = scene.tri_uv[i_t]
            du1 = uv6[..., 2] - uv6[..., 0]
            du2 = uv6[..., 4] - uv6[..., 0]
            tu = uv6[..., 0] + ub * du1 + vb * du2
            tv = (uv6[..., 1] + ub * (uv6[..., 3] - uv6[..., 1])
                  + vb * (uv6[..., 5] - uv6[..., 1]))
            if scene.has_normal_map:
                # world texture-u tangent: d(u_tex)/dp = du1*gu + du2*gv
                tan3 = gu * du1[..., None] + gv * du2[..., None]
        else:
            tu = tv = jnp.zeros_like(t)
        out["uv"] = (jnp.where(use_tri, tu, su), jnp.where(use_tri, tv, sv))
        if scene.has_normal_map:
            # sphere: azimuthal direction d p/d u ∝ (-y, x, 0)
            stan = jnp.stack([-n_sph[..., 1], n_sph[..., 0],
                              jnp.zeros_like(t)], axis=-1)
            if tan3 is None:
                tan3 = jnp.zeros_like(stan)
            out["tan3"] = jnp.where(use_tri[..., None], tan3, stan)
    return out


def _perturb_normal3(scene: PTScene, mat_id, n3, tan3, uv, bilinear=False):
    """Stacked twin of wavefront._perturb_normal (same op order — the
    parity contract): fetch the tangent-space normal-map texel, build the
    (T, B, n) frame from the texture-u tangent, rotate, renormalize."""
    from raytracing_engine_tpu.pathtracer.wavefront import _sample_rect

    rect = scene.mat_nrm_rect[mat_id]  # (..., 4)
    s = scene.mat_nrm_scale[mat_id]
    tw, th = rect[..., 2], rect[..., 3]
    rgb = _sample_rect(scene.tex_atlas, rect[..., 0], rect[..., 1], tw, th,
                       uv, s, bilinear=bilinear)
    nt = jnp.stack([2.0 * c - 1.0 for c in rgb], axis=-1)
    tp = tan3 - n3 * jnp.sum(n3 * tan3, axis=-1, keepdims=True)
    z = jnp.zeros_like(n3[..., 0])
    one = jnp.ones_like(z)
    fb_x = jnp.cross(jnp.stack([z, z, one], -1), n3)   # z × n
    fb_y = jnp.cross(jnp.stack([one, z, z], -1), n3)   # x × n (n ~ ±z)
    fb = jnp.where((jnp.abs(n3[..., 2]) < 0.9)[..., None], fb_x, fb_y)
    tp = jnp.where((jnp.sum(tp * tp, -1) > 1e-12)[..., None], tp, fb)
    T = tp / jnp.maximum(
        jnp.linalg.norm(tp, axis=-1, keepdims=True), 1e-20)
    B = jnp.cross(n3, T)
    np_ = (nt[..., 0:1] * T + nt[..., 1:2] * B + nt[..., 2:3] * n3)
    ln = jnp.linalg.norm(np_, axis=-1, keepdims=True)
    np_ = jnp.where(ln > 1e-6, np_ / jnp.maximum(ln, 1e-20), n3)
    return jnp.where((tw > 0.0)[..., None], np_, n3)


def occluded(scene: PTScene, o3, d3, max_t, t_min, bvh=None):
    """Any-hit test up to max_t (...,). Returns bool plane."""
    smask = jnp.arange(scene.sph_pos.shape[0]) < scene.sph_count
    ts = ray_sphere(o3, d3, scene.sph_pos, scene.sph_radius, t_min)
    ts = jnp.where(smask, ts, INF)
    t_sph = jnp.min(ts, axis=-1)
    if bvh is None:
        tmask = jnp.arange(scene.tri_v0.shape[0]) < scene.tri_count
        tt, _, _ = ray_triangle(
            o3, d3, scene.tri_v0, scene.tri_e1, scene.tri_e2, t_min
        )
        tt = jnp.where(tmask, tt, INF)
        t_tri = jnp.min(tt, axis=-1)
    else:
        from raytracing_engine_tpu.accel.bvh import bvh_intersect

        # per-lane t_max bounds the any-hit search to the light distance
        _, idx, _, _ = bvh_intersect(
            bvh, o3, d3, t_min=t_min, t_max=max_t, any_hit=True
        )
        return (t_sph < max_t) | (idx >= 0)
    return jnp.minimum(t_sph, t_tri) < max_t


# ---------------------------------------------------------------------------
# NEE light sampling
# ---------------------------------------------------------------------------

def tree_cluster_weights(scene: PTScene, p3):
    """Light-tree cluster importances at (..., 3) points: (..., C) array
    of power_c / max(dist^2, radius_c^2) plus its sum (see
    scene._build_light_tree). Vectorized over the cluster axis — the
    gather-based cross-check of wavefront._tree_cluster_weights."""
    d2 = jnp.sum((p3[..., None, :] - scene.lt_center) ** 2, axis=-1)
    floor = jnp.maximum(d2, scene.lt_radius ** 2)
    w = scene.lt_power / jnp.maximum(floor, 1e-12)
    return w, jnp.sum(w, axis=-1)


def sample_light_point(scene: PTScene, u_sel, u1, u2, uniform=False,
                       tree_p3=None, u_tri=None):
    """Pick a light (power-weighted by default, uniform with uniform=True,
    light tree with tree_p3=the shading point), sample a uniform-area
    point on it.

    Returns (point (...,3), normal (...,3), Le (...,3), pdf_area (...,),
    any_light bool scalar). pdf_area includes the selection probability.
    """
    count = jnp.maximum(scene.light_count, 1)
    tree_pick = None
    if tree_p3 is not None:
        # two-level tree selection, written with gathers/argmax as the
        # independent cross-check of the plane-native unrolled walks
        w, wtot = tree_cluster_weights(scene, tree_p3)
        cum = jnp.cumsum(w, axis=-1)
        uw = (u_sel * wtot)[..., None]
        cl = jnp.sum((uw >= cum[..., :-1]).astype(jnp.int32), axis=-1)
        w_sel = jnp.take_along_axis(w, cl[..., None], axis=-1)[..., 0]
        lo = jnp.where(cl > 0,
                       jnp.take_along_axis(
                           cum, jnp.maximum(cl - 1, 0)[..., None],
                           axis=-1)[..., 0], 0.0)
        p_cl = w_sel / jnp.maximum(wtot, 1e-30)
        u_in = jnp.clip((uw[..., 0] - lo) / jnp.maximum(w_sel, 1e-30),
                        0.0, 1.0 - 1e-7)
        # first slot of the chosen cluster whose within-cluster CDF
        # exceeds u_in (argmax returns the first True)
        passed = ((scene.lt_cluster == cl[..., None].astype(jnp.float32))
                  & (u_in[..., None] < scene.lt_cdf_intra))
        idx = jnp.argmax(passed, axis=-1).astype(jnp.int32)
        tree_pick = p_cl * scene.lt_pick_intra[idx]
    elif uniform:
        idx = jnp.minimum((u_sel * count).astype(jnp.int32), count - 1)
    else:
        # inclusive-CDF walk (padded slots pinned to 1 -> never chosen);
        # same formula as the plane-native sampler for parity
        idx = jnp.zeros(jnp.shape(u_sel), jnp.int32)
        for k in range(scene.light_cdf.shape[0] - 1):
            idx = idx + (u_sel >= scene.light_cdf[k]).astype(jnp.int32)
    kind = scene.light_kind[idx]
    prim = scene.light_prim[idx]
    area = scene.light_area[idx]

    # sphere sample
    c = scene.sph_pos[prim]
    r = scene.sph_radius[prim]
    z = 1.0 - 2.0 * u1
    rr = jnp.sqrt(jnp.maximum(1.0 - z * z, 0.0))
    phi = 2.0 * _PI * u2
    n_s = jnp.stack([rr * jnp.cos(phi), rr * jnp.sin(phi), z], axis=-1)
    p_s = c + n_s * r[..., None]
    mat_s = scene.sph_mat[prim]

    # triangle sample
    v0 = scene.tri_v0[prim]
    e1 = scene.tri_e1[prim]
    e2 = scene.tri_e2[prim]
    su = jnp.sqrt(u1)
    b1 = (su * (1.0 - u2))[..., None]
    b2 = (su * u2)[..., None]
    p_t = v0 + e1 * b1 + e2 * b2
    n_t = jnp.cross(e1, e2)
    n_t = n_t / jnp.maximum(jnp.linalg.norm(n_t, axis=-1, keepdims=True), 1e-20)
    mat_t = scene.tri_mat[prim]

    is_tri = (kind == 1)[..., None]
    point = jnp.where(is_tri, p_t, p_s)
    normal = jnp.where(is_tri, n_t, n_s)
    mat = jnp.where(kind == 1, mat_t, mat_s)
    le = scene.mat_emission[mat]

    if scene.has_lane_mesh_light:
        # per-lane emissive-triangle sampling — same helper as the
        # wavefront engine (lane-row fetch machinery works on any 2D
        # plane shape), same b1/b2 barycentrics
        from raytracing_engine_tpu.pathtracer.wavefront import (
            _sample_mesh_tri_lane,
        )

        p_m, n_m, le_m = _sample_mesh_tri_lane(
            scene, u_tri, b1[..., 0], b2[..., 0])
        is_mesh = (kind == LIGHT_MESH)[..., None]
        point = jnp.where(is_mesh, jnp.stack(p_m, -1), point)
        normal = jnp.where(is_mesh, jnp.stack(n_m, -1), normal)
        le = jnp.where(is_mesh, jnp.stack(le_m, -1), le)

    if tree_pick is not None:
        pdf_area = tree_pick / jnp.maximum(area, 1e-20)
    elif uniform:
        pdf_area = 1.0 / (area * count)
    else:
        pick = scene.light_pick[idx]
        pdf_area = pick / jnp.maximum(area, 1e-20)
    return point, normal, le, pdf_area


# ---------------------------------------------------------------------------
# the integrator
# ---------------------------------------------------------------------------

def camera_rays(cfg: PTConfig, cam_pos, cam_quat, u1, u2, row0=0, lens=None):
    """Jittered primary rays using the engine's NDC mapping
    (compute.glsl:71-77 with a sub-pixel offset for anti-aliasing).
    u1/u2 may be a row band of the image; row0 is its first global row.
    lens=(u3, u4) + cfg.aperture>0: thin-lens depth of field (sample a
    sensor-plane disk, aim at the pixel's point on the y=focus_dist
    camera-space plane) — same model as wavefront._camera_rays."""
    from raytracing_engine_tpu.ops.quaternion import quat_rotate

    bh, w = u1.shape
    h = cfg.height
    ix = jnp.arange(w, dtype=jnp.float32)[None, :]
    iy = jnp.arange(bh, dtype=jnp.float32)[:, None] + row0
    ncx = ((ix + u1) * 2.0 / w - 1.0) * cfg.ratio[0]
    ncy = ((iy + u2) * 2.0 / h - 1.0) * cfg.ratio[1]
    vdir = jnp.stack([ncx, jnp.ones_like(ncx), ncy], axis=-1)
    off3 = None
    if lens is not None and cfg.aperture > 0.0:
        r = cfg.aperture * jnp.sqrt(lens[0])
        phi = (2.0 * _PI) * lens[1]
        lx, lz = r * jnp.cos(phi), r * jnp.sin(phi)
        off3 = quat_rotate(
            cam_quat, jnp.stack([lx, jnp.zeros_like(lx), lz], axis=-1))
        vdir = vdir * cfg.focus_dist - jnp.stack(
            [lx, jnp.zeros_like(lx), lz], axis=-1)
    vdir = quat_rotate(cam_quat, vdir)
    vdir = vdir / jnp.linalg.norm(vdir, axis=-1, keepdims=True)
    o3 = jnp.broadcast_to(cam_pos, vdir.shape)
    if off3 is not None:
        o3 = o3 + off3
    return o3, vdir


def trace_pass(cfg: PTConfig, scene: PTScene, cam_pos, cam_quat, key, bvh=None,
               row0=0, band_h=None):
    """One sample per pixel. Returns ((H, W, 3) radiance, rays-traced scalar).
    row0/band_h restrict to a horizontal band (tile-sharded rendering);
    randoms are always drawn image-wide and sliced, so a sharded render is
    bit-identical to the single-device one."""
    if scene.has_mesh_light:
        raise ValueError(
            "the stacked reference integrator samples per-slot lights and "
            "cannot use a mesh-light scene; build the cross-check scene "
            "with allow_many_tri_lights=True instead of mesh_lights=True")
    if cfg.light_sampling == "tree" and not scene.has_light_tree:
        raise ValueError(
            "light_sampling='tree' needs the scene's light-tree tables — "
            "build it with build_pt_scene(..., light_tree=C)")
    if cfg.sampler == "r2":
        raise ValueError(
            "sampler='r2' is a production-path (rng='pcg') feature — the "
            "stacked reference integrator stays purely random as the "
            "cross-check estimator; use render_pt_fast")
    if cfg.tex_filter == "trilinear":
        raise ValueError(
            "tex_filter='trilinear' is a production-path feature (the mip "
            "LOD is execution-strategy state, not an estimator change) — "
            "use render_pt_fast; its "
            "mutual bit-exactness is the trilinear cross-check")
    h, w = (band_h or cfg.height), cfg.width

    def draw(k, n):
        full = random.uniform(k, (n, cfg.height, cfg.width))
        if band_h is None:
            return full
        return lax.dynamic_slice_in_dim(full, row0, band_h, axis=1)

    kj = random.fold_in(key, 0)
    if cfg.aperture > 0.0:  # static: +2 lens randoms only when DOF is on
        u = draw(kj, 4)
        o3, d3 = camera_rays(cfg, cam_pos, cam_quat, u[0], u[1], row0=row0,
                             lens=(u[2], u[3]))
    else:
        u = draw(kj, 2)
        o3, d3 = camera_rays(cfg, cam_pos, cam_quat, u[0], u[1], row0=row0)

    # all carries derived from the (device-varying) ray DIRECTIONS so their
    # varying-axis types are loop-invariant under shard_map (o3 alone is a
    # broadcast of the replicated camera position — unvarying)
    zero3 = d3 * 0.0
    zero = zero3[..., 0]
    o3 = o3 + zero3
    state = dict(
        o3=o3,
        d3=d3,
        throughput=zero3 + 1.0,
        radiance=zero3,
        alive=zero == 0.0,
        **({"chan": zero - 1.0} if scene.has_dispersion else {}),
        # True iff the PREVIOUS vertex performed NEE — emission hit through a
        # vertex that did NOT (camera, mirror, emissive-diffuse) gets full
        # weight; weighting it down would double-discount and bias darker.
        prev_did_nee=zero > 0.0,
        prev_pdf=zero,
        nrays=jnp.sum(zero),
    )

    def bounce(b, st):
        kb = random.fold_in(key, b + 1)
        nu = 6 if cfg.rr_start > 0 else 5  # [5] = roulette coin
        # lane mesh lights append one dedicated triangle-selection dim
        # AFTER the fixed layout (matches wavefront._trace_core exactly —
        # same dim count keeps the threefry streams engine-identical)
        mlt_dim = nu if scene.has_lane_mesh_light else None
        nu = nu + (1 if scene.has_lane_mesh_light else 0)
        media_dim = None
        if cfg.fog_scatter > 0.0:  # media dims after the lane-mlt dim
            media_dim = nu
            nu = nu + (5 if scene.has_lane_mesh_light else 4)
        u = draw(kb, nu)

        st = dict(st)
        st["nrays"] += jnp.sum(st["alive"])

        isect = intersect_scene(scene, st["o3"], st["d3"], cfg.t_min, bvh=bvh)
        if cfg.fog_density > 0.0:  # static: fog-free scenes pay nothing
            # Beer-Lambert over this segment (escapes = infinite); the
            # absorbed energy re-emerges as constant in-scatter fog_color
            seg = jnp.where(isect["hit"], isect["t"], 1e4)
            trans = jnp.exp(-cfg.fog_density * seg)
            fogc = jnp.asarray(cfg.fog_color, jnp.float32)
            st["radiance"] = st["radiance"] + (
                st["throughput"] * (1.0 - trans)[..., None] * fogc)
            if cfg.fog_scatter > 0.0:
                # equiangular single-scatter NEE — same estimator as
                # wavefront._trace_core (the engines must agree)
                from raytracing_engine_tpu.pathtracer.wavefront import (
                    _poly_atan2,
                )

                m0 = media_dim
                u_tri_m = (u[m0 + 4] if scene.has_lane_mesh_light
                           else None)
                lp_m, ln_m, le_m, pdfa_m = sample_light_point(
                    scene, u[m0], u[m0 + 1], u[m0 + 2],
                    uniform=cfg.light_sampling == "uniform",
                    u_tri=u_tri_m)
                rel = lp_m - st["o3"]
                delta = jnp.sum(rel * st["d3"], axis=-1)
                perp = rel - st["d3"] * delta[..., None]
                d_m = jnp.sqrt(jnp.maximum(
                    jnp.sum(perp * perp, axis=-1), 1e-12))
                tha = _poly_atan2(-delta, d_m)
                thb = _poly_atan2(seg - delta, d_m)
                th = tha + (thb - tha) * u[m0 + 3]
                tt = delta + d_m * (jnp.sin(th)
                                    / jnp.maximum(jnp.cos(th), 1e-9))
                tt = jnp.clip(tt, 0.0, seg)
                pdf_t = d_m / jnp.maximum(
                    (thb - tha) * (d_m * d_m + (tt - delta) ** 2), 1e-12)
                xm = st["o3"] + st["d3"] * tt[..., None]
                tol = lp_m - xm
                rdist = jnp.linalg.norm(tol, axis=-1)
                wim = tol / jnp.maximum(rdist[..., None], 1e-20)
                cos_lm = jnp.abs(jnp.sum(ln_m * wim, axis=-1))
                cand_m = (st["alive"] & (scene.light_count > 0)
                          & (rdist > cfg.eps) & (thb > tha + 1e-7))
                st["nrays"] += jnp.sum(cand_m)
                blocked_m = occluded(scene, xm, wim,
                                     rdist * (1.0 - 1e-3), cfg.t_min,
                                     bvh=bvh)
                gain = (jnp.float32(cfg.fog_scatter)
                        * jnp.exp(-cfg.fog_density * tt)
                        * (1.0 / (4.0 * _PI)) * cos_lm
                        * jnp.exp(-cfg.fog_density * rdist)
                        / jnp.maximum(pdfa_m * rdist * rdist * pdf_t,
                                      1e-20))
                gain = jnp.where(cand_m & ~blocked_m, gain, 0.0)
                st["radiance"] = st["radiance"] + (
                    st["throughput"] * le_m * gain[..., None])
            st["throughput"] = st["throughput"] * trans[..., None]
        hit = isect["hit"] & st["alive"]
        mat_id = isect["mat_id"]
        albedo = scene.mat_albedo[mat_id]
        emission = scene.mat_emission[mat_id]
        kind = scene.mat_kind[mat_id]
        n3 = isect["n3"]
        p3 = isect["p3"]
        if scene.has_normal_map:  # static: unmapped scenes pay nothing
            n3 = _perturb_normal3(scene, mat_id, n3, isect["tan3"],
                                  isect["uv"],
                                  bilinear=cfg.tex_filter == "bilinear")
        if scene.has_texture:  # static: untextured scenes pay nothing
            # checker in world or texture-UV space, then image-atlas
            # override (same math as wavefront._textured_albedo)
            s = scene.mat_tex_scale[mat_id]
            cells = jnp.floor(p3 * s[..., None]).sum(-1)
            if scene.mat_tex_space is not None and "uv" in isect:
                space = scene.mat_tex_space[mat_id]
                tu, tv = isect["uv"]
                cells = jnp.where(space > 0.5,
                                  jnp.floor(tu * s) + jnp.floor(tv * s),
                                  cells)
            use2 = (s > 0.0) & (jnp.mod(cells, 2.0) >= 1.0)
            albedo = jnp.where(use2[..., None], scene.mat_albedo2[mat_id],
                               albedo)
            if scene.mat_tex_rect is not None and "uv" in isect:
                from raytracing_engine_tpu.pathtracer.wavefront import (
                    _sample_rect,
                )

                rect = scene.mat_tex_rect[mat_id]  # (..., 4)
                tw, th = rect[..., 2], rect[..., 3]
                rgb = jnp.stack(_sample_rect(
                    scene.tex_atlas, rect[..., 0], rect[..., 1], tw, th,
                    isect["uv"], s,
                    bilinear=cfg.tex_filter == "bilinear"), axis=-1)
                albedo = jnp.where((tw > 0.0)[..., None], rgb, albedo)

        # --- emission on hit (MIS-weighted against NEE) -------------------
        emissive = jnp.any(emission > 0.0, axis=-1)
        cos_l = jnp.abs(jnp.sum(n3 * st["d3"], axis=-1))
        if cfg.light_sampling == "uniform":
            light_area_h = isect["light_area"]
            if scene.has_lane_mesh_light:  # mesh hits: 1/total marginal
                light_area_h = jnp.where(isect["is_tri"],
                                         scene.mesh_light_area,
                                         light_area_h)
            sel_density = 1.0 / jnp.maximum(
                light_area_h * jnp.maximum(scene.light_count, 1),
                1e-20)
        elif cfg.light_sampling == "tree":
            # exact tree-selection pdf of the hit light as seen from the
            # previous vertex (st["o3"] — the same p + eps*n the NEE
            # sampler there used). Slot recovered by a vectorized
            # (prim, kind) match; zero-pick padding keeps non-lights at
            # density 0 = full BSDF weight, the correct MIS for a light
            # the other strategy cannot sample.
            match = ((isect["prim"][..., None] == scene.light_prim)
                     & (isect["is_tri"][..., None]
                        == (scene.light_kind == 1)))
            clh = jnp.sum(jnp.where(match, scene.lt_cluster, 0.0), axis=-1)
            pick_h = jnp.sum(jnp.where(match, scene.lt_pick_intra, 0.0),
                             axis=-1)
            w, wtot = tree_cluster_weights(scene, st["o3"])
            w_sel = jnp.take_along_axis(
                w, clh.astype(jnp.int32)[..., None], axis=-1)[..., 0]
            p_cl = w_sel / jnp.maximum(wtot, 1e-30)
            sel_density = (p_cl * pick_h
                           / jnp.maximum(isect["light_area"], 1e-20))
        else:
            # pick/area = lum(Le)/total_power — no table walk on the hit
            lum_e = (0.2126 * emission[..., 0] + 0.7152 * emission[..., 1]
                     + 0.0722 * emission[..., 2])
            sel_density = lum_e / jnp.maximum(scene.light_total_power, 1e-20)
            if scene.has_lane_mesh_light:
                # per-lane scheme: identical pick/total_area marginal
                sel_density = jnp.where(
                    isect["is_tri"],
                    scene.mesh_light_pick
                    / jnp.maximum(scene.mesh_light_area, 1e-20),
                    sel_density)
        if scene.has_env_map and cfg.use_nee:
            # the light-table branch runs with probability 1 - env_pick
            # (see wavefront._trace_core — the engines must agree exactly)
            sel_density = sel_density * (1.0 - scene.env_pick)
        pdf_light_w = sel_density * isect["t"] ** 2 / jnp.maximum(cos_l, 1e-6)
        w_bsdf = jnp.where(
            st["prev_did_nee"],
            sampler.power_heuristic(st["prev_pdf"], pdf_light_w),
            1.0,
        )
        add_e = jnp.where((hit & emissive)[..., None],
                          st["throughput"] * emission * w_bsdf[..., None], 0.0)
        st["radiance"] = st["radiance"] + add_e

        if scene.has_env_map:  # static: map-free scenes pay nothing
            # same math as wavefront._trace_core: escaped rays fetch their
            # direction's texel and MIS-weight against the previous
            # vertex's env NEE strategy
            from raytracing_engine_tpu.pathtracer.wavefront import (
                _atlas_fetch,
                _env_pdf_w,
                _env_texel_of,
            )

            esc = st["alive"] & ~isect["hit"]
            K_env = scene.env_img.shape[0] // 3
            dxy = (st["d3"][..., 0], st["d3"][..., 1], st["d3"][..., 2])
            e_ty, e_tx = _env_texel_of(dxy, K_env)
            e_rad = jnp.stack(_atlas_fetch(scene.env_img, e_ty, e_tx), -1)
            sin_t = jnp.sqrt(jnp.maximum(1.0 - dxy[2] * dxy[2], 1e-12))
            pdf_env_h = _env_pdf_w(scene, e_ty, e_tx, sin_t)
            w_esc = jnp.where(
                st["prev_did_nee"] & jnp.bool_(cfg.use_nee),
                sampler.power_heuristic(st["prev_pdf"],
                                        scene.env_pick * pdf_env_h),
                1.0)
            st["radiance"] = st["radiance"] + jnp.where(
                esc[..., None],
                st["throughput"] * e_rad * w_esc[..., None], 0.0)

        if scene.env is not None:  # static: env-free scenes pay nothing
            # escaped rays read the gradient sky at FULL weight (the env is
            # never NEE-sampled — see scene.py `env`); the lane then dies
            # via cont = hit & ..., so this adds exactly once
            esc = st["alive"] & ~isect["hit"]
            tz = 0.5 * (st["d3"][..., 2] + 1.0)
            env3 = scene.env[0] + (scene.env[1] - scene.env[0]) * tz[..., None]
            st["radiance"] = st["radiance"] + jnp.where(
                esc[..., None], st["throughput"] * env3, 0.0)

        # --- NEE from diffuse surfaces ------------------------------------
        if cfg.use_nee:
            u_sel = u[2]
            if scene.has_env_map:
                # one-coin env-vs-lights split with CDF-reuse rescaling —
                # identical construction to wavefront._trace_core
                pick = scene.env_pick
                sel_env = u[2] < pick
                u_sel = jnp.clip((u[2] - pick)
                                 / jnp.maximum(1.0 - pick, 1e-6),
                                 0.0, 1.0 - 1e-7)
            lp3, ln3, le, pdf_area = sample_light_point(
                scene, u_sel, u[3], u[4],
                uniform=cfg.light_sampling == "uniform",
                # evaluated at p + eps*n — the next segment's o3, so the
                # hit-side tree pdf above reproduces this pdf exactly
                tree_p3=(p3 + n3 * cfg.eps
                         if cfg.light_sampling == "tree" else None),
                u_tri=None if mlt_dim is None else u[mlt_dim])
            to_l = lp3 - p3
            dist = jnp.linalg.norm(to_l, axis=-1)
            wi3 = to_l / jnp.maximum(dist[..., None], 1e-20)
            cos_ll = jnp.abs(jnp.sum(ln3 * -wi3, axis=-1))
            light_ok = ((scene.light_count > 0) & (cos_ll > 1e-6)
                        & (dist > cfg.eps))
            if scene.has_env_map:
                from raytracing_engine_tpu.pathtracer.wavefront import (
                    _sample_env,
                )

                e_d, e_pdf, e_le = _sample_env(
                    scene,
                    jnp.clip(u[2] / jnp.maximum(pick, 1e-6),
                             0.0, 1.0 - 1e-7), u[3], u[4])
                wi3 = jnp.where(sel_env[..., None], jnp.stack(e_d, -1), wi3)
                le = jnp.where(sel_env[..., None], jnp.stack(e_le, -1), le)
                light_ok = sel_env | light_ok
                dist = jnp.where(sel_env, 1e4, dist)
            cos_s = jnp.sum(n3 * wi3, axis=-1)

            nee_kind = kind == DIFFUSE
            if scene.has_metal:  # GGX surfaces are NEE-sampled too
                nee_kind = nee_kind | (kind == METAL)
            nee_candidate = hit & nee_kind & light_ok & (cos_s > 0.0)
            shadow_o = p3 + n3 * cfg.eps
            st["nrays"] += jnp.sum(nee_candidate)
            max_t = dist * (1.0 - 1e-3)
            if scene.has_env_map:
                max_t = jnp.where(sel_env, jnp.float32(3.4e38), max_t)
            blocked = occluded(
                scene, shadow_o, wi3, max_t, cfg.t_min, bvh=bvh
            )
            vis = nee_candidate & ~blocked

            pdf_w = pdf_area * dist**2 / jnp.maximum(cos_ll, 1e-6)
            if scene.has_env_map:
                pdf_w = jnp.where(sel_env, pick * e_pdf,
                                  (1.0 - pick) * pdf_w)
            f = albedo / _PI
            pdf_b = cos_s / _PI
            if scene.has_metal:  # GGX BRDF toward the light + its pdf
                rough = scene.mat_rough[mat_id]
                alpha = jnp.maximum(rough * rough, 1e-4)
                un = lambda a: (a[..., 0], a[..., 1], a[..., 2])
                if scene.has_aniso:  # same ONB-frame aniso as wavefront
                    alpha_y = jnp.maximum(
                        scene.mat_rough2[mat_id] ** 2, 1e-4)
                    onb_t, onb_s = sampler.build_onb(un(n3))
                    f_m, pdf_m = sampler.ggx_eval_aniso(
                        un(n3), onb_t, onb_s, un(-st["d3"]), un(wi3),
                        un(albedo), alpha, alpha_y)
                else:
                    f_m, pdf_m = sampler.ggx_eval(
                        un(n3), un(-st["d3"]), un(wi3), un(albedo), alpha)
                is_met = kind == METAL
                f = jnp.where(is_met[..., None], jnp.stack(f_m, -1), f)
                pdf_b = jnp.where(is_met, pdf_m, pdf_b)
            w_nee = sampler.power_heuristic(pdf_w, pdf_b)
            nee_gain = cos_s / jnp.maximum(pdf_w, 1e-20) * w_nee
            if cfg.fog_density > 0.0:  # shadow segment transmittance
                nee_gain = nee_gain * jnp.exp(-cfg.fog_density * dist)
            contrib = (
                st["throughput"] * f * le * nee_gain[..., None]
            )
            st["radiance"] = st["radiance"] + jnp.where(vis[..., None], contrib, 0.0)

        # --- scatter -------------------------------------------------------
        nx, ny, nz = n3[..., 0], n3[..., 1], n3[..., 2]
        (ddx, ddy, ddz), pdf_cos = sampler.cosine_hemisphere(u[0], u[1], (nx, ny, nz))
        diff_d3 = jnp.stack([ddx, ddy, ddz], axis=-1)
        mirr_d3 = st["d3"] - 2.0 * jnp.sum(st["d3"] * n3, axis=-1, keepdims=True) * n3

        is_mirror = kind == MIRROR
        new_d3 = jnp.where(is_mirror[..., None], mirr_d3, diff_d3)
        new_o3 = p3 + n3 * cfg.eps
        if scene.has_dielectric:  # static: glass-free scenes pay nothing
            # dielectric: exact unpolarized Fresnel split between reflection
            # and Snell refraction; selecting reflect w.p. R cancels the
            # Fresnel factor from throughput (see scene.py DIELECTRIC)
            ior = scene.mat_ior[mat_id]
            if scene.has_dispersion:
                # spectral dispersion — same construction as wavefront.py
                dispm = scene.mat_dispersion[mat_id]
                pick = (hit & (kind == DIELECTRIC) & (dispm > 0.0)
                        & (st["chan"] < 0.0))
                c = jnp.clip(jnp.floor(u[1] * 3.0), 0.0, 2.0)
                chan = jnp.where(pick, c, st["chan"])
                onehot = jnp.stack(
                    [jnp.where(pick, 3.0 * (chan == float(k)), 1.0)
                     for k in range(3)], axis=-1)
                st["throughput"] = st["throughput"] * onehot
                st["chan"] = chan
                shift = jnp.where(chan >= 0.0, (chan - 1.0) * 0.5, 0.0)
                ior = ior + dispm * shift
            eta = jnp.where(isect["front"], 1.0 / ior, ior)
            cosi = -jnp.sum(st["d3"] * n3, axis=-1)  # n faces the ray: >= 0
            k = 1.0 - eta * eta * (1.0 - cosi * cosi)
            cost = jnp.sqrt(jnp.maximum(k, 0.0))
            rs = (eta * cosi - cost) / jnp.maximum(eta * cosi + cost, 1e-20)
            rp = (eta * cost - cosi) / jnp.maximum(eta * cost + cosi, 1e-20)
            refl_p = jnp.where(k <= 0.0, 1.0, 0.5 * (rs * rs + rp * rp))
            refr_d3 = (eta[..., None] * st["d3"]
                       + (eta * cosi - cost)[..., None] * n3)
            # u[0] doubles as the R/T coin: a dielectric lane never consumes
            # its cosine-hemisphere sample, so the streams never collide
            reflect = u[0] < refl_p
            is_diel = kind == DIELECTRIC
            diel_w = None
            if scene.has_rough_dielectric:
                # GGX rough dielectric — same Walter construction as
                # wavefront.py (NDF half-vector on u[3]/u[4], Fresnel coin
                # about h, |d.h|*G/(cos_o*cos_h) weight); the engines must
                # agree
                un_ = lambda a: (a[..., 0], a[..., 1], a[..., 2])
                rough_d = scene.mat_rough[mat_id]
                alpha_d = jnp.maximum(rough_d * rough_d, 1e-4)
                h_t, cos_hd = sampler.sample_ggx_h(u[3], u[4], un_(n3),
                                                   alpha_d)
                h_d3 = jnp.stack(h_t, -1)
                cosi_h = -jnp.sum(st["d3"] * h_d3, axis=-1)
                kk_h = 1.0 - eta * eta * (1.0 - cosi_h * cosi_h)
                cost_h = jnp.sqrt(jnp.maximum(kk_h, 0.0))
                rs_h = ((eta * cosi_h - cost_h)
                        / jnp.maximum(eta * cosi_h + cost_h, 1e-20))
                rp_h = ((eta * cost_h - cosi_h)
                        / jnp.maximum(eta * cost_h + cosi_h, 1e-20))
                reflp_h = jnp.where(kk_h <= 0.0, 1.0,
                                    0.5 * (rs_h * rs_h + rp_h * rp_h))
                refl_h = u[0] < reflp_h
                mirr_h3 = (st["d3"] - 2.0 * jnp.sum(
                    st["d3"] * h_d3, axis=-1, keepdims=True) * h_d3)
                refr_h3 = (eta[..., None] * st["d3"]
                           + (eta * cosi_h - cost_h)[..., None] * h_d3)
                d_r3 = jnp.where(refl_h[..., None], mirr_h3, refr_h3)
                cos_i_r = jnp.sum(d_r3 * n3, axis=-1)
                g_r = (sampler.ggx_smith_g1(cosi, alpha_d)
                       * sampler.ggx_smith_g1(jnp.abs(cos_i_r), alpha_d))
                w_g = (jnp.abs(cosi_h) * g_r
                       / jnp.maximum(cosi * jnp.maximum(cos_hd, 1e-6),
                                     1e-6))
                ok_r = ((cosi_h > 0.0)
                        & jnp.where(refl_h, cos_i_r > 0.0, cos_i_r < 0.0))
                w_g = jnp.where(ok_r, w_g, 0.0)
                is_rough_d = is_diel & (rough_d > 0.0)
                reflect = jnp.where(is_rough_d, refl_h, reflect)
                diel_w = jnp.where(is_rough_d, w_g, 1.0)
                mirr_d3 = jnp.where(is_rough_d[..., None], d_r3, mirr_d3)
                refr_d3 = jnp.where(is_rough_d[..., None], d_r3, refr_d3)
            new_d3 = jnp.where(is_diel[..., None],
                               jnp.where(reflect[..., None], mirr_d3,
                                         refr_d3), new_d3)
            # refracted rays continue THROUGH the surface: offset inward
            off = jnp.where(is_diel & ~reflect, -cfg.eps, cfg.eps)
            new_o3 = p3 + n3 * off[..., None]
        if scene.has_metal:  # GGX conductor scatter (same math as
            # wavefront.py: NDF half-vector sample, reflect, f*cos/pdf)
            rough = scene.mat_rough[mat_id]
            alpha = jnp.maximum(rough * rough, 1e-4)
            un = lambda a: (a[..., 0], a[..., 1], a[..., 2])
            if scene.has_aniso:
                alpha_y = jnp.maximum(scene.mat_rough2[mat_id] ** 2, 1e-4)
                onb_t, onb_s = sampler.build_onb(un(n3))
                h_t = sampler.sample_ggx_h_aniso(
                    u[0], u[1], onb_t, onb_s, un(n3), alpha, alpha_y)
                met_t = sampler.reflect(un(st["d3"]), h_t)
                f_s, pdf_s = sampler.ggx_eval_aniso(
                    un(n3), onb_t, onb_s, un(-st["d3"]), met_t,
                    un(albedo), alpha, alpha_y)
            else:
                h_t, _ = sampler.sample_ggx_h(u[0], u[1], un(n3), alpha)
                met_t = sampler.reflect(un(st["d3"]), h_t)
                f_s, pdf_s = sampler.ggx_eval(un(n3), un(-st["d3"]), met_t,
                                              un(albedo), alpha)
            cos_i_s = sum(nc * mc for nc, mc in zip(un(n3), met_t))
            w_met = jnp.stack(f_s, -1) * jnp.where(
                pdf_s > 0.0,
                cos_i_s / jnp.maximum(pdf_s, 1e-12), 0.0)[..., None]
            is_metal = kind == METAL
            new_d3 = jnp.where(is_metal[..., None], jnp.stack(met_t, -1),
                               new_d3)
            w_mat = jnp.where(is_metal[..., None], w_met, albedo)
            new_thr = st["throughput"] * w_mat
            pdf_bsdf = jnp.where(is_metal, pdf_s, pdf_cos)
        else:
            new_thr = st["throughput"] * albedo  # f*cos/pdf = albedo
            pdf_bsdf = pdf_cos
        if scene.has_rough_dielectric:  # Walter weight on rough-glass lanes
            new_thr = new_thr * diel_w[..., None]

        cont = hit & (jnp.max(new_thr, axis=-1) > 0.0)
        if cfg.rr_start > 0:  # static: RR-off keeps the 5-plane stream
            # Russian roulette: survive w.p. p, divide throughput by p —
            # E[thr] is unchanged (unbiased), dim deep paths terminate
            p_c = jnp.clip(jnp.max(new_thr, axis=-1), 0.05, 1.0)
            rr_on = b >= cfg.rr_start
            cont = cont & (~rr_on | (u[5] < p_c))
            new_thr = jnp.where(rr_on, new_thr / p_c[..., None], new_thr)
        st["throughput"] = jnp.where(cont[..., None], new_thr, 0.0)
        st["o3"] = jnp.where(cont[..., None], new_o3, st["o3"])
        st["d3"] = jnp.where(cont[..., None], new_d3, st["d3"])
        st["alive"] = cont
        nee_kinds = kind == DIFFUSE
        if scene.has_metal:
            nee_kinds = nee_kinds | (kind == METAL)
        # an env map is an NEE target even with zero slot lights (matches
        # wavefront._trace_core — next-segment MIS must down-weight)
        nee_avail = (jnp.bool_(True) if scene.has_env_map
                     else scene.light_count > 0)
        st["prev_did_nee"] = hit & nee_kinds & nee_avail & jnp.bool_(cfg.use_nee)
        st["prev_pdf"] = pdf_bsdf
        return st

    state = lax.fori_loop(0, cfg.max_bounces + 1, bounce, state)
    return state["radiance"], state["nrays"]


@partial(jax.jit, static_argnums=(0, 4))
def render_pt(cfg: PTConfig, scene: PTScene, cam_pos, cam_quat, spp: int,
              key=None, bvh=None, spp_offset=0):
    """Average `spp` passes. Returns ((H, W, 3) image, rays-traced scalar).
    Pass a BVH (accel/bvh.py) to accelerate triangle intersection.

    Pass i uses fold_in(key, spp_offset + i): progressive renders chunked at
    arbitrary boundaries reproduce the exact same sample sequence."""
    if key is None:
        key = random.PRNGKey(0)

    def body(i, carry):
        acc, nrays = carry
        rad, nr = trace_pass(cfg, scene, cam_pos, cam_quat,
                             random.fold_in(key, spp_offset + i), bvh=bvh)
        return acc + rad, nrays + nr

    acc, nrays = lax.fori_loop(
        0, spp, body,
        (jnp.zeros((cfg.height, cfg.width, 3), jnp.float32), jnp.float32(0.0)),
    )
    return acc / spp, nrays
