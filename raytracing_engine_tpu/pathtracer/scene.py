"""Path-tracer scene: spheres + triangle meshes + physically-based materials.

Extends the parity renderer's sphere scene (scene/types.py) with triangles
and emission, per the north star (BASELINE.json): SoA arrays, static padded
shapes, host-built light table for next-event estimation.

Material model (BASELINE config 2: diffuse/specular/emissive):
    kind 0 = DIFFUSE    — Lambertian, albedo/π BRDF, cosine-sampled
    kind 1 = MIRROR     — perfect specular reflection (delta; skipped by NEE)
    kind 3 = DIELECTRIC — smooth glass: exact (unpolarized) Fresnel split
                          between reflection and Snell refraction, total
                          internal reflection, one-sample R/(1-R) selection
                          so the Fresnel factor cancels from throughput
                          (energy-exact: a clear dielectric passes the
                          furnace test). `ior` per material (default 1.5).
                          Delta; skipped by NEE. The radiance eta^2
                          compression factor is deliberately omitted (it
                          cancels on enter/exit pairs of closed objects) —
                          consistent across all three integrators.
    kind 4 = METAL      — GGX rough conductor: Trowbridge-Reitz NDF,
                          separable Smith masking, Schlick Fresnel with
                          albedo as F0, NDF half-vector sampling
                          (f·cos/pdf weight), NEE+MIS like diffuse.
                          `roughness` per material (alpha = roughness²).
    emission is a per-material RGB; any primitive with a nonzero-emission
    material is a light for NEE.
"""

from __future__ import annotations

import dataclasses

import jax
import numpy as np
import jax.numpy as jnp

DIFFUSE = 0
MIRROR = 1
EMISSIVE = 2  # alias: a diffuse surface whose emission dominates
DIELECTRIC = 3
METAL = 4        # GGX rough conductor: albedo = F0, mat_rough = roughness

# Triangle slots the plane-native integrators unroll into scalar selects
# (wavefront._tri_hits_unrolled / _sample_light). Bigger meshes ride the
# cluster sweep for INTERSECTION, but per-triangle NEE light slots cannot
# exceed this — emissive triangles beyond it must use mesh_lights=True
# (global per-pass area-CDF selection; see build_pt_scene).
TRI_UNROLL_MAX = 32

# light_kind values in the NEE light table
LIGHT_SPHERE = 0
LIGHT_TRI = 1
LIGHT_MESH = 2   # pseudo-slot: the whole emissive mesh, one light

# Rec.709 luminance weights — the "power" in power-weighted light selection
_LUM = np.array([0.2126, 0.7152, 0.0722], np.float64)


ATLAS_W = 128        # texels per atlas row
ATLAS_MAX_ROWS = 32  # in-kernel texture budget: 32 * 128 = 4096 texels


def build_mip_chain(img):
    """Box-filtered mip chain of an (h, w, 3) image: level 0 is the image
    itself, each next level 2x2-averages the previous (odd dims edge-pad
    by duplicating the last row/column, ceil-halving) until 1x1. The
    chain is the standard pre-filtering pyramid for trilinear sampling —
    level L integrates the texture over 2^L x 2^L texel footprints."""
    img = np.asarray(img, np.float32)
    chain = [img]
    while img.shape[0] > 1 or img.shape[1] > 1:
        h, w = img.shape[:2]
        if h % 2:
            img = np.concatenate([img, img[-1:]], axis=0)
        if w % 2:
            img = np.concatenate([img, img[:, -1:]], axis=1)
        img = 0.25 * (img[0::2, 0::2] + img[1::2, 0::2]
                      + img[0::2, 1::2] + img[1::2, 1::2])
        chain.append(img)
    return chain


def pack_texture_atlas(images):
    """Shelf-pack RGB images into the shared texture atlas.

    images: sequence of (h, w, 3) float arrays, each w <= ATLAS_W. Returns
    (atlas (3K, ATLAS_W) f32 — channel-major rows, row c*K + k —
    and rects (N, 4) f32 = [x0, y0, w, h] texel rectangles). K is capped
    at ATLAS_MAX_ROWS: the per-lane fetch is a K-row select chain, so the
    budget bounds texture cost.
    """
    rects = np.zeros((len(images), 4), np.float32)
    x = y = shelf_h = 0
    placed = []
    for n, img in enumerate(images):
        img = np.asarray(img, np.float32)
        if img.ndim != 3 or img.shape[2] != 3:
            raise ValueError(f"texture {n} must be (h, w, 3); got {img.shape}")
        h, w = img.shape[:2]
        if w > ATLAS_W:
            raise ValueError(
                f"texture {n} is {w} texels wide > atlas width {ATLAS_W}")
        if x + w > ATLAS_W:  # new shelf
            y += shelf_h
            x = shelf_h = 0
        rects[n] = (x, y, w, h)
        placed.append((x, y, img))
        shelf_h = max(shelf_h, h)
        x += w
    K = y + shelf_h
    if K > ATLAS_MAX_ROWS:
        raise ValueError(
            f"textures need {K} atlas rows > budget {ATLAS_MAX_ROWS} "
            f"({ATLAS_MAX_ROWS * ATLAS_W} texels) — shrink or share textures")
    K = max(K, 1)
    atlas = np.zeros((3 * K, ATLAS_W), np.float32)
    for x0, y0, img in placed:
        h, w = img.shape[:2]
        for c in range(3):
            atlas[c * K + y0:c * K + y0 + h, x0:x0 + w] = img[:, :, c]
    return atlas, rects


def _pad(a, n, fill=0.0):
    a = np.asarray(a, np.float32)
    if a.shape[0] == n:
        return a
    pad = np.full((n - a.shape[0],) + a.shape[1:], fill, np.float32)
    return np.concatenate([a, pad], axis=0)


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class PTScene:
    # spheres (SoA, padded)
    sph_pos: jax.Array      # (S, 3)
    sph_radius: jax.Array   # (S,)
    sph_mat: jax.Array      # (S,) int32
    sph_count: jax.Array    # () int32
    # triangles (SoA, padded): v0 + edge vectors for Möller–Trumbore
    tri_v0: jax.Array       # (T, 3)
    tri_e1: jax.Array       # (T, 3)
    tri_e2: jax.Array       # (T, 3)
    tri_mat: jax.Array      # (T,) int32
    tri_count: jax.Array    # () int32
    # materials
    mat_albedo: jax.Array   # (M, 3)
    mat_emission: jax.Array # (M, 3)
    mat_kind: jax.Array     # (M,) int32
    mat_ior: jax.Array      # (M,) f32 — refraction index (DIELECTRIC only)
    # NEE light table (host-built from emissive primitives)
    light_kind: jax.Array   # (L,) int32 — 0 sphere, 1 triangle, 2 mesh
    light_prim: jax.Array   # (L,) int32 — index into the primitive arrays
    light_area: jax.Array   # (L,) f32   — surface area (uniform-area pdf)
    light_le: jax.Array     # (L, 3) f32 — emitted radiance (precomputed)
    light_count: jax.Array  # () int32
    # power-weighted NEE light selection (PTConfig.light_sampling="power"):
    # pick probability per slot ∝ area * luminance(Le) (for the mesh
    # pseudo-slot: sum over its triangles), its inclusive CDF (padded
    # slots pinned to 1 so they are never chosen), and the total power —
    # the hit-side MIS pdf needs lum(emission)/total without a table walk
    light_pick: jax.Array   # (L,) f32 — selection probabilities
    light_cdf: jax.Array    # (L,) f32 — inclusive cumulative of the above
    light_total_power: jax.Array  # () f32 — sum(area * lum(Le))
    # mesh light (mesh_lights=True): ALL emissive triangles, any count.
    # Sampled per PASS: one area-weighted triangle per global pass index
    # (scalar), per-lane barycentric jitter — the marginal point pdf is
    # 1/(total_area * light_count), used consistently on both MIS sides,
    # so the estimator stays unbiased; the per-pass row is a scalar
    # table instead of a per-lane gather.
    mesh_light_tri: jax.Array | None = None   # (E, 12): v0, e1, e2, Le
    mesh_light_cdf: jax.Array | None = None   # (E,) normalized area CDF
    mesh_light_area: jax.Array | None = None  # () total emissive area
    mesh_light_pick: jax.Array | None = None  # () the mesh slot's pick prob
    # PER-LANE mesh lights (mesh_lights="lane"): all emissive triangles in
    # lane-row tables — 12 K-row blocks [v0, e1, e2, Le] + a Vose alias
    # table over the area pmf (padding probability 0). Every lane NEE
    # draw area-samples its OWN triangle (two alias fetches + 12 row
    # fetches, the env-map fetch machinery); the point pdf marginalizes
    # to 1/total_area exactly like the per-pass scheme, so hit-side MIS
    # is unchanged. None = per-pass or no mesh lights (static gate).
    mlt_rows: jax.Array | None = None   # (12K, 128) triangle component rows
    mlt_smp: jax.Array | None = None    # (2K, 128) [alias-prob; alias-idx]
    # procedural world-space checker texture: cells of size 1/scale
    # alternate between mat_albedo and mat_albedo2; scale 0 = untextured.
    # World-space procedural is the gather-free texture model: pure
    # elementwise math at the hit point.
    # None = no material textures anywhere (static; zero cost).
    mat_albedo2: jax.Array | None = None    # (M, 3)
    mat_tex_scale: jax.Array | None = None  # (M,) f32 — 0 = flat
    # METAL (GGX rough conductor) roughness r; the microfacet alpha is the
    # Disney remap a = r*r. None when no metal material exists — the
    # static gate that keeps metal-free scenes compiling the prior
    # program (same None-gating contract as every optional feature).
    mat_rough: jax.Array | None = None      # (M,) f32
    # ANISOTROPIC GGX conductors: second roughness axis (material key
    # "roughness_y"). alpha_x/alpha_y = Disney-remapped squares; the
    # anisotropy axes live in the deterministic per-normal ONB frame
    # (sampler.build_onb). None = all metals isotropic — the exact prior
    # (cheaper) isotropic GGX program compiles (static None gate).
    mat_rough2: jax.Array | None = None     # (M,) f32 — roughness_y
    # UV texturing. Geometry carries per-corner UVs (ClusterSet rows
    # 32-37 / `tri_uv` below); spheres get the analytic spherical
    # parametrization. Procedural checkers may evaluate in UV space
    # (mat_tex_space=1), and IMAGE textures sample a shared atlas.
    # The atlas is (3K, 128) f32 — K rows of 128 texels per channel,
    # channel-major (row c*K + k) — and the per-lane texel fetch is a
    # lane-axis take_along_axis over a broadcast atlas row + a K-row
    # select chain, so ONE implementation serves both integrators
    # bit-identically. K <= 32 keeps the fetch ~3*K vector ops (the
    # texture budget: 4096 texels).
    mat_tex_space: jax.Array | None = None  # (M,) f32 — 1 = UV-space checker
    tex_atlas: jax.Array | None = None      # (3K, 128) f32 atlas rows
    mat_tex_rect: jax.Array | None = None   # (M, 4) f32 — x0, y0, w, h texels
    # trilinear mip filtering (build_pt_scene tex_mips=True + PTConfig
    # tex_filter="trilinear"): each albedo image's box-filtered mip chain
    # is shelf-packed into the SAME atlas, and this table carries the
    # per-(material, level) rects, flattened (M, 4*L) = L blocks of
    # [x0, y0, w, h]. Level 0 duplicates mat_tex_rect (nearest/bilinear
    # renders of a mipped scene are bit-identical to an unmipped one);
    # chains shorter than L repeat their last (1x1) level, so a clamped
    # LOD never reads out of chain. The LOD itself comes from a ray cone
    # (see wavefront._trace_core): width = alpha * accumulated path
    # distance, alpha = 2*fov/width — the Akenine-Moller ray-cone scheme
    # without curvature/roughness growth. Normal maps stay un-mipped
    # (naive normal averaging denormalizes; they sample bilinearly).
    # None = no mips (static; zero cost, the existing program).
    mat_tex_mips: jax.Array | None = None   # (M, 4*L) f32 per-level rects
    # tangent-space normal maps: a rect into the SAME atlas whose RGB
    # encodes the tangent-space normal as (n+1)/2 (standard encoding),
    # plus a per-material UV tiling scale. The shading tangent frame is
    # DERIVED, not stored: triangles use the texture-u gradient
    # d(u_tex)/dp = du1*r1 + du2*r2 from the Baldwin–Weber barycentric
    # gradient rows already in the tables (translation-invariant), and
    # spheres the analytic azimuthal direction (-ny, nx, 0) — so normal
    # maps add zero geometry storage on every path.
    mat_nrm_rect: jax.Array | None = None   # (M, 4) f32 — x0, y0, w, h texels
    mat_nrm_scale: jax.Array | None = None  # (M,) f32 — UV tiling
    tri_uv: jax.Array | None = None         # (T, 6) f32 — u0,v0,u1,v1,u2,v2
    #   per-corner UVs of the UNROLLED triangle slots (gather paths);
    #   cluster meshes carry UVs in the table rows instead
    # spectral dispersion for DIELECTRIC materials: ior spread between
    # the blue and red channels (ior_R = ior - d/2 ... ior_B = ior + d/2).
    # A path hitting dispersive glass commits to ONE color channel
    # (one-hot x3 throughput — unbiased, 3x chroma noise on glass paths).
    # None = no dispersive materials anywhere (static; zero cost).
    mat_dispersion: jax.Array | None = None  # (M,) f32 — 0 = achromatic
    # two-level LIGHT TREE for many-light NEE (build_pt_scene
    # light_tree=C, PTConfig.light_sampling="tree"): the gather-free
    # answer to a pointer-chasing light BVH is a fixed two-level CDF —
    # C position-bounded clusters whose per-lane importance
    # w_c = power_c / max(dist(p, center_c)^2, radius_c^2) is pure
    # vector math over a STATIC C axis, then a power-CDF over the
    # cluster's member slots. Selection and the hit-side MIS pdf are
    # both exact per-lane expressions — no gathers, no stack, no
    # data-dependent control flow. None = flat power/uniform selection
    # only (static; zero cost — the tables below never ship).
    lt_center: jax.Array | None = None      # (C, 3) cluster bound centers
    lt_radius: jax.Array | None = None      # (C,) cluster bound radii
    lt_power: jax.Array | None = None       # (C,) cluster total power
    lt_cluster: jax.Array | None = None     # (L,) f32 slot -> cluster id
    lt_cdf_intra: jax.Array | None = None   # (L,) within-cluster incl. CDF
    lt_pick_intra: jax.Array | None = None  # (L,) within-cluster pick prob
    # environment light: (2, 3) [bottom, top] radiance rows, linearly
    # interpolated on the ray direction's z (Z-up gradient sky; equal rows
    # = constant sky). Escaped rays add throughput * env(d) at FULL weight:
    # the env is BSDF-sampling-only (never in the NEE light table), which
    # is unbiased — put bright small suns in the scene as area lights.
    env: jax.Array | None = None
    # HDR environment MAP with NEE importance sampling (build_pt_scene
    # env=(H, W, 3) image). env_img: (3K, 128) channel-major equirect
    # texels (atlas-format rows — the per-lane fetch is the same K-row
    # select chain + lane gather as the texture atlas, kernel-safe).
    # env_smp: (3K, 128) = [p_sel; alias-prob; alias-index] — a Vose
    # alias table over the K*128 texels, luminance-x-solid-angle
    # weighted, so ONE uniform picks a texel in O(1) with two per-lane
    # table reads. env_pick: probability NEE samples the env instead of
    # the light table (power-proportional by default); both strategies
    # MIS against BSDF sampling with their selection-scaled pdfs.
    # Mutually exclusive with the gradient `env`. None = no env map
    # (static; zero cost — same None-gating contract as every feature).
    env_img: jax.Array | None = None   # (3K, 128) radiance rows
    env_smp: jax.Array | None = None   # (3K, 128) sampling tables
    env_pick: jax.Array | None = None  # () f32 NEE env-vs-lights prob
    # static (trace-time) flag: scenes without glass skip the dielectric
    # scatter planes entirely — no per-bounce cost for configs 2/3/4
    has_dielectric: bool = dataclasses.field(
        default=False, metadata=dict(static=True))
    # static flag: any DIELECTRIC material with roughness > 0 — the
    # scatter step then adds the GGX rough-dielectric branch (Walter 2007
    # microfacet refraction: NDF half-vector, Fresnel coin about h, the
    # |oh|·G/(cos_o·cos_h) weight). Smooth-glass lanes keep the exact
    # prior math via per-lane selects; scenes without rough glass compile
    # the prior program (same None/static-gating contract as every
    # feature). mat_rough ships whenever metal OR rough glass exists.
    has_rough_dielectric: bool = dataclasses.field(
        default=False, metadata=dict(static=True))
    # number of TRIANGLE slot lights in the NEE table (static, set by
    # build_pt_scene). The light-tree render guard needs it: in-kernel
    # cluster/instanced sweeps return padded-reordered triangle indices,
    # so a BSDF hit on a slot-light triangle there cannot be matched back
    # to its light slot — its hit-side MIS density would read 0 (full
    # BSDF weight) while NEE also samples it, double-counting direct
    # light. The combination is rejected at render entry instead.
    n_tri_slot_lights: int = dataclasses.field(
        default=0, metadata=dict(static=True))

    @property
    def num_sphere_slots(self) -> int:
        return self.sph_pos.shape[0]

    @property
    def num_triangle_slots(self) -> int:
        return self.tri_v0.shape[0]

    @property
    def has_metal(self) -> bool:
        """GGX rough-conductor materials present — static predicate."""
        return self.mat_rough is not None

    @property
    def has_aniso(self) -> bool:
        """Anisotropic GGX conductors present — static predicate."""
        return self.mat_rough2 is not None

    @property
    def has_mesh_light(self) -> bool:
        return self.mesh_light_tri is not None

    @property
    def has_lane_mesh_light(self) -> bool:
        """Per-lane emissive-triangle sampling tables present — static."""
        return self.mlt_rows is not None

    @property
    def has_texture(self) -> bool:
        # None-ness is pytree structure -> static predicate (like has_env)
        return self.mat_tex_scale is not None

    @property
    def has_image(self) -> bool:
        """Albedo image textures present — static None-ness predicate."""
        return self.mat_tex_rect is not None

    @property
    def has_atlas(self) -> bool:
        """Any atlas present (albedo images and/or normal maps)."""
        return self.tex_atlas is not None

    @property
    def has_normal_map(self) -> bool:
        """Tangent-space normal maps present — the intersectors then also
        emit a `tan` (world tangent) plane triple."""
        return self.mat_nrm_rect is not None

    @property
    def has_mips(self) -> bool:
        """Mip-chain rect table present (tex_mips=True) — static."""
        return self.mat_tex_mips is not None

    @property
    def n_mip_levels(self) -> int:
        """Static mip level count L of the per-material rect table."""
        return 0 if self.mat_tex_mips is None else (
            self.mat_tex_mips.shape[1] // 4)

    @property
    def needs_tan(self) -> bool:
        """True when shading consumes the world texture-u tangent plane
        triple: normal maps (the tangent frame) or mip LOD (the UV
        density |du/dp| that converts a ray-cone width to texels)."""
        return self.mat_nrm_rect is not None or self.mat_tex_mips is not None

    @property
    def needs_uv(self) -> bool:
        """True when shading consumes hit UVs (image textures, normal
        maps, or UV-space checkers) — the intersectors then emit a `uv`
        plane pair."""
        return self.tex_atlas is not None or self.mat_tex_space is not None

    @property
    def has_tri_uv(self) -> bool:
        return self.tri_uv is not None

    @property
    def has_dispersion(self) -> bool:
        return self.mat_dispersion is not None

    @property
    def has_light_tree(self) -> bool:
        """Two-level light-tree tables present — static None-ness
        predicate; required by PTConfig.light_sampling="tree"."""
        return self.lt_center is not None

    @property
    def has_env(self) -> bool:
        # None-ness is part of the pytree structure, so this is a
        # trace-time (static) predicate: env-free scenes compile the
        # exact pre-env program
        return self.env is not None

    @property
    def has_env_map(self) -> bool:
        """Importance-sampled HDR env map present — static predicate."""
        return self.env_img is not None


def _morton3(q):
    """Interleave the bits of (N, 3) integer coords (10 bits/axis)."""
    def spread(x):
        x = (x | (x << 16)) & 0x030000FF
        x = (x | (x << 8)) & 0x0300F00F
        x = (x | (x << 4)) & 0x030C30C3
        x = (x | (x << 2)) & 0x09249249
        return x
    q = q.astype(np.uint32)
    return (spread(q[:, 0]) | (spread(q[:, 1]) << 1)
            | (spread(q[:, 2]) << 2))


def _build_light_tree(pos, rad, powers, C, light_pad):
    """Host build of the two-level light tree (see PTScene.lt_* fields).

    Morton-orders the L light slots by position and splits the order into
    C contiguous, count-balanced clusters — spatially coherent groups
    without any reordering of the slot tables themselves (selection at
    render time walks the ORIGINAL slot axis with a cluster mask, so the
    base light table stays bit-identical to the tree-free build).

    Returns (center (C,3), radius (C,), power (C,), cluster (light_pad,),
    cdf_intra (light_pad,), pick_intra (light_pad,)) — padded slots carry
    cluster 0 / pick 0 / cdf 1, which the render-time walks were designed
    around: zero pick keeps them out of every pdf sum, and real clusters
    always terminate the masked CDF walk before padding is reached.
    """
    L = pos.shape[0]
    C = max(1, min(int(C), L))
    lo = pos.min(axis=0)
    span = np.maximum(pos.max(axis=0) - lo, 1e-12)
    q = np.clip(((pos - lo) / span) * 1023.0, 0.0, 1023.0).astype(np.int64)
    order = np.argsort(_morton3(q), kind="stable")

    cluster = np.zeros((light_pad,), np.float32)
    # count-balanced contiguous split of the Morton order
    bounds = np.linspace(0, L, C + 1).round().astype(int)
    for c in range(C):
        for j in order[bounds[c]:bounds[c + 1]]:
            cluster[j] = float(c)

    center = np.zeros((C, 3), np.float32)
    radius = np.zeros((C,), np.float32)
    cpow = np.zeros((C,), np.float64)
    pick = np.zeros((light_pad,), np.float32)
    cdf = np.ones((light_pad,), np.float32)  # padding pinned to 1
    for c in range(C):
        members = [k for k in range(L) if cluster[k] == c]
        mp = pos[members]
        center[c] = mp.mean(axis=0)
        radius[c] = max(float(np.linalg.norm(mp[i] - center[c]) + rad[k])
                        for i, k in enumerate(members))
        cpow[c] = sum(powers[k] for k in members)
        # within-cluster power CDF over members IN SLOT ORDER; uniform
        # fallback when the cluster's total power is zero
        n = len(members)
        w = [powers[k] / cpow[c] if cpow[c] > 0 else 1.0 / n
             for k in members]
        run = 0.0
        for i, k in enumerate(members):
            run += w[i]
            pick[k] = w[i]
            cdf[k] = min(run, 1.0)
        cdf[members[-1]] = 1.0  # guard fp drift: the walk must terminate
    return (center, radius, cpow.astype(np.float32), cluster, cdf, pick)


def build_pt_scene(
    spheres=(),          # sequence of (center(3,), radius, mat_id)
    triangles=None,      # (T, 3, 3) vertex array (v0, v1, v2 per row)
    tri_mats=None,       # (T,) material ids
    materials=(),        # sequence of dicts: albedo(3,), emission(3,), kind
    sphere_pad: int | None = None,
    tri_pad: int | None = None,
    light_pad: int | None = None,
    mesh_lights: bool = False,
    allow_many_tri_lights: bool = False,
    env=None,            # (3,) constant sky, ((3,), (3,)) = (bottom, top)
    #                      gradient, or an (H, W, 3) equirect HDR image ->
    #                      importance-sampled env map (build_env_map)
    tri_uvs=None,        # (T, 3, 2) per-corner UVs of the unrolled slots
    light_tree: int = 0,  # > 0: build a C-cluster two-level light tree
    env_pick=None,       # NEE env-vs-lights probability override (map env)
    env_rows=None,       # env-map polar resolution override (<= 32)
    tex_mips: bool = False,  # pack albedo-image mip chains (trilinear)
) -> PTScene:
    """Host-side scene assembly: pads SoA arrays, derives the light table.

    mesh_lights=True routes ALL emissive triangles through the mesh-light
    sampler (area-weighted per-pass triangle selection, no slot limit)
    instead of per-triangle light slots. Emissive triangles at index >=
    TRI_UNROLL_MAX REQUIRE it: the plane-native NEE samplers unroll
    per-triangle light slots into scalar selects and cannot address later
    slots, so without it such a light would silently vanish from direct
    lighting — this constructor refuses instead (the reference shades
    every light it has: /root/reference/shaders/fragment.glsl:170-185).

    allow_many_tri_lights=True keeps per-triangle light slots beyond the
    unroll limit anyway — ONLY the stacked reference integrator
    (pathtracer/integrator.py, gather-based) samples those correctly; use
    it for statistical cross-checks of the mesh-light estimator.

    light_tree=C builds a two-level light hierarchy over the slot lights
    for position-aware NEE selection (PTConfig.light_sampling="tree"):
    slots are Morton-ordered by position and split into C contiguous
    clusters; a render-time lane picks a cluster by distance-discounted
    power, then a slot by the cluster's power CDF. Incompatible with
    mesh_lights (the per-pass mesh pseudo-slot has no fixed position) —
    this constructor refuses the combination loudly.
    """
    S = len(spheres)
    sphere_pad = sphere_pad or max(S, 1)
    sph_pos = np.zeros((sphere_pad, 3), np.float32)
    sph_radius = np.zeros((sphere_pad,), np.float32)
    sph_mat = np.zeros((sphere_pad,), np.int32)
    for i, (c, r, m) in enumerate(spheres):
        sph_pos[i] = c
        sph_radius[i] = r
        sph_mat[i] = m

    if triangles is None:
        triangles = np.zeros((0, 3, 3), np.float32)
        tri_mats = np.zeros((0,), np.int32)
    triangles = np.asarray(triangles, np.float32)
    tri_mats = np.asarray(tri_mats, np.int32)
    T = triangles.shape[0]
    tri_pad = tri_pad or max(T, 1)
    v0 = _pad(triangles[:, 0], tri_pad)
    e1 = _pad(triangles[:, 1] - triangles[:, 0], tri_pad)
    e2 = _pad(triangles[:, 2] - triangles[:, 0], tri_pad)
    tmat = np.zeros((tri_pad,), np.int32)
    tmat[:T] = tri_mats

    M = max(len(materials), 1)
    mat_albedo = np.zeros((M, 3), np.float32)
    mat_emission = np.zeros((M, 3), np.float32)
    mat_kind = np.zeros((M,), np.int32)
    mat_ior = np.ones((M,), np.float32)
    mat_rough = np.zeros((M,), np.float32)
    mat_rough2 = np.zeros((M,), np.float32)
    mat_albedo2 = np.zeros((M, 3), np.float32)
    mat_tex_scale = np.zeros((M,), np.float32)
    mat_tex_space = np.zeros((M,), np.float32)
    mat_dispersion = np.zeros((M,), np.float32)
    mat_nrm_scale = np.zeros((M,), np.float32)
    images = []   # (material index, (h, w, 3) pixels) for the atlas
    normals = []  # (material index, (h, w, 3) (n+1)/2-encoded normal map)
    for i, m in enumerate(materials):
        mat_kind[i] = m.get("kind", DIFFUSE)
        # a clear dielectric tints nothing: albedo defaults to 1 there
        # (0 would kill the path at the throughput gate)
        default_albedo = (1.0,) * 3 if mat_kind[i] == DIELECTRIC else (0.0,) * 3
        mat_albedo[i] = m.get("albedo", default_albedo)
        mat_emission[i] = m.get("emission", (0.0, 0.0, 0.0))
        mat_ior[i] = m.get("ior", 1.5)
        mat_rough[i] = m.get("roughness", 0.3 if mat_kind[i] == METAL
                             else 0.0)
        mat_rough2[i] = m.get("roughness_y", mat_rough[i])
        if "checker" in m:  # {"color": (3,), "scale", "space": "world"|"uv"}
            mat_albedo2[i] = m["checker"].get("color", (0.0, 0.0, 0.0))
            mat_tex_scale[i] = m["checker"].get("scale", 1.0)
            mat_tex_space[i] = (
                1.0 if m["checker"].get("space", "world") == "uv" else 0.0)
        if "image" in m:  # {"pixels": (h, w, 3), "scale": uv tiling} | array
            spec = m["image"]
            if isinstance(spec, dict):
                pixels, scale = spec["pixels"], spec.get("scale", 1.0)
            else:
                pixels, scale = spec, 1.0
            images.append((i, np.asarray(pixels, np.float32)))
            mat_tex_scale[i] = scale
        if "normal" in m:  # {"pixels": (h, w, 3) (n+1)/2, "scale"} | array
            spec = m["normal"]
            if isinstance(spec, dict):
                pixels, scale = spec["pixels"], spec.get("scale", 1.0)
            else:
                pixels, scale = spec, 1.0
            normals.append((i, np.asarray(pixels, np.float32)))
            mat_nrm_scale[i] = scale
        mat_dispersion[i] = m.get("dispersion", 0.0)
    textured = bool((mat_tex_scale > 0).any())
    uv_space = bool((mat_tex_space > 0).any())
    dispersive = bool((mat_dispersion > 0).any())
    tex_atlas = mat_rect = nrm_rect = mat_mips = None
    if images or normals:
        # albedo images and normal maps share ONE atlas (one table, one
        # fetch implementation). tex_mips packs each albedo image's
        # whole mip chain as extra rects in the same atlas; level 0 IS
        # the image, so mat_tex_rect (and every nearest/bilinear read)
        # is unchanged by mipping.
        chains = ([build_mip_chain(img) for _, img in images]
                  if tex_mips and images else
                  [[np.asarray(img, np.float32)] for _, img in images])
        flat = [lv for ch in chains for lv in ch]
        tex_atlas, rects = pack_texture_atlas(
            flat + [img for _, img in normals])
        if images:
            mat_rect = np.zeros((M, 4), np.float32)  # w=0 -> no image tex
            L = max(len(ch) for ch in chains)
            if tex_mips:
                mat_mips = np.zeros((M, 4 * L), np.float32)
            off = 0
            for (i, _), ch in zip(images, chains):
                mat_rect[i] = rects[off]
                if tex_mips:
                    for lv in range(L):  # short chains repeat their 1x1
                        mat_mips[i, 4 * lv:4 * lv + 4] = rects[
                            off + min(lv, len(ch) - 1)]
                off += len(ch)
        if normals:
            nrm_rect = np.zeros((M, 4), np.float32)  # w=0 -> no normal map
            for (i, _), r in zip(normals, rects[len(flat):]):
                nrm_rect[i] = r
    tri_uv6 = None
    if tri_uvs is not None:
        uv_arr = np.asarray(tri_uvs, np.float32)
        if uv_arr.shape != (T, 3, 2):
            raise ValueError(
                f"tri_uvs must be (T, 3, 2) matching triangles; got "
                f"{uv_arr.shape} for T={T}")
        tri_uv6 = _pad(uv_arr.reshape(T, 6), tri_pad)

    # --- light table: all primitives whose material emits -----------------
    lk, lp, la, le = [], [], [], []
    for i in range(S):
        if np.any(mat_emission[sph_mat[i]] > 0):
            lk.append(LIGHT_SPHERE)
            lp.append(i)
            la.append(4.0 * np.pi * float(sph_radius[i]) ** 2)
            le.append(mat_emission[sph_mat[i]])

    emissive_tris = [i for i in range(T)
                     if np.any(mat_emission[tri_mats[i]] > 0)]
    mesh_tri = mesh_cdf = mesh_area = None
    mlt_rows = mlt_smp = None
    mesh_mode = (mesh_lights if isinstance(mesh_lights, str)
                 else ("pass" if mesh_lights else None))
    if mesh_mode not in (None, "pass", "lane"):
        raise ValueError(f"mesh_lights must be bool, 'pass' or 'lane'; "
                         f"got {mesh_lights!r}")
    if mesh_mode:
        if not emissive_tris:
            raise ValueError("mesh_lights=True but no triangle has an "
                             "emissive material")
        idxs = np.asarray(emissive_tris)
        cross = np.cross(e1[idxs], e2[idxs])
        areas = 0.5 * np.linalg.norm(cross, axis=1).astype(np.float64)
        total = float(areas.sum())
        if total <= 0:
            raise ValueError("emissive triangles have zero total area")
        if mesh_mode == "pass":
            mesh_tri = np.concatenate(
                [v0[idxs], e1[idxs], e2[idxs],
                 mat_emission[tri_mats[idxs]]], axis=1).astype(np.float32)
            mesh_cdf = np.cumsum(areas / total).astype(np.float32)
            mesh_cdf[-1] = 1.0  # guard fp drift: last bin covers u -> 1
        else:
            # PER-LANE mesh lights: every lane area-samples its own
            # emissive triangle via a Vose alias table over lane-row
            # tables (the env-map machinery) — no per-pass correlation,
            # no slot limit up to MLT_MAX_ROWS*128 triangles. The point
            # pdf is area_t/total * 1/area_t = 1/total: the same
            # marginal as the per-pass scheme, so the hit-side MIS is
            # identical and needs no per-lane triangle match.
            E = len(idxs)
            if E > MLT_MAX_ROWS * ENV_W:
                raise ValueError(
                    f"mesh_lights='lane' holds up to "
                    f"{MLT_MAX_ROWS * ENV_W} emissive triangles (got {E})"
                    " — use mesh_lights=True (per-pass, unlimited)")
            K_m = max((E + ENV_W - 1) // ENV_W, 1)
            Ep = K_m * ENV_W
            pmf = np.zeros(Ep, np.float64)
            pmf[:E] = areas / total  # padding stays probability 0
            ap, ai = _alias_table(pmf)
            cols = np.concatenate(
                [v0[idxs], e1[idxs], e2[idxs],
                 mat_emission[tri_mats[idxs]]], axis=1).astype(np.float32)
            rows = np.zeros((12 * K_m, ENV_W), np.float32)
            for b in range(12):
                rows[b * K_m:(b + 1) * K_m].reshape(-1)[:E] = cols[:, b]
            mlt_rows = rows
            mlt_smp = np.concatenate(
                [ap.reshape(K_m, ENV_W), ai.reshape(K_m, ENV_W)], axis=0)
        mesh_area = np.float32(total)
        mesh_lum = mat_emission[tri_mats[idxs]] @ _LUM  # per-tri luminance
        mesh_power = float((areas * mesh_lum).sum())
        lk.append(LIGHT_MESH)
        lp.append(-1)
        la.append(total)          # slot area = TOTAL area -> the uniform
        le.append((0.0, 0.0, 0.0))  # 1/(area*count) pdf is the marginal
    else:
        for i in emissive_tris:
            if i >= TRI_UNROLL_MAX and not allow_many_tri_lights:
                raise ValueError(
                    f"emissive triangle at slot {i} >= TRI_UNROLL_MAX="
                    f"{TRI_UNROLL_MAX}: the unrolled NEE samplers cannot "
                    f"address it and it would silently vanish from direct "
                    f"lighting. Pass mesh_lights=True (area-CDF per-pass "
                    f"sampling, no slot limit) or move emissive triangles "
                    f"into the first {TRI_UNROLL_MAX} slots.")
            lk.append(LIGHT_TRI)
            lp.append(i)
            cross = np.cross(e1[i], e2[i])
            la.append(0.5 * float(np.linalg.norm(cross)))
            le.append(mat_emission[tri_mats[i]])
    L = len(lk)
    light_pad = light_pad or max(L, 1)
    light_kind = np.zeros((light_pad,), np.int32)
    light_prim = np.zeros((light_pad,), np.int32)
    light_area = np.ones((light_pad,), np.float32)
    light_le = np.zeros((light_pad, 3), np.float32)
    light_kind[:L] = lk
    light_prim[:L] = lp
    light_area[:L] = la
    if L:
        light_le[:L] = np.stack(le)

    # power-weighted selection table: power = area * lum(Le) per slot
    # (mesh pseudo-slot: sum over its triangles, computed above)
    powers = np.zeros((light_pad,), np.float64)
    for k in range(L):
        powers[k] = (mesh_power if lk[k] == LIGHT_MESH
                     else la[k] * float(np.dot(le[k], _LUM)))
    total_power = float(powers.sum())
    light_pick = (powers / total_power if total_power > 0
                  else powers).astype(np.float32)
    light_cdf = np.minimum(np.cumsum(light_pick), 1.0).astype(np.float32)
    light_cdf[max(L - 1, 0):] = 1.0  # padded slots are never selected
    mesh_pick = None
    if (mesh_tri is not None or mlt_rows is not None) and total_power > 0:
        mesh_pick = np.float32(mesh_power / total_power)

    lt = None
    if light_tree:
        if mesh_lights:
            raise ValueError(
                "light_tree is incompatible with mesh_lights: the mesh "
                "pseudo-slot is sampled per pass and has no fixed "
                "position for the tree's distance term. Use per-slot "
                "triangle lights (<= TRI_UNROLL_MAX) with light_tree, or "
                "mesh_lights alone.")
        if L == 0:
            raise ValueError("light_tree > 0 but the scene has no "
                             "emissive primitives")
        over = [lp[k] for k in range(L)
                if lk[k] == LIGHT_TRI and lp[k] >= TRI_UNROLL_MAX]
        if over:
            raise ValueError(
                f"light_tree with emissive triangle slots >= "
                f"TRI_UNROLL_MAX={TRI_UNROLL_MAX} (slots {over}): the "
                "tree walk can select lights the unrolled point samplers "
                "cannot address (allow_many_tri_lights only defers the "
                "hole to render time). Keep emissive triangles in the "
                f"first {TRI_UNROLL_MAX} slots.")
        # slot positions + bounding radii (sphere center/radius, triangle
        # centroid/max corner distance)
        pos = np.zeros((L, 3), np.float64)
        rad = np.zeros((L,), np.float64)
        for k in range(L):
            if lk[k] == LIGHT_SPHERE:
                pos[k] = sph_pos[lp[k]]
                rad[k] = float(sph_radius[lp[k]])
            else:  # LIGHT_TRI
                cen = v0[lp[k]] + (e1[lp[k]] + e2[lp[k]]) / 3.0
                pos[k] = cen
                rad[k] = max(
                    float(np.linalg.norm(v0[lp[k]] - cen)),
                    float(np.linalg.norm(v0[lp[k]] + e1[lp[k]] - cen)),
                    float(np.linalg.norm(v0[lp[k]] + e2[lp[k]] - cen)))
        lt = _build_light_tree(pos, rad, powers[:L], int(light_tree),
                               light_pad)

    env_img = env_smp = env_pick_v = None
    if env is not None and np.asarray(env, object).ndim == 3:
        env_img, env_smp, env_power = build_env_map(env, rows=env_rows)
        if env_pick is None:
            # default: power-proportional split between the env and the
            # light table (any value in (0, 1] is unbiased — MIS covers
            # the other strategy at full weight where one can't sample)
            env_pick = (1.0 if total_power <= 0
                        else env_power / (env_power + total_power))
        env_pick_v = np.float32(np.clip(env_pick, 1e-3 if L else 1.0, 1.0))
        env = None  # the gradient env and the map are mutually exclusive

    return PTScene(
        sph_pos=jnp.asarray(sph_pos),
        sph_radius=jnp.asarray(sph_radius),
        sph_mat=jnp.asarray(sph_mat),
        sph_count=jnp.int32(S),
        tri_v0=jnp.asarray(v0),
        tri_e1=jnp.asarray(e1),
        tri_e2=jnp.asarray(e2),
        tri_mat=jnp.asarray(tmat),
        tri_count=jnp.int32(T),
        mat_albedo=jnp.asarray(mat_albedo),
        mat_emission=jnp.asarray(mat_emission),
        mat_kind=jnp.asarray(mat_kind),
        mat_ior=jnp.asarray(mat_ior),
        mat_rough=(jnp.asarray(mat_rough)
                   if bool((mat_kind == METAL).any()
                           or ((mat_kind == DIELECTRIC)
                               & (mat_rough > 0)).any()) else None),
        mat_rough2=(jnp.asarray(mat_rough2)
                    if bool(((mat_kind == METAL)
                             & (mat_rough2 != mat_rough)).any()) else None),
        has_rough_dielectric=bool(
            ((mat_kind == DIELECTRIC) & (mat_rough > 0)).any()),
        mat_albedo2=jnp.asarray(mat_albedo2) if textured else None,
        mat_tex_scale=jnp.asarray(mat_tex_scale) if textured else None,
        mat_tex_space=jnp.asarray(mat_tex_space) if uv_space else None,
        tex_atlas=None if tex_atlas is None else jnp.asarray(tex_atlas),
        mat_tex_rect=None if mat_rect is None else jnp.asarray(mat_rect),
        mat_tex_mips=None if mat_mips is None else jnp.asarray(mat_mips),
        mat_nrm_rect=None if nrm_rect is None else jnp.asarray(nrm_rect),
        mat_nrm_scale=None if nrm_rect is None else jnp.asarray(mat_nrm_scale),
        tri_uv=None if tri_uv6 is None else jnp.asarray(tri_uv6),
        mat_dispersion=jnp.asarray(mat_dispersion) if dispersive else None,
        light_kind=jnp.asarray(light_kind),
        light_prim=jnp.asarray(light_prim),
        light_area=jnp.asarray(light_area),
        light_le=jnp.asarray(light_le),
        light_count=jnp.int32(L),
        light_pick=jnp.asarray(light_pick),
        light_cdf=jnp.asarray(light_cdf),
        light_total_power=jnp.float32(total_power),
        mesh_light_tri=None if mesh_tri is None else jnp.asarray(mesh_tri),
        mesh_light_cdf=None if mesh_cdf is None else jnp.asarray(mesh_cdf),
        mesh_light_area=None if mesh_area is None else jnp.float32(mesh_area),
        mesh_light_pick=None if mesh_pick is None else jnp.float32(mesh_pick),
        mlt_rows=None if mlt_rows is None else jnp.asarray(mlt_rows),
        mlt_smp=None if mlt_smp is None else jnp.asarray(mlt_smp),
        env=_env_rows(env),
        env_img=None if env_img is None else jnp.asarray(env_img),
        env_smp=None if env_smp is None else jnp.asarray(env_smp),
        env_pick=None if env_pick_v is None else jnp.float32(env_pick_v),
        has_dielectric=bool((mat_kind == DIELECTRIC).any()),
        n_tri_slot_lights=sum(1 for k in lk if k == LIGHT_TRI),
        lt_center=None if lt is None else jnp.asarray(lt[0]),
        lt_radius=None if lt is None else jnp.asarray(lt[1]),
        lt_power=None if lt is None else jnp.asarray(lt[2]),
        lt_cluster=None if lt is None else jnp.asarray(lt[3]),
        lt_cdf_intra=None if lt is None else jnp.asarray(lt[4]),
        lt_pick_intra=None if lt is None else jnp.asarray(lt[5]),
    )


ENV_W = 128         # env-map texels per row
ENV_MAX_ROWS = 32   # polar rows budget (same fetch-chain bound as the atlas)
MLT_MAX_ROWS = 32   # per-lane mesh-light budget: 32 * 128 = 4096 triangles


def _alias_table(p):
    """Vose alias table for the normalized pmf p (N,): returns
    (accept_prob (N,) f32, alias_index (N,) f32). Sampling with ONE
    uniform u: x = u*N, j = floor(x), f = x - j; take j if f < prob[j]
    else alias[j] — exact, O(1) per sample, gather-light (two per-lane
    table reads)."""
    p = np.asarray(p, np.float64)
    n = p.size
    scaled = p * n
    prob = np.ones(n, np.float64)
    alias = np.arange(n, dtype=np.int64)
    small = [i for i in range(n) if scaled[i] < 1.0]
    large = [i for i in range(n) if scaled[i] >= 1.0]
    while small and large:
        s = small.pop()
        l = large.pop()
        prob[s] = scaled[s]
        alias[s] = l
        scaled[l] = scaled[l] - (1.0 - scaled[s])
        (small if scaled[l] < 1.0 else large).append(l)
    return prob.astype(np.float32), alias.astype(np.float32)


def build_env_map(img, rows: int | None = None):
    """Equirect HDR environment map -> kernel tables.

    img: (H, W, 3) radiance (θ from +z top row to -z bottom row, φ wrapping
    the full azimuth with u=0.5 at +x — the same spherical parametrization
    as _sphere_uv). Resampled (nearest) to (K, ENV_W=128) with
    K = min(rows or H, ENV_MAX_ROWS): the per-lane fetch is a K-row select
    chain + a lane gather, identical machinery to the texture atlas, so it
    runs bit-identically in XLA and inside the Pallas kernels.

    Returns (env_img (3K, 128) channel-major rows,
             env_smp (3K, 128) = [p_sel rows; alias-prob rows; alias-index
             rows] — p_sel is each texel's SELECTION probability
             (∝ luminance × texel solid angle, floored so any texel with
             energy stays samplable),
             env_power — ∫ lum(L) dω, the default NEE pick-ratio weight).

    Generalizes the reference's black-beyond-RENDER_DIST sky
    (/root/reference/shaders/fragment.glsl:137-140) and the round-3
    2-stop gradient into an arbitrary importance-sampled HDR image.
    """
    img = np.asarray(img, np.float32)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"env map must be (H, W, 3); got {img.shape}")
    H, W = img.shape[:2]
    K = min(rows or H, ENV_MAX_ROWS)
    iy = np.minimum(((np.arange(K) + 0.5) / K * H).astype(np.int64), H - 1)
    ix = np.minimum(((np.arange(ENV_W) + 0.5) / ENV_W * W).astype(np.int64),
                    W - 1)
    tex = img[iy][:, ix]  # (K, 128, 3) nearest resample
    lum = tex @ _LUM      # (K, 128) float64
    # texel solid angle: (2π/W) * (cos θ_top - cos θ_bot) per row
    th = np.arange(K + 1) / K * np.pi
    domega = (2.0 * np.pi / ENV_W) * (np.cos(th[:-1]) - np.cos(th[1:]))
    w = lum * domega[:, None]
    env_power = float(w.sum())
    # floor: texels with any energy must stay samplable (pdf > 0 wherever
    # Le > 0 keeps MIS/NEE unbiased); a tiny uniform floor also lets
    # all-black maps build
    w = w + max(env_power, 1e-12) * 1e-4 * (domega[:, None] / (4 * np.pi))
    p_sel = (w / w.sum()).astype(np.float32)
    ap, ai = _alias_table(p_sel.reshape(-1))
    env_img = np.concatenate([tex[:, :, c] for c in range(3)], axis=0)
    env_smp = np.concatenate(
        [p_sel, ap.reshape(K, ENV_W), ai.reshape(K, ENV_W)], axis=0)
    return (env_img.astype(np.float32), env_smp.astype(np.float32),
            env_power)


def _env_rows(env):
    """Normalize the env argument to (2, 3) [bottom, top] rows (or None)."""
    if env is None:
        return None
    e = np.asarray(env, np.float32)
    if e.shape == (3,):
        e = np.stack([e, e])
    if e.shape != (2, 3):
        raise ValueError(f"env must be (3,) or (2, 3) [bottom, top]: "
                         f"shape {e.shape}")
    return jnp.asarray(e)


def mesh_light_rows(scene: PTScene, seed, gpass):
    """Per-pass mesh-light rows: (N, 14) f32 = [v0, e1, e2, Le, total_area,
    pick] for int32 pass indices `gpass` (scalar or (N,)).

    One area-weighted emissive triangle is selected per GLOBAL pass index
    by a counter-based hash, so the selection is invariant to chunking,
    sharding and tile decomposition (same invariance contract as the pixel
    RNG). The XLA paths compute a row per pass inline."""
    import jax.numpy as jnp  # noqa: F811 (kernel-safe local import style)

    from raytracing_engine_tpu.ops.rng_pcg import pcg4d, _to_unit

    gp = jnp.atleast_1d(jnp.asarray(gpass)).astype(jnp.uint32)
    # distinct stream from the pixel-keyed draws: y-channel pinned to a
    # sentinel no pixel coordinate reaches
    o1, _, _, _ = pcg4d(gp, jnp.full_like(gp, np.uint32(0x9E3779B9)),
                        jnp.zeros_like(gp),
                        jnp.broadcast_to(jnp.asarray(seed).astype(jnp.uint32),
                                         gp.shape))
    u = _to_unit(o1)
    e = jnp.searchsorted(scene.mesh_light_cdf, u, side="left")
    e = jnp.minimum(e, scene.mesh_light_cdf.shape[0] - 1)
    rows = scene.mesh_light_tri[e]  # (N, 12)
    area = jnp.broadcast_to(scene.mesh_light_area, (rows.shape[0], 1))
    pick = jnp.broadcast_to(
        scene.mesh_light_pick if scene.mesh_light_pick is not None
        else jnp.float32(1.0), (rows.shape[0], 1))
    return jnp.concatenate([rows, area, pick], axis=1)
