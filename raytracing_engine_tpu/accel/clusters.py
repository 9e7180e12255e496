"""Cluster-binned triangle layout — the acceleration structure of the
Triton cluster kernels (ops/pallas/cluster_intersect.py).

Take the BVH's spatially-coherent leaf ordering, cut it into clusters of
``CLUSTER`` (=128) consecutive triangles, group ``SUPER`` clusters under a
super box and split each cluster into ``SUBS`` sub-boxes. A block of rays
culls whole super boxes, cluster boxes and sub-boxes at once and tests only
the triangles near it; every table access is a scalar read at a computed
index. The layout carries interpolation rows for vertex normals and UVs,
which the plain skip-link BVH path (accel/bvh.py) does not.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp

from raytracing_engine_tpu.accel.bvh import BVH, build_bvh

CLUSTER = 128  # triangles per cluster
SUPER = 8      # clusters per super-cluster
SUBS = 4       # sub-boxes per cluster (32-triangle gates; not swept on the GPU)
ROWS = 24      # tri-table rows (21 used, 3 spare)
ROWS_SMOOTH = 32  # +8 rows when per-corner shading normals are stored
ROWS_UV = 40   # +8 more when per-corner texture UVs are stored

# Triangle rows hold the Baldwin–Weber precomputed intersection transform
# (plane + barycentric rows) instead of raw v0/e1/e2: ~30% fewer VPU ops
# per ray-triangle test than Möller–Trumbore, and the unnormalized
# geometric normal + area come for free (no cross product per test).
#   rows 0-2   n      unnormalized geometric normal e1 x e2 (plane normal)
#   row  3     nd     plane offset: n . p + nd = 0 on the triangle plane
#   rows 4-6   r1     barycentric u row:  u = r1 . p + c1
#   row  7     c1
#   rows 8-10  r2     barycentric v row:  v = r2 . p + c2
#   row  11    c2
#   row  12    mat    material id (f32)
#   row  13    |n|    = 2 * triangle area
#   rows 14-19 sub-box [minx,miny,minz,maxx,maxy,maxz] at lanes 0..SUBS-1
#   row  20    oc     cluster-local origin (box center) at lanes 0..2
#   rows 21-23 spare
#
# Smooth-shading tables (build_clusters(vertex_normals=...)) append 8 rows
# (ROWS_SMOOTH=32) holding the per-corner shading
# normals in interpolation-ready form, so the sweep's attrs path emits
# ns = s0 + u*(s1-s0) + v*(s2-s0) with 9 extra FMAs per test and the SAME
# select count (reference shades with interpolated normals implicitly via
# its analytic SDF gradients — shaders/utilities.glsl sceneSDF; meshes are
# the north-star extension, so Gouraud-interpolated normals are the parity
# analog):
#   rows 21-23 s0     corner-0 shading normal
#   rows 24-26 s1-s0  corner-1 delta
#   rows 27-29 s2-s0  corner-2 delta
#   rows 30-31 spare
# Flat tables stay at ROWS=24 — zero cost when no normals are given; a
# flat mesh inside a smooth build stores s0=face normal, deltas=0, which
# interpolates back to exact flat shading (mixed meshes compose).
#
# UV tables (build_clusters(vertex_uvs=...)) append 8 more rows (ROWS_UV
# = 40) holding per-corner texture coordinates in the same interpolation-
# ready form — the sweep's attrs path then also emits
# uv = uv0 + u*(uv1-uv0) + v*(uv2-uv0) (8 extra FMAs + 2 selects per
# test). A UV table always carries the smooth rows too (face-normal
# fallback when no vertex normals are given — interpolates back to flat):
#   rows 32-33 uv0        corner-0 (u, v)
#   rows 34-35 uv1-uv0    corner-1 delta
#   rows 36-37 uv2-uv0    corner-2 delta
#   rows 38-39 spare
#
# The affine rows (nd, c1, c2) are REBASED to each cluster's box center:
# nd = -n.(v0-oc) etc., and the kernel intersects with o' = o - oc. This
# keeps u, v, t translation-invariant like Möller–Trumbore: with absolute
# coordinates a mesh at |p| ~ 1e4 would lose ~1e-2 of barycentric
# precision (2^-24 * |r1||p|), visible as edge cracks; rebased, precision
# depends only on cluster-local geometry. Costs 3 scalar reads + 3 vector
# subs per cluster (hoisted out of the per-triangle loop).


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class ClusterSet:
    tri: jax.Array       # (ROWS, T_pad) f32 — Baldwin–Weber rows (see above)
    boxes: jax.Array     # (C, 8) f32 — [minx,miny,minz,maxx,maxy,maxz,pad,pad];
                         #   C is a SUPER multiple (tail = inverted never-hit)
    perm: jax.Array      # (T_pad,) int32 — padded-slot -> original tri (-1 pad)
    centroid: jax.Array  # (C, 3) f32 — box centers
    super_boxes: jax.Array     # (C/SUPER, 8) f32 — union AABB of SUPER children
    super_centroid: jax.Array  # (C/SUPER, 3) f32 — for per-frame visit order

    @property
    def num_clusters(self) -> int:
        return self.boxes.shape[0]

    @property
    def num_super(self) -> int:
        return self.super_boxes.shape[0]

    @property
    def padded_tris(self) -> int:
        return self.tri.shape[1]

    @property
    def smooth(self) -> bool:
        """True when the table carries per-corner shading-normal rows
        (21-29) — the sweep then emits interpolated normals."""
        return self.tri.shape[0] >= ROWS_SMOOTH

    @property
    def has_uv(self) -> bool:
        """True when the table carries per-corner texture-UV rows
        (32-37) — the sweep's attrs path then also emits the hit UV."""
        return self.tri.shape[0] >= ROWS_UV


def _subtree_ranges(bvh: BVH, max_tris: int, descend: int | None = None):
    """DFS-ordered (start, end) triangle ranges, each a whole BVH subtree
    of <= max_tris triangles, greedily merging adjacent small subtrees.

    A fixed 128-chunk of the leaf order can straddle a major BVH split and
    get a box spanning disjoint geometry; cutting at subtree boundaries
    keeps every cluster box as tight as the tree itself. Descends to
    subtrees of <= ``descend`` before packing. Default ``max_tris`` (=128):
    finer chunks repack into tighter merged boxes at a modest cluster-count
    increase — the on-chip A/B (benchmarks/run_packing_ab.sh, config 3
    @512^2) measured 145.8 ms at descend=64, 138.2 at 96, 133.3 at 128
    (-8.6%, the default), with the DP-optimal contiguous partition
    (align="dp", kc=0.5) tying at 134.6 — the cheap subtree cut already
    sits at the cost-model optimum. History: descend=64 was chosen over
    stopping at <= max_tris when clusters held RAW triangles; with
    Baldwin-Weber rows the per-cluster constant is lower, which moves the
    optimum to finer descent."""
    first = np.asarray(bvh.first_tri)
    cnt = np.asarray(bvh.tri_count)
    skip = np.asarray(bvh.skip)
    N = first.shape[0]
    T = int(cnt[first >= 0].sum())
    # nxt[k] = first triangle index of the first leaf at preorder >= k;
    # subtree rooted at i covers tris [nxt[i], nxt[skip[i]])
    nxt = np.full((N + 1,), T, np.int64)
    for k in range(N - 1, -1, -1):
        nxt[k] = first[k] if first[k] >= 0 else nxt[k + 1]

    ranges = []
    stack = [0]
    if descend is None:
        descend = max(max_tris, 1)
    while stack:
        i = stack.pop()
        s, e = int(nxt[i]), int(nxt[min(int(skip[i]), N)])
        if e - s <= descend or first[i] >= 0:
            if e > s:
                ranges.append((s, e))
        else:
            left = i + 1
            stack.append(int(skip[left]))  # right child
            stack.append(left)             # popped first -> DFS order
    merged = [list(ranges[0])]
    for s, e in ranges[1:]:
        if e - merged[-1][0] <= max_tris:
            merged[-1][1] = e  # adjacent in DFS order = spatially coherent
        else:
            merged.append([s, e])
    return [tuple(r) for r in merged]


def _dp_ranges(ordered: np.ndarray, max_tris: int, kc: float = 0.25):
    """Optimal contiguous partition of the BVH leaf order into segments of
    <= max_tris, minimizing the sweep's expected lane-ops under the
    touch-probability ~ box-half-area model (the same model the committed
    roofline fit validated at r^2=0.999).

    Any BVH subtree covers a contiguous DFS leaf range, so this search
    space strictly contains every subtree-aligned cut — the DP can only do
    better than ``_subtree_ranges`` under the cost model. Per candidate
    segment [s, s+w):

      cost = 4*OPS_SLAB * A(s, w)                  # sub gates when touched
           + 32*OPS_TEST * sum_k A(sub_k)          # tests: full 32-lane
                                                   #   issue per touched sub
           + kc * Abar                             # per-cluster constant:
                                                   #   cluster gate + scalar
                                                   #   traversal step

    where A = box half-area (relative touch probability), sub_k the
    32-triangle sub-windows (a partial sub still issues 32 lanes — the
    model penalizes fragmentation exactly like the hardware does), and
    Abar = mean leaf-window area normalizer so ``kc`` is dimensionless.
    O(T * max_tris) via incremental window min/max; ~1-3 s at 70k tris.
    """
    OPS_TEST, OPS_SLAB, SUB = 30.0, 28.0, 32
    T = ordered.shape[0]
    lmin = ordered.min(axis=1).astype(np.float64)  # (T, 3) per-tri box
    lmax = ordered.max(axis=1).astype(np.float64)

    def half_area(mn, mx):
        d = mx - mn
        return d[:, 0] * d[:, 1] + d[:, 1] * d[:, 2] + d[:, 0] * d[:, 2]

    # area[w][s] = half-area of window [s, s+w), built incrementally
    area = np.full((max_tris + 1, T), np.inf)
    wmin, wmax = lmin.copy(), lmax.copy()
    area[1][:] = half_area(wmin, wmax)
    for w in range(2, max_tris + 1):
        wmin = np.minimum(wmin[: T - w + 1], lmin[w - 1:])
        wmax = np.maximum(wmax[: T - w + 1], lmax[w - 1:])
        area[w][: T - w + 1] = half_area(wmin, wmax)

    abar = float(np.mean(area[min(SUB, max_tris)][: max(T - SUB + 1, 1)]))
    const = kc * abar * (32 * OPS_TEST)  # in lane-op*area units

    # seg_cost[w-1][s] = cost of cluster [s, s+w)
    seg = np.full((max_tris, T), np.inf)
    for w in range(1, max_tris + 1):
        q, r = divmod(w, SUB)
        sub_sum = np.zeros(T)
        for k in range(q):
            sub_sum[: T - w + 1] += area[SUB][k * SUB: k * SUB + T - w + 1]
        if r:
            sub_sum[: T - w + 1] += area[r][q * SUB: q * SUB + T - w + 1]
        seg[w - 1] = 4 * OPS_SLAB * area[w] + 32 * OPS_TEST * sub_sum + const

    best = np.full(T + 1, np.inf)
    best[0] = 0.0
    take = np.zeros(T + 1, np.int32)
    ws = np.arange(1, max_tris + 1)
    for e in range(1, T + 1):
        k = min(e, max_tris)
        w = ws[:k]
        c = best[e - w] + seg[w - 1, e - w]
        j = int(np.argmin(c))
        best[e] = c[j]
        take[e] = j + 1
    ranges = []
    e = T
    while e > 0:
        s = e - int(take[e])
        ranges.append((s, e))
        e = s
    return ranges[::-1]


def build_clusters(triangles: np.ndarray, bvh: BVH | None = None,
                   tri_mats: np.ndarray | None = None,
                   align: str = "subtree", method: str = "sah",
                   descend: int | None = None,
                   dp_kc: float = 0.25,
                   vertex_normals: np.ndarray | None = None,
                   vertex_uvs: np.ndarray | None = None) -> ClusterSet:
    """triangles: (T, 3, 3). Uses the BVH leaf order for spatial coherence
    (builds one if not given), pads to a CLUSTER multiple with degenerate
    triangles (zero rows -> never hit) inside NaN never-hit boxes.
    tri_mats: optional (T,) material ids, stored in tri row 12 so the
    intersector can emit materials without a post-kernel gather.
    vertex_normals: optional (T, 3, 3) per-corner shading normals
    (accel.mesh.smooth_vertex_normals / load_obj(normals=True)) — stored
    in rows 21-29 (ROWS_SMOOTH table) so the sweep emits barycentric-
    interpolated smooth normals; corners whose normal is zero/non-finite
    fall back to the face normal (flat).
    vertex_uvs: optional (T, 3, 2) per-corner texture coordinates
    (load_obj(uvs=True) / any parametrization) — stored in rows 32-37
    (ROWS_UV table) so the sweep also emits the barycentric-interpolated
    hit UV. Implies the smooth rows (face-normal fallback = exact flat
    shading when no vertex_normals are given).

    align: "subtree" cuts clusters at BVH subtree boundaries (tight boxes,
    some intra-cluster padding — see _subtree_ranges); "fixed" packs the
    leaf order into exactly-128 chunks (full clusters, looser boxes).
    method: BVH partitioner when building one here ("sah" or "median") —
    SAH subtrees are tighter, so the sweep touches fewer sub-blocks.

    bvh=None builds the BVH here, on the host."""
    tris = np.asarray(triangles, np.float32)
    T = tris.shape[0]
    if bvh is None:
        bvh = build_bvh(tris, method=method)
    perm = np.asarray(bvh.perm)
    ordered = tris[perm]

    if align == "subtree":
        ranges = _subtree_ranges(bvh, CLUSTER, descend=descend)
    elif align == "fixed":
        ranges = [(k * CLUSTER, min((k + 1) * CLUSTER, T))
                  for k in range(-(-T // CLUSTER))]
    elif align == "dp":
        ranges = _dp_ranges(ordered, CLUSTER, kc=dp_kc)
    else:
        raise ValueError(
            f"align must be 'subtree', 'fixed' or 'dp': {align!r}")

    # pad the cluster count to a SUPER multiple (tail clusters are NaN
    # never-hit boxes) so the hierarchical sweep's inner loop is rectangular
    C = -(-len(ranges) // SUPER) * SUPER
    T_pad = C * CLUSTER
    # cluster c's tris ordered[s:e] sit at lanes [c*CLUSTER, c*CLUSTER+e-s);
    # unfilled lanes keep all-zero rows = never-hit triangles
    v0 = np.zeros((T_pad, 3), np.float32)
    e1 = np.zeros((T_pad, 3), np.float32)
    e2 = np.zeros((T_pad, 3), np.float32)
    perm_pad = np.full((T_pad,), -1, np.int32)
    for c, (s, e) in enumerate(ranges):
        base = c * CLUSTER
        L = e - s
        v0[base:base + L] = ordered[s:e, 0]
        e1[base:base + L] = ordered[s:e, 1] - ordered[s:e, 0]
        e2[base:base + L] = ordered[s:e, 2] - ordered[s:e, 0]
        perm_pad[base:base + L] = perm[s:e]

    # Padding boxes are ALL-NaN: the swap-based slab test (min/max per
    # axis) lets an inverted (+inf/-inf) box pass for EVERY ray (t_near=-inf,
    # t_far=+inf), whereas NaN propagates and every comparison is false —
    # a genuine never-hit that costs one failed gate instead of a full
    # degenerate triangle sweep.
    boxes = np.full((C, 8), np.nan, np.float32)
    boxes[:, 6:] = 0.0
    for c, (s, e) in enumerate(ranges):
        chunk = ordered[s:e].reshape(-1, 3)
        boxes[c, :3] = chunk.min(0)
        boxes[c, 3:6] = chunk.max(0)

    # sub-boxes (SUB_TRIS-triangle intersection gates) — packed into tri
    # rows 14-19 at lanes 0..SUBS-1 of each cluster's slice (free padding
    # rows of the table), read by the kernel as scalars next to the
    # triangles they gate.
    sub = CLUSTER // SUBS
    sub_boxes = np.full((C * SUBS, 6), np.nan, np.float32)
    for c, (s, e) in enumerate(ranges):
        for k in range(SUBS):
            lo = s + k * sub
            hi = min(s + (k + 1) * sub, e)
            if lo >= e:
                continue  # fully-padded sub-block stays NaN never-hit
            chunk = ordered[lo:hi].reshape(-1, 3)
            sub_boxes[c * SUBS + k, :3] = chunk.min(0)
            sub_boxes[c * SUBS + k, 3:6] = chunk.max(0)

    with np.errstate(invalid="ignore"):  # NaN on padded boxes
        centroid = (boxes[:, :3] + boxes[:, 3:6]) * 0.5
    centroid[~np.isfinite(centroid)] = 1e30  # padded never-hit clusters last

    # super-cluster union boxes: nanmin/nanmax ignore padded (NaN) children;
    # an all-padded super stays all-NaN = never hit
    S = T_pad // (CLUSTER * SUPER)
    sb = boxes.reshape(S, SUPER, 8)
    super_boxes = np.zeros((S, 8), np.float32)
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)  # all-NaN slices
        super_boxes[:, :3] = np.nanmin(sb[:, :, :3], 1)
        super_boxes[:, 3:6] = np.nanmax(sb[:, :, 3:6], 1)
    with np.errstate(invalid="ignore"):
        super_centroid = (super_boxes[:, :3] + super_boxes[:, 3:6]) * 0.5
    super_centroid[~np.isfinite(super_centroid)] = 1e30

    # Baldwin–Weber precompute (see row map at the top of this module):
    #   n  = e1 x e2 (plane normal; also the geometric shading normal)
    #   nd = -n . v0                      (t     = -(n.o + nd) / (n.d))
    #   r1 = (e2 x n) / (n.n), c1 = -r1.v0   (u = r1.p + c1)
    #   r2 = (n x e1) / (n.n), c2 = -r2.v0   (v = r2.p + c2)
    # Identities: r1.e1 = n.(e1 x e2)/(n.n) = 1, r1.e2 = 0 (and symm.) —
    # so u, v are exactly the Möller–Trumbore barycentrics of p on the
    # plane. Degenerate / padding triangles (|n|^2 ~ 0) get all-zero rows:
    # den = n.d = 0 fails the |den| >= eps gate, a genuine never-hit.
    n = np.cross(e1, e2)
    nn = np.einsum("ij,ij->i", n, n)
    ok = nn > 1e-30
    inv_nn = np.where(ok, 1.0 / np.maximum(nn, 1e-30), 0.0)[:, None]
    r1 = np.cross(e2, n) * inv_nn
    r2 = np.cross(n, e1) * inv_nn
    n = np.where(ok[:, None], n, 0.0)

    # per-corner shading normals in padded slot order (smooth tables only):
    # normalized on host; zero / non-finite corners fall back to the
    # normalized face normal, which interpolates back to flat shading
    svn = None
    if vertex_normals is not None or vertex_uvs is not None:
        # a UV table implies the smooth rows; with no vertex normals the
        # all-zero corners fall back to the face normal = exact flat
        svn = np.zeros((3, T_pad, 3), np.float32)
        if vertex_normals is not None:
            vn_arr = np.asarray(vertex_normals, np.float32)
            if vn_arr.shape != (T, 3, 3):
                raise ValueError(
                    f"vertex_normals must be (T, 3, 3) matching triangles; "
                    f"got {vn_arr.shape} for T={T}")
            vn_ord = vn_arr[perm]
            for c, (s, e) in enumerate(ranges):
                base = c * CLUSTER
                for k in range(3):
                    svn[k, base:base + (e - s)] = vn_ord[s:e, k]
        nf = n / np.maximum(np.sqrt(nn), 1e-30)[:, None]
        for k in range(3):
            ln = np.linalg.norm(svn[k], axis=1)
            good = np.isfinite(ln) & (ln > 1e-12)
            svn[k] = np.where(good[:, None],
                              svn[k] / np.maximum(ln, 1e-30)[:, None], nf)
    # per-corner texture UVs in padded slot order (UV tables only)
    suv = None
    if vertex_uvs is not None:
        uv_arr = np.asarray(vertex_uvs, np.float32)
        if uv_arr.shape != (T, 3, 2):
            raise ValueError(
                f"vertex_uvs must be (T, 3, 2) matching triangles; got "
                f"{uv_arr.shape} for T={T}")
        uv_ord = uv_arr[perm]
        suv = np.zeros((3, T_pad, 2), np.float32)
        for c, (s, e) in enumerate(ranges):
            base = c * CLUSTER
            for k in range(3):
                suv[k, base:base + (e - s)] = uv_ord[s:e, k]
    # per-slot cluster-local origin (box center; 0 for padded clusters) —
    # the affine offsets are precomputed against v0 - oc (see row map)
    with np.errstate(invalid="ignore"):
        oc_cluster = np.where(np.isfinite(boxes[:, 0:1]),
                              (boxes[:, 0:3] + boxes[:, 3:6]) * 0.5, 0.0)
    oc_cluster = oc_cluster.astype(np.float32)
    oc = np.repeat(oc_cluster, CLUSTER, axis=0)  # (T_pad, 3)
    v0l = v0 - oc
    nd = -np.einsum("ij,ij->i", n, v0l)
    c1 = -np.einsum("ij,ij->i", r1, v0l)
    c2 = -np.einsum("ij,ij->i", r2, v0l)

    n_rows = (ROWS_UV if suv is not None
              else ROWS_SMOOTH if svn is not None else ROWS)
    tri_rows = np.zeros((n_rows, T_pad), np.float32)
    tri_rows[0:3] = n.T
    tri_rows[3] = nd
    tri_rows[4:7] = r1.T
    tri_rows[7] = c1
    tri_rows[8:11] = r2.T
    tri_rows[11] = c2
    if tri_mats is not None:
        mats = np.asarray(tri_mats, np.float32)[perm]
        for c, (s, e) in enumerate(ranges):
            base = c * CLUSTER
            tri_rows[12, base:base + (e - s)] = mats[s:e]
    tri_rows[13] = np.sqrt(nn)  # |n| = 2 * area
    # row 20 lanes 0-2 of each cluster's slice = the cluster's local origin
    tri_rows[20].reshape(C, CLUSTER)[:, 0:3] = oc_cluster
    # rows 14-19 = sub-box [minx,miny,minz,maxx,maxy,maxz]; lane s of each
    # cluster's slice holds sub-block s's box
    for c in range(C):
        for s in range(SUBS):
            tri_rows[14:20, c * CLUSTER + s] = sub_boxes[c * SUBS + s]
    if svn is not None:  # rows 21-29: s0, s1-s0, s2-s0 (see row map)
        tri_rows[21:24] = svn[0].T
        tri_rows[24:27] = (svn[1] - svn[0]).T
        tri_rows[27:30] = (svn[2] - svn[0]).T
    if suv is not None:  # rows 32-37: uv0, uv1-uv0, uv2-uv0 (see row map)
        tri_rows[32:34] = suv[0].T
        tri_rows[34:36] = (suv[1] - suv[0]).T
        tri_rows[36:38] = (suv[2] - suv[0]).T
    return ClusterSet(
        tri=jnp.asarray(tri_rows),
        boxes=jnp.asarray(boxes),
        perm=jnp.asarray(perm_pad),
        centroid=jnp.asarray(centroid),
        super_boxes=jnp.asarray(super_boxes),
        super_centroid=jnp.asarray(super_centroid),
    )


def visit_orders(cs: ClusterSet, origins):
    """(P, 3) origins -> (P, S) int32 near-to-far SUPER orders (one row per
    origin; vectorized visit_order — pure perf hint, order-independent)."""
    o = jnp.asarray(origins, jnp.float32)
    d = cs.super_centroid[None, :, :] - o[:, None, :]
    return jnp.argsort(jnp.sum(d * d, axis=-1), axis=-1).astype(jnp.int32)


def visit_order(cs: ClusterSet, origin):
    """Near-to-far SUPER-cluster visit order from a representative origin (3,).

    Ordering is a pure performance hint for the sweep: nearer clusters hit
    first shrink the running t, so farther boxes fail the (t_near < t) test
    and skip their triangle work entirely. Results are order-independent.
    """
    d = cs.super_centroid - jnp.asarray(origin, jnp.float32)
    return jnp.argsort(jnp.sum(d * d, axis=-1)).astype(jnp.int32)
