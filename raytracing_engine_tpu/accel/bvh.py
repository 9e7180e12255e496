"""Stackless threaded BVH: host-built, breadth-friendly flat layout, skip
links — per the north star ("stackless, breadth-ordered BVH built on host and
laid out for coalesced Pallas gathers", BASELINE.json).

Layout: nodes flattened in DFS preorder. An interior node's "hit" successor
is implicitly ``node+1`` (its left child); every node stores a ``skip`` link
— the preorder index of the next subtree — taken on a miss (or after a leaf).
Traversal is therefore a single while-loop with NO per-ray stack: exactly the
control shape SIMD lanes want; per-lane state is one int32 node cursor.

Build: ``method="sah"`` (default) is a 16-bin binned surface-area-heuristic
split — it produces tighter subtrees than a median split, which matters
twice here: once for traversal, and once because accel/clusters.py cuts its
cluster boxes at BVH subtree boundaries, so tree quality directly sets how
many clusters/sub-blocks the Pallas sweep touches per ray (the config-3
roofline's "issued ops" axis). ``method="median"`` (longest-centroid-axis
median split) is kept as the reference partitioner. The native C++ builder
(native/) produces the same arrays faster for big meshes; this numpy
implementation is the reference/fallback.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp

LEAF_SIZE = 4


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class BVH:
    # nodes, DFS preorder
    bb_min: jax.Array     # (N, 3) f32
    bb_max: jax.Array     # (N, 3) f32
    first_tri: jax.Array  # (N,) int32 — start into reordered tris; -1 = interior
    tri_count: jax.Array  # (N,) int32 — 0 for interior
    skip: jax.Array       # (N,) int32 — next preorder subtree (miss link)
    # reordered triangle SoA (gathered once at build)
    v0: jax.Array         # (T, 3)
    e1: jax.Array         # (T, 3)
    e2: jax.Array         # (T, 3)
    perm: jax.Array       # (T,) int32 — reordered index -> original tri index


SAH_BINS = 16


def build_bvh(triangles: np.ndarray, leaf_size: int = LEAF_SIZE,
              use_native: bool | None = None, method: str = "sah") -> BVH:
    """triangles: (T, 3, 3) float32 vertex array.

    use_native: True = require the C++ builder (native/bvh_builder.cpp),
    False = force the numpy reference builder, None = native if available.
    method: "sah" (binned surface-area heuristic, default) or "median".
    Both builders produce the same layout (DFS preorder + skip links); for a
    given method the trees may differ only in partition tie-breaking, which
    traversal results don't see.
    """
    if method not in ("sah", "median"):
        raise ValueError(f"method must be 'sah' or 'median': {method!r}")
    tris = np.ascontiguousarray(triangles, dtype=np.float32)
    T = tris.shape[0]

    if use_native is not False:
        from raytracing_engine_tpu.native.loader import get_bvh_lib

        lib = get_bvh_lib()
        if lib is not None:
            cap = 4 * max(T // max(leaf_size // 2, 1), 1) + 8
            bbmin = np.empty((cap, 3), np.float32)
            bbmax = np.empty((cap, 3), np.float32)
            first = np.empty((cap,), np.int32)
            cnt = np.empty((cap,), np.int32)
            skp = np.empty((cap,), np.int32)
            perm = np.empty((T,), np.int32)
            n = lib.bvh_build(tris.reshape(T, 9), T, leaf_size, cap,
                              bbmin, bbmax, first, cnt, skp, perm,
                              1 if method == "sah" else 0)
            if n > 0:
                rt = tris[perm]
                return BVH(
                    bb_min=jnp.asarray(bbmin[:n]),
                    bb_max=jnp.asarray(bbmax[:n]),
                    first_tri=jnp.asarray(first[:n]),
                    tri_count=jnp.asarray(cnt[:n]),
                    skip=jnp.asarray(skp[:n]),
                    v0=jnp.asarray(rt[:, 0]),
                    e1=jnp.asarray(rt[:, 1] - rt[:, 0]),
                    e2=jnp.asarray(rt[:, 2] - rt[:, 0]),
                    perm=jnp.asarray(perm),
                )
        if use_native:
            raise RuntimeError("native BVH builder unavailable")
    lo = tris.min(axis=1)  # (T, 3)
    hi = tris.max(axis=1)
    centroid = (lo + hi) * 0.5

    order = np.arange(T)
    bb_min, bb_max, first, count, skip = [], [], [], [], []
    out_order = []

    # iterative DFS preorder build; each frame = (index slice, parent patch)
    def emit(node):
        bb_min.append(node[0])
        bb_max.append(node[1])
        first.append(node[2])
        count.append(node[3])
        skip.append(-1)  # patched after subtree is emitted
        return len(bb_min) - 1

    def split_median(ids, c, axis):
        med = len(ids) // 2
        part = np.argpartition(c[:, axis], med)
        return ids[part[:med]], ids[part[med:]]

    def split_sah(ids, c, axis, clo, chi):
        """16-bin binned SAH on the longest centroid axis: min over split
        planes of A_left*N_left + A_right*N_right (leaf/traversal constants
        drop out — we always split while len > leaf_size, SAH only picks
        WHERE). Falls back to median when the centroids are degenerate or
        every candidate plane leaves one side empty."""
        ext = chi[axis] - clo[axis]
        if not ext > 0:
            return split_median(ids, c, axis)
        b = np.minimum((
            (c[:, axis] - clo[axis]) * (SAH_BINS / ext)).astype(np.int64),
            SAH_BINS - 1)
        cnt_b = np.bincount(b, minlength=SAH_BINS)
        binlo = np.full((SAH_BINS, 3), 1e30, np.float32)
        binhi = np.full((SAH_BINS, 3), -1e30, np.float32)
        np.minimum.at(binlo, b, lo[ids])
        np.maximum.at(binhi, b, hi[ids])

        def areas(lo_c, hi_c):
            d = np.maximum(hi_c - lo_c, 0.0)
            return d[:, 0] * d[:, 1] + d[:, 1] * d[:, 2] + d[:, 2] * d[:, 0]

        # growing unions left-to-right and right-to-left
        llo = np.minimum.accumulate(binlo, 0)
        lhi = np.maximum.accumulate(binhi, 0)
        rlo = np.minimum.accumulate(binlo[::-1], 0)[::-1]
        rhi = np.maximum.accumulate(binhi[::-1], 0)[::-1]
        nl = np.cumsum(cnt_b)[:-1]             # split after bin i: bins <= i left
        nr = len(ids) - nl
        cost = (areas(llo, lhi)[:-1] * nl + areas(rlo, rhi)[1:] * nr)
        cost = np.where((nl == 0) | (nr == 0), np.inf, cost)
        best = int(np.argmin(cost))
        if not np.isfinite(cost[best]):
            return split_median(ids, c, axis)
        mask = b <= best
        return ids[mask], ids[~mask]

    def build(ids):
        n0 = emit((lo[ids].min(0), hi[ids].max(0), -1, 0))
        if len(ids) <= leaf_size:
            bb = len(out_order)
            first[n0] = bb
            count[n0] = len(ids)
            out_order.extend(ids.tolist())
        else:
            c = centroid[ids]
            clo, chi = c.min(0), c.max(0)
            axis = int(np.argmax(chi - clo))
            if method == "sah":
                left, right = split_sah(ids, c, axis, clo, chi)
            else:
                left, right = split_median(ids, c, axis)
            build(left)
            build(right)
        skip[n0] = len(bb_min)  # next preorder index after this subtree
        return n0

    import sys

    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_limit, 10000))
    try:
        build(order)
    finally:
        sys.setrecursionlimit(old_limit)

    perm = np.asarray(out_order, np.int32)
    rt = tris[perm]
    return BVH(
        bb_min=jnp.asarray(np.stack(bb_min)),
        bb_max=jnp.asarray(np.stack(bb_max)),
        first_tri=jnp.asarray(np.asarray(first, np.int32)),
        tri_count=jnp.asarray(np.asarray(count, np.int32)),
        skip=jnp.asarray(np.asarray(skip, np.int32)),
        v0=jnp.asarray(rt[:, 0]),
        e1=jnp.asarray(rt[:, 1] - rt[:, 0]),
        e2=jnp.asarray(rt[:, 2] - rt[:, 0]),
        perm=jnp.asarray(perm),
    )


def bvh_intersect(bvh: BVH, o3, d3, t_min=1e-3, t_max=jnp.inf,
                  any_hit: bool = False, max_steps: int = 10_000):
    """Closest-hit traversal for a batch of rays.

    o3/d3: (..., 3). Returns (t, tri_idx, u, v): t=inf on miss; tri_idx is an
    index into the REORDERED arrays (use bvh.perm to map back).
    With any_hit=True, lanes stop at the first confirmed hit (shadow rays).
    """
    n_nodes = bvh.bb_min.shape[0]
    batch = o3.shape[:-1]
    inv_d = 1.0 / d3  # inf components are fine for the slab test

    # t_max may be a scalar or a per-lane array (shadow-ray cutoffs)
    t0 = jnp.broadcast_to(jnp.asarray(t_max, jnp.float32), batch)
    node0 = jnp.zeros(batch, jnp.int32)
    idx0 = jnp.full(batch, -1, jnp.int32)
    uv0 = jnp.zeros(batch + (2,), jnp.float32)

    def cond(state):
        node, t, idx, uv, steps = state
        return (steps < max_steps) & jnp.any(node < n_nodes)

    def body(state):
        node, t, idx, uv, steps = state
        live = node < n_nodes
        nsafe = jnp.where(live, node, 0)

        bmin = bvh.bb_min[nsafe]
        bmax = bvh.bb_max[nsafe]
        tn = (bmin - o3) * inv_d
        tf = (bmax - o3) * inv_d
        t_near = jnp.max(jnp.minimum(tn, tf), axis=-1)
        t_far = jnp.min(jnp.maximum(tn, tf), axis=-1)
        box_hit = (t_near <= t_far) & (t_far > t_min) & (t_near < t) & live

        ftri = bvh.first_tri[nsafe]
        tcount = bvh.tri_count[nsafe]
        is_leaf = ftri >= 0

        # leaf: unrolled up-to-LEAF_SIZE triangle tests
        do_leaf = box_hit & is_leaf
        for k in range(LEAF_SIZE):
            valid = do_leaf & (k < tcount)
            ti = jnp.clip(ftri + k, 0, bvh.v0.shape[0] - 1)
            v0 = bvh.v0[ti]
            e1 = bvh.e1[ti]
            e2 = bvh.e2[ti]
            pvec = jnp.cross(d3, e2)
            det = jnp.sum(e1 * pvec, axis=-1)
            inv_det = 1.0 / jnp.where(jnp.abs(det) < 1e-9, 1.0, det)
            tvec = o3 - v0
            uu = jnp.sum(tvec * pvec, axis=-1) * inv_det
            qvec = jnp.cross(tvec, e1)
            vv = jnp.sum(d3 * qvec, axis=-1) * inv_det
            tt = jnp.sum(e2 * qvec, axis=-1) * inv_det
            ok = (
                valid
                & (jnp.abs(det) >= 1e-9)
                & (uu >= 0.0)
                & (vv >= 0.0)
                & (uu + vv <= 1.0)
                & (tt > t_min)
                & (tt < t)
            )
            t = jnp.where(ok, tt, t)
            idx = jnp.where(ok, ti, idx)
            uv = jnp.where(ok[..., None], jnp.stack([uu, vv], -1), uv)

        if any_hit:
            # a confirmed hit parks the lane past the end
            finished = idx >= 0
        else:
            finished = jnp.zeros_like(box_hit)

        descend = box_hit & ~is_leaf
        nxt = jnp.where(descend, node + 1, bvh.skip[nsafe])
        nxt = jnp.where(finished, n_nodes, nxt)
        node = jnp.where(live, nxt, node)
        return (node, t, idx, uv, steps + 1)

    node, t, idx, uv, _ = jax.lax.while_loop(
        cond, body, (node0, t0, idx0, uv0, jnp.int32(0))
    )
    t = jnp.where(idx >= 0, t, jnp.inf)
    return t, idx, uv[..., 0], uv[..., 1]
