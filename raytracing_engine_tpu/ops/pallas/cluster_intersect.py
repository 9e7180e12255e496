"""Pallas cluster intersector — block-of-rays triangle sweep (Triton route).

Each program owns one (block_h, block_w) block of rays and walks the
cluster hierarchy of accel/clusters.py:

  while over SUPER-clusters (near-to-far order, any-hit early exit):
    slab-test the super box against the block; if any ray enters,
    loop over its SUPER child clusters:
      slab-test the cluster box; if any ray enters, for each of its SUBS
      sub-boxes (cluster rows 14-19) that some ray enters, run the
      SUB_TRIS Baldwin–Weber triangle tests of that sub-block.

Whole boxes are culled per block, so a block of coherent rays pays only for
the triangles near it. Every table access is a scalar read at a computed
index (the whole block reads the same triangle), so nothing is loaded
whole. With attrs=True the sweep also selects the hit's shading normal,
material, area and — for smooth / UV tables — interpolated normal, texture
UV and tangent, which the plain skip-link BVH path (accel/bvh.py) cannot
provide.

The sweep body (`cluster_sweep`) is shared with the instanced intersector
(ops/pallas/instanced_intersect.py), which runs it once per instance in
object space.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from raytracing_engine_tpu.accel.clusters import (
    CLUSTER, ROWS_SMOOTH, ROWS_UV, SUBS, SUPER, ClusterSet)
from raytracing_engine_tpu.ops.pallas.common import (
    any_true,
    block2d,
    cdiv,
    resolve_interpret,
    triton_call,
    whole,
)

SUB_TRIS = CLUSTER // SUBS
_INF = np.float32(np.inf)
# Padding rays: parked far away with an all-positive direction, so every
# slab test fails and an any-hit sweep counts them as already satisfied.
_PARK_O = np.float32(1e18)
_PARK_D = np.float32(0.5773502691896258)
DEFAULT_TILE = (8, 16)


@dataclasses.dataclass(frozen=True)
class KernelClusters:
    """In-kernel view of a ClusterSet: refs + static metadata."""
    order_ref: Any    # (S,) int32 super visit order, or (K, S) with order_row
    sboxes_ref: Any   # (S, 8) f32 super boxes
    boxes_ref: Any    # (C, 8) f32 cluster boxes
    tri_ref: Any      # (ROWS, T_pad) f32 triangle rows (14-19: sub-boxes)
    n_super: int
    # When not None, order_ref is (K, S) and the sweep reads row
    # `order_row` (a traced scalar): the instanced sweep gives each
    # instance its own object-space near-to-far order. Pure perf hint.
    order_row: Any = None
    # Emit the world texture-u tangent attr planes (UV tables only).
    emit_tan: bool = False


def _slab_vals(bminx, bminy, bminz, bmaxx, bmaxy, bmaxz,
               ox, oy, oz, ix, iy, iz):
    """Vector slab test of a scalar box against the ray block."""
    tx0 = (bminx - ox) * ix
    tx1 = (bmaxx - ox) * ix
    ty0 = (bminy - oy) * iy
    ty1 = (bmaxy - oy) * iy
    tz0 = (bminz - oz) * iz
    tz1 = (bmaxz - oz) * iz
    t_near = jnp.maximum(
        jnp.maximum(jnp.minimum(tx0, tx1), jnp.minimum(ty0, ty1)),
        jnp.minimum(tz0, tz1),
    )
    t_far = jnp.minimum(
        jnp.minimum(jnp.maximum(tx0, tx1), jnp.maximum(ty0, ty1)),
        jnp.maximum(tz0, tz1),
    )
    return t_near, t_far


def _slab(box_ref, c, ox, oy, oz, ix, iy, iz):
    """Slab test of box row `box_ref[c]` against the ray block."""
    return _slab_vals(box_ref[c, 0], box_ref[c, 1], box_ref[c, 2],
                      box_ref[c, 3], box_ref[c, 4], box_ref[c, 5],
                      ox, oy, oz, ix, iy, iz)


def n_attr_planes(tri_rows: int, emit_tan: bool) -> int:
    """Attr planes the sweep emits for a table of `tri_rows` rows."""
    uv = tri_rows >= ROWS_UV
    return 10 if (uv and emit_tan) else (7 if uv else 5)


def cluster_sweep(kc: KernelClusters, o, d, t0, *, t_min, any_hit=False,
                  attrs=False):
    """Hierarchical closest-/any-hit sweep. Returns (t, idx_f32, attr).

    o, d: ray component planes; t0: initial best-t plane (doubles as t_max).
    idx < 0 means miss (t is then left at whatever the carry held — mask on
    idx, not t). attr = (nx, ny, nz, mat, 2*area) planes when attrs else ()
    — plus (u, v) texture-coordinate planes for UV (ROWS_UV) tables, plus
    the (tx, ty, tz) texture-u tangent when kc.emit_tan. The normal attr is
    the GEOMETRIC plane normal for flat tables and the barycentric-
    interpolated SHADING normal for smooth (ROWS_SMOOTH) tables — detected
    statically from the table shape. Results are visit-order independent;
    order is a near-to-far perf hint.
    """
    tri = kc.tri_ref
    smooth = tri.shape[0] >= ROWS_SMOOTH  # static: table shape
    uv = tri.shape[0] >= ROWS_UV          # static: table shape
    tan = uv and kc.emit_tan
    n_attr = n_attr_planes(tri.shape[0], kc.emit_tan)

    ox, oy, oz = o
    dx, dy, dz = d
    inv_dx = 1.0 / dx
    inv_dy = 1.0 / dy
    inv_dz = 1.0 / dz

    t0 = jnp.broadcast_to(t0, ox.shape).astype(jnp.float32)
    idx0 = jnp.zeros_like(t0) - 1.0  # f32 idx carry
    if any_hit:
        # Parked lanes (dead rays, padding) count as already satisfied
        # (idx=0): their slab tests all fail anyway, but seeding them lets
        # `live` clear, so a block whose real candidates are all blocked
        # exits early. Callers gate occlusion by their own candidate mask.
        idx0 = jnp.where(jnp.abs(ox) >= 1e17, 0.0, idx0)
    attr0 = tuple(jnp.zeros_like(t0) for _ in range(n_attr)) if attrs else ()

    def tri_test(j, lo, ray_hit, carry):
        """Baldwin–Weber test of triangle slot j (a traced index). The
        precomputed transform (accel/clusters.py row map) needs no cross
        products; `lo` is the ray origin rebased to the cluster's frame."""
        t, idx = carry[0], carry[1]
        lox, loy, loz = lo
        nx, ny, nz, nd = tri[0, j], tri[1, j], tri[2, j], tri[3, j]
        den = nx * dx + ny * dy + nz * dz
        num = nx * lox + ny * loy + nz * loz + nd
        # No den==0 guard needed: IEEE semantics make every degenerate
        # case a miss (tt = +/-inf or NaN fails tt>t_min / tt<t).
        tt = -num * (1.0 / den)
        px = lox + tt * dx  # cluster-local hit point
        py = loy + tt * dy
        pz = loz + tt * dz
        u = tri[4, j] * px + tri[5, j] * py + tri[6, j] * pz + tri[7, j]
        v = tri[8, j] * px + tri[9, j] * py + tri[10, j] * pz + tri[11, j]
        ok = (
            ray_hit
            & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
            & (tt > t_min) & (tt < t)
        )
        t = jnp.where(ok, tt, t)
        idx = jnp.where(ok, j.astype(jnp.float32), idx)
        if not attrs:
            return (t, idx)
        if smooth:
            # barycentric-interpolated shading normal from rows 21-29
            # (s0, s1-s0, s2-s0); normalization/facing happen downstream
            cnx = tri[21, j] + u * tri[24, j] + v * tri[27, j]
            cny = tri[22, j] + u * tri[25, j] + v * tri[28, j]
            cnz = tri[23, j] + u * tri[26, j] + v * tri[29, j]
        else:
            cnx, cny, cnz = nx, ny, nz
        new = (cnx, cny, cnz, tri[12, j], tri[13, j])
        if uv:
            # barycentric-interpolated texture UV from rows 32-37
            new += (tri[32, j] + u * tri[34, j] + v * tri[36, j],
                    tri[33, j] + u * tri[35, j] + v * tri[37, j])
        if tan:
            # triangle-constant world texture-u tangent from the
            # (translation-invariant) barycentric gradient rows:
            # d(u_tex)/dp = du1*r1 + du2*r2
            du1, du2 = tri[34, j], tri[36, j]
            new += tuple(du1 * tri[4 + a, j] + du2 * tri[8 + a, j]
                         for a in range(3))
        return (t, idx) + tuple(jnp.where(ok, nv, av)
                                for nv, av in zip(new, carry[2:]))

    def mt_cluster(c, ray_hit, carry):
        """Cluster c's triangle tests, gated per SUB_TRIS-triangle sub-box."""
        base = c * CLUSTER
        # rebase the ray origin to the cluster's local frame once per
        # cluster (translation-invariant affine rows, see accel/clusters)
        lo = (ox - tri[20, base], oy - tri[20, base + 1],
              oz - tri[20, base + 2])
        for sub in range(SUBS):
            t_near, t_far = _slab_vals(
                tri[14, base + sub], tri[15, base + sub], tri[16, base + sub],
                tri[17, base + sub], tri[18, base + sub], tri[19, base + sub],
                ox, oy, oz, inv_dx, inv_dy, inv_dz)
            sub_hit = (ray_hit & (t_near <= t_far) & (t_far > t_min)
                       & (t_near < carry[0]))
            lo_k = base + sub * SUB_TRIS

            def tests(a, _sh=sub_hit, _lo=lo_k):
                return lax.fori_loop(
                    0, SUB_TRIS, lambda k, a: tri_test(_lo + k, lo, _sh, a), a)

            carry = lax.cond(any_true(sub_hit), tests, lambda a: a, carry)
        return carry

    def child(k, carry, *, s):
        c = s * SUPER + k
        t_near, t_far = _slab(kc.boxes_ref, c, ox, oy, oz,
                              inv_dx, inv_dy, inv_dz)
        ray_hit = (t_near <= t_far) & (t_far > t_min) & (t_near < carry[0])
        if any_hit:
            ray_hit = ray_hit & (carry[1] < 0.0)
        return lax.cond(any_true(ray_hit),
                        lambda a: mt_cluster(c, ray_hit, a), lambda a: a,
                        carry)

    def cond(state):
        go = state[0] < kc.n_super
        if any_hit:  # early exit once every ray of the block is blocked
            go = go & any_true(state[2] < 0.0)
        return go

    def body(state):
        si, carry = state[0], state[1:]
        if kc.order_row is not None:
            s = kc.order_ref[kc.order_row, si]  # per-instance order row
        else:
            s = kc.order_ref[si]  # near-to-far visit order (perf hint only)
        t_near, t_far = _slab(kc.sboxes_ref, s, ox, oy, oz,
                              inv_dx, inv_dy, inv_dz)
        super_hit = (t_near <= t_far) & (t_far > t_min) & (t_near < carry[0])
        if any_hit:
            super_hit = super_hit & (carry[1] < 0.0)
        carry = lax.cond(
            any_true(super_hit),
            lambda a: lax.fori_loop(0, SUPER, functools.partial(child, s=s),
                                    a),
            lambda a: a,
            carry,
        )
        return (si + 1,) + carry

    state = lax.while_loop(cond, body, (jnp.int32(0), t0, idx0) + attr0)
    return state[1], state[2], tuple(state[3:])


def _cluster_kernel(order_ref, sboxes_ref, boxes_ref, tri_ref,
                    ox_ref, oy_ref, oz_ref, dx_ref, dy_ref, dz_ref,
                    tmax_ref, *out_refs, n_super, t_min, any_hit, attrs,
                    tan=False):
    kc = KernelClusters(order_ref, sboxes_ref, boxes_ref, tri_ref, n_super,
                        emit_tan=tan)
    t, idx, attr = cluster_sweep(
        kc,
        (ox_ref[...], oy_ref[...], oz_ref[...]),
        (dx_ref[...], dy_ref[...], dz_ref[...]),
        tmax_ref[...], t_min=t_min, any_hit=any_hit, attrs=attrs,
    )
    out_refs[0][...] = jnp.where(idx >= 0.0, t, _INF)
    out_refs[1][...] = idx.astype(jnp.int32)
    for a, ref in enumerate(out_refs[2:]):
        # |n| row holds 2 * area
        ref[...] = attr[a] * 0.5 if a == 4 else attr[a]


def pad_rays(o_planes, d_planes, t_max, tile):
    """Pad (H, W) ray planes up to whole (bh, bw) blocks with parked rays.
    Returns (o, d, t_max planes, (bh, bw), (hp, wp))."""
    h, w = o_planes[0].shape
    bh = min(tile[0], 1 << max(h - 1, 0).bit_length())
    bw = min(tile[1], 1 << max(w - 1, 0).bit_length())
    hp, wp = cdiv(h, bh) * bh, cdiv(w, bw) * bw

    def pad(x, fill):
        x = jnp.broadcast_to(jnp.asarray(x, jnp.float32), (h, w))
        if (hp, wp) == (h, w):
            return x
        return jnp.pad(x, ((0, hp - h), (0, wp - w)), constant_values=fill)

    o = tuple(pad(p, _PARK_O) for p in o_planes)
    d = tuple(pad(p, _PARK_D) for p in d_planes)
    return o, d, pad(t_max, 0.0), (bh, bw), (hp, wp)


@functools.partial(
    jax.jit,
    static_argnames=("t_min", "any_hit", "tile", "interpret", "attrs", "tan"),
)
def cluster_intersect(cs: ClusterSet, o_planes, d_planes, t_max,
                      t_min=1e-3, any_hit=False, tile=DEFAULT_TILE,
                      interpret=None, attrs=False, order=None, tan=False):
    """Intersect an (H, W) ray-plane grid against a ClusterSet.

    Returns (t (H,W) — inf on miss, tri_idx (H,W) int32 — PADDED-REORDERED
    slot, -1 on miss; map back with cs.perm).

    attrs=True additionally returns (nx, ny, nz, mat, area): unnormalized
    normal (geometric, or interpolated shading normal for smooth tables),
    material id (f32, from tri row 12) and triangle area of the hit. UV
    tables (cs.has_uv) append the interpolated texture (u, v) planes, and
    with tan=True the world texture-u tangent (tx, ty, tz).

    order: optional (S,) int32 SUPER-cluster visit order
    (accel.clusters.visit_order) — near-to-far ordering lets the running t
    cull far boxes; pure perf hint, results are order-independent.

    tile: (block_h, block_w) rays per program, powers of two.
    """
    h, w = o_planes[0].shape
    o, d, tmax, (bh, bw), (hp, wp) = pad_rays(o_planes, d_planes, t_max, tile)
    tan = tan and cs.has_uv
    kernel = functools.partial(
        _cluster_kernel,
        n_super=cs.num_super,
        t_min=t_min,
        any_hit=any_hit,
        attrs=attrs,
        tan=tan,
    )
    if order is None:
        order = jnp.arange(cs.num_super, dtype=jnp.int32)
    n_out = 2 + (n_attr_planes(cs.tri.shape[0], tan) if attrs else 0)
    out_shape = [jax.ShapeDtypeStruct((hp, wp), jnp.float32)
                 for _ in range(n_out)]
    out_shape[1] = jax.ShapeDtypeStruct((hp, wp), jnp.int32)
    blk = block2d(bh, bw)
    tabs = (order, cs.super_boxes, cs.boxes, cs.tri)
    outs = triton_call(
        kernel,
        out_shape=tuple(out_shape),
        grid=(hp // bh, wp // bw),
        in_specs=[whole(x.shape) for x in tabs] + [blk] * 7,
        out_specs=tuple(blk for _ in out_shape),
        interpret=resolve_interpret(interpret),
        name="cluster_anyhit" if any_hit else "cluster_closest",
    )(*tabs, *o, *d, tmax)
    return tuple(x[:h, :w] for x in outs)
