"""Instanced cluster intersector — two-level acceleration (Triton route).

BASELINE config 5: N instances of one base mesh. The base mesh's ClusterSet
tables are shared; each instance is ~20 scalars (world->object rotation
rows, translation, uniform scale, world AABB). Per block of rays:

  loop over instances (near-to-far order, any-hit early exit):
    - world-AABB pre-cull (vector slab test, `lax.cond` skip)
    - transform the block's rays into object space (scalar-broadcast mults)
    - the SAME hierarchical `cluster_sweep` as the single-mesh path
      (super -> cluster -> sub-box gates), bounded by the current
      best t (world units)

The winning hit is encoded as instance * padded_tris + slot; with
attrs=True the kernel also emits the WORLD-space normal (and UV / tangent
planes for UV tables), so a shaded render needs no post-kernel gathers.
Memory holds one base mesh regardless of instance count — 1M+ effective
triangles from a 70k-entry table.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from raytracing_engine_tpu.accel.clusters import ROWS_UV, ClusterSet
from raytracing_engine_tpu.ops.pallas.cluster_intersect import (
    DEFAULT_TILE,
    KernelClusters,
    _slab_vals,
    cluster_sweep,
    pad_rays,
)
from raytracing_engine_tpu.ops.pallas.common import (
    any_true,
    block2d,
    resolve_interpret,
    triton_call,
    whole,
)

_INF = np.float32(np.inf)


def pack_instances(inst, mats=None):
    """accel.instancing.InstancedMesh -> (inst_tab (N, 24) f32):
    rows [inv_rot(9, row-major), trans(3), scale(1), world_bb_min(3),
    world_bb_max(3), mat(1), pads]. Column 19 carries the per-instance
    material id (from `mats` or InstancedMesh.mat); consumers resolve it
    from the hit code as code // padded_tris.
    """
    n = inst.num_instances
    if mats is None:
        mats = getattr(inst, "mat", None)
    if mats is None:
        mats = jnp.zeros((n,), jnp.float32)
    tab = jnp.concatenate(
        [
            inst.inv_rot.reshape(n, 9),
            inst.trans,
            inst.scale[:, None],
            inst.aabb_min,
            inst.aabb_max,
            jnp.asarray(mats, jnp.float32)[:, None],
            jnp.zeros((n, 4), jnp.float32),
        ],
        axis=1,
    )  # (N, 24)
    return tab


@dataclasses.dataclass(frozen=True)
class KernelInstances:
    """In-kernel view of an instanced two-level scene: the shared base-mesh
    KernelClusters plus the instance table."""
    inst_ref: Any     # (N, 24) f32 — see pack_instances
    iorder_ref: Any   # (N,) int32 — instance visit order (perf hint)
    kc: Any           # KernelClusters of the base mesh
    n_instances: int
    t_pad: int        # base ClusterSet padded_tris (hit-code stride)
    # (N, S) int32: per-instance SUPER visit order, row k = near-to-far
    # from the camera TRANSFORMED INTO instance k's object space (the
    # sweep runs in object space, where a single shared order is
    # meaningless). Pure perf hint; results order-independent.
    iorders_ref: Any = None


def instanced_sweep(ki: KernelInstances, o, d, t0, *, t_min, any_hit=False,
                    attrs=False):
    """Two-level closest/any-hit sweep over all instances.

    o, d: WORLD-space ray component planes; t0: initial best-t (world
    units, doubles as t_max). Returns (t_world, code_f32, attr) where
    code = instance * ki.t_pad + slot (< 0 = miss) and attr =
    (nx, ny, nz) unnormalized WORLD-space geometric normal planes when
    attrs else () — plus interpolated texture-(u, v) planes for UV
    (ROWS_UV) base tables (UVs are object-space data: no transform).
    """
    wox, woy, woz = o
    wdx, wdy, wdz = d
    winv_dx = 1.0 / wdx
    winv_dy = 1.0 / wdy
    winv_dz = 1.0 / wdz
    inst_ref = ki.inst_ref

    t0 = jnp.broadcast_to(t0, wox.shape).astype(jnp.float32)
    code0 = jnp.zeros_like(wox) - 1.0
    if any_hit:
        # parked lanes count as satisfied so the instance loop can
        # early-exit once every real candidate is blocked (see
        # cluster_intersect.cluster_sweep); callers gate by candidacy
        code0 = jnp.where(jnp.abs(wox) >= 1e17, 0.0, code0)
    uv = ki.kc.tri_ref.shape[0] >= ROWS_UV  # static: base-table shape
    tan = uv and ki.kc.emit_tan             # static: tangent planes
    zero = jnp.zeros_like(wox)
    n_attr = 8 if tan else (5 if uv else 3)
    attr0 = tuple(zero for _ in range(n_attr)) if attrs else ()

    def body(ki_i, carry):
        t_w, code, attr = carry[0], carry[1], carry[2:]
        k = ki.iorder_ref[ki_i]  # near-to-far instance order (perf hint)

        # world AABB pre-cull for this instance
        t_near, t_far = _slab_vals(
            inst_ref[k, 13], inst_ref[k, 14], inst_ref[k, 15],
            inst_ref[k, 16], inst_ref[k, 17], inst_ref[k, 18],
            wox, woy, woz, winv_dx, winv_dy, winv_dz)
        gate = (t_near <= t_far) & (t_far > t_min) & (t_near < t_w)
        if any_hit:
            gate = gate & (code < 0.0)

        def inst_fn(args):
            t_w, code, attr = args[0], args[1], args[2:]
            # world -> object: o' = R^T (o - trans) / s ; d' = R^T d
            r00, r01, r02 = inst_ref[k, 0], inst_ref[k, 1], inst_ref[k, 2]
            r10, r11, r12 = inst_ref[k, 3], inst_ref[k, 4], inst_ref[k, 5]
            r20, r21, r22 = inst_ref[k, 6], inst_ref[k, 7], inst_ref[k, 8]
            tx, ty, tz = inst_ref[k, 9], inst_ref[k, 10], inst_ref[k, 11]
            s = inst_ref[k, 12]
            inv_s = 1.0 / s

            sx, sy, sz = wox - tx, woy - ty, woz - tz
            ox = (r00 * sx + r01 * sy + r02 * sz) * inv_s
            oy = (r10 * sx + r11 * sy + r12 * sz) * inv_s
            oz = (r20 * sx + r21 * sy + r22 * sz) * inv_s
            dx = r00 * wdx + r01 * wdy + r02 * wdz
            dy = r10 * wdx + r11 * wdy + r12 * wdz
            dz = r20 * wdx + r21 * wdy + r22 * wdz

            kc_k = ki.kc
            if ki.iorders_ref is not None:
                # this instance's object-space near-to-far super order
                kc_k = dataclasses.replace(
                    kc_k, order_ref=ki.iorders_ref, order_row=k)
            t_obj, idx, sattr = cluster_sweep(
                kc_k, (ox, oy, oz), (dx, dy, dz), t_w * inv_s,
                t_min=t_min * inv_s, any_hit=any_hit, attrs=attrs,
            )
            upd = idx >= 0.0
            t_w = jnp.where(upd, t_obj * s, t_w)
            code = jnp.where(upd, jnp.float32(1.0) * k * ki.t_pad + idx,
                             code)
            if attrs:
                # object normal -> world: n_w = R n (R = inv_rot^T)
                nx, ny, nz = sattr[0], sattr[1], sattr[2]
                wx = r00 * nx + r10 * ny + r20 * nz
                wy = r01 * nx + r11 * ny + r21 * nz
                wz = r02 * nx + r12 * ny + r22 * nz
                new = (wx, wy, wz)
                if uv:  # UVs are object-space data — carried untransformed
                    new += (sattr[5], sattr[6])
                if tan:
                    # object tangent -> world: directions rotate like
                    # normals under R + uniform scale
                    ttx, tty, ttz = sattr[7], sattr[8], sattr[9]
                    new += (r00 * ttx + r10 * tty + r20 * ttz,
                            r01 * ttx + r11 * tty + r21 * ttz,
                            r02 * ttx + r12 * tty + r22 * ttz)
                attr = tuple(jnp.where(upd, nv, av)
                             for nv, av in zip(new, attr))
            return (t_w, code) + attr

        return lax.cond(any_true(gate), inst_fn, lambda a: a,
                        (t_w, code) + tuple(attr))

    def cond(carry):
        go = carry[0] < ki.n_instances
        if any_hit:  # early exit once every ray of the block is blocked
            go = go & any_true(carry[2] < 0.0)
        return go

    def wbody(carry):
        k = carry[0]
        out = body(k, carry[1:])
        return (k + 1,) + out

    state = lax.while_loop(cond, wbody, (jnp.int32(0), t0, code0) + attr0)
    return state[1], state[2], state[3:]


def object_space_origins(inst_tab, origin):
    """(N, 24) pack_instances table + world origin (3,) -> (N, 3) origin in
    each instance's object space: R_k^T (origin - trans_k) / s_k. Feeds
    accel.clusters.visit_orders to build the per-instance (N, S) super
    visit-order table (KernelInstances.iorders_ref)."""
    n = inst_tab.shape[0]
    inv = inst_tab[:, 0:9].reshape(n, 3, 3)
    rel = jnp.asarray(origin, jnp.float32)[None, :] - inst_tab[:, 9:12]
    return jnp.einsum("nij,nj->ni", inv, rel,
                      precision=jax.lax.Precision.HIGHEST) / inst_tab[:, 12:13]


def _instanced_kernel(inst_ref, iorder_ref, iorders_ref, sboxes_ref,
                      boxes_ref, tri_ref, ox_ref, oy_ref, oz_ref, dx_ref,
                      dy_ref, dz_ref, tmax_ref, *out_refs, n_instances,
                      n_super, t_pad, t_min, any_hit, attrs, tan=False):
    kc = KernelClusters(iorders_ref, sboxes_ref, boxes_ref, tri_ref, n_super,
                        emit_tan=tan)
    ki = KernelInstances(inst_ref, iorder_ref, kc, n_instances, t_pad,
                         iorders_ref=iorders_ref)
    t_w, code, attr = instanced_sweep(
        ki,
        (ox_ref[...], oy_ref[...], oz_ref[...]),
        (dx_ref[...], dy_ref[...], dz_ref[...]),
        tmax_ref[...], t_min=t_min, any_hit=any_hit, attrs=attrs,
    )
    out_refs[0][...] = jnp.where(code >= 0.0, t_w, _INF)
    out_refs[1][...] = code.astype(jnp.int32)
    for a, ref in enumerate(out_refs[2:]):
        ref[...] = attr[a]


@functools.partial(
    jax.jit, static_argnames=("t_min", "tile", "interpret", "any_hit",
                              "attrs", "tan")
)
def instanced_cluster_intersect(inst_tab, cs: ClusterSet, o_planes, d_planes,
                                t_min=1e-3, tile=DEFAULT_TILE, interpret=None,
                                any_hit=False, attrs=False, t_max=_INF,
                                origin=None, tan=False):
    """Closest hit (or any-hit occlusion) over all instances of the base
    ClusterSet.

    inst_tab: pack_instances(...) output. t_max: scalar or (H, W) cutoff
    (shadow-ray light distance). origin: optional (3,) representative ray
    origin — instances are then visited near-to-far so nearer hits cull
    farther instance AABBs (pure perf hint; results order-independent).
    Returns (t_world (H,W) — inf miss, code (H,W) int32 — instance *
    cs.padded_tris + slot, -1 miss); with attrs=True additionally
    (nx, ny, nz) — unnormalized world-space normal of the hit — plus (u, v)
    interpolated texture-coordinate planes for UV base tables (cs.has_uv)
    and, with tan=True, the world texture-u tangent.
    """
    from raytracing_engine_tpu.accel.clusters import visit_orders

    h, w = o_planes[0].shape
    o, d, tmax, (bh, bw), (hp, wp) = pad_rays(o_planes, d_planes, t_max, tile)
    tan = tan and cs.has_uv
    kernel = functools.partial(
        _instanced_kernel,
        n_instances=inst_tab.shape[0],
        n_super=cs.num_super,
        t_pad=cs.padded_tris,
        t_min=t_min,
        any_hit=any_hit,
        attrs=attrs,
        tan=tan,
    )
    n_attr = 0
    if attrs:
        n_attr = 3 + (2 if cs.has_uv else 0) + (3 if tan else 0)
    out_shape = [jax.ShapeDtypeStruct((hp, wp), jnp.float32)
                 for _ in range(2 + n_attr)]
    out_shape[1] = jax.ShapeDtypeStruct((hp, wp), jnp.int32)

    n = inst_tab.shape[0]
    if origin is None:
        iorder = jnp.arange(n, dtype=jnp.int32)
        iorders = jnp.broadcast_to(
            jnp.arange(cs.num_super, dtype=jnp.int32)[None, :],
            (n, cs.num_super))
    else:
        center = (inst_tab[:, 13:16] + inst_tab[:, 16:19]) * 0.5
        delta = center - jnp.asarray(origin, jnp.float32)
        iorder = jnp.argsort(jnp.sum(delta * delta, -1)).astype(jnp.int32)
        # per-instance OBJECT-space super orders (the sweep runs in object
        # space; identity order there forfeits near-to-far t-shrink)
        iorders = visit_orders(cs, object_space_origins(inst_tab, origin))
    tabs = (inst_tab, iorder, iorders, cs.super_boxes, cs.boxes, cs.tri)
    blk = block2d(bh, bw)
    outs = triton_call(
        kernel,
        out_shape=tuple(out_shape),
        grid=(hp // bh, wp // bw),
        in_specs=[whole(x.shape) for x in tabs] + [blk] * 7,
        out_specs=tuple(blk for _ in out_shape),
        interpret=resolve_interpret(interpret),
        name="instanced_anyhit" if any_hit else "instanced_closest",
    )(*tabs, *o, *d, tmax)
    return tuple(x[:h, :w] for x in outs)
