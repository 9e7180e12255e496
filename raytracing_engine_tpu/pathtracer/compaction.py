"""Wavefront ray compaction (sort-based, static shapes).

The north-star wavefront architecture calls for "ray compaction between
bounces so divergent paths stay dense". With static shapes, compaction is a
stable key-sort that moves dead rays to the tail. The bounce stages still
process all N lanes, so compaction pays only when a *later consumer* can
exploit density — e.g. per-block kernels whose loops early-exit on all-dead
blocks, or (future) truncating work to the live prefix at a static budget.
It is OFF by default; this module provides the mechanism and proves it
preserves the estimator exactly.

Everything here is permutation bookkeeping: ray state is flattened to
(N, ...) arrays, sorted by aliveness (stable, so live-ray relative order —
and therefore any pixel-keyed RNG stream permuted alongside — is preserved),
and radiance is scattered back through the carried pixel index at the end.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def compaction_perm(alive):
    """Stable permutation putting live lanes first.

    alive: (N,) bool/0-1. Returns (perm, num_alive): state[perm] is
    compacted; stability keeps live-ray order unchanged.
    """
    alive = alive.astype(jnp.int32)
    # stable argsort of (1 - alive): zeros (alive) first, original order kept
    perm = jnp.argsort(1 - alive, stable=True)
    return perm, jnp.sum(alive)


def apply_perm(state, perm):
    """Gather every array leaf of a pytree along axis 0."""
    return jax.tree_util.tree_map(lambda a: a[perm], state)


def scatter_by_pixel(values, pixel_idx, num_pixels):
    """Scatter (N, ...) values back to pixel order via the carried index."""
    out_shape = (num_pixels,) + values.shape[1:]
    return jnp.zeros(out_shape, values.dtype).at[pixel_idx].add(values)


def compacted_trace(cfg, scene, cam_pos, cam_quat, key, spp=1):
    """Reference mini-integrator with per-bounce compaction (flat SoA).

    Estimator-identical to pathtracer.wavefront with rng='pcg' on the same
    seeds: RNG planes are drawn in PIXEL order each bounce and permuted with
    the state, so compaction cannot change any sample. Returns ((H, W, 3)
    image, nrays). Spheres + unrolled-triangle scenes (no BVH arg here —
    this is the mechanism demo, not the production path).
    """
    from jax import lax

    if getattr(cfg, "light_sampling", "power") == "tree":
        raise ValueError(
            "compacted_trace is the power-sampling mechanism demo; "
            "light_sampling='tree' runs on the production paths "
            "(render_pt_fast / render_pt)")

    from raytracing_engine_tpu.ops.rng_pcg import key_to_seed
    from raytracing_engine_tpu.ops.rng_pcg import uniform_pcg
    from raytracing_engine_tpu.pathtracer import wavefront as wf

    h, w = cfg.height, cfg.width
    n = h * w
    base = key_to_seed(key)

    def one_pass(i, carry):
        acc, nrays = carry
        seed0 = base + i * jnp.int32(-1640531527)

        u = uniform_pcg(seed0, 0, 2, h, w)
        o, d = wf._camera_rays(cfg, cam_pos, cam_quat, u[0], u[1])

        flat = lambda p: p.reshape(n)
        st = dict(
            o=tuple(map(flat, o)), d=tuple(map(flat, d)),
            thr=tuple(jnp.ones(n) for _ in range(3)),
            rad=tuple(jnp.zeros(n) for _ in range(3)),
            alive=jnp.ones(n),
            prev_did_nee=jnp.zeros(n),
            prev_pdf=jnp.zeros(n),
            pixel=jnp.arange(n),
            nrays=jnp.float32(0.0),
        )

        def bounce(b, st):
            st = dict(st)
            # draw in PIXEL order, then permute into lane order with the
            # state — compaction-invariant by construction
            up = uniform_pcg(seed0, b + 1, 5, h, w)
            up = tuple(p.reshape(n)[st["pixel"]] for p in up)

            st["nrays"] = st["nrays"] + jnp.sum(st["alive"])
            o2 = tuple(p.reshape(1, n) for p in st["o"])
            d2 = tuple(p.reshape(1, n) for p in st["d"])
            isect = wf._intersect(scene, o2, d2, cfg.t_min, None)
            isect = {k: (tuple(x.reshape(n) for x in v) if isinstance(v, tuple)
                         else v.reshape(n)) for k, v in isect.items()}
            alive_b = st["alive"] != 0.0
            hit = isect["hit"] & alive_b
            # (ior unused: this demonstration path scatters diffuse/mirror
            # only — glass scenes belong to the production integrators)
            albedo, emission, kind, _ = wf._mat_lookup(scene, isect["mat_id"])
            nrm = isect["n"]
            p = isect["p"]

            from raytracing_engine_tpu.ops import vec3 as v3
            from raytracing_engine_tpu.pathtracer import sampler
            from raytracing_engine_tpu.pathtracer.scene import DIFFUSE, MIRROR

            emissive = (emission[0] > 0) | (emission[1] > 0) | (emission[2] > 0)
            cos_l = jnp.abs(v3.dot(nrm, st["d"]))
            pdf_lw = (1.0 / jnp.maximum(
                isect["light_area"] * jnp.maximum(scene.light_count, 1), 1e-20)
                * isect["t"] ** 2 / jnp.maximum(cos_l, 1e-6))
            w_b = jnp.where(st["prev_did_nee"] != 0.0,
                            sampler.power_heuristic(st["prev_pdf"], pdf_lw), 1.0)
            gate = jnp.where(hit & emissive, w_b, 0.0)
            st["rad"] = v3.add(st["rad"], v3.mul(st["thr"], v3.scale(emission, gate)))

            if cfg.use_nee:
                lp, ln, le, pdf_area = wf._sample_light(scene, up[2], up[3], up[4])
                to_l = v3.sub(lp, p)
                dist = v3.length(to_l)
                wi = v3.scale(to_l, 1.0 / jnp.maximum(dist, 1e-20))
                cos_s = v3.dot(nrm, wi)
                cos_ll = jnp.abs(v3.dot(ln, wi))
                cand = (hit & (kind == DIFFUSE) & (scene.light_count > 0)
                        & (cos_s > 0) & (cos_ll > 1e-6) & (dist > cfg.eps))
                st["nrays"] = st["nrays"] + jnp.sum(cand)
                sh_o = v3.add(p, v3.scale(nrm, cfg.eps))
                sh_o2 = tuple(x.reshape(1, n) for x in sh_o)
                wi2 = tuple(x.reshape(1, n) for x in wi)
                blocked = wf._occluded(scene, sh_o2, wi2,
                                       (dist * (1 - 1e-3)).reshape(1, n),
                                       cfg.t_min, None).reshape(n)
                vis = cand & ~blocked
                pdf_w = pdf_area * dist**2 / jnp.maximum(cos_ll, 1e-6)
                w_nee = sampler.power_heuristic(pdf_w, cos_s / jnp.pi)
                scale = jnp.where(vis, cos_s / jnp.maximum(pdf_w, 1e-20)
                                  * w_nee / jnp.pi, 0.0)
                st["rad"] = v3.add(
                    st["rad"], v3.mul(v3.mul(st["thr"], albedo), v3.scale(le, scale)))

            diff_d, pdf_cos = sampler.cosine_hemisphere(up[0], up[1], nrm)
            mirr_d = v3.sub(st["d"], v3.scale(nrm, 2.0 * v3.dot(st["d"], nrm)))
            is_mirror = kind == MIRROR
            new_d = v3.where(is_mirror, mirr_d, diff_d)
            new_o = v3.add(p, v3.scale(nrm, cfg.eps))
            new_thr = v3.mul(st["thr"], albedo)
            cont = hit & (jnp.maximum(new_thr[0],
                          jnp.maximum(new_thr[1], new_thr[2])) > 0)
            zero = st["alive"] * 0.0
            st["thr"] = v3.where(cont, new_thr, (zero, zero, zero))
            st["o"] = v3.where(cont, new_o, st["o"])
            st["d"] = v3.where(cont, new_d, st["d"])
            st["alive"] = jnp.where(cont, 1.0, 0.0)
            did = (hit & (kind == DIFFUSE) & (scene.light_count > 0)
                   & jnp.bool_(cfg.use_nee))
            st["prev_did_nee"] = jnp.where(did, 1.0, 0.0)
            st["prev_pdf"] = pdf_cos

            # ---- COMPACTION: live rays to the front, dead to the tail ----
            perm, _ = compaction_perm(st["alive"])
            nrays = st.pop("nrays")
            st = apply_perm(st, perm)
            st["nrays"] = nrays
            return st

        st = lax.fori_loop(0, cfg.max_bounces + 1, bounce, st)
        rad = jnp.stack(st["rad"], axis=-1)  # (N, 3), lane order
        img = scatter_by_pixel(rad, st["pixel"], n).reshape(h, w, 3)
        return acc + img, nrays + st["nrays"]

    acc, nrays = lax.fori_loop(
        0, spp, one_pass,
        (jnp.zeros((h, w, 3), jnp.float32), jnp.float32(0.0)),
    )
    return acc / spp, nrays
