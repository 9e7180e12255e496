#!/usr/bin/env python3
"""Smoke test of the renderer on NVIDIA GPUs: main paths, parity, timings.

    python chip_smoke.py             one card: every phase below
    python chip_smoke.py --cards 4   four cards: the sharded paths only

One card, in one process:
  1. the main paths through the user's entry points at real sizes — the
     1920x1088 cone-march (cli render / orbit / replay, FrameLoop,
     runtime.serve.render_sequence, bench.py), path tracing through
     render_pt_fast (Cornell + NEE, the 70k-triangle knot flat and smooth,
     examples/showcase.json) and the 1.06M-triangle instanced frame;
  2. parity of each Triton kernel with its plain reference at real widths;
  3. timings: each Triton kernel against the plain route XLA compiles
     (median and p90 over >= 20 warm frames, each ending in
     block_until_ready), plus the path-tracer reference numbers;
  4. the card-only tests (pytest -m gpu).

Four cards: the sharded cone-march over (4 x 1) and (2 x 2) meshes, the
sharded wavefront path tracer over tiles x spp and the sharded instanced
frame, each against the one-card result on device 0.

Every phase prints one line. A failed phase does not stop the others, but
the script then exits non-zero. Compile time is reported as set-up. The
last line of standard output is the device record
{"ok": true, "device": {...}}; it is printed only when every phase passed.
Details go to chiprun_out/chip_smoke_<N>card.json. Exits non-zero
before any work unless JAX runs on a GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(ROOT, "chiprun_out")
FRAMES = 20  # timed frames per measurement (after 2 warm-up frames)
# sizes of the four-card phases: frame, path-traced frame, instance grid
# and knot segments of the config-5 scene
SHARDED_HD = (1920, 1088)
SHARDED_PT = 512
SHARDED_GRID = (6, 5, 550)


class Phases:
    """Runs named phases, prints one line each, remembers failures."""

    def __init__(self):
        self.records = []

    def run(self, name, fn):
        t0 = time.perf_counter()
        try:
            info = fn() or {}
            ok = True
        except Exception as e:  # reported, and turned into a non-zero exit
            traceback.print_exc()
            info = {"error": f"{type(e).__name__}: {e}"[:2000]}
            ok = False
        rec = {"phase": name, "ok": ok,
               "seconds": time.perf_counter() - t0, **info}
        self.records.append(rec)
        print(f"[{'ok' if ok else 'FAILED'}] {name}: "
              f"{json.dumps(rec, default=float)}", flush=True)
        return info

    @property
    def ok(self):
        return all(r["ok"] for r in self.records)


def _check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def _first_call(fn, *args, **kw):
    """Run fn once (compiling it) and block; returns (result, seconds)."""
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args, **kw))
    return out, time.perf_counter() - t0


def _png(path, shape):
    import numpy as np

    from raytracing_engine_tpu.utils.image import read_png

    img = read_png(path)
    _check(img.shape == shape, f"{path}: shape {img.shape} != {shape}")
    _check(img.max() > 0, f"{path}: all black")
    return float(np.asarray(img, np.float64).mean())


def _timed(fn, make_args, frames=FRAMES):
    """Median/p90 of `frames` timed calls after 2 warm-up calls."""
    from raytracing_engine_tpu.utils.timing import summarize_ms, time_frames

    return summarize_ms(time_frames(fn, [make_args(i)
                                         for i in range(frames + 2)]))


def _pixel_diff(got, want, tol):
    import numpy as np

    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    _check(got.shape == want.shape, f"shape {got.shape} != {want.shape}")
    _check(np.isfinite(got).all(), "non-finite pixels")
    d = np.abs(got - want)
    if d.ndim == 3:
        d = d.max(-1)
    return {"max_abs": float(d.max()), "mean_abs": float(d.mean()),
            "frac_over_tol": float((d > tol).mean()), "tol": tol}


# ---------------------------------------------------------------- one card

def conemarch_phases(P, scratch):
    import jax
    import jax.numpy as jnp
    import numpy as np

    import raytracing_engine_tpu as rt
    from raytracing_engine_tpu.cli import main as cli
    from raytracing_engine_tpu.models import conemarch, pallas_renderer
    from raytracing_engine_tpu.ops.quaternion import quat_from_rotation_z

    cfg = rt.RenderConfig(width=1920, height=1088)
    scene = rt.default_scene()
    cam = rt.Camera.initial()

    def cli_render():
        out = os.path.join(scratch, "render")
        t0 = time.perf_counter()
        cli(["render", "--size", "1920x1088", "--out", out])
        return {"setup_s": time.perf_counter() - t0,
                "png_mean": _png(os.path.join(out, "frame_0000.png"),
                                 (1088, 1920, 3))}

    def parity_1080p():
        # depth pyramid and image of the Triton route against the XLA
        # cone-march (models/conemarch.py) at full width
        pos, quat = cam.position, cam.quat()
        got = pallas_renderer.render_depth_pyramid(cfg, scene, pos, quat)
        want = conemarch.render_depth_pyramid(cfg, scene, pos, quat)
        depth = []
        for g, w in zip(got, want):
            g, w = np.asarray(g), np.asarray(w)
            rel = np.abs(g - w) / np.maximum(np.abs(w), 1.0)
            depth.append(float((rel > 1e-3).mean()))
        img_g, _ = _first_call(pallas_renderer.render_jit_for(cfg, scene),
                               scene, pos, quat)
        img_w = conemarch.render_jit(cfg, scene, pos, quat)
        img = _pixel_diff(img_g, img_w, 2e-3)
        _check(max(depth) < 5e-3, f"depth levels differ: {depth}")
        _check(img["frac_over_tol"] < 5e-3, f"image differs: {img}")
        return {"depth_frac_rel_over_1e-3": depth, "image": img}

    def golden_64():
        z = np.load(os.path.join(ROOT, "tests", "golden", "golden_64.npz"))
        c64 = rt.RenderConfig(width=64, height=64)
        pos, quat = jnp.asarray(z["pos"]), jnp.asarray(z["quat"])
        img = pallas_renderer.render_jit(c64, scene, pos, quat)
        levels = pallas_renderer.render_depth_pyramid(c64, scene, pos, quat)
        d = max(float(np.abs(np.asarray(lv) - z[f"level_{i}"]).max())
                for i, lv in enumerate(levels))
        res = _pixel_diff(img, z["image"], 2e-3)
        _check(res["max_abs"] < 2e-3 + 1e-3 * np.abs(z["image"]).max(),
               f"golden image differs: {res}")
        return {"image": res, "depth_max_abs": d}

    def frameloop_and_serve():
        from raytracing_engine_tpu.runtime import FrameLoop, InputEvent
        from raytracing_engine_tpu.runtime.serve import render_sequence

        loop = FrameLoop(cfg, scene)
        t0 = time.perf_counter()
        img = jax.block_until_ready(loop.step(InputEvent()))
        setup = time.perf_counter() - t0
        stats = loop.run([InputEvent(move=(0, 1, 0), dt=0.05)] * 8,
                         stats=True)
        _check(np.isfinite(np.asarray(img)).all(), "FrameLoop image")
        yaws = jnp.linspace(0.0, 1.0, 4)
        quats = jnp.stack([quat_from_rotation_z(y) for y in yaws])
        pos = jnp.zeros((4, 3))
        frames, t_seq = _first_call(render_sequence, cfg, scene, pos, quats)
        _check(frames.shape == (4, 3, 1088, 1920), f"{frames.shape}")
        ms = [s.seconds * 1e3 for s in stats]
        return {"frameloop_setup_s": setup,
                "frameloop_ms_median": float(np.median(ms)),
                "render_sequence_first_call_s": t_seq}

    def cli_orbit_replay():
        from raytracing_engine_tpu.runtime import InputEvent
        from raytracing_engine_tpu.runtime.replay import save_replay

        out = os.path.join(scratch, "orbit")
        cli(["orbit", "--size", "1920x1088", "--frames", "4", "--chunk", "2",
             "--out", out])
        orbit = _png(os.path.join(out, "frame_0003.png"), (1088, 1920, 3))
        rp = os.path.join(scratch, "walk.jsonl")
        save_replay(rp, [InputEvent(move=(0, 1, 0), dt=0.05)] * 3
                    + [InputEvent(cursor=(5.0, 0.0))] * 2)
        out = os.path.join(scratch, "replay")
        cli(["replay", rp, "--size", "1920x1088", "--out", out,
             "--chunk", "1"])
        replay = _png(os.path.join(out, "frame_0004.png"), (1088, 1920, 3))
        return {"orbit_png_mean": orbit, "replay_png_mean": replay}

    def bench():
        sys.path.insert(0, ROOT)
        import bench as bench_mod

        return {"bench": bench_mod.main(["--frames", str(FRAMES)])}

    P.run("conemarch_cli_render_1080p", cli_render)
    P.run("conemarch_parity_1080p", parity_1080p)
    P.run("conemarch_golden_64", golden_64)
    P.run("conemarch_frameloop_serve_1080p", frameloop_and_serve)
    P.run("conemarch_cli_orbit_replay_1080p", cli_orbit_replay)
    P.run("conemarch_bench_py", bench)


def pt_phases(P, scratch):
    import dataclasses

    import jax
    import jax.numpy as jnp
    import numpy as np

    from raytracing_engine_tpu.cli import main as cli
    from raytracing_engine_tpu.pathtracer import PTConfig, render_pt_fast
    from raytracing_engine_tpu.pathtracer import scenes as pt_scenes
    from raytracing_engine_tpu.pathtracer.integrator import render_pt

    def cornell():
        out = os.path.join(scratch, "cornell.png")
        t0 = time.perf_counter()
        cli(["pt", "--scene", "cornell", "--size", "512x512", "--spp", "4",
             "--bounces", "4", "--out", out])
        setup = time.perf_counter() - t0
        mean_png = _png(out, (512, 512, 3))
        # statistical parity with the stacked reference integrator: same
        # estimator, same threefry stream (f32 summation order differs)
        cfg = PTConfig(width=512, height=512, max_bounces=4, rng="threefry")
        scene = pt_scenes.cornell_box()
        pos, quat = jnp.array([0.0, 0.2, 0.0]), jnp.array([0.0, 0.0, 0.0, 1.0])
        key = jax.random.PRNGKey(0)
        a, _ = render_pt_fast(cfg, scene, pos, quat, 4, key)
        b, _ = render_pt(cfg, scene, pos, quat, 4, key)
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        d = np.abs(a - b).max(-1)
        rel_mean = abs(a.mean() - b.mean()) / b.mean()
        res = {"setup_s": setup, "png_mean": mean_png,
               "frac_px_over_1e-3": float((d > 1e-3).mean()),
               "image_mean_rel_diff": float(rel_mean)}
        _check(res["frac_px_over_1e-3"] < 0.01 and rel_mean < 1e-3,
               f"fast vs stacked: {res}")
        return res

    def knot():
        res = {}
        for name, extra in [("flat_bvh", []), ("smooth_clusters",
                                               ["--smooth"])]:
            out = os.path.join(scratch, f"knot_{name}.png")
            t0 = time.perf_counter()
            cli(["pt", "--scene", "knot", "--bvh", "--size", "512x512",
                 "--spp", "2", "--bounces", "2", "--out", out] + extra)
            res[name] = {"seconds": time.perf_counter() - t0,
                         "png_mean": _png(out, (512, 512, 3))}
        return res

    def showcase():
        out = os.path.join(scratch, "showcase.png")
        t0 = time.perf_counter()
        cli(["pt", "--scene", os.path.join(ROOT, "examples", "showcase.json"),
             "--bvh", "--size", "512x512", "--spp", "4", "--bounces", "4",
             "--out", out])
        return {"seconds": time.perf_counter() - t0,
                "png_mean": _png(out, (512, 512, 3))}

    P.run("pt_cornell_nee_512", cornell)
    P.run("pt_knot_70k_512", knot)
    P.run("pt_showcase_json_512", showcase)

    def reference_numbers():
        # the numbers a future GPU megakernel must beat
        res = {}
        c2 = PTConfig(width=800, height=608, max_bounces=4, rng="pcg")
        s2 = pt_scenes.material_spheres()
        c4 = PTConfig(width=512, height=512, max_bounces=4, rng="pcg")
        s4 = pt_scenes.cornell_box()
        for name, cfg, scene, pos, spp in [
                ("config2_spheres_800x608_4b_4spp", c2, s2, jnp.zeros(3), 4),
                ("config4_cornell_nee_512_4b_4spp", c4, s4,
                 jnp.array([0.0, 0.2, 0.0]), 4)]:
            quat = jnp.array([0.0, 0.0, 0.0, 1.0])
            fn = jax.jit(lambda s, p, q, k, _c=cfg, _n=spp:
                         render_pt_fast(_c, s, p, q, _n, k)[0])
            _, setup = _first_call(fn, scene, pos, quat,
                                   jax.random.PRNGKey(99))
            res[name] = {"setup_s": setup, **_timed(
                fn, lambda i: (scene, pos, quat, jax.random.PRNGKey(i)))}
        return res

    P.run("timing_render_pt_fast_reference", reference_numbers)


def knot_kernel_phases(P):
    """Cluster kernel vs skip-link BVH on the 70k-triangle knot."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from raytracing_engine_tpu.accel import build_bvh, torus_knot
    from raytracing_engine_tpu.accel.bvh import bvh_intersect
    from raytracing_engine_tpu.accel.clusters import build_clusters
    from raytracing_engine_tpu.ops.pallas.cluster_intersect import (
        cluster_intersect)
    from raytracing_engine_tpu.pathtracer import PTConfig, render_pt_fast
    from raytracing_engine_tpu.pathtracer.scenes import mesh_lit_scene
    from raytracing_engine_tpu.pathtracer.wavefront import _camera_rays

    mesh = torus_knot(segments=1100, sides=32, center=(0.0, 8.0, 0.0))
    t0 = time.perf_counter()
    bvh = build_bvh(mesh)
    cs = build_clusters(mesh, tri_mats=np.zeros(mesh.shape[0], np.int32))
    build_s = time.perf_counter() - t0
    scene = mesh_lit_scene(mesh)
    cfg = PTConfig(width=512, height=512, max_bounces=2, rng="pcg")
    pos, quat = jnp.zeros(3), jnp.array([0.0, 0.0, 0.0, 1.0])

    def parity():
        half = jnp.full((512, 512), 0.5)
        o, d = _camera_rays(cfg, pos, quat, half, half)
        t_c, slot = cluster_intersect(cs, o, d, jnp.inf)
        t_b, ridx, _, _ = bvh_intersect(bvh, jnp.stack(o, -1),
                                        jnp.stack(d, -1))
        t_c, t_b = np.asarray(t_c), np.asarray(t_b)
        hc, hb = np.isfinite(t_c), np.isfinite(t_b)
        both = hc & hb
        rel = np.abs(t_c[both] - t_b[both]) / t_b[both]
        tri_c = np.asarray(cs.perm)[np.asarray(slot)[both]]
        tri_b = np.asarray(bvh.perm)[np.asarray(ridx)[both]]
        res = {"hit_frac": float(hb.mean()),
               "hit_mask_mismatch": float((hc != hb).mean()),
               "t_rel_max": float(rel.max()),
               "tri_id_agree": float((tri_c == tri_b).mean()),
               "tables_build_s": build_s}
        _check(res["hit_frac"] > 0.02, f"camera misses the knot: {res}")
        _check(res["hit_mask_mismatch"] < 1e-3 and res["t_rel_max"] < 1e-4
               and res["tri_id_agree"] > 0.995, f"cluster vs bvh: {res}")
        return res

    def timing():
        res = {}
        for name, accel in [("triton_clusters", cs), ("xla_skiplink_bvh",
                                                      bvh)]:
            fn = jax.jit(lambda s, k, b: render_pt_fast(cfg, s, pos, quat, 1,
                                                        k, bvh=b)[0])
            _, setup = _first_call(fn, scene, jax.random.PRNGKey(99), accel)
            res[name] = {"setup_s": setup, **_timed(
                fn, lambda i: (scene, jax.random.PRNGKey(i), accel))}
        return res

    P.run("cluster_parity_knot_512", parity)
    P.run("timing_knot_512_render_pt_fast_clusters_vs_bvh", timing)


def instanced_phases(P, scratch):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from raytracing_engine_tpu.accel import build_bvh, torus_knot
    from raytracing_engine_tpu.accel.clusters import build_clusters
    from raytracing_engine_tpu.accel.instancing import (
        grid_instances, instanced_intersect)
    from raytracing_engine_tpu.cli import main as cli
    from raytracing_engine_tpu.models.instanced import instanced_camera_rays
    from raytracing_engine_tpu.ops.pallas.instanced_intersect import (
        instanced_cluster_intersect, pack_instances)

    def cli_instanced():
        out = os.path.join(scratch, "instanced")
        t0 = time.perf_counter()
        cli(["instanced", "--size", "1920x1088", "--frames", "2",
             "--grid", "6x5", "--segments", "550", "--out", out])
        return {"seconds": time.perf_counter() - t0,
                "png_mean": _png(os.path.join(out, "frame_0001.png"),
                                 (1088, 1920, 3))}

    P.run("instanced_cli_config5_1080p", cli_instanced)

    mesh = torus_knot(segments=550, sides=32)
    bvh = build_bvh(mesh)
    cs = build_clusters(mesh, bvh=bvh)
    inst = grid_instances(bvh, nx=6, ny=5, spacing=4.0, base=(0.0, 14.0, 0.0),
                          mats=np.arange(30, dtype=np.int32) % 3)
    tab = pack_instances(inst)

    def rays(yaw):
        return instanced_camera_rays(jnp.zeros(3), jnp.float32(yaw),
                                     1920, 1088)

    def parity():
        o, d = rays(0.0)
        t_k, code = instanced_cluster_intersect(tab, cs, o, d,
                                                origin=jnp.zeros(3))
        t_g, gi, _, _ = instanced_intersect(inst, jnp.stack(o, -1),
                                            jnp.stack(d, -1))
        t_k, t_g = np.asarray(t_k), np.asarray(t_g)
        hk, hg = np.isfinite(t_k), np.isfinite(t_g)
        both = hk & hg
        rel = np.abs(t_k[both] - t_g[both]) / t_g[both]
        inst_k = np.asarray(code)[both] // cs.padded_tris
        # a ray through a shared edge can hit one neighbour in one method
        # and slip through the crack to a farther surface in the other
        # (Baldwin-Weber on cluster-rebased rows vs Moller-Trumbore):
        # allow a few such pixels (under 0.1% of the hits), not a
        # systematic difference, which would move most of them
        res = {"triangles": int(inst.total_triangles),
               "hit_frac": float(hg.mean()),
               "hit_mask_mismatch": float((hk != hg).mean()),
               "t_rel_max": float(rel.max()),
               "n_t_rel_over_2e-4": int((rel > 2e-4).sum()),
               "frac_t_rel_over_2e-4": float((rel > 2e-4).mean()),
               "instance_agree": float((inst_k == np.asarray(gi)[both]).mean())}
        _check(res["hit_frac"] > 0.05, f"camera misses the grid: {res}")
        _check(res["hit_mask_mismatch"] < 1e-3
               and res["frac_t_rel_over_2e-4"] < 1e-3
               and res["instance_agree"] > 0.999, f"instanced: {res}")
        return res

    def timing():
        kern = jax.jit(lambda t, c, o, d: instanced_cluster_intersect(
            t, c, o, d, origin=jnp.zeros(3))[0])
        plain = jax.jit(lambda m, o, d: instanced_intersect(
            m, jnp.stack(o, -1), jnp.stack(d, -1))[0])
        res = {}
        for name, fn, first in [("triton_instanced", kern, (tab, cs)),
                                ("xla_plain_instanced", plain, (inst,))]:
            args = lambda i, _f=first: _f + rays(0.01 * i)
            _, setup = _first_call(fn, *args(99))
            res[name] = {"setup_s": setup, **_timed(fn, args)}
        return res

    P.run("instanced_parity_config5_1080p", parity)
    P.run("timing_instanced_config5_1080p_kernel_vs_plain", timing)


def conemarch_timing(P):
    import jax.numpy as jnp

    import raytracing_engine_tpu as rt
    from raytracing_engine_tpu.models import conemarch, pallas_renderer
    from raytracing_engine_tpu.ops.quaternion import quat_from_rotation_z

    scene = rt.default_scene()

    def timing():
        res = {}
        for w, h in [(1920, 1088), (512, 512)]:
            cfg = rt.RenderConfig(width=w, height=h)
            args = lambda i: (scene, jnp.zeros(3),
                              quat_from_rotation_z(jnp.float32(0.1 * i)))
            triton = pallas_renderer.render_jit_for(cfg, scene)
            xla = (lambda s, p, q, _c=cfg: conemarch.render_jit(_c, s, p, q))
            for name, fn in [("triton", triton), ("xla_conemarch", xla)]:
                _, setup = _first_call(fn, *args(99))
                res[f"{w}x{h}_{name}"] = {"setup_s": setup,
                                          **_timed(fn, args)}
        return res

    P.run("timing_conemarch_triton_vs_xla", timing)


def gpu_tests(P):
    def run():
        import pytest

        os.environ["RTE_TEST_DEVICE"] = "gpu"
        rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                          os.path.join(ROOT, "tests", "test_gpu_kernels.py")])
        _check(rc == 0, f"pytest -m gpu exited {rc}")
        return {"pytest_rc": int(rc)}

    P.run("card_only_tests", run)


# -------------------------------------------------------------- four cards

def sharded_phases(P):
    import jax
    import jax.numpy as jnp
    import numpy as np

    import raytracing_engine_tpu as rt
    from raytracing_engine_tpu.models import conemarch
    from raytracing_engine_tpu.parallel import (
        make_mesh, render_instanced_sharded, render_pt_sharded,
        sharded_render_step)
    from raytracing_engine_tpu.pathtracer import PTConfig, render_pt_fast
    from raytracing_engine_tpu.pathtracer import scenes as pt_scenes

    def conemarch_sharded():
        cfg = rt.RenderConfig(width=SHARDED_HD[0], height=SHARDED_HD[1])
        scene = rt.default_scene()
        cam = rt.Camera.initial()
        want = np.asarray(conemarch.render_jit(cfg, scene, cam.position,
                                               cam.quat()))
        res = {}
        for tiles, samples in [(4, 1), (2, 2)]:
            step = sharded_render_step(cfg, make_mesh(tiles, samples))
            got, setup = _first_call(step, scene, cam.position, cam.quat())
            d = _pixel_diff(got, want, 1e-5)
            res[f"{tiles}x{samples}"] = {"setup_s": setup, **d}
            _check(d["frac_over_tol"] < 1e-4, f"{tiles}x{samples}: {d}")
        return res

    def pt_sharded():
        cfg = PTConfig(width=SHARDED_PT, height=SHARDED_PT, max_bounces=4,
                       rng="pcg")
        scene = pt_scenes.cornell_box()
        pos, quat = jnp.array([0.0, 0.2, 0.0]), jnp.array([0.0, 0.0, 0.0, 1.0])
        key = jax.random.PRNGKey(5)
        want, _ = render_pt_fast(cfg, scene, pos, quat, 8, key)
        res = {}
        for tiles, samples in [(4, 1), (2, 2)]:
            got, setup = _first_call(
                render_pt_sharded, cfg, scene, pos, quat, 8, key,
                make_mesh(tiles, samples), soa=True)
            d = _pixel_diff(got[0], want, 1e-4)
            res[f"{tiles}x{samples}"] = {"setup_s": setup, **d}
            _check(d["frac_over_tol"] < 1e-3, f"{tiles}x{samples}: {d}")
        return res

    def instanced_sharded():
        from raytracing_engine_tpu.accel import build_bvh, torus_knot
        from raytracing_engine_tpu.accel.clusters import build_clusters
        from raytracing_engine_tpu.accel.instancing import grid_instances
        from raytracing_engine_tpu.models.instanced import (
            render_instanced_phong)
        from raytracing_engine_tpu.ops.pallas.instanced_intersect import (
            pack_instances)

        nx, ny, segments = SHARDED_GRID
        mesh = torus_knot(segments=segments, sides=32)
        bvh = build_bvh(mesh)
        cs = build_clusters(mesh)
        inst = grid_instances(bvh, nx=nx, ny=ny, spacing=4.0,
                              base=(0.0, 14.0, 0.0),
                              mats=np.arange(nx * ny, dtype=np.int32) % 3)
        tab = pack_instances(inst)
        albedo = jnp.asarray([[0.8, 0.5, 0.3], [0.4, 0.7, 0.5],
                              [0.5, 0.5, 0.8]], jnp.float32)
        light = jnp.asarray([6.0, 2.0, 8.0])
        args = (tab, cs, inst.mat, albedo, jnp.zeros(3), jnp.float32(0.2),
                light)
        w, h = SHARDED_HD
        want = np.asarray(render_instanced_phong(*args, width=w, height=h))
        got, setup = _first_call(render_instanced_sharded, *args,
                                 mesh=make_mesh(4, 1), width=w, height=h)
        d = _pixel_diff(got, want, 1e-4)
        _check(d["frac_over_tol"] < 1e-3, f"instanced 4x1: {d}")
        return {"4x1": {"setup_s": setup, **d}}

    P.run("sharded_conemarch_1080p", conemarch_sharded)
    P.run("sharded_render_pt_fast_cornell_512", pt_sharded)
    P.run("sharded_instanced_config5_1080p", instanced_sharded)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cards", type=int, choices=(1, 4), default=1,
                    help="4: run only the sharded paths, on four cards")
    args = ap.parse_args(argv)

    from raytracing_engine_tpu.utils.devices import (
        card_name_power, device_record, require_gpu)

    devices = require_gpu(args.cards)
    from raytracing_engine_tpu.utils.compile_cache import enable_compile_cache

    card = card_name_power()
    print(card)
    print(f"device_kind: {devices[0].device_kind}; cards: {args.cards}; "
          f"compile cache: {enable_compile_cache() or 'off'}", flush=True)

    P = Phases()
    t_start = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=ROOT, prefix=".smoke_") as scratch:
        if args.cards == 4:
            sharded_phases(P)
        else:
            conemarch_phases(P, scratch)
            pt_phases(P, scratch)
            knot_kernel_phases(P)
            instanced_phases(P, scratch)
            conemarch_timing(P)
            gpu_tests(P)
    peaks = [d.memory_stats().get("peak_bytes_in_use") for d in devices]
    print(f"peak_bytes_in_use: {peaks}; total {time.perf_counter() - t_start:.1f} s",
          flush=True)
    os.makedirs(OUT, exist_ok=True)
    with open(os.path.join(OUT, f"chip_smoke_{args.cards}card.json"), "w") as f:
        json.dump({"card": card, "device": device_record(args.cards),
                   "peak_bytes_in_use": peaks, "phases": P.records}, f,
                  indent=1, default=float)
    if not P.ok:
        failed = [r["phase"] for r in P.records if not r["ok"]]
        print(f"FAILED phases: {failed}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": device_record(args.cards)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
