"""Command-line frame server: render scenes headlessly to PNGs.

The headless counterpart of the reference's windowed app — scripted
camera paths instead of WASD/mouse, PNG frames instead of a swapchain.

Usage:
    python -m raytracing_engine_tpu.cli render  --size 512x512 --out out/
    python -m raytracing_engine_tpu.cli orbit   --frames 60 --out orbit/
    python -m raytracing_engine_tpu.cli pt      --scene cornell --spp 64
    python -m raytracing_engine_tpu.cli pt      --scene knot --spp 16 --bvh
"""

from __future__ import annotations

import argparse
import os
import time


def _parse_size(s: str):
    w, h = s.lower().split("x")
    return int(w), int(h)


def cmd_render(args):
    import jax
    import numpy as np
    import jax.numpy as jnp

    import raytracing_engine_tpu as rt
    from raytracing_engine_tpu.models import pallas_renderer
    from raytracing_engine_tpu.utils import write_png

    w, h = _parse_size(args.size)
    cfg = rt.RenderConfig(width=w, height=h)
    scene = rt.default_scene()
    cam = rt.Camera.initial()
    render = pallas_renderer.render_jit_for(cfg, scene)
    t0 = time.perf_counter()
    img = jax.block_until_ready(render(scene, cam.position, cam.quat()))
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, "frame_0000.png")
    write_png(path, np.asarray(img))
    print(f"{path}  ({time.perf_counter()-t0:.1f}s incl. compile)")


def cmd_orbit(args):
    import jax
    import numpy as np

    import raytracing_engine_tpu as rt
    from raytracing_engine_tpu.camera import Camera, orbit_path
    from raytracing_engine_tpu.models import pallas_renderer
    from raytracing_engine_tpu.utils import write_png
    from raytracing_engine_tpu.utils.timing import FrameStats, conemarch_ray_count

    w, h = _parse_size(args.size)
    cfg = rt.RenderConfig(width=w, height=h)
    scene = rt.default_scene()
    positions, rotations = orbit_path(args.frames)
    # --resume (PNG-dir sink only): skip frames whose file already exists.
    # Orbit poses are a pure function of the frame index, so a resumed run
    # produces bit-identical frames to an uninterrupted one — the
    # animation analog of the path tracer's --checkpoint resume.
    todo = list(range(args.frames))
    if args.resume and not (args.y4m or args.apng):
        todo = [i for i in todo
                if not os.path.exists(
                    os.path.join(args.out, f"frame_{i:04d}.png"))]
        print(f"resume: {args.frames - len(todo)} frames already on disk, "
              f"{len(todo)} to render")
    writer = None
    if args.y4m:
        from raytracing_engine_tpu.utils.video import VideoWriter

        writer = VideoWriter(args.y4m, fps=args.fps)
    elif args.apng:
        from raytracing_engine_tpu.utils.video import ApngWriter

        writer = ApngWriter(args.apng, fps=args.fps)
    else:
        os.makedirs(args.out, exist_ok=True)
    primary, secondary = conemarch_ray_count(cfg, int(scene.light_count))
    if args.chunk > 1:
        # batched serving: K frames per dispatch (runtime/serve.py)
        import jax.numpy as jnp

        from raytracing_engine_tpu.runtime import render_sequence

        n_obj, n_light = int(scene.obj_count), int(scene.light_count)

        def fn(cfg, scene, pos, quat, _n_obj=n_obj, _n_light=n_light):
            return pallas_renderer.render(cfg, scene, pos, quat,
                                          n_obj=_n_obj, n_light=_n_light)

        cams = [Camera(position=positions[i], rotation=rotations[i])
                for i in todo]
        P = jnp.asarray(np.stack([np.asarray(c.position) for c in cams]))
        Q = jnp.asarray(np.stack([np.asarray(c.quat()) for c in cams]))
        for k0 in range(0, len(todo), args.chunk):
            k1 = min(k0 + args.chunk, len(todo))
            t0 = time.perf_counter()
            frames = render_sequence(cfg, scene, P[k0:k1], Q[k0:k1], fn=fn)
            frames = np.moveaxis(np.asarray(frames), 1, -1)
            dt = (time.perf_counter() - t0) / (k1 - k0)
            st = FrameStats(primary, secondary, dt)
            for i, img in zip(todo[k0:k1], frames):
                if writer is not None:
                    writer.add(img)
                else:
                    write_png(os.path.join(args.out, f"frame_{i:04d}.png"),
                              img)
            print(f"frames {todo[k0]:3d}-{todo[k1-1]:3d}: "
                  f"{st.seconds*1e3:7.2f} ms/frame "
                  f"{st.mrays_per_sec:8.1f} Mrays/s (chunked dispatch)")
    else:
        render = pallas_renderer.render_jit_for(cfg, scene)  # static counts
        for i in todo:
            cam = Camera(position=positions[i], rotation=rotations[i])
            t0 = time.perf_counter()
            img = jax.block_until_ready(render(scene, cam.position, cam.quat()))
            st = FrameStats(primary, secondary, time.perf_counter() - t0)
            if writer is not None:
                writer.add(np.asarray(img))
            else:
                write_png(os.path.join(args.out, f"frame_{i:04d}.png"), np.asarray(img))
            print(f"frame {i:3d}: {st.seconds*1e3:7.2f} ms  {st.mrays_per_sec:8.1f} Mrays/s")
    if writer is not None:
        writer.close()
        print(f"{args.y4m or args.apng}: {writer.frames} frames "
              f"@ {args.fps} fps")


def cmd_replay(args):
    """Play a recorded input stream through the frame loop (deterministic:
    same replay file -> bit-identical frames; see runtime/replay.py)."""
    import numpy as np

    import raytracing_engine_tpu as rt
    from raytracing_engine_tpu.runtime import FrameLoop, load_replay
    from raytracing_engine_tpu.utils import write_png

    w, h = _parse_size(args.size)
    cfg = rt.RenderConfig(width=w, height=h)
    scene = rt.default_scene()
    loop = FrameLoop(cfg, scene, monitor=_parse_size(args.monitor))
    events = load_replay(args.replay)

    writer = None
    if args.y4m or args.apng:
        if args.y4m:
            from raytracing_engine_tpu.utils.video import VideoWriter

            writer = VideoWriter(args.y4m, fps=args.fps)
        else:
            from raytracing_engine_tpu.utils.video import ApngWriter

            writer = ApngWriter(args.apng, fps=args.fps)

        def sink(i, img):
            writer.add(img)
    else:
        os.makedirs(args.out, exist_ok=True)

        def sink(i, img):
            write_png(os.path.join(args.out, f"frame_{i:04d}.png"), img)

    stats = loop.run(events, sink=sink, stats=True,
                     chunk=args.chunk if args.chunk > 1 else None)
    if writer is not None:
        writer.close()
    n = len(stats)
    if n:
        ms = sum(s.seconds for s in stats) / n * 1e3
        print(f"{n} frames replayed, {ms:.2f} ms/frame avg")
    else:
        print("0 frames replayed")


def _pt_orbit(args, cfg, scene, bvh, key):
    """Path-traced camera orbit: N low-spp frames around --orbit-target,
    optionally temporal-reprojection accumulated (--temporal — each frame
    inherits the history of the previous poses, the real-time serving
    pattern) and tonemapped; sink = --apng or a PNG directory (--out)."""
    import jax
    import numpy as np
    import jax.numpy as jnp

    from raytracing_engine_tpu.camera import orbit_path
    from raytracing_engine_tpu.ops.quaternion import (
        quat_from_rotation_x,
        quat_from_rotation_z,
        quat_mul,
    )
    from raytracing_engine_tpu.pathtracer import render_pt_fast
    from raytracing_engine_tpu.utils import tonemap, write_png

    positions, rotations = orbit_path(
        args.orbit, radius=args.orbit_radius, height=args.orbit_height,
        target=tuple(args.orbit_target))
    tstate = None
    if args.temporal:
        from raytracing_engine_tpu.pathtracer import (
            render_aovs,
            temporal_init,
            temporal_step,
        )

        tstate = temporal_init(cfg)

    writer = None
    if args.apng:
        from raytracing_engine_tpu.utils.video import ApngWriter

        writer = ApngWriter(args.apng, fps=args.fps)
    else:
        os.makedirs(args.out or "pt_orbit", exist_ok=True)

    t0 = time.perf_counter()
    for i in range(args.orbit):
        yaw, pitch = float(rotations[i][0]), float(rotations[i][1])
        quat = quat_mul(quat_from_rotation_z(jnp.float32(-yaw)),
                        quat_from_rotation_x(jnp.float32(pitch)))
        pos = jnp.asarray(positions[i])
        fkey = jax.random.fold_in(key, i)
        img, _ = render_pt_fast(cfg, scene, pos, quat, args.spp, fkey,
                                bvh=bvh)
        if args.temporal:
            aovs = render_aovs(cfg, scene, pos, quat,
                               min(args.spp, 8), fkey, bvh=bvh)
            tstate, img = temporal_step(cfg, tstate, img, aovs, pos, quat)
        frame = np.asarray(jax.block_until_ready(img))
        if args.tonemap != "none" or args.exposure != 1.0 or args.gamma != 1.0:
            frame = tonemap(frame, args.tonemap, args.exposure, args.gamma)
        if writer is not None:
            writer.add(frame)
        else:
            write_png(os.path.join(args.out or "pt_orbit",
                                   f"frame_{i:04d}.png"), frame)
        if i % 8 == 0:
            print(f"  frame {i}/{args.orbit}")
    if writer is not None:
        writer.close()
        sink = args.apng
    else:
        sink = args.out or "pt_orbit"
    dt = time.perf_counter() - t0
    print(f"{sink}  {args.orbit} frames in {dt:.1f}s "
          f"({dt / args.orbit * 1e3:.0f} ms/frame"
          + (", temporal" if args.temporal else "") + ")")


def _mesh_accel(mesh, tri_mats=None, vertex_normals=None, vertex_uvs=None):
    """Acceleration structure for a triangle mesh, chosen by what the scene
    needs: cluster tables (the Triton cluster kernel) when the mesh carries
    per-vertex normals or UVs — only they interpolate those — and the
    skip-link BVH (plain XLA traversal) otherwise."""
    from raytracing_engine_tpu.accel import build_bvh
    from raytracing_engine_tpu.accel.clusters import build_clusters

    if vertex_normals is None and vertex_uvs is None:
        return build_bvh(mesh)
    return build_clusters(mesh, tri_mats=tri_mats,
                          vertex_normals=vertex_normals,
                          vertex_uvs=vertex_uvs)


def cmd_pt(args):
    import jax
    import numpy as np
    import jax.numpy as jnp

    from raytracing_engine_tpu.pathtracer import PTConfig, render_pt_fast
    from raytracing_engine_tpu.pathtracer import scenes as pt_scenes
    from raytracing_engine_tpu.utils import write_png

    w, h = _parse_size(args.size)
    cfg = PTConfig(width=w, height=h, max_bounces=args.bounces, rng=args.rng,
                   aperture=args.aperture, focus_dist=args.focus,
                   rr_start=args.rr, sampler=args.sampler,
                   fog_density=args.fog, fog_color=tuple(args.fog_color),
                   tex_filter=args.tex_filter)
    bvh = None
    if args.scene.endswith(".json"):
        # declarative scene file (pathtracer/sceneio.py schema)
        from raytracing_engine_tpu.pathtracer.sceneio import load_scene_json

        b = load_scene_json(args.scene)
        scene, mesh, tri_mats = b.scene, b.tris, b.tri_mats
        instanced, tri_normals = b.instanced, b.tri_normals
        pos, quat = jnp.asarray(b.cam_pos), jnp.asarray(b.cam_quat)
        if mesh is not None:
            print(f"{args.scene}: {mesh.shape[0]} triangles"
                  + (" (smooth)" if tri_normals is not None else ""))
            if args.bvh:
                bvh = _mesh_accel(mesh, tri_mats, tri_normals, b.tri_uvs)
        if instanced is not None:
            import numpy as onp

            from raytracing_engine_tpu.accel import build_bvh
            from raytracing_engine_tpu.accel.clusters import build_clusters
            from raytracing_engine_tpu.accel.instancing import (
                make_instanced_clusters,
                make_instances,
            )

            n_inst = len(instanced["transforms"])
            print(f"{args.scene}: {instanced['mesh'].shape[0]} tris x "
                  f"{n_inst} instances (two-level)")
            bvh_i = build_bvh(instanced["mesh"])
            cs_i = build_clusters(
                instanced["mesh"], bvh=bvh_i,
                tri_mats=onp.full(instanced["mesh"].shape[0],
                                  instanced["mat"], onp.int32),
                vertex_uvs=instanced.get("uvs"))
            inst = make_instances(bvh_i, instanced["transforms"],
                                  mats=onp.full(n_inst, instanced["mat"],
                                                onp.int32))
            bvh = make_instanced_clusters(inst, cs_i, scene=scene)
    elif args.scene in ("cornell", "glass"):
        scene = pt_scenes.cornell_box(glass=args.scene == "glass")
        pos, quat = jnp.array([0.0, 0.2, 0.0]), jnp.array([0.0, 0.0, 0.0, 1.0])
    elif args.scene == "spheres":
        scene = pt_scenes.material_spheres()
        pos, quat = jnp.zeros(3), jnp.array([0.0, 0.0, 0.0, 1.0])
    elif args.scene in ("knot", "obj"):
        import numpy as onp

        from raytracing_engine_tpu.accel import load_obj, torus_knot

        vnorms = None
        if args.scene == "obj":
            if not args.mesh:
                raise SystemExit("--scene obj requires --mesh FILE.obj")
            if args.smooth:
                mesh, vnorms = load_obj(args.mesh, normals=True)
            else:
                mesh = load_obj(args.mesh)
            print(f"{args.mesh}: {mesh.shape[0]} triangles")
        else:
            mesh = torus_knot(segments=args.segments, sides=32,
                              center=(0.0, 8.0, 0.0))
        if args.smooth and vnorms is None:
            from raytracing_engine_tpu.accel import smooth_vertex_normals

            vnorms = smooth_vertex_normals(mesh)
        scene = pt_scenes.mesh_lit_scene(mesh)
        if args.bvh:
            bvh = _mesh_accel(mesh, onp.zeros(mesh.shape[0], onp.int32),
                              vnorms)
        pos, quat = jnp.zeros(3), jnp.array([0.0, 0.0, 0.0, 1.0])
    else:
        raise SystemExit(f"unknown scene {args.scene}")

    key = jax.random.PRNGKey(args.seed)
    t0 = time.perf_counter()
    if args.orbit:
        return _pt_orbit(args, cfg, scene, bvh, key)
    if args.checkpoint:
        from raytracing_engine_tpu.runtime.checkpoint import (
            ProgressiveState,
            load_checkpoint,
            progressive_render,
        )

        if os.path.exists(args.checkpoint) and not args.fresh:
            state = load_checkpoint(args.checkpoint)
            print(f"resuming at {state.spp_done} spp")
        else:
            state = ProgressiveState(
                accum=jnp.zeros((h, w, 3), jnp.float32),
                spp_done=0, key=key, cam_pos=pos, cam_quat=quat,
            )
        for state in progressive_render(cfg, scene, state, args.spp,
                                        bvh=bvh, checkpoint_path=args.checkpoint):
            print(f"  {state.spp_done}/{args.spp} spp")
        img = state.image
        nrays = float("nan")
    else:
        img, nrays = render_pt_fast(cfg, scene, pos, quat, args.spp,
                                    key, bvh=bvh)
        img = np.asarray(jax.block_until_ready(img))
    dt = time.perf_counter() - t0
    out = args.out or f"{args.scene}_{args.spp}spp.png"
    if args.denoise:
        from raytracing_engine_tpu.pathtracer import denoise, render_aovs

        aovs_d = render_aovs(cfg, scene, pos, quat, min(args.spp, 16), key,
                             bvh=bvh)
        img = jax.block_until_ready(
            denoise(jnp.asarray(img), aovs_d["albedo"], aovs_d["normal"],
                    aovs_d["depth"]))
    if args.bloom > 0.0:
        from raytracing_engine_tpu.utils import bloom

        img = bloom(np.asarray(img), strength=args.bloom)
    if args.tonemap != "none" or args.exposure != 1.0 or args.gamma != 1.0:
        from raytracing_engine_tpu.utils import tonemap

        img = tonemap(np.asarray(img), args.tonemap, args.exposure,
                      args.gamma)
    write_png(out, np.asarray(img))
    print(f"{out}  {dt:.1f}s  ({float(nrays)/1e6:.1f} Mrays)"
          + ("  [denoised]" if args.denoise else ""))
    if args.aov:
        from raytracing_engine_tpu.pathtracer.aov import render_aovs

        aovs = jax.block_until_ready(
            render_aovs(cfg, scene, pos, quat, min(args.spp, 16), key,
                        bvh=bvh, ao_radius=args.ao_radius))
        stem = out[:-4] if out.endswith(".png") else out
        if "ao" in aovs:
            write_png(f"{stem}_ao.png",
                      np.repeat(np.asarray(aovs["ao"])[..., None], 3, -1))
        write_png(f"{stem}_albedo.png", np.asarray(aovs["albedo"]))
        # normals in [-1,1] -> visualize in [0,1]
        write_png(f"{stem}_normal.png",
                  np.asarray(aovs["normal"]) * 0.5 + 0.5)
        dep = np.asarray(aovs["depth"])
        lo, hi = dep[dep > 0].min() if (dep > 0).any() else 0.0, dep.max()
        dvis = np.where(dep > 0, 1.0 - (dep - lo) / max(hi - lo, 1e-6), 0.0)
        write_png(f"{stem}_depth.png", np.repeat(dvis[..., None], 3, -1))
        print(f"{stem}_{{albedo,normal,depth}}.png  (denoiser guide planes)")


def cmd_instanced(args):
    """Shaded orbit frames of the instanced torus-knot grid (config 5)."""
    import jax
    import numpy as np
    import jax.numpy as jnp

    from raytracing_engine_tpu.accel import build_bvh, torus_knot
    from raytracing_engine_tpu.accel.clusters import build_clusters
    from raytracing_engine_tpu.accel.instancing import grid_instances
    from raytracing_engine_tpu.models.instanced import render_instanced_phong
    from raytracing_engine_tpu.ops.pallas.instanced_intersect import (
        pack_instances,
    )
    from raytracing_engine_tpu.utils import write_png

    w, h = _parse_size(args.size)
    nx, ny = _parse_size(args.grid)
    mesh = torus_knot(segments=args.segments, sides=32)
    bvh = build_bvh(mesh)
    cs = build_clusters(mesh)
    inst = grid_instances(bvh, nx=nx, ny=ny, spacing=4.0,
                          base=(0.0, 14.0, 0.0),
                          mats=np.arange(nx * ny, dtype=np.int32) % 3)
    tab = pack_instances(inst)
    mat_albedo = jnp.asarray(np.array(
        [[0.8, 0.5, 0.3], [0.4, 0.7, 0.5], [0.5, 0.5, 0.8]], np.float32))
    light = jnp.asarray([6.0, 2.0, 8.0])
    print(f"{inst.total_triangles} triangles ({inst.num_instances} instances)")

    os.makedirs(args.out, exist_ok=True)
    for i in range(args.frames):
        yaw = jnp.float32(0.5 * i / max(args.frames - 1, 1))
        t0 = time.perf_counter()
        img = jax.block_until_ready(render_instanced_phong(
            tab, cs, inst.mat, mat_albedo, jnp.zeros(3), yaw, light,
            width=w, height=h, shadows=not args.no_shadows,
            light_radius=args.light_radius,
            shadow_samples=args.shadow_samples))
        write_png(os.path.join(args.out, f"frame_{i:04d}.png"),
                  np.asarray(img))
        print(f"frame {i:3d}: {(time.perf_counter()-t0)*1e3:8.1f} ms")


def main(argv=None):
    ap = argparse.ArgumentParser(prog="raytracing_engine_tpu")
    sub = ap.add_subparsers(dest="cmd", required=True)

    r = sub.add_parser("render", help="single cone-march frame of the default scene")
    r.add_argument("--size", default="512x512")
    r.add_argument("--out", default="out")
    r.set_defaults(fn=cmd_render)

    o = sub.add_parser("orbit", help="camera-orbit sequence (interactive analog)")
    o.add_argument("--size", default="512x512")
    o.add_argument("--frames", type=int, default=60)
    o.add_argument("--out", default="orbit")
    o.add_argument("--apng", default=None,
                   help="write a lossless animated PNG instead of frames/")
    o.add_argument("--resume", action="store_true",
                   help="skip frames already in --out (PNG sink only; "
                        "poses are deterministic, so resumed frames are "
                        "bit-identical to an uninterrupted run)")
    o.add_argument("--y4m", default=None,
                   help="write a YUV4MPEG2 video instead of PNG frames")
    o.add_argument("--fps", type=int, default=30)
    o.add_argument("--chunk", type=int, default=8,
                   help="frames per dispatch (batched serving via "
                        "runtime.serve.render_sequence; 1 = per-frame "
                        "dispatch)")
    o.set_defaults(fn=cmd_orbit)

    rp = sub.add_parser(
        "replay",
        help="play a recorded input stream (runtime/replay.py) deterministically")
    rp.add_argument("replay", help="replay file (JSONL, see runtime/replay.py)")
    rp.add_argument("--size", default="512x512")
    rp.add_argument("--out", default="replay_out")
    rp.add_argument("--y4m", default=None)
    rp.add_argument("--apng", default=None,
                    help="write a lossless animated PNG instead of frames/")
    rp.add_argument("--fps", type=int, default=30)
    rp.add_argument("--monitor", default="1920x1080",
                    help="borderless-fullscreen resolution an F11 event "
                         "switches to (the reference reads the real "
                         "monitor's mode, src/main.rs:689-696)")
    rp.add_argument("--chunk", type=int, default=8,
                    help="frames per dispatch (replay events are known "
                         "ahead; 1 = per-frame dispatch)")
    rp.set_defaults(fn=cmd_replay)

    p = sub.add_parser("pt", help="path-trace a scene")
    p.add_argument("--scene", default="cornell",
                   help="cornell | glass (cornell w/ a dielectric ball) | "
                        "spheres | knot | obj | FILE.json "
                        "(declarative scene, pathtracer/sceneio.py schema)")
    p.add_argument("--mesh", default=None,
                   help="OBJ file for --scene obj (lit by the knot-scene lights)")
    p.add_argument("--size", default="256x256")
    p.add_argument("--spp", type=int, default=16)
    p.add_argument("--bounces", type=int, default=4)
    p.add_argument("--aperture", type=float, default=0.0,
                   help="thin-lens radius, world units (0 = pinhole)")
    p.add_argument("--focus", type=float, default=10.0,
                   help="focus distance along the view axis (with --aperture)")
    p.add_argument("--sampler", default="random", choices=["random", "r2"],
                   help="r2 = low-discrepancy camera/NEE sampling "
                        "(faster convergence; needs --rng pcg)")
    p.add_argument("--rr", type=int, default=0, metavar="BOUNCE",
                   help="Russian-roulette path termination from this bounce "
                        "on (0 = off); unbiased, prunes dim deep paths")
    p.add_argument("--orbit", type=int, default=0, metavar="FRAMES",
                   help="render a path-traced camera orbit instead of one "
                        "frame (sink: --apng or --out dir)")
    p.add_argument("--orbit-radius", type=float, default=10.0)
    p.add_argument("--orbit-height", type=float, default=2.0)
    p.add_argument("--orbit-target", type=float, nargs=3,
                   default=(0.0, 6.0, 0.0))
    p.add_argument("--temporal", action="store_true",
                   help="temporal reprojection accumulation across orbit "
                        "frames (low-spp frames inherit history)")
    p.add_argument("--apng", default=None, metavar="FILE")
    p.add_argument("--fps", type=int, default=30)
    p.add_argument("--aov", action="store_true",
                   help="also write first-hit albedo/normal/depth PNGs "
                        "(denoiser guide planes)")
    p.add_argument("--ao-radius", type=float, default=0.0,
                   help="with --aov: also write a ray-traced ambient-"
                        "occlusion plane probed within this radius")
    p.add_argument("--denoise", action="store_true",
                   help="AOV-guided a-trous denoise of the beauty pass "
                        "(the low-spp real-time pattern)")
    p.add_argument("--fog", type=float, default=0.0, metavar="DENSITY",
                   help="homogeneous Beer-Lambert fog density (0 = off)")
    p.add_argument("--fog-color", type=float, nargs=3,
                   default=(0.0, 0.0, 0.0))
    p.add_argument("--bloom", type=float, default=0.0, metavar="STRENGTH",
                   help="HDR bloom before tonemapping (0 = off)")
    p.add_argument("--tonemap", default="none",
                   choices=["none", "reinhard", "aces"],
                   help="HDR->display curve for the beauty PNG")
    p.add_argument("--exposure", type=float, default=1.0,
                   help="linear radiance scale before tonemapping")
    p.add_argument("--gamma", type=float, default=1.0,
                   help="final 1/gamma encode (2.2 for sRGB-ish output; "
                        "default 1.0 = the reference's linear UNORM present)")
    p.add_argument("--tex-filter",
                   choices=["nearest", "bilinear", "trilinear"],
                   default="nearest", dest="tex_filter",
                   help="atlas texture filtering (images + normal maps; "
                        "trilinear = ray-cone mip LOD, needs a scene "
                        "with tex_mips: true)")
    p.add_argument("--rng", choices=["threefry", "pcg"], default="pcg")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--bvh", action="store_true")
    p.add_argument("--smooth", action="store_true",
                   help="interpolated vertex-normal shading for --scene "
                        "obj/knot (OBJ vn records when present, else "
                        "computed welded-vertex normals; needs --bvh)")
    p.add_argument("--segments", type=int, default=1100)
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--fresh", action="store_true")
    p.add_argument("--out", default=None)
    p.set_defaults(fn=cmd_pt)

    i = sub.add_parser(
        "instanced",
        help="shaded orbit of the 1M-triangle instanced scene (config 5)")
    i.add_argument("--size", default="960x544")
    i.add_argument("--frames", type=int, default=8)
    i.add_argument("--segments", type=int, default=550)
    i.add_argument("--grid", default="6x5")
    i.add_argument("--no-shadows", action="store_true")
    i.add_argument("--light-radius", type=float, default=0.0,
                   help="area-light radius for soft shadows (0 = hard)")
    i.add_argument("--shadow-samples", type=int, default=1,
                   help="shadow rays per pixel (area-light sampling)")
    i.add_argument("--out", default="instanced")
    i.set_defaults(fn=cmd_instanced)

    args = ap.parse_args(argv)
    from raytracing_engine_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    args.fn(args)


if __name__ == "__main__":
    main()
