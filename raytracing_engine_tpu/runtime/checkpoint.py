"""Checkpoint / resume for progressive accumulation.

The reference is stateless per frame (SURVEY.md §5 — camera state dies with
the process); progressive 1024-spp accumulation (BASELINE config 4) needs
restartability: (accumulated radiance, spp done, RNG key, camera pose) is
the complete state of a progressive render. Stored as a plain .npz — no
framework lock-in, loadable anywhere.
"""

from __future__ import annotations

import dataclasses
import functools
import os

import numpy as np
import jax
import jax.numpy as jnp


@functools.partial(jax.jit, donate_argnums=(0,))
def _accumulate_donated(accum, img, n):
    return accum + img * n


def _accumulate(accum, img, n):
    """Add a chunk into the running sum, DONATING the old accumulator: XLA
    reuses its buffer in place instead of allocating a new (H, W, 3) every
    chunk — the frames-in-flight buffer-reuse analog (SURVEY.md §2.5,
    src/main.rs:882-927 per-image fences). The donated array is consumed:
    callers must not reuse a ProgressiveState after advancing past it.
    (CPU backends don't implement donation — plain add, avoids the warning.)
    """
    if jax.default_backend() == "cpu":
        return accum + img * n
    return _accumulate_donated(accum, img, n)


@dataclasses.dataclass
class ProgressiveState:
    accum: jnp.ndarray      # (H, W, 3) SUM of per-pass radiance (not mean)
    spp_done: int
    key: jnp.ndarray        # base PRNG key (pass i uses fold_in(key, i))
    cam_pos: jnp.ndarray    # (3,)
    cam_quat: jnp.ndarray   # (4,)

    @property
    def image(self) -> np.ndarray:
        """Current mean image."""
        return np.asarray(self.accum) / max(self.spp_done, 1)


def save_checkpoint(path: str, state: ProgressiveState) -> None:
    tmp = path + ".tmp"
    np.savez(
        tmp,
        accum=np.asarray(state.accum),
        spp_done=np.int64(state.spp_done),
        key=np.asarray(state.key),
        cam_pos=np.asarray(state.cam_pos),
        cam_quat=np.asarray(state.cam_quat),
    )
    os.replace(tmp + ".npz" if not tmp.endswith(".npz") else tmp, path)


def load_checkpoint(path: str) -> ProgressiveState:
    z = np.load(path)
    return ProgressiveState(
        accum=jnp.asarray(z["accum"]),
        spp_done=int(z["spp_done"]),
        key=jnp.asarray(z["key"]),
        cam_pos=jnp.asarray(z["cam_pos"]),
        cam_quat=jnp.asarray(z["cam_quat"]),
    )


def progressive_render(
    cfg,
    scene,
    state: ProgressiveState,
    target_spp: int,
    passes_per_chunk: int = 16,
    bvh=None,
    checkpoint_path: str | None = None,
    fast: bool = True,
    donate: bool = True,
    mesh=None,
):
    """Advance a progressive render to target_spp in resumable chunks.

    Yields the state after each chunk (also checkpointing if a path is
    given), so a killed job resumes exactly — pass i always uses
    fold_in(key, i), making the result independent of chunking.

    mesh: optional jax.sharding.Mesh — each chunk then renders SPMD via
    parallel.render_pt_sharded (soa=fast: the same wavefront passes as
    render_pt_fast, per device band). Pass streams are keyed by GLOBAL
    pass index, so a job checkpointed on one mesh shape RESUMES on any
    other (or on a single device) and accumulates the same sample set —
    multi-chip 1024-spp jobs survive preemption and reshaping (VERDICT
    round-2 item 6).

    donate=True (default) reuses the accumulation buffer in place each
    chunk — including the buffer of the state passed in and of every state
    previously yielded: treat each yielded state as valid only until the
    next chunk (its .accum is consumed). Pass donate=False to retain
    intermediate states (costs one (H, W, 3) allocation per chunk).
    """
    if mesh is not None:
        from raytracing_engine_tpu.parallel import render_pt_sharded

        def render_fn(cfg, scene, pos, quat, n, key, bvh=None, spp_offset=0):
            return render_pt_sharded(cfg, scene, pos, quat, n, key, mesh,
                                     bvh=bvh, soa=fast,
                                     spp_offset=spp_offset)
    elif fast:
        from raytracing_engine_tpu.pathtracer.wavefront import render_pt_fast as render_fn
    else:
        from raytracing_engine_tpu.pathtracer.integrator import render_pt as render_fn

    while state.spp_done < target_spp:
        n = min(passes_per_chunk, target_spp - state.spp_done)
        # pass i (globally) always uses fold_in(key, i) via spp_offset, so
        # the accumulated result is independent of chunk boundaries
        img, _ = render_fn(
            cfg, scene, state.cam_pos, state.cam_quat, n, state.key,
            bvh=bvh, spp_offset=jnp.int32(state.spp_done),
        )
        add = _accumulate if donate else (lambda a, b, m: a + b * m)
        state = ProgressiveState(
            accum=add(state.accum, img, jnp.float32(n)),
            spp_done=state.spp_done + n,
            key=state.key,
            cam_pos=state.cam_pos,
            cam_quat=state.cam_quat,
        )
        if checkpoint_path:
            save_checkpoint(checkpoint_path, state)
        yield state
