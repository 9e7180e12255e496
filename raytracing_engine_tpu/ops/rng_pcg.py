"""Counter-based PCG4D hash RNG (pure jnp — fuses into consumers).

PCG4D (Jarzynski & Olano, JCGT 2020 — public domain construction) is ~12
int32 ops per value of pure elementwise work, so XLA fuses it straight into
the consuming kernel instead of materialising uniforms as jax.random's
threefry does: identical on every backend, and high-quality enough for
Monte-Carlo rendering (validated by the furnace/NEE cross-estimator tests,
which hold for any healthy RNG).

Stream layout: value = hash(pixel_x, pixel_y, draw_counter, seed) — fully
counter-based, so any slice of the image draws the same numbers (tile
sharding stays bit-identical to single-device).
"""

from __future__ import annotations

import jax
import numpy as np
import jax.numpy as jnp

# numpy scalars (not jnp arrays): they trace as literals
_M = np.uint32(1664525)
_A = np.uint32(1013904223)


def pcg4d(x, y, z, w):
    """PCG4D hash of four uint32 arrays -> four uint32 arrays."""
    x = x * _M + _A
    y = y * _M + _A
    z = z * _M + _A
    w = w * _M + _A
    x = x + y * w
    y = y + z * x
    z = z + x * y
    w = w + y * z
    x = x ^ (x >> 16)
    y = y ^ (y >> 16)
    z = z ^ (z >> 16)
    w = w ^ (w >> 16)
    x = x + y * w
    y = y + z * x
    z = z + x * y
    w = w + y * z
    return x, y, z, w


def _to_unit(u):
    """uint32 -> float32 in [0, 1) via the 24-bit mantissa scale.
    u>>8 < 2^24 is exact through int32, so the cast never rounds."""
    u24 = jax.lax.bitcast_convert_type(u >> np.uint32(8), jnp.int32)
    return u24.astype(jnp.float32) * np.float32(1.0 / (1 << 24))


def uniform_pcg(seed, ctr: jax.Array | int, n: int, h: int, w: int,
                row0=0, col0=0):
    """(n, h, w) float32 uniforms in [0,1), as a tuple of planes.

    seed: int32/uint32 scalar (traced ok); ctr: draw counter (traced ok) —
    distinct (seed, ctr) pairs give independent planes. Values are keyed by
    GLOBAL pixel coordinates (row0/col0 offset a window into the image), so
    any tiling/sharding of the image draws identical numbers — the property
    that lets the XLA path and shard_map bands share one stream. Works inside Pallas kernels (pure elementwise jnp).
    """
    px = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1)
    py = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0)
    px = (px + col0).astype(jnp.uint32)
    py = (py + row0).astype(jnp.uint32)
    seed = jnp.asarray(seed).astype(jnp.uint32)
    ctr = jnp.asarray(ctr).astype(jnp.uint32)

    planes = []
    blocks = -(-n // 4)
    for b in range(blocks):
        zz = jnp.broadcast_to(ctr * jnp.uint32(blocks) + jnp.uint32(b), (h, w))
        ww = jnp.broadcast_to(seed, (h, w))
        o1, o2, o3, o4 = pcg4d(px, py, zz, ww)
        planes.extend([_to_unit(o1), _to_unit(o2), _to_unit(o3), _to_unit(o4)])
    return tuple(planes[:n])


# additive-recurrence (quasirandom "R_d") alphas, Roberts 2018 — stored as
# exact uint32 fractions so i*alpha mod 1 is computed exactly in wrapping
# uint32 arithmetic (float accumulation would lose the low bits by i~10^4)
_R2_ALPHAS = {
    1: (0.6180339887498949,),
    2: (0.7548776662466927, 0.5698402909980532),
    3: (0.8191725133961645, 0.6710436067037893, 0.5497004779019703),
    4: (0.8566748838545029, 0.7338918566271259,
        0.6287067210378087, 0.5385972572236101),
}
_R2_U32 = {n: tuple(np.uint32(int(round(a * 2.0**32)) & 0xFFFFFFFF)
                    for a in al) for n, al in _R2_ALPHAS.items()}


def r2_planes(seed, gpass, n: int, px, py, channel=0x52AD1A7E):
    """n low-discrepancy unit planes for GLOBAL pass index `gpass`.

    Per-pixel Cranley-Patterson rotation (pcg4d hash of the pixel coords,
    `channel` selects an independent stream) plus the d-dimensional R_d
    additive recurrence i*alpha — pixels are mutually decorrelated while
    each pixel's pass sequence is quasirandom (star discrepancy O(log i/i)
    instead of random's O(sqrt(log log i / i))): AA edges, lens bokeh and
    area-light penumbras converge near-linearly in spp. Counter-based on
    (pixel, gpass, seed) like uniform_pcg — tiling/sharding/chunk
    invariant by the same construction."""
    if n not in _R2_U32:
        raise ValueError(f"r2_planes supports 1-4 dims, got {n}")
    shape = px.shape
    px_u = px.astype(jnp.uint32)
    py_u = py.astype(jnp.uint32)
    seed = jnp.asarray(seed).astype(jnp.uint32)
    i = jnp.asarray(gpass).astype(jnp.uint32)
    zz = jnp.broadcast_to(jnp.uint32(channel), shape)
    ww = jnp.broadcast_to(seed, shape)
    rots = pcg4d(px_u, py_u, zz, ww)
    return tuple(_to_unit(rots[k] + i * _R2_U32[n][k]) for k in range(n))


def uniform_pcg_coords(seed, ctr, n: int, px, py):
    """Like uniform_pcg, but keyed by EXPLICIT int32 coordinate planes.

    The sorted wavefront permutes ray state between bounces; carrying each
    ray's original pixel coordinates through the permutation and hashing on
    them keeps the sample stream identical to the unsorted render, so
    sorting is a pure execution-order optimization (bit-identical images).
    """
    shape = px.shape
    px = px.astype(jnp.uint32)
    py = py.astype(jnp.uint32)
    seed = jnp.asarray(seed).astype(jnp.uint32)
    ctr = jnp.asarray(ctr).astype(jnp.uint32)

    planes = []
    blocks = -(-n // 4)
    for b in range(blocks):
        zz = jnp.broadcast_to(ctr * jnp.uint32(blocks) + jnp.uint32(b), shape)
        ww = jnp.broadcast_to(seed, shape)
        o1, o2, o3, o4 = pcg4d(px, py, zz, ww)
        planes.extend([_to_unit(o1), _to_unit(o2), _to_unit(o3), _to_unit(o4)])
    return tuple(planes[:n])


def key_to_seed(key) -> jnp.ndarray:
    """Derive an int32 seed scalar from a jax PRNG key (any impl)."""
    data = jax.random.key_data(key).astype(jnp.uint32).ravel()
    s = jnp.uint32(0)
    for i in range(data.shape[0]):
        s = s ^ (data[i] * jnp.uint32(2654435761))
    return jax.lax.bitcast_convert_type(s, jnp.int32)
