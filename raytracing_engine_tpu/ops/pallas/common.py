"""Shared helpers for the Pallas kernels (Triton route).

Every kernel in this package is written for one block of pixels or rays and
lowered through Pallas' Triton backend. Blocks are powers of two (Triton's
tensor rule); arrays whose sizes are not are padded up to whole blocks by
the wrappers and cropped afterwards. Scene tables are read as scalars, so
they keep their natural shapes.

On the CPU (the test suite) the same kernels run in the Pallas interpreter.
Which of the two a call gets is decided in one place, `interpret_mode`.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton


def interpret_mode() -> bool:
    """True on the CPU backend (Pallas interpreter), False on the GPU.

    Any other backend raises: a kernel must never drop into the
    interpreter on an accelerator without saying so."""
    backend = jax.default_backend()
    if backend == "cpu":
        return True
    if backend == "gpu":
        return False
    raise RuntimeError(
        f"Pallas kernels run on the GPU (Triton) or, for tests, in the CPU "
        f"interpreter; backend {backend!r} is neither")


def resolve_interpret(interpret) -> bool:
    """An explicit `interpret` argument wins; None asks `interpret_mode`."""
    return interpret_mode() if interpret is None else bool(interpret)


def triton_call(kernel, *, out_shape, grid, in_specs, out_specs, interpret,
                name, num_warps=4, num_stages=1):
    """`pl.pallas_call` on the Triton route, with the route named. Four
    warps per program measured best for the 16x32 cone-march block on the
    H100 (PERF.md)."""
    return pl.pallas_call(
        kernel,
        out_shape=out_shape,
        grid=grid,
        in_specs=in_specs,
        out_specs=out_specs,
        interpret=interpret,
        name=name,
        backend="triton",
        compiler_params=pltriton.CompilerParams(num_warps=num_warps,
                                                num_stages=num_stages),
    )


def whole(shape):
    """BlockSpec handing the kernel a whole (small) table for scalar reads."""
    nd = len(shape)
    return pl.BlockSpec(tuple(shape), lambda *_: (0,) * nd)


def block2d(bh: int, bw: int):
    """BlockSpec of one (bh, bw) block per program of a 2D grid."""
    return pl.BlockSpec((bh, bw), lambda i, j: (i, j))


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def pad_to(x, shape):
    """Zero-pad a 2D array at the high end up to `shape`."""
    ph, pw = shape[0] - x.shape[0], shape[1] - x.shape[1]
    if ph == 0 and pw == 0:
        return x
    return jnp.pad(x, ((0, ph), (0, pw)))


def any_true(mask):
    """Scalar OR over a block. (`jnp.any` lowers to reduce_or, which the
    Triton route does not implement; a max over int32 does.)"""
    return jnp.max(mask.astype(jnp.int32)) > 0


def tile_pixel_planes(row0, col0, th: int, tw: int):
    """(rows, cols) f32 planes of global pixel indices for this block."""
    rows = jax.lax.broadcasted_iota(jnp.int32, (th, tw), 0).astype(jnp.float32) + row0
    cols = jax.lax.broadcasted_iota(jnp.int32, (th, tw), 1).astype(jnp.float32) + col0
    return rows, cols


def rotate_planes(qx, qy, qz, qw, vx, vy, vz):
    """Quaternion rotate with scalar q and plane v — utilities.glsl:26-29.

    t = cross(q.xyz, v) + q.w*v;  r = v + 2*cross(q.xyz, t)
    """
    tx = qy * vz - qz * vy + qw * vx
    ty = qz * vx - qx * vz + qw * vy
    tz = qx * vy - qy * vx + qw * vz
    rx = vx + 2.0 * (qy * tz - qz * ty)
    ry = vy + 2.0 * (qz * tx - qx * tz)
    rz = vz + 2.0 * (qx * ty - qy * tx)
    return rx, ry, rz


def ray_dir_planes(ncx, ncy, qx, qy, qz, qw):
    """normalize(rotate(q, (ncx, 1, ncy))) — compute.glsl:77 as planes."""
    vx, vy, vz = ncx, jnp.ones_like(ncx), ncy
    dx, dy, dz = rotate_planes(qx, qy, qz, qw, vx, vy, vz)
    inv = jnp.sqrt(dx * dx + dy * dy + dz * dz)
    return dx / inv, dy / inv, dz / inv


def sphere_sdf_plane(px, py, pz, cx, cy, cz, radius):
    """sphereSDF as planes with scalar center/radius — utilities.glsl:36-38."""
    dx = px - cx
    dy = py - cy
    dz = pz - cz
    return jnp.sqrt(dx * dx + dy * dy + dz * dz) - radius


def dead_slot_mask(count, big, masked):
    """v -> v, or `big` for unrolled slots k >= count (generic kernels);
    the identity when the kernel is specialized to the live slots."""
    if not masked:
        return lambda k, v: v
    return lambda k, v: jnp.where(k < count, v, big)


def read_rows(ref, n_rows: int, n_cols: int):
    """Scalars of a small table as a list of row tuples, read once."""
    return [tuple(ref[k, c] for c in range(n_cols)) for k in range(n_rows)]
