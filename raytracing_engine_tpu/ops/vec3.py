"""Component-plane vec3 helpers.

Layout rule: device code represents 3-vectors as tuples of (H, W)-shaped
component planes rather than trailing (..., 3) axes, so elementwise math
fuses over dense planes. These
helpers keep that code readable. A V3 is any 3-tuple of same-shape arrays.
"""

from __future__ import annotations

import jax.numpy as jnp


def v3(x, y, z):
    return (x, y, z)


def splat(vec, like=None):
    """Lift a (3,) array / tuple of scalars to a V3 (broadcast as needed)."""
    x, y, z = vec[0], vec[1], vec[2]
    if like is not None:
        x = jnp.broadcast_to(x, like.shape).astype(like.dtype)
        y = jnp.broadcast_to(y, like.shape).astype(like.dtype)
        z = jnp.broadcast_to(z, like.shape).astype(like.dtype)
    return (x, y, z)


def add(a, b):
    return (a[0] + b[0], a[1] + b[1], a[2] + b[2])


def sub(a, b):
    return (a[0] - b[0], a[1] - b[1], a[2] - b[2])


def mul(a, b):
    """Elementwise (Hadamard) product of two V3s."""
    return (a[0] * b[0], a[1] * b[1], a[2] * b[2])


def scale(a, s):
    return (a[0] * s, a[1] * s, a[2] * s)


def dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def cross(a, b):
    return (
        a[1] * b[2] - a[2] * b[1],
        a[2] * b[0] - a[0] * b[2],
        a[0] * b[1] - a[1] * b[0],
    )


def length(a):
    return jnp.sqrt(dot(a, a))


def normalize(a):
    n = length(a)
    return (a[0] / n, a[1] / n, a[2] / n), n


def where(cond, a, b):
    return (
        jnp.where(cond, a[0], b[0]),
        jnp.where(cond, a[1], b[1]),
        jnp.where(cond, a[2], b[2]),
    )


def neg(a):
    return (-a[0], -a[1], -a[2])


def stack(a, axis=-1):
    """V3 -> (..., 3) array (host/output boundary only)."""
    return jnp.stack(list(a), axis=axis)


def unstack(arr, axis=-1):
    """(..., 3) array -> V3."""
    x, y, z = jnp.split(arr, 3, axis=axis)
    return (x.squeeze(axis), y.squeeze(axis), z.squeeze(axis))
