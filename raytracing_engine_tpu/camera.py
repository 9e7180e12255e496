"""Camera state and input integration.

Mirrors the reference's FPS-style camera (reference src/main.rs:343-415,
721-775): absolute yaw/pitch angles, quaternion
``from_rotation_z(-yaw) * from_rotation_x(pitch)`` (src/main.rs:402-404),
movement vectors rotated into the camera frame and ACCUMULATED into the
world-space position (src/main.rs:772 — ``pos`` accumulates across frames).
Coordinate convention: Z-up, Y-forward, X-right (src/main.rs:350-357).

There is no window system on a headless host; interaction becomes scripted input
streams / camera paths replayed through the same integration math, so
interactive parity is testable (SURVEY.md §7).
"""

from __future__ import annotations

import dataclasses
import math

import jax
import jax.numpy as jnp

from raytracing_engine_tpu.ops.quaternion import (
    quat_from_rotation_x,
    quat_from_rotation_z,
    quat_mul,
    quat_rotate,
)

# reference src/main.rs:344-348
MOVEMENT_SPEED = 25.0
ROTATION_SPEED = 1.0
MOUSE_SPEED = 1.0

_HALF_PI = 0.5 * math.pi


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class Camera:
    """position: (3,) world-space f32; rotation: (2,) [yaw, pitch] radians."""

    position: jax.Array
    rotation: jax.Array

    @staticmethod
    def initial() -> "Camera":
        return Camera(
            position=jnp.zeros((3,), jnp.float32),
            rotation=jnp.zeros((2,), jnp.float32),
        )

    def quat(self) -> jax.Array:
        """Camera quaternion [x,y,z,w] — reference src/main.rs:402-404."""
        return quat_mul(
            quat_from_rotation_z(-self.rotation[0]),
            quat_from_rotation_x(self.rotation[1]),
        )


def integrate_input(
    cam: Camera,
    move: jax.Array,       # (3,) [right, forward, up] key axes in {-1,0,1}
    rot_keys: jax.Array,   # (2,) [yaw, pitch] arrow-key axes in {-1,0,1}
    cursor_delta: jax.Array,  # (2,) raw mouse delta in px
    dt: jax.Array,         # scalar seconds since last update
    window_width: jax.Array,  # scalar px (mouse scaling divides by width)
) -> Camera:
    """One frame of input integration — reference src/main.rs:732-775.

    mouse:   rotation += cursor_delta / window_width * ROTATION * MOUSE
    arrows:  rotation += rot_keys * dt * ROTATION
    pitch clamped to ±π/2 (src/main.rs:770)
    movement: camera-frame axes scaled by dt * MOVEMENT, rotated into world
              by the (post-update) camera quaternion, accumulated.
    """
    rotation = cam.rotation + cursor_delta / window_width * ROTATION_SPEED * MOUSE_SPEED
    rotation = rotation + rot_keys * (dt * ROTATION_SPEED)
    rotation = rotation.at[1].set(jnp.clip(rotation[1], -_HALF_PI, _HALF_PI))

    new_cam = Camera(position=cam.position, rotation=rotation)
    q = new_cam.quat()
    # reference src/main.rs:406-414: world-space basis of the camera frame
    right = quat_rotate(q, jnp.array([1.0, 0.0, 0.0], jnp.float32))
    forward = quat_rotate(q, jnp.array([0.0, 1.0, 0.0], jnp.float32))
    up = quat_rotate(q, jnp.array([0.0, 0.0, 1.0], jnp.float32))
    delta = move * (dt * MOVEMENT_SPEED)
    world_delta = delta[0] * right + delta[1] * forward + delta[2] * up
    return Camera(position=cam.position + world_delta, rotation=rotation)


def orbit_path(num_frames: int, radius: float = 20.0, height: float = 2.0,
               target=(2.0, 3.0, 1.0)):
    """A scripted camera orbit: positions + yaw/pitch per frame (host-side).

    Returns (positions (F,3), rotations (F,2)) as numpy-compatible jnp arrays.
    Used by the headless frame server and the interactive-orbit benchmark
    (BASELINE.json config 5).
    """
    import numpy as np

    t = np.linspace(0.0, 2.0 * np.pi, num_frames, endpoint=False)
    tx, ty, tz = target
    px = tx + radius * np.sin(t)
    py = ty - radius * np.cos(t)
    pz = np.full_like(t, height)
    positions = np.stack([px, py, pz], axis=-1).astype(np.float32)
    # The camera quat is from_rotation_z(-yaw)*from_rotation_x(pitch), which
    # maps forward (0,1,0) to (sin(yaw)cos(pitch), cos(yaw)cos(pitch),
    # sin(pitch)); aim it at the target:
    yaw = np.arctan2(tx - px, ty - py)
    pitch = np.arctan2(tz - pz, np.hypot(tx - px, ty - py))
    rotations = np.stack([yaw, pitch], axis=-1).astype(np.float32)
    return jnp.asarray(positions), jnp.asarray(rotations)
