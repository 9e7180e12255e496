"""Static render configuration.

The reference keeps these as compile-time constants / specialization
constants (reference src/main.rs:359-364, RENDER_DIST reaches the shaders as
a Vulkan specialization constant at src/main.rs:521,636). Here they live in a
frozen dataclass that is hashable, so it can be a static argument to
``jax.jit`` — the XLA analog of shader specialization.
"""

from __future__ import annotations

import dataclasses
import math
from functools import cached_property

# Fixed capacities — reference shaders/utilities.glsl:2-4. Static shapes are
# exactly what XLA wants; scenes are padded to these and masked by counts.
MAX_MATERIALS = 8
MAX_OBJECTS = 8
MAX_LIGHTS = 8

# Shading constants — reference shaders/fragment.glsl:35-37.
CAM_FALL_OFF = 0.01
LIGHT_FALL_OFF = 0.01
RAY_RADIUS = 0.01


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Hashable static configuration for one renderer specialization.

    width/height: output resolution in pixels (the reference window size).
    render_dist:  ray cutoff distance (reference src/main.rs:362).
    fov:          field-of-view scale (reference src/main.rs:364); the
                  per-axis NDC multiplier is [fov, fov*h/w]
                  (reference src/main.rs:610).
    max_march_steps / max_shadow_steps: bounded-loop trip limits for the
                  data-dependent GLSL while-loops (compute.glsl:44,
                  fragment.glsl:99). The marches also early-exit via
                  ``lax.while_loop`` so these are safety bounds only.
    """

    width: int = 512
    height: int = 512
    render_dist: float = 1000.0
    fov: float = 1.0
    max_march_steps: int = 256
    max_shadow_steps: int = 256
    # Cone-march kernel block (ops/pallas/depth.py block_dims): powers of
    # two, one Triton program per block, whose march stops when the block's
    # own pixels converge; 16x32 measured fastest at 1080p on the H100
    # (PERF.md). Part of this frozen config so kernel specializations key
    # on them under jit.
    tile_h: int = 16
    tile_w: int = 32

    def __post_init__(self):
        if self.width % 8 or self.height % 8:
            raise ValueError(
                "width/height must be multiples of 8 (the reference rounds "
                "the finest pyramid level up to a multiple of 8; we require "
                "it so every level maps exactly onto the output)"
            )
        if self.height > self.width:
            # Reference enforces width >= height on resize
            # (src/main.rs:698-709); the pyramid sizing assumes it.
            raise ValueError("height must be <= width")
        for name in ("tile_h", "tile_w"):
            v = getattr(self, name)
            if v <= 0 or v & (v - 1):
                raise ValueError(f"{name}={v} must be a power of two")

    # ---- depth pyramid geometry -------------------------------------------------
    # The reference builds N storage images, coarsest ~8x8(×aspect), each level
    # 2× finer, finest = window resolution rounded up to a multiple of 8
    # (src/main.rs:203-234). Level count = log2(w/8)+1 (src/main.rs:639 uses
    # floor, the resize path :845 uses ceil; we use ceil deliberately — they
    # agree for power-of-two widths and ceil keeps the finest level >= the
    # window for all widths).

    @cached_property
    def level_count(self) -> int:
        return int(math.ceil(math.log2(self.width / 8.0))) + 1

    @cached_property
    def level_dims(self) -> tuple[tuple[int, int], ...]:
        """(width, height) per pyramid level, coarse → fine.

        Mirrors get_compute_images (reference src/main.rs:209-213):
        ratio = res / (4 << N); dims_i = ceil(2^i * ratio) * 8.
        """
        n = self.level_count
        rx = self.width / float(4 << n)
        ry = self.height / float(4 << n)
        dims = []
        for i in range(n):
            w = int(math.ceil((1 << i) * rx)) * 8
            h = int(math.ceil((1 << i) * ry)) * 8
            dims.append((w, h))
        return tuple(dims)

    def level_image_size(self, i: int) -> tuple[float, float]:
        """Per-level ``imageSize`` push constant: 2^(N-1-i) / window size.

        This is the width of one level-i pixel measured in window pixels,
        divided by the window size — i.e. the reciprocal of the level's
        effective resolution (reference src/main.rs:301-307).
        """
        s = float(1 << (self.level_count - 1 - i))
        return (s / self.width, s / self.height)

    def level_threshold(self, i: int) -> float:
        """Cone-march threshold: sqrt(2) * workgroup(8) * imageSize.x —
        the cone covers the pixel footprint (reference compute.glsl:75)."""
        return math.sqrt(2.0) * 8.0 * self.level_image_size(i)[0]

    @cached_property
    def ratio(self) -> tuple[float, float]:
        """NDC→camera-plane multiplier [FOV, FOV*h/w] (reference src/main.rs:610)."""
        return (self.fov, self.fov * self.height / self.width)

    @property
    def resolution(self) -> tuple[int, int]:
        return (self.width, self.height)
