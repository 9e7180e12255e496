"""Pallas kernels for the renderer hot paths (Triton route).

Inside a kernel every per-pixel or per-ray quantity is a 2D block of f32
component planes — vectors (ray dirs, positions, colors) are never
(..., 3) arrays. The <= 8 scene objects/materials/lights are unrolled at
compile time with scalar parameters read once per program — the analog of
the reference's uniform buffer + per-thread loops. `common.py` holds the
route, interpret-mode and block helpers.
"""

from raytracing_engine_tpu.ops.pallas.depth import depth_level_pallas  # noqa: F401
from raytracing_engine_tpu.ops.pallas.shade import shade_pallas  # noqa: F401
