"""Wavefront path tracer — the north-star extension (BASELINE.json).

Beyond reference parity (the cone-march renderer reproduces
shaders/compute.glsl + fragment.glsl), this subsystem extends the engine per
the driver-set north star: SoA ray buffers in HBM, wavefront stages
(ray-gen → intersect → shade) over a `lax.fori_loop` bounce loop, triangle
meshes with a stackless breadth-ordered BVH, next-event estimation,
progressive multi-spp accumulation with checkpoint/resume, and tile/spp
sharding over a device mesh. Production shading surface on top:
dielectrics, env lights, checker textures, fog, thin-lens DOF, Russian
roulette, R_d low-discrepancy sampling, power-weighted light selection,
first-hit AOVs + à-trous denoising, and temporal reprojection
accumulation (see DESIGN.md §8b).
"""

from raytracing_engine_tpu.pathtracer.scene import (  # noqa: F401
    PTScene,
    DIFFUSE,
    MIRROR,
    EMISSIVE,
    DIELECTRIC,
)
from raytracing_engine_tpu.pathtracer.integrator import (  # noqa: F401
    render_pt,
    PTConfig,
)
from raytracing_engine_tpu.pathtracer.wavefront import render_pt_fast  # noqa: F401
from raytracing_engine_tpu.pathtracer.sceneio import load_scene_json  # noqa: F401
from raytracing_engine_tpu.pathtracer.aov import render_aovs  # noqa: F401
from raytracing_engine_tpu.pathtracer.denoise import denoise  # noqa: F401
from raytracing_engine_tpu.pathtracer.temporal import (  # noqa: F401
    TemporalState,
    temporal_init,
    temporal_noise,
    temporal_step,
)

