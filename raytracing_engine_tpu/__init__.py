"""raytracing_engine_tpu — a real-time renderer in JAX/Pallas for NVIDIA GPUs.

A brand-new framework with the capabilities of IvoteSligte/raytracing_engine
(Rust + Vulkan + GLSL hierarchical cone-marching SDF renderer):

- the GLSL compute/fragment kernels (reference ``shaders/compute.glsl``,
  ``shaders/fragment.glsl``) become Pallas (Triton) kernels and vectorized jnp
  pipelines over SoA scene buffers (``ops/``, ``models/``),
- the Rust host loop (reference ``src/main.rs:721-928``) becomes a thin
  jitted frame driver with headless camera-path replay (``runtime/``),
- the design extends into a wavefront path tracer with triangle meshes,
  a stackless breadth-ordered BVH and progressive accumulation
  (``pathtracer/``, ``accel/``), per the north star in BASELINE.json,
- multi-card scaling is tile/sample sharding via ``shard_map`` over a
  ``jax.sharding.Mesh`` (``parallel/``).

Layout:
    config.py      static render configuration (RENDER_DIST, FOV, pyramid)
    scene/         SoA scene pytrees + the reference default scene
    camera.py      yaw/pitch camera, quaternion state, input integration
    ops/           device math: quaternion, sdf, raygen, march, shade
    ops/pallas/    Pallas kernels (Triton route) for the hot paths
    models/        renderers: golden (numpy), conemarch (jnp), pallas, wavefront
    accel/         triangle + BVH acceleration structures
    parallel/      mesh / shard_map sharding strategies
    runtime/       frame loop, headless server, checkpointing
    utils/         image io, timing, metrics
"""

__version__ = "0.1.0"

from raytracing_engine_tpu.config import RenderConfig  # noqa: F401
from raytracing_engine_tpu.scene import Scene, default_scene  # noqa: F401
from raytracing_engine_tpu.camera import Camera  # noqa: F401
