"""Test harness config: run everything on CPU with 8 virtual devices.

This is the standard JAX fake-backend trick (SURVEY.md §4.4): multi-device
tile/sample sharding is validated without a GPU cluster, and Pallas kernels
run in the interpreter (ops/pallas/common.interpret_mode). Must run before
jax is imported anywhere.

Card-only tests carry the `gpu` marker and request the `gpu` fixture, which
skips them unless JAX runs on a GPU. `chip_smoke.py` runs them on the card:
it sets RTE_TEST_DEVICE=gpu so this file leaves the platform alone.
"""

import os
import sys

ON_CARD = os.environ.get("RTE_TEST_DEVICE") == "gpu"
if not ON_CARD:
    os.environ["JAX_PLATFORMS"] = "cpu"
    _flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in _flags:
        os.environ["XLA_FLAGS"] = (
            _flags + " --xla_force_host_platform_device_count=8"
        ).strip()

# Persistent XLA compile cache: DISABLED for the suite. It was a real
# speedup (test_clusters.py 152 s cold -> 61 s warm), but this jaxlib's
# XLA:CPU executable (de)serialization is unreliable for this repo's
# programs — five full-suite runs produced five fatal-signal worker
# crashes inside compilation_cache.{put,get}_executable_and_time, across
# DIFFERENT tests (frame-sequence executables twice on write, two
# different artifacts on read), surviving per-host-CPU cache keys,
# per-xdist-worker directories, and cache clears. A crash-flaky suite is
# worse than a slower one. Opt back in explicitly by exporting
# JAX_COMPILATION_CACHE_DIR.
os.environ.setdefault("JAX_COMPILATION_CACHE_DIR", "")

# JAX_PLATFORMS is bound to jax.config at import time; if a pytest plugin
# already imported jax (before this conftest), the env var alone is too late.
if "jax" in sys.modules and not ON_CARD:
    import jax

    jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def gpu():
    """Skip unless JAX runs on a GPU (decided when the test runs, never at
    import or collection, so every xdist worker collects the same tests)."""
    import jax

    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU; run through chip_smoke.py")
    return jax.devices()[0]


@pytest.fixture(scope="session")
def small_cfg():
    from raytracing_engine_tpu.config import RenderConfig

    return RenderConfig(width=64, height=64)


@pytest.fixture(scope="session")
def scene():
    from raytracing_engine_tpu.scene import default_scene

    return default_scene()


@pytest.fixture(scope="session")
def camera_pose():
    """A slightly rotated/translated pose so no symmetry hides bugs."""
    import jax.numpy as jnp
    from raytracing_engine_tpu.camera import Camera

    cam = Camera(
        position=jnp.array([0.5, -2.0, 0.25], jnp.float32),
        rotation=jnp.array([0.15, -0.1], jnp.float32),
    )
    return np.asarray(cam.position), np.asarray(cam.quat())


_GOLDEN_NPZ = os.path.join(os.path.dirname(__file__), "golden", "golden_64.npz")


def _stored_golden(camera_pose):
    """Load the committed golden artifact if it matches the fixture pose.
    Regenerate with GOLDEN_REGEN=1 (runs the slow scalar renderer)."""
    if os.environ.get("GOLDEN_REGEN") or not os.path.exists(_GOLDEN_NPZ):
        return None
    z = np.load(_GOLDEN_NPZ)
    pos, quat = camera_pose
    if not (np.allclose(z["pos"], pos) and np.allclose(z["quat"], quat)):
        return None
    return z


@pytest.fixture(scope="session")
def golden_levels(small_cfg, scene, camera_pose):
    z = _stored_golden(camera_pose)
    if z is not None:
        n = small_cfg.level_count
        return [z[f"level_{i}"] for i in range(n)]
    from raytracing_engine_tpu.models import golden

    pos, quat = camera_pose
    return golden.render_depth_pyramid(small_cfg, scene, pos, quat)


@pytest.fixture(scope="session")
def golden_image(small_cfg, scene, camera_pose, golden_levels):
    z = _stored_golden(camera_pose)
    if z is not None:
        return z["image"]
    from raytracing_engine_tpu.models import golden

    pos, quat = camera_pose
    return golden.shade(small_cfg, scene, golden_levels[-1], pos, quat)
