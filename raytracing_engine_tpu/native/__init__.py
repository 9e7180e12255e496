"""Native (C++) runtime components, loaded via ctypes.

The reference's host runtime is native Rust (src/main.rs); this build
keeps the heavy host-side work native too: the BVH builder here, compiled
on first use with g++ (no pybind11 in this image — C ABI + ctypes).
"""

from raytracing_engine_tpu.native.loader import get_bvh_lib, native_available  # noqa: F401
