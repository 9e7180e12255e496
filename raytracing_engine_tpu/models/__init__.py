"""Renderer model families.

- ``golden``      — scalar numpy reference (the missing upstream tests' anchor)
- ``conemarch``   — vectorized jnp depth-pyramid renderer (reference parity)
- ``pallas_renderer`` — Pallas (Triton) kernels for depth + shading (production)
- ``instanced``   — shaded frames of instanced meshes (BASELINE config 5)
"""
