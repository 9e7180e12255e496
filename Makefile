# Convenience targets (see README.md for details)

.PHONY: test test-fast test-core smoke smoke-4 bench benchmarks golden native clean

# CPU: JAX_PLATFORMS=cpu with 8 virtual devices (tests/conftest.py); the
# Pallas kernels run in the interpreter. The persistent XLA compile cache
# is off for the suite (tests/conftest.py explains why).
test:            ## full CPU suite, slow interpret-mode kernel suites included
	JAX_PLATFORMS=cpu python -m pytest tests/ -q -n auto

test-fast:       ## CPU suite without the slow suites (marker: slow)
	JAX_PLATFORMS=cpu python -m pytest tests/ -q -n auto -m "not slow"

test-core:       ## quick correctness core (golden parity, units, lowering)
	JAX_PLATFORMS=cpu python -m pytest -q -n auto -m "not slow" \
	  tests/test_parity_jnp_vs_golden.py tests/test_config.py \
	  tests/test_quaternion.py tests/test_scene.py tests/test_sceneio.py \
	  tests/test_pallas_rng.py tests/test_devices.py \
	  tests/test_triton_lowering.py tests/test_pallas_kernels.py \
	  "tests/test_sharding.py::test_sharded_matches_single_device[8-1]"

# GPU targets: run on a machine with an NVIDIA GPU. Each refuses to run on
# the CPU.
smoke:           ## one card: main paths, parity, timings, pytest -m gpu
	python chip_smoke.py

smoke-4:         ## four cards: the sharded paths only
	python chip_smoke.py --cards 4

bench:           ## 1080p cone-march frame time + Mrays/s
	python bench.py

benchmarks:      ## all BASELINE configs
	python benchmarks/run_all.py

golden:          ## regenerate the stored golden artifact (slow scalar render)
	GOLDEN_REGEN=1 python -m pytest tests/test_parity_jnp_vs_golden.py -q

native:          ## force-rebuild the C++ BVH builder
	rm -rf raytracing_engine_tpu/native/build
	python -c "from raytracing_engine_tpu.native.loader import native_available; print('native:', native_available())"

clean:
	find . -name __pycache__ -type d -exec rm -rf {} + 2>/dev/null; true
