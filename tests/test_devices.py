"""The one place that picks interpret mode, the device check the measuring
scripts use, and the compile-cache helper of the entry points."""

import os

import jax
import pytest

from raytracing_engine_tpu.ops.pallas import common
from raytracing_engine_tpu.utils import compile_cache, devices


def test_interpret_mode_on_cpu():
    assert jax.default_backend() == "cpu"
    assert common.interpret_mode() is True
    assert common.resolve_interpret(None) is True
    assert common.resolve_interpret(False) is False


@pytest.mark.parametrize("backend,want", [("gpu", False), ("metal", None),
                                          ("rocm", None)])
def test_interpret_mode_by_backend(monkeypatch, backend, want):
    """GPU compiles through Triton; any other accelerator raises instead
    of dropping into the interpreter."""
    monkeypatch.setattr(common.jax, "default_backend", lambda: backend)
    if want is None:
        with pytest.raises(RuntimeError, match=backend):
            common.interpret_mode()
    else:
        assert common.interpret_mode() is want


def test_require_gpu_refuses_cpu():
    with pytest.raises(SystemExit, match="cpu"):
        devices.require_gpu()


def test_device_record_names_the_device():
    rec = devices.device_record()
    assert rec["platform"] == "cpu"
    assert rec["count"] == len(jax.devices())
    assert isinstance(rec["kind"], str) and rec["kind"]
    assert devices.device_record(count=1)["count"] == 1


def test_card_name_power_never_raises():
    assert isinstance(devices.card_name_power(), str)


def test_compile_cache_env_wins(monkeypatch):
    """A set JAX_COMPILATION_CACHE_DIR (the suite sets it empty: cache off)
    is used as is, and nothing else is configured."""
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: calls.append(a))
    monkeypatch.setenv(compile_cache.ENV, "")
    assert compile_cache.enable_compile_cache() == ""
    monkeypatch.setenv(compile_cache.ENV, "/some/dir")
    assert compile_cache.enable_compile_cache() == "/some/dir"
    assert calls == []


def test_compile_cache_default_is_fixed_repo_dir(monkeypatch):
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: calls.append(a))
    monkeypatch.delenv(compile_cache.ENV, raising=False)
    got = compile_cache.enable_compile_cache()
    assert got == compile_cache.DEFAULT_DIR
    assert got == os.path.join(compile_cache.REPO_ROOT, ".jax_cache")
    assert os.path.isdir(os.path.join(compile_cache.REPO_ROOT,
                                      "raytracing_engine_tpu"))
    assert calls == [("jax_compilation_cache_dir", got)]
