"""The platform -> implementation table (ops/platform.py) and the compile
cache helper (utils/compile_cache.py)."""

import jax
import jax.numpy as jnp
import pytest

from mam3slam_tpu.ops import platform
from mam3slam_tpu.utils import compile_cache


@pytest.mark.parametrize("name", ["cpu", "rocm"])
def test_non_cuda_platforms_take_xla(name):
    for part in platform.TABLE:
        assert platform.path(part, name) == platform.XLA


@pytest.mark.parametrize("name", ["cuda", "gpu"])
def test_gpu_takes_the_kernel(name):
    assert platform.path("pose", name) == platform.TRITON


def test_no_entry_is_interpret_mode():
    """Every entry names a compiled route: XLA or a GPU kernel route."""
    for part, per_platform in platform.TABLE.items():
        for name, impl in per_platform.items():
            assert impl in (platform.XLA, platform.TRITON), (part, name)
            assert "interpret" not in impl


def test_dispatch_is_decided_at_lowering():
    """``dispatch`` stages both branches; the lowering platform picks one,
    so one traced program compiles to either."""
    impls = {platform.XLA: lambda x: x + 1.0,
             platform.TRITON: lambda x: x * 3.0}
    f = jax.jit(lambda x: platform.dispatch("pose", impls, x))
    x = jnp.ones(4)
    assert float(f(x)[0]) == 2.0  # this process runs on the CPU
    cuda = f.trace(x).lower(lowering_platforms=("cuda",)).as_text()
    cpu = f.trace(x).lower(lowering_platforms=("cpu",)).as_text()
    assert "multiply" in cuda and "multiply" not in cpu
    assert "add" in cpu


def test_unknown_part_raises():
    with pytest.raises(KeyError):
        platform.path("no_such_part", "cuda")


def test_compile_cache_honours_env(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert compile_cache.enable() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before  # nothing set


def test_compile_cache_fixed_path(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        d = compile_cache.enable()
        assert d == compile_cache.DEFAULT_DIR
        assert d == compile_cache.enable()  # the same path every time
        assert d.startswith(compile_cache.CHECKOUT)
        assert jax.config.jax_compilation_cache_dir == d
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
