"""Runtime helpers: compilation-cache location and the GPU requirement."""

import os
import subprocess
import sys

import jax
import pytest

from tpu_euler.utils import runtime

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def test_cache_dir_from_env(tmp_path):
    """A fresh process: JAX reads the variable at import, and the helper
    neither moves the cache nor adds a subdirectory."""
    path = str(tmp_path / "cache")
    code = (
        "import jax\n"
        "from tpu_euler.utils.runtime import setup_compilation_cache\n"
        "print(setup_compilation_cache())\n"
        "print(jax.config.jax_compilation_cache_dir)\n"
    )
    env = dict(os.environ, JAX_COMPILATION_CACHE_DIR=path, JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120, check=True,
    )
    assert out.stdout.split() == [path, path]
    assert os.path.isdir(path)


def test_cache_dir_default_is_fixed(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    expected = os.path.join(REPO, ".jax_cache")
    assert runtime.setup_compilation_cache() == expected
    assert jax.config.jax_compilation_cache_dir == expected


def test_require_gpu_raises_on_cpu():
    assert jax.default_backend() == "cpu"
    with pytest.raises(RuntimeError, match="no GPU"):
        runtime.require_gpu()
