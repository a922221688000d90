"""The compile-cache location: ``JAX_COMPILATION_CACHE_DIR`` when set,
else the fixed repo-local ``.jax_cache``."""

import os

import pytest

from conftest import REPO_ROOT
from hnsw_rs_tpu.utils import cache


@pytest.mark.parametrize("env", ["/some/cache/dir", None])
def test_compile_cache_dir(monkeypatch, env):
    if env is None:
        monkeypatch.delenv(cache.ENV_VAR, raising=False)
        want = os.path.join(REPO_ROOT, ".jax_cache")
    else:
        monkeypatch.setenv(cache.ENV_VAR, env)
        want = env
    assert cache.compile_cache_dir() == want
