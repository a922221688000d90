"""Test harness config: force an 8-device virtual CPU mesh so sharding
tests run without an accelerator (multi-device code is validated on a
host-platform mesh, the analogue of the reference's thread-pool
concurrency test at ``graph/src/graph.rs:463-486``)."""

import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

# jax may already be imported before any test code runs (e.g. by a
# sitecustomize), which makes the env var alone too late — force the
# platform through the live config as well.
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
# Persistent compile cache + per-module executable eviction: the full
# suite compiles 100+ distinct programs, and the XLA:CPU compiler has
# been observed to SEGFAULT deep in LLVM once that much compiled state
# accumulates in one process (reproducible at ~suite-end, never in
# isolation). The disk cache makes reruns skip LLVM entirely; clearing
# JAX's executable caches between modules bounds in-process accumulation.
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from hnsw_rs_tpu.utils.cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

import pytest  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _bound_compiled_state():
    yield
    jax.clear_caches()


# Round 3 grew the build-path program diversity enough that the LLVM
# accumulation segfault now fires MID-module (reproducibly at the same
# test_hnsw test, 2/2 runs; same test passes in isolation), so bound
# accumulation within modules too: evict every few tests. The disk cache
# makes the forced recompiles cheap reloads.
_TESTS_PER_CLEAR = 6
_test_counter = {"n": 0}


@pytest.fixture(autouse=True)
def _bound_compiled_state_intra_module():
    yield
    _test_counter["n"] += 1
    if _test_counter["n"] % _TESTS_PER_CLEAR == 0:
        jax.clear_caches()


REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TEST_DATA = os.path.join(REPO_ROOT, "test-data")
