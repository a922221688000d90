"""Structured logging + profiling shims.

The reference uses the ``log`` crate with ``env_logger`` controlled by
``RUST_LOG`` (``eval_glove/src/main.rs:18``; trace statements throughout
``searcher.rs``/``results.rs``). Equivalent here: stdlib logging under the
``hnsw_rs_tpu`` namespace controlled by ``HNSW_LOG`` (trace/debug/info/
warn/error), plus a JAX-profiler trace context for the device side (the
reference's profiling support is build-config only, ``Cargo.toml:11-20``).
"""

from __future__ import annotations

import contextlib
import logging
import os
import time

TRACE = 5
logging.addLevelName(TRACE, "TRACE")

_LEVELS = {
    "trace": TRACE,
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "warn": logging.WARNING,
    "warning": logging.WARNING,
    "error": logging.ERROR,
}

_configured = False


def _configure() -> None:
    global _configured
    if _configured:
        return
    _configured = True
    level = _LEVELS.get(os.environ.get("HNSW_LOG", "warn").lower(), logging.WARNING)
    root = logging.getLogger("hnsw_rs_tpu")
    root.setLevel(level)
    if not root.handlers:
        h = logging.StreamHandler()
        h.setFormatter(
            logging.Formatter("[%(asctime)s %(levelname)s %(name)s] %(message)s")
        )
        root.addHandler(h)


def get_logger(name: str) -> logging.Logger:
    """Logger under the ``hnsw_rs_tpu`` namespace; level set by
    ``HNSW_LOG`` (the ``RUST_LOG`` analogue)."""
    _configure()
    return logging.getLogger(f"hnsw_rs_tpu.{name}")


@contextlib.contextmanager
def profile_trace(path: str = "/tmp/hnsw_rs_tpu_trace"):
    """Capture a JAX profiler trace (viewable in TensorBoard/XProf) around
    a block — the device-side analogue of criterion timing harnesses."""
    import jax

    jax.profiler.start_trace(path)
    try:
        yield path
    finally:
        jax.profiler.stop_trace()


@contextlib.contextmanager
def timed(label: str, logger: logging.Logger | None = None):
    """Host wall-clock timer; logs at INFO."""
    t0 = time.perf_counter()
    yield
    dt = time.perf_counter() - t0
    (logger or get_logger("timing")).info("%s: %.4fs", label, dt)
