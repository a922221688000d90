"""Native host runtime (C++ via ctypes).

The reference's host paths (data loading, block IO) are native Rust; the
framework's equivalents live in ``fastio.cpp`` and are compiled on first
use with the system g++ into a cached shared object. Everything degrades
gracefully: if no compiler is available the pure-Python/numpy fallbacks in
``utils`` are used instead.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_CACHE = os.path.expanduser(
    os.environ.get("HNSW_NATIVE_CACHE", "~/.cache/hnsw_rs_tpu")
)
_SRC = os.path.join(_DIR, "fastio.cpp")
_SO = os.path.join(_CACHE, "fastio.so")
_BASE_SRC = os.path.join(_DIR, "baseline_hnsw.cpp")
_BASE_SO = os.path.join(_CACHE, "baseline_hnsw.so")
_lock = threading.Lock()
_lib = None
_tried = False
_base_lib = None
_base_tried = False


def _compile(src: str, so: str) -> str | None:
    os.makedirs(os.path.dirname(so), exist_ok=True)
    if os.path.exists(so) and os.path.getmtime(so) >= os.path.getmtime(src):
        return so
    try:
        subprocess.run(
            ["g++", "-O3", "-march=native", "-shared", "-fPIC", src, "-o", so],
            check=True, capture_output=True, timeout=300,
        )
        return so
    except Exception:
        return None


def _build() -> str | None:
    return _compile(_SRC, _SO)


def get_lib():
    """The loaded native library, or None if unavailable."""
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        so = _build()
        if so is None:
            return None
        try:
            lib = ctypes.CDLL(so)
        except OSError:
            return None
        lib.glove_shape.restype = ctypes.c_int
        lib.glove_shape.argtypes = [
            ctypes.c_char_p, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ]
        lib.glove_parse.restype = ctypes.c_int64
        lib.glove_parse.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_float), ctypes.c_char_p, ctypes.c_int64,
        ]
        lib.pread_block.restype = ctypes.c_int64
        lib.pread_block.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint8),
        ]
        lib.assemble_packed_rows.restype = ctypes.c_int64
        lib.assemble_packed_rows.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint8),
        ]
        lib.quantize_rows.restype = ctypes.c_int64
        lib.quantize_rows.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_float),
        ]
        _lib = lib
        return _lib


def assemble_packed_rows(
    adj_path: str, n: int, cap: int, blocks_path: str, d: int,
    max_per_block: int, ids,
):
    """Native cold-tier packed-row assembly (see fastio.cpp); returns
    u8[K, cap*(d+12)] or None when the native library is unavailable."""
    import numpy as np

    lib = get_lib()
    if lib is None:
        return None
    ids = np.ascontiguousarray(np.asarray(ids, np.int64).ravel())
    out = np.empty((ids.size, cap * (d + 12)), np.uint8)
    got = lib.assemble_packed_rows(
        adj_path.encode(), n, cap, blocks_path.encode(), d, max_per_block,
        ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), ids.size,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    return out if got == ids.size else None


def quantize_rows(x: "np.ndarray"):
    """Fused single-pass per-vector u8 quantization on host (see
    fastio.cpp): returns (codes u8[n, d], scales f32[n, 2]) bit-identical
    to ``ops.quant.quantize_np``, or None when the native library is
    unavailable (callers fall back to numpy). Exists because the numpy
    pipeline makes ~6 full-size passes over the data, a large host-side
    share of a bulk build."""
    lib = get_lib()
    if lib is None:
        return None
    x = np.ascontiguousarray(x, np.float32)
    n, d = x.shape
    codes = np.empty((n, d), np.uint8)
    scales = np.empty((n, 2), np.float32)
    got = lib.quantize_rows(
        x.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n, d,
        codes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        scales.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    return (codes, scales) if got == n else None


WORD_CAP = 64


def load_glove_native(path: str, limit: int = 0):
    """Native GloVe text parse -> (words, float32[N, d]) or None if the
    native library is unavailable (callers fall back to Python)."""
    lib = get_lib()
    if lib is None:
        return None
    n = ctypes.c_int64()
    d = ctypes.c_int64()
    if lib.glove_shape(path.encode(), limit, ctypes.byref(n), ctypes.byref(d)) != 0:
        return None
    n, d = n.value, d.value
    if n <= 0 or d <= 0:
        return None
    out = np.empty((n, d), np.float32)
    words_buf = ctypes.create_string_buffer(n * WORD_CAP)
    got = lib.glove_parse(
        path.encode(), n, d,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        words_buf, WORD_CAP,
    )
    if got < 0:
        if got == -2:
            raise ValueError(f"ragged GloVe row in {path}")
        return None
    raw = words_buf.raw
    words = [
        raw[i * WORD_CAP : (i + 1) * WORD_CAP].split(b"\0", 1)[0].decode("utf-8", "replace")
        for i in range(got)
    ]
    return words, out[:got]


def pread_block(path: str, offset: int, nbytes: int) -> np.ndarray | None:
    """Positioned block read via the native lib (pread), or None."""
    lib = get_lib()
    if lib is None:
        return None
    out = np.empty(nbytes, np.uint8)
    got = lib.pread_block(
        path.encode(), offset, nbytes,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    if got < 0:
        return None
    return out[:got]

# ---------------------------------------------------------------------------
# single-core CPU HNSW baseline (the measured denominator for the
# ">= 50x single-core build rate" north star; see baseline_hnsw.cpp)


def get_baseline_lib():
    """Loaded baseline library, or None if unavailable."""
    global _base_lib, _base_tried
    with _lock:
        if _base_tried:
            return _base_lib
        _base_tried = True
        so = _compile(_BASE_SRC, _BASE_SO)
        if so is None:
            return None
        try:
            lib = ctypes.CDLL(so)
        except OSError:
            return None
        lib.hnsw_baseline_build.restype = ctypes.c_int
        lib.hnsw_baseline_build.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int, ctypes.c_int, ctypes.c_uint64,
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
        ]
        lib.hnsw_baseline_query_rate.restype = ctypes.c_int
        lib.hnsw_baseline_query_rate.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_uint64, ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_int32),
        ]
        _base_lib = lib
        return _base_lib


def baseline_build_rate(
    vectors: "np.ndarray", m: int, ef_cons: int = 0, seed: int = 0
) -> tuple[float, float] | None:
    """Single-core sequential HNSW build on this host's CPU.

    Returns (seconds, vectors_per_second) for the insert loop, or None if
    the native toolchain is unavailable."""
    lib = get_baseline_lib()
    if lib is None:
        return None
    v = np.ascontiguousarray(vectors, np.float32)
    secs = ctypes.c_double()
    rate = ctypes.c_double()
    rc = lib.hnsw_baseline_build(
        v.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        v.shape[0], v.shape[1], m, ef_cons, seed,
        ctypes.byref(secs), ctypes.byref(rate),
    )
    if rc != 0:
        return None
    return secs.value, rate.value


def baseline_query_rate(
    vectors: "np.ndarray", queries: "np.ndarray",
    m: int, ef: int, k: int = 10, ef_cons: int = 0, seed: int = 0,
) -> tuple[float, "np.ndarray"] | None:
    """Single-core one-query-at-a-time HNSW QPS on this host's CPU
    (the role of the reference README's ~300 req/s figure). Returns
    (qps, ids[nq, k]) or None."""
    lib = get_baseline_lib()
    if lib is None:
        return None
    v = np.ascontiguousarray(vectors, np.float32)
    q = np.ascontiguousarray(queries, np.float32)
    qps = ctypes.c_double()
    ids = np.empty((q.shape[0], k), np.int32)
    rc = lib.hnsw_baseline_query_rate(
        v.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        v.shape[0], v.shape[1],
        q.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), q.shape[0],
        m, ef_cons, ef, k, seed, ctypes.byref(qps),
        ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    if rc != 0:
        return None
    return qps.value, ids
