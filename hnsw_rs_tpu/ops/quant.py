"""Per-vector 8-bit scalar quantization (LVQ-1 style), structure-of-arrays.

device-native equivalent of the reference's ``QuantVec``
(``vectors/src/quant.rs:7-66``): each vector stores a per-vector ``min`` and
``delta = (max - min) / 255`` plus uint8 codes
``floor((x - min) / delta + 0.5)``. Instead of one heap object per vector we
keep the whole collection as two dense device arrays:

- ``codes``:  uint8[N, d]
- ``scales``: float32[N, 2]   (column 0 = min, column 1 = delta)

Dequantized value: ``codes * delta + min`` (``vectors/src/quant.rs:79-83``).

All ops are pure jnp functions, shape-polymorphic over leading batch dims, so
they fuse under jit and vectorize.
"""

from __future__ import annotations

import jax.numpy as jnp

BITS = 8
LEVELS = float(2**BITS - 1)  # 255


def quantize(x: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Quantize float vectors to (codes, scales).

    ``x``: float[..., d]  →  codes uint8[..., d], scales float32[..., 2].

    Matches the reference rounding exactly (``vectors/src/quant.rs:41-66``):
    ``delta = (max - min) / 255``; ``code = floor((x - min)/delta + 0.5)``,
    saturating-cast to u8 (Rust ``as u8`` clamps; NaN from a 0/0 when
    ``delta == 0`` becomes 0 — we make that explicit with a where).
    """
    x = jnp.asarray(x, jnp.float32)
    mn = jnp.min(x, axis=-1, keepdims=True)
    mx = jnp.max(x, axis=-1, keepdims=True)
    delta = (mx - mn) / LEVELS
    t = jnp.where(delta > 0.0, (x - mn) / jnp.where(delta > 0.0, delta, 1.0), 0.0)
    codes = jnp.clip(jnp.floor(t + 0.5), 0.0, LEVELS).astype(jnp.uint8)
    scales = jnp.concatenate([mn, delta], axis=-1).astype(jnp.float32)
    return codes, scales


def quantize_np(x) -> tuple:
    """Numpy twin of :func:`quantize` for HOST-side quantization.

    Same arithmetic, same reference rounding (``vectors/src/quant.rs:
    41-66``): IEEE-754 f32 min/max/sub/div/floor, so codes match the
    device path bit-for-bit on XLA:CPU (pinned by
    ``tests/test_quant.py::test_host_quantize_matches_device``). Exists
    so bulk builds can upload ``uint8`` codes + 8 B/point scales instead
    of the raw f32 vectors — 4x less host->device traffic.

    Dispatches to the native fused single-pass kernel when available
    (``native.quantize_rows`` — the numpy pipeline below makes ~6
    full-size passes + temps); both paths are bit-identical (tests/test_native.py)."""
    import numpy as np

    x = np.asarray(x, np.float32)
    if x.ndim == 2 and x.shape[0] >= 1024:  # native pays off in bulk
        from ..native import quantize_rows

        out = quantize_rows(x)
        if out is not None:
            return out
    mn = np.min(x, axis=-1, keepdims=True)
    mx = np.max(x, axis=-1, keepdims=True)
    delta = (mx - mn) / np.float32(LEVELS)
    safe = np.where(delta > 0.0, delta, 1.0).astype(np.float32)
    t = np.where(delta > 0.0, (x - mn) / safe, 0.0).astype(np.float32)
    codes = np.clip(np.floor(t + np.float32(0.5)), 0.0, LEVELS).astype(np.uint8)
    scales = np.concatenate([mn, delta], axis=-1).astype(np.float32)
    return codes, scales


def dequantize(codes: jnp.ndarray, scales: jnp.ndarray) -> jnp.ndarray:
    """Dequantize codes back to float32: ``codes * delta + min``.

    ``codes``: uint8[..., d], ``scales``: float32[..., 2] → float32[..., d].
    Mirrors ``QuantVec::iter_vals`` (``vectors/src/quant.rs:79-83``).
    """
    mn = scales[..., 0:1]
    delta = scales[..., 1:2]
    return codes.astype(jnp.float32) * delta + mn
