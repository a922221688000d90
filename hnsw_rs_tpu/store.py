"""Quantized point storage, structure-of-arrays.

device-native equivalent of the reference's ``points`` crate: ``SimplePoints``
(``points/src/points.rs:33-169``) holding ``Point { id, level, QuantVec }``
records (``points/src/point.rs:5-10``) becomes three dense device arrays —
``codes`` uint8[N, d], ``scales`` float32[N, 2] and ``levels`` int32[N] —
with ids being row positions (exactly the reference's id-is-position
contract, ``points/src/points.rs:64-73``).

Level sampling follows ``new_layer`` (``points/src/points.rs:148-160``):
``level = floor(-ln(u) * ml)`` with ``u`` drawn uniform in (0, 1), using a
deterministic seed like the reference's ``StdRng::seed_from_u64(0)``
(``points/src/points.rs:40``).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .ops.distance import l2sq_quant
from .ops.quant import dequantize, quantize, quantize_np

MAX_LEVEL = 31  # safety cap; with ml = 1/ln(m) real levels stay far below


def sample_levels(n: int, ml: float, seed: int = 0) -> np.ndarray:
    """Geometric level sampling, ``floor(-ln(u) * ml)``, u in (0, 1)
    (``points/src/points.rs:148-160``), deterministic in ``seed``."""
    rng = np.random.default_rng(seed)
    u = rng.random(n)
    # the reference redraws u == 0.0 / 1.0; p=0 events with float64 open
    # interval [0,1) except exactly 0.0 — redraw those
    while np.any(u == 0.0):
        u[u == 0.0] = rng.random(int(np.sum(u == 0.0)))
    levels = np.floor(-np.log(u) * ml).astype(np.int32)
    return np.minimum(levels, MAX_LEVEL)


POISON_MIN = 1.0e18  # pad-row dequant value: astronomically far, never top-k


class PointStore:
    """Dense quantized point collection (the ``SimplePoints`` analogue).

    Arrays may carry *capacity* beyond the live count ``len(self)`` so
    that incremental inserts amortize growth (power-of-two capacity keeps
    array shapes — and therefore compiled programs — stable). Padding rows
    are "poisoned": ``scales = (POISON_MIN, 0)`` dequantizes them to a
    vector astronomically far from everything, and ``levels = -1`` keeps
    them out of every layer, so all consumers (search, brute force,
    compliance) work on the capacity arrays unchanged.
    """

    def __init__(
        self, codes: jnp.ndarray, scales: jnp.ndarray, levels: np.ndarray,
        n: int | None = None,
    ):
        self.codes = codes  # uint8[C, d], C = capacity
        self.scales = scales  # f32[C, 2]
        self.levels = np.asarray(levels, np.int32)  # host metadata, len C
        self._n = int(codes.shape[0]) if n is None else int(n)

    @classmethod
    def empty(cls, dim: int) -> "PointStore":
        return cls(
            jnp.zeros((0, dim), jnp.uint8),
            jnp.zeros((0, 2), jnp.float32),
            np.zeros((0,), np.int32),
        )

    @classmethod
    def from_vectors(
        cls, vectors: np.ndarray, ml: float, seed: int = 0
    ) -> "PointStore":
        """Quantize and level-sample a batch of float vectors
        (``SimplePoints::new``, ``points/src/points.rs:39-48``).

        Host (numpy) input is quantized ON HOST and uploaded as u8 codes
        + scales — 4x less host->device traffic than shipping the f32
        vectors to a device-side quantize (same arithmetic/rounding;
        parity pinned in tests/test_quant.py)."""
        if isinstance(vectors, np.ndarray):
            codes_np, scales_np = quantize_np(vectors)
            codes = jnp.asarray(codes_np)
            scales = jnp.asarray(scales_np)
            n = vectors.shape[0]
        else:
            vectors = jnp.asarray(vectors, jnp.float32)
            codes, scales = quantize(vectors)
            n = vectors.shape[0]
        levels = sample_levels(n, ml, seed)
        return cls(codes, scales, levels)

    def __len__(self) -> int:
        return self._n

    @property
    def capacity(self) -> int:
        return int(self.codes.shape[0])

    @property
    def dim(self) -> int | None:
        return int(self.codes.shape[1]) if len(self) else None

    def _grow_to(self, cap: int) -> None:
        """Grow the capacity arrays (next power of two), poisoning pads."""
        old = self.capacity
        if cap <= old:
            return
        d = self.codes.shape[1]
        codes = jnp.zeros((cap, d), jnp.uint8)
        scales = jnp.tile(
            jnp.asarray([[POISON_MIN, 0.0]], jnp.float32), (cap, 1)
        )
        self.codes = jax.lax.dynamic_update_slice(codes, self.codes, (0, 0))
        self.scales = jax.lax.dynamic_update_slice(scales, self.scales, (0, 0))
        self.levels = np.concatenate(
            [self.levels, np.full((cap - old,), -1, np.int32)]
        )

    def ids(self) -> np.ndarray:
        return np.arange(len(self), dtype=np.int32)

    def push(self, vector: np.ndarray, level: int) -> int:
        """Append one point with an explicit level, re-iding it to the
        tail position (``SimplePoints::push``, ``points/src/points.rs:
        64-73``). Returns the new id."""
        other = PointStore(
            *quantize(jnp.asarray(vector, jnp.float32).reshape(1, -1)),
            np.asarray([level], np.int32),
        )
        return int(self.extend(other)[0])

    def extend(self, other: "PointStore") -> np.ndarray:
        """Append another store, re-iding its points to tail positions
        (``SimplePoints::extend``, ``points/src/points.rs:103-116``).
        Returns the new ids. Capacity grows in powers of two; a fresh bulk
        extend into an empty store stays exactly sized (no padding)."""
        start = len(self)
        k = len(other)
        need = start + k
        if start == 0 and self.capacity == 0:
            self.codes = other.codes[:k]
            self.scales = other.scales[:k]
            self.levels = np.asarray(other.levels[:k], np.int32)
            self._n = k
            return np.arange(k, dtype=np.int32)
        if need > self.capacity:
            self._grow_to(max(1 << (need - 1).bit_length(), 64))
        at = jnp.asarray(start, jnp.int32)
        z = jnp.asarray(0, jnp.int32)
        self.codes = jax.lax.dynamic_update_slice(
            self.codes, other.codes[:k], (at, z)
        )
        self.scales = jax.lax.dynamic_update_slice(
            self.scales, other.scales[:k], (at, z)
        )
        self.levels[start:need] = other.levels[:k]
        self._n = need
        return np.arange(start, need, dtype=np.int32)

    def get_values(self, idx) -> np.ndarray:
        """Dequantized float values of point(s) ``idx``
        (``Point::get_vals`` / ``iter_vals``)."""
        return np.asarray(dequantize(self.codes[idx], self.scales[idx]))

    def distance(self, a: int, b: int) -> float:
        """True L2 between stored (quantized) points ``a`` and ``b``
        (``SimplePoints::distance``, ``points/src/points.rs:88-96``)."""
        qa = dequantize(self.codes[a], self.scales[a])
        return float(jnp.sqrt(l2sq_quant(qa, self.codes[b], self.scales[b])))

    def distance_to_vector(self, vector: np.ndarray, idx: int) -> float:
        """L2 from a raw query vector (quantized first, as the reference
        quantizes every query — ``hnsw/src/template.rs:313``) to point
        ``idx`` (``SimplePoints::distance2point``)."""
        qc, qs = quantize(jnp.asarray(vector, jnp.float32))
        q = dequantize(qc, qs)
        return float(jnp.sqrt(l2sq_quant(q, self.codes[idx], self.scales[idx])))
