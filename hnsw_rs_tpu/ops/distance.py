"""Batched L2 distance kernels over quantized vectors.

device-native equivalent of ``QuantVec::distance_unrolled``
(``vectors/src/quant.rs:14-37``) and ``FullVec::distance``
(``vectors/src/full.rs:23-29``). The reference dequantizes on the fly inside
an 8-lane unrolled scalar loop; here the same math is expressed as dense
array ops so XLA fuses dequantize + subtract + square + reduce,
and the all-pairs form is a matmul.

Distances are computed and compared as *squared* L2 internally (monotonic in
the true distance, so every ordering/threshold decision is unchanged);
``sqrt`` is applied only at API boundaries to match the reference's returned
values.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .quant import dequantize


def l2sq(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Elementwise-broadcast squared L2 over the last axis, float32."""
    a = jnp.asarray(a, jnp.float32)
    b = jnp.asarray(b, jnp.float32)
    d = a - b
    return jnp.sum(d * d, axis=-1)


def l2(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """True L2 (sqrt of :func:`l2sq`), the reference's ``distance`` value."""
    return jnp.sqrt(l2sq(a, b))


def l2sq_quant(q: jnp.ndarray, codes: jnp.ndarray, scales: jnp.ndarray) -> jnp.ndarray:
    """Squared L2 from dequantized query ``q`` to quantized points.

    ``q``: float32[..., d] broadcastable against ``codes``: uint8[..., d].
    Fused dequantize-then-subtract, the batched analogue of
    ``distance_unrolled`` (``vectors/src/quant.rs:14-37``).
    """
    return l2sq(q, dequantize(codes, scales))


def pairwise_l2sq_exact(
    q: jnp.ndarray, codes: jnp.ndarray, scales: jnp.ndarray
) -> jnp.ndarray:
    """All-pairs squared L2, direct form: [B, d] x [N, d] -> [B, N].

    Numerically exact (no |a|^2+|b|^2-2ab cancellation); used as the
    ground-truth oracle for recall tests (the batched analogue of
    ``brute_force_nns``, ``hnsw/src/helpers/glove.rs:73-109``).
    Memory: materializes [B, N, d]; keep B modest or use the matmul form.
    """
    x = dequantize(codes, scales)  # [N, d]
    diff = q[:, None, :] - x[None, :, :]
    return jnp.sum(diff * diff, axis=-1)


def pairwise_l2sq_mxu(
    q: jnp.ndarray,
    codes: jnp.ndarray,
    scales: jnp.ndarray,
    normsq: jnp.ndarray | None = None,
) -> jnp.ndarray:
    """All-pairs squared L2 via one matmul: |q|^2 + |x|^2 - 2 q.x -> [B, N].

    Exploits the affine structure of the quantized points
    (``x_j = delta_j * c_j + min_j``) so the only O(B*N*d) work is one
    ``q @ codes.T`` matmul:

        q.x_j = delta_j * (q . c_j) + min_j * sum(q)

    ``normsq`` (float32[N], = |x_j|^2) can be precomputed once per index.
    """
    q = jnp.asarray(q, jnp.float32)
    mn = scales[:, 0]
    delta = scales[:, 1]
    if normsq is None:
        normsq = point_normsq(codes, scales)
    # HIGHEST keeps the contraction in true f32: the default lets the GPU
    # run it in TF32, whose ~0.05% operand rounding is amplified by the
    # affine expansion's cancellation and flips near-tie orderings.
    qdotc = jnp.dot(
        q,
        codes.astype(jnp.float32).T,
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )
    qdotx = delta[None, :] * qdotc + mn[None, :] * jnp.sum(q, axis=-1, keepdims=True)
    qsq = jnp.sum(q * q, axis=-1, keepdims=True)
    return jnp.maximum(qsq + normsq[None, :] - 2.0 * qdotx, 0.0)


def point_normsq(codes: jnp.ndarray, scales: jnp.ndarray) -> jnp.ndarray:
    """|x_j|^2 for each quantized point, float32[N]."""
    x = dequantize(codes, scales)
    return jnp.sum(x * x, axis=-1)


def normalize(x: jnp.ndarray) -> jnp.ndarray:
    """Unit-normalize along the last axis (zero vectors pass through).

    Cosine/angular similarity reduces to L2 over unit vectors
    (||a-b||^2 = 2 - 2 cos(a, b)), so every index supports
    ``metric="cosine"`` by normalizing at insert and query time."""
    x = jnp.asarray(x, jnp.float32)
    n = jnp.sqrt(jnp.sum(x * x, axis=-1, keepdims=True))
    return x / jnp.where(n > 0.0, n, 1.0)
