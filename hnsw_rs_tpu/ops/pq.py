"""Product-quantization primitives shared by the IVF-PQ family and the
PQ-coded HNSW serving mode.

PQ splits a d-dim vector into ``m_pq`` contiguous subvectors and stores
one byte per subspace (the id of the nearest entry in that subspace's
256-entry codebook) — ``m_pq`` bytes/point against the reference's
1 byte/DIM ceiling (``vectors/src/quant.rs``). Asymmetric distance
computation (ADC) then needs only a per-query lookup table
``LUT[m, v] = ||q_m - cb[m, v]||²`` (one batched matmul against the
codebooks) and a table-take along the code axis — no per-candidate
vector fetch at all, which is what lets graph beams and IVF scans run
over collections whose exact codes would not fit HBM.

Dense shapes throughout: codebooks are one dense
``f32[m_pq, 256, ds]`` array (all subspaces train vmapped at once, every
Lloyd step a batched matmul), codes are ``u8[N, m_pq]``.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["pq_train", "pq_encode", "pq_decode", "train_pq", "encode_pq",
           "pq_lut", "adc_score", "adc_score16", "pack_nibbles",
           "unpack_nibbles", "opq_train"]


@functools.partial(jax.jit, static_argnames=("iters",))
def pq_train(res: jnp.ndarray, init_idx: jnp.ndarray, iters: int):
    """Train all m_pq sub-codebooks at once: ``res`` [N, m_pq, ds]
    (sub-)vectors, ``init_idx`` i32[256] initial rows. Returns codebooks
    f32[m_pq, 256, ds]. vmapped batched Lloyd's — every step is a
    matmul batch. Empty cells keep their previous centroid."""

    def one(sub):  # [N, ds] -> [256, ds]
        cent = sub[init_idx]

        def step(c, _):
            # DEFAULT precision (TF32 allowed): codebook training sits
            # far inside PQ's own quantization error
            d2 = (
                jnp.sum(sub * sub, 1, keepdims=True)
                - 2.0 * jnp.dot(sub, c.T, preferred_element_type=jnp.float32,
                                precision=jax.lax.Precision.DEFAULT)
                + jnp.sum(c * c, 1)[None, :]
            )
            a = jnp.argmin(d2, 1)
            sums = jnp.zeros_like(c).at[a].add(sub)
            counts = jnp.zeros((c.shape[0],), jnp.float32).at[a].add(1.0)
            return (
                jnp.where(counts[:, None] > 0,
                          sums / jnp.maximum(counts, 1.0)[:, None], c),
                None,
            )

        cent, _ = jax.lax.scan(step, cent, None, length=iters)
        return cent

    return jax.vmap(one, in_axes=1, out_axes=0)(res)


@jax.jit
def pq_encode(res: jnp.ndarray, codebooks: jnp.ndarray) -> jnp.ndarray:
    """``res`` [N, m_pq, ds] -> codes u8[N, m_pq] (nearest codebook
    entry per subspace; ties -> lowest id, deterministic)."""

    def one(sub, cb):  # [N, ds], [256, ds]
        # DEFAULT precision: encoding picks a codeword, an approximation
        # the exact rerank (or PQ's own error) owns
        d2 = (
            jnp.sum(sub * sub, 1, keepdims=True)
            - 2.0 * jnp.dot(sub, cb.T, preferred_element_type=jnp.float32,
                            precision=jax.lax.Precision.DEFAULT)
            + jnp.sum(cb * cb, 1)[None, :]
        )
        return jnp.argmin(d2, 1).astype(jnp.uint8)

    return jax.vmap(one, in_axes=(1, 0), out_axes=1)(res, codebooks)


def train_pq(
    x: jnp.ndarray, m_pq: int, iters: int = 12, seed: int = 0, nv: int = 256
) -> jnp.ndarray:
    """Convenience wrapper over :func:`pq_train` for flat [N, d] input:
    reshapes into subspaces and draws a deterministic ``nv``-row init.
    ``nv=16`` trains 4-bit sub-codebooks (the LUT16 serving mode —
    :func:`adc_score16`)."""
    n, d = x.shape
    if d % m_pq != 0:
        raise ValueError(f"m_pq {m_pq} must divide dim {d}")
    rng = np.random.default_rng(seed)
    init = rng.choice(n, size=min(nv, n), replace=False).astype(np.int32)
    if n < nv:  # tiny collections: repeat rows to fill the codebook
        init = np.concatenate([init, np.zeros(nv - n, np.int32)])
    res = jnp.asarray(x, jnp.float32).reshape(n, m_pq, d // m_pq)
    return pq_train(res, jnp.asarray(init), iters)


def encode_pq(x: jnp.ndarray, codebooks: jnp.ndarray) -> jnp.ndarray:
    """Flat [N, d] -> u8[N, m_pq] against :func:`train_pq` codebooks."""
    n, d = x.shape
    m_pq = codebooks.shape[0]
    return pq_encode(
        jnp.asarray(x, jnp.float32).reshape(n, m_pq, d // m_pq), codebooks
    )


@jax.jit
def pq_decode(codes: jnp.ndarray, codebooks: jnp.ndarray) -> jnp.ndarray:
    """codes u8[N, m_pq] -> reconstructed f32[N, m_pq * ds] (each
    subspace's codebook entry, concatenated)."""
    n, m_pq = codes.shape
    take = jax.vmap(lambda cb, c: cb[c], in_axes=(0, 1), out_axes=1)
    return take(codebooks, codes.astype(jnp.int32)).reshape(n, -1)


def opq_train(
    x: jnp.ndarray,
    m_pq: int,
    pq_iters: int = 8,
    opq_iters: int = 6,
    seed: int = 0,
    train_n: int = 131072,
    nv: int = 256,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """OPQ (Ge et al., CVPR'13): learn an orthogonal rotation ``R`` so the
    PQ subspace split loses less energy, by alternating (a) PQ
    train+encode in the rotated space with (b) the orthogonal-Procrustes
    update ``R = U V^T`` from ``svd(x^T x_hat)``. Every step
    is a batched matmul except one tiny [d, d] SVD.

    ``x`` f32[N, d] (training sample; evenly-strided subsample of at most
    ``train_n`` rows is used). Returns ``(R f32[d, d], codebooks
    f32[m_pq, 256, ds])`` where encoding is ``pq_encode((x @ R).reshape
    (n, m_pq, ds), codebooks)`` and queries build LUTs from ``q @ R``.

    No reference analogue (the reference's quantization ceiling is
    u8-per-dim, ``vectors/src/quant.rs``); this is the memory-axis
    extension beyond it."""
    n, d = x.shape
    if d % m_pq != 0:
        raise ValueError(f"m_pq {m_pq} must divide dim {d}")
    if n > train_n:
        sel = jnp.asarray(
            np.linspace(0, n - 1, train_n).round().astype(np.int32)
        )
        x = x[sel]
        n = train_n
    x = jnp.asarray(x, jnp.float32)
    rng = np.random.default_rng(seed)
    init = rng.choice(n, size=min(nv, n), replace=False).astype(np.int32)
    if n < nv:
        init = np.concatenate([init, np.zeros(nv - n, np.int32)])
    init = jnp.asarray(init)
    rot = jnp.eye(d, dtype=jnp.float32)
    cb = None
    # training products run at DEFAULT precision (TF32 allowed); the
    # rotation itself is formed at HIGHEST so it stays orthogonal
    train_dot = functools.partial(jnp.dot, preferred_element_type=jnp.float32,
                                  precision=jax.lax.Precision.DEFAULT)
    for _ in range(max(opq_iters, 1)):
        xr = train_dot(x, rot)
        res = xr.reshape(n, m_pq, d // m_pq)
        cb = pq_train(res, init, pq_iters)
        xhat = pq_decode(pq_encode(res, cb), cb)  # [n, d] in rotated space
        u, _, vt = jnp.linalg.svd(train_dot(x.T, xhat))
        rot = jnp.dot(u, vt, preferred_element_type=jnp.float32,
                      precision=jax.lax.Precision.HIGHEST)
    # final codebooks against the final rotation
    xr = train_dot(x, rot)
    cb = pq_train(xr.reshape(n, m_pq, d // m_pq), init, pq_iters)
    return rot, cb


def pq_lut(q: jnp.ndarray, codebooks: jnp.ndarray) -> jnp.ndarray:
    """Per-query ADC lookup table ``f32[B, m_pq, 256]``:
    ``LUT[b, m, v] = ||q_m - cb[m, v]||²`` via one batched matmul
    (the cross term) — every subsequent candidate scoring is a pure
    table take, no vector fetches."""
    b, d = q.shape
    m_pq, nv, ds = codebooks.shape
    qs = jnp.asarray(q, jnp.float32).reshape(b, m_pq, ds)
    # HIGHEST: the table scores the candidates a query visits
    cross = jnp.einsum(
        "bms,mvs->bmv", qs, codebooks, preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )
    cbn = jnp.sum(codebooks * codebooks, -1)  # [m_pq, 256]
    return jnp.sum(qs * qs, -1)[..., None] - 2.0 * cross + cbn[None]


def adc_score(lut: jnp.ndarray, codes: jnp.ndarray) -> jnp.ndarray:
    """Approximate squared L2 of candidates against their query's LUT:
    ``lut`` f32[B, m_pq, 256], ``codes`` u8[B, C, m_pq] -> f32[B, C]
    (``d2 ≈ Σ_m LUT[m, code_m]``, clamped at 0 — each term is a true
    subspace distance so the sum is nonnegative up to rounding)."""
    idx = codes.astype(jnp.int32).transpose(0, 2, 1)  # [B, m_pq, C]
    got = jnp.take_along_axis(lut, idx, axis=2)  # [B, m_pq, C]
    return jnp.maximum(jnp.sum(got, axis=1), 0.0)


def pack_nibbles(codes: jnp.ndarray) -> jnp.ndarray:
    """4-bit codes u8[..., m] (values < 16, m even) -> u8[..., m // 2].
    Subspace ``2j`` lives in byte ``j``'s LOW nibble, ``2j+1`` in its
    high nibble (the layout :func:`unpack_nibbles`/:func:`adc_score16`
    decode in-register)."""
    lo = codes[..., 0::2].astype(jnp.uint8)
    hi = codes[..., 1::2].astype(jnp.uint8)
    return lo | (hi << 4)


def unpack_nibbles(packed: jnp.ndarray) -> jnp.ndarray:
    """u8[..., mb] -> u8[..., 2 * mb] 4-bit codes (pure bit ops)."""
    lo = packed & jnp.uint8(0xF)
    hi = packed >> jnp.uint8(4)
    return jnp.stack([lo, hi], axis=-1).reshape(*packed.shape[:-1], -1)


def adc_score16(lut: jnp.ndarray, packed: jnp.ndarray) -> jnp.ndarray:
    """GATHER-FREE ADC over 4-bit codes: ``lut`` f32[B, m, 16] (from
    :func:`pq_lut` with 16-entry codebooks), ``packed`` u8[B, C, m // 2]
    nibble-packed codes -> f32[B, C].

    Why this exists: :func:`adc_score`'s ``take_along_axis`` lowers to
    B*m*C per-ELEMENT gathers — at serving batch sizes the LUT lookups
    dominate the whole PQ beam. With 16-entry codebooks the lookup becomes an
    unrolled 16-step compare-select — pure elementwise, zero gathers,
    one fused loop nest (the device-native analogue of SIMD LUT16 /
    4-bit-PQ ADC; beyond the reference's u8-per-dim ceiling,
    vectors/src/quant.rs)."""
    b, c, mb = packed.shape
    codes = unpack_nibbles(packed)  # [B, C, m] u8, values < 16
    g = jnp.zeros((b, c, 2 * mb), jnp.float32)
    for v in range(16):
        # lut[..., v]: [B, m] -> broadcast [B, 1, m] against codes
        g = g + jnp.where(codes == jnp.uint8(v), lut[:, None, :, v], 0.0)
    return jnp.maximum(jnp.sum(g, axis=-1), 0.0)
