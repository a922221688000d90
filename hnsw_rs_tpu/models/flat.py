"""Exact (brute-force) nearest-neighbor index.

The reference only has a host-side scalar brute-force helper used as the
recall oracle (``hnsw/src/helpers/glove.rs:73-109``); here it is a
first-class index model: all-pairs quantized L2 as one matmul with
on-device top-k — the "flat" baseline every ANN framework needs
(arXiv:2206.14286), and the ground-truth generator for the HNSW recall
gate.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..errors import DimensionMismatch
from ..ops.distance import normalize, pairwise_l2sq_exact, pairwise_l2sq_mxu, point_normsq
from ..ops.quant import dequantize, quantize
from ..ops.topk import topk_dist_id


_SORT_PATH_MAX = 32768  # below this, one two-key sort is cheap and gives
# exact (d2, id) tie-breaks; above, the tiled path (see _flat_search_tiled)

_TILE = 131072


@functools.partial(jax.jit, static_argnames=("k", "exact"))
def _flat_search(q, codes, scales, normsq, k: int, exact: bool):
    n = codes.shape[0]
    if n > _SORT_PATH_MAX and not exact:
        return _flat_search_tiled(q, codes, scales, normsq, k)
    if exact:
        d2 = pairwise_l2sq_exact(q, codes, scales)
    else:
        d2 = pairwise_l2sq_mxu(q, codes, scales, normsq)
    ids = jnp.broadcast_to(
        jnp.arange(codes.shape[0], dtype=jnp.int32), d2.shape
    )
    td, ti = topk_dist_id(d2, ids, k)
    return jnp.sqrt(td), ti


def _flat_search_tiled(q, codes, scales, normsq, k: int):
    """Streaming exact top-k: matmul affine distances one tile at a time with
    a running (d2, id)-sorted top-k merge, so no [B, N] matrix is ever
    sorted (a [1024, 1M] two-key sort is orders of magnitude slower).
    Exactness caveat: ``lax.top_k`` inside a tile breaks distance
    ties by position, so when more than k points tie *exactly* at the
    k-th distance within one tile the (d2, id) winner may differ — recall
    is unaffected and the small-N sort path keeps the strict contract."""
    b = q.shape[0]
    n = codes.shape[0]
    t = min(_TILE, n)
    nt = -(-n // t)
    npad = nt * t
    if npad != n:  # pad the collection so tiles are uniform
        codes = jnp.pad(codes, ((0, npad - n), (0, 0)))
        scales = jnp.pad(scales, ((0, npad - n), (0, 0)))
        normsq = jnp.pad(normsq, (0, npad - n), constant_values=jnp.inf)
    qsq = jnp.sum(q * q, axis=-1, keepdims=True)
    qsum = jnp.sum(q, axis=-1, keepdims=True)

    def step(carry, i):
        bd, bi = carry
        sl = lambda x: jax.lax.dynamic_slice_in_dim(x, i * t, t, 0)
        c, s, ns = sl(codes), sl(scales), sl(normsq)
        qdotc = jnp.dot(
            q, c.astype(jnp.float32).T,
            preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST,
        )
        qdotx = s[:, 1][None] * qdotc + s[:, 0][None] * qsum
        d2 = jnp.maximum(qsq + ns[None] - 2.0 * qdotx, 0.0)
        nv, ni = jax.lax.top_k(-d2, k)
        mi = jnp.concatenate([bi, (i * t + ni).astype(jnp.int32)], axis=1)
        md = jnp.concatenate([bd, -nv], axis=1)
        sd, si = topk_dist_id(md, mi, k)
        return (sd, si), None

    bd0 = jnp.full((b, k), jnp.inf, jnp.float32)
    bi0 = jnp.full((b, k), np.int32(np.iinfo(np.int32).max), jnp.int32)
    (bd, bi), _ = jax.lax.scan(step, (bd0, bi0), jnp.arange(nt))
    return jnp.sqrt(bd), bi


class FlatIndex:
    """Exact k-NN over a quantized (or raw float) collection."""

    def __init__(self, dim: int, quantized: bool = True, metric: str = "l2"):
        if metric not in ("l2", "cosine"):
            raise ValueError(f"unknown metric {metric!r}")
        self.dim = int(dim)
        self.quantized = quantized
        self.metric = metric
        self.codes = jnp.zeros((0, dim), jnp.uint8 if quantized else jnp.float32)
        self.scales = jnp.zeros((0, 2), jnp.float32)
        self._normsq = jnp.zeros((0,), jnp.float32)

    def __len__(self) -> int:
        return int(self.codes.shape[0])

    def add(self, vectors: np.ndarray) -> np.ndarray:
        """Append vectors; returns their assigned ids (row positions)."""
        vectors = jnp.asarray(vectors, jnp.float32)
        if vectors.shape[-1] != self.dim:
            raise DimensionMismatch(
                f"index dim {self.dim}, got {vectors.shape[-1]}"
            )
        if self.metric == "cosine":
            vectors = normalize(vectors)
        if self.quantized:
            codes, scales = quantize(vectors)
        else:
            # FullVec parity (vectors/src/full.rs): raw f32 storage with
            # identity scales, so the same kernels compute exact L2
            codes = vectors
            scales = jnp.tile(jnp.asarray([[0.0, 1.0]], jnp.float32), (vectors.shape[0], 1))
        start = len(self)
        self.codes = jnp.concatenate([self.codes, codes], axis=0)
        self.scales = jnp.concatenate([self.scales, scales], axis=0)
        self._normsq = point_normsq(self.codes, self.scales)
        return np.arange(start, start + vectors.shape[0], dtype=np.int32)

    def search(
        self,
        queries: np.ndarray,
        k: int,
        exact: bool = False,
    ) -> tuple[np.ndarray, np.ndarray]:
        """Exact top-k: returns (distances [B, k], ids [B, k]).

        Queries are quantized first (the reference quantizes every query,
        ``hnsw/src/template.rs:313``) so distances live in the same
        quantized space as the HNSW path. ``exact=True`` uses the direct
        (cancellation-free) distance form for oracle use; the default matmul
        form is the fast path.
        """
        queries = jnp.atleast_2d(jnp.asarray(queries, jnp.float32))
        if self.metric == "cosine":
            queries = normalize(queries)
        if self.quantized:
            qc, qs = quantize(queries)
            q = dequantize(qc, qs)
        else:
            q = queries
        d, i = _flat_search(q, self.codes, self.scales, self._normsq, k, exact)
        return np.asarray(d), np.asarray(i)

    # -- persistence ----------------------------------------------------

    def save(self, path: str) -> None:
        """Checkpoint to a directory (``params.json`` + ``arrays.npz``) —
        persistence as a first-class index capability for every family,
        matching the reference's persisted HNSW
        (``hnsw/src/template.rs:43-73``)."""
        import json
        import os

        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, "params.json"), "w") as f:
            json.dump(
                {
                    "format": "hnsw_rs_tpu.flat.v1",
                    "dim": self.dim,
                    "quantized": self.quantized,
                    "metric": self.metric,
                },
                f,
                indent=2,
            )
        np.savez_compressed(
            os.path.join(path, "arrays.npz"),
            codes=np.asarray(self.codes),
            scales=np.asarray(self.scales),
        )

    @classmethod
    def load(cls, path: str) -> "FlatIndex":
        """Restore from :meth:`save`."""
        import json
        import os

        with open(os.path.join(path, "params.json")) as f:
            meta = json.load(f)
        if meta.get("format") != "hnsw_rs_tpu.flat.v1":
            raise ValueError(f"unknown index format in {path}")
        index = cls(meta["dim"], quantized=meta["quantized"], metric=meta["metric"])
        with np.load(os.path.join(path, "arrays.npz")) as z:
            index.codes = jnp.asarray(z["codes"])
            index.scales = jnp.asarray(z["scales"])
        index._normsq = point_normsq(index.codes, index.scales)
        return index
