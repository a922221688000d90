"""GloVe text-embedding loading and exact-NN ground truth.

Equivalent of ``hnsw/src/helpers/glove.rs`` — parses "word v1 v2 ..." rows
(``load_glove_array``, ``glove.rs:14-71``) and computes brute-force nearest
neighbors (``brute_force_nns``, ``glove.rs:73-109``), but batched on device
as a matmul instead of a scalar host loop. Paths are repo-relative (the
reference hardcodes the author's home directory, ``template.rs:520-522``).
"""

from __future__ import annotations

import numpy as np

from ..ops.distance import pairwise_l2sq_exact
from ..ops.quant import dequantize, quantize
from .progress import progress_iter


def load_glove_array(
    path: str, limit: int = 0, verbose: bool = False
) -> tuple[list[str], np.ndarray]:
    """Load up to ``limit`` rows (0 = all) of a GloVe text file.

    Returns (words, float32[N, d]). Raises on ragged rows like the
    reference (``glove.rs:56-65``). Uses the native C++ parser
    (``native/fastio.cpp``) when available; pure-Python fallback below.
    """
    from ..native import load_glove_native

    native = load_glove_native(path, limit)
    if native is not None:
        return native

    words: list[str] = []
    vecs: list[np.ndarray] = []
    dim = None
    with open(path, "r", encoding="utf-8") as f:
        it = progress_iter(f, desc=f"loading {path}", enabled=verbose)
        for i, line in enumerate(it):
            if limit and i >= limit:
                break
            parts = line.rstrip("\n").split(" ")
            words.append(parts[0])
            v = np.asarray(parts[1:], dtype=np.float32)
            if dim is None:
                dim = v.shape[0]
            elif v.shape[0] != dim:
                raise ValueError(
                    f"ragged GloVe row {i}: got dim {v.shape[0]}, expected {dim}"
                )
            vecs.append(v)
    return words, np.stack(vecs) if vecs else np.zeros((0, 0), np.float32)


def brute_force_nns(
    queries: np.ndarray,
    codes,
    scales,
    k: int,
    batch: int = 256,
) -> np.ndarray:
    """Exact top-k ids for each query over the *quantized* store.

    Queries are quantized then dequantized first, mirroring the reference's
    recall gate which computes ground truth in quantized space
    (``hnsw/src/template.rs:531-541``). Ties broken by id asc
    (``graph/src/dist.rs:30-38``).
    """
    import jax.numpy as jnp

    from ..ops.topk import topk_dist_id

    qc, qs = quantize(jnp.asarray(queries, jnp.float32))
    q = dequantize(qc, qs)
    n = codes.shape[0]
    ids = jnp.arange(n, dtype=jnp.int32)
    out = []
    for i in range(0, q.shape[0], batch):
        d2 = pairwise_l2sq_exact(q[i : i + batch], codes, scales)
        _, top_ids = topk_dist_id(d2, jnp.broadcast_to(ids, d2.shape), k)
        out.append(np.asarray(top_ids))
    return np.concatenate(out, axis=0)
