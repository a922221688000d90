"""IVF-PQ: inverted file + product quantization — the MEMORY axis of the
scaling story (beyond the reference's u8-per-dimension ceiling,
``vectors/src/quant.rs``: 1 byte/dim; PQ stores ``m_pq`` bytes/POINT).

Layout and math:

- coarse quantizer: k-means centroids trained on device (shared
  ``models.ivf._kmeans`` — assignment is one matmul + argmin);
- product quantizer: the RESIDUAL (x - coarse centroid) is split into
  ``m_pq`` subspaces; each subspace gets a 256-entry codebook trained on
  device (batched Lloyd's per subspace, all subspaces vmapped at once).
  Storage per point: ``m_pq`` bytes of codes (+4 id bytes) — e.g. 16 B
  vs 96 B for u8-per-dim at d=96;
- search (ADC): per query × probed list, the distance decomposes as
  ``d2(q, x) ≈ Σ_m ||q_m - r_m - cb_m[c_m]||²`` which needs only the
  per-subspace lookup table ``LUT[b, m, v] = ||(q - centroid)_m -
  cb_m[v]||²`` — built with ONE batched matmul against the codebooks
  — and a [B, L, m_pq] table take along the code axis. Optionally the
  top-``rerank`` ADC candidates are re-scored EXACTLY against the u8
  codes kept host-side... no: rerank uses an optional exact code table
  on device (``keep_codes=True``) — recall then approaches IVF-Flat at a
  fraction of the hot memory.

No reference analogue; quantization error vs exact L2 is measured by
tests (ADC is an approximation — the recall/QPS/memory trade is the
point; see benchmarks/bench_ivfpq.py for the committed curve).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..errors import DimensionMismatch
from ..ops.distance import normalize
from ..ops.pq import pq_encode as _pq_encode
from ..ops.pq import pq_train as _pq_train
from ..ops.quant import dequantize, quantize
from ..ops.topk import INF, PAD_ID, sort_dist_id
from .ivf import _assign_jit, _coarse_kmeans

# PQ codebook training subsample cap (see train_add): the vmapped Lloyd
# and the encoder both materialize [rows, m_pq, 256]-shaped temps.
_PQ_TRAIN_MAX = 65536


@functools.partial(jax.jit, static_argnames=("n_probe", "k"))
def _ivfpq_search(
    q, centroids, codebooks, blocks, block_ids, rot, n_probe: int, k: int
):
    """ADC search. q f32[B, d]; codebooks f32[m_pq, 256, ds]; blocks
    u8[C, Lmax, m_pq]; block_ids i32[C, Lmax]; ``rot`` f32[d, d] OPQ
    rotation (identity when disabled — residuals are scored in the
    rotated space, where ``(q - c) @ R = qR - cR`` lets both operands be
    rotated ONCE outside the probe loop).

    Scans one probed list per step with a running sorted top-k merge —
    the [B, m_pq, Lmax] LUT-take temp stays bounded regardless of
    n_probe (an unscanned [B, p, m, Lmax] take would reach GBs)."""
    from ..ops.topk import topk_dist_id

    b, d = q.shape
    m_pq, nv, ds = codebooks.shape
    cd2 = (
        jnp.sum(q * q, 1, keepdims=True)
        - 2.0 * jnp.dot(q, centroids.T, preferred_element_type=jnp.float32,
                        precision=jax.lax.Precision.HIGHEST)
        + jnp.sum(centroids * centroids, 1)[None, :]
    )
    _, probe = jax.lax.top_k(-cd2, n_probe)  # [B, p]
    cbn = jnp.sum(codebooks * codebooks, -1)  # [m_pq, 256]
    # HIGHEST: the ADC scores below rank the returned candidates
    qr = jnp.dot(q, rot, preferred_element_type=jnp.float32,
                 precision=jax.lax.Precision.HIGHEST)
    centr = jnp.dot(centroids, rot, preferred_element_type=jnp.float32,
                    precision=jax.lax.Precision.HIGHEST)

    # bound the [B, m, chunk] LUT-take temp (i32 indices + f32 values,
    # ~8 B per cell): one un-chunked take at 1M-scale serving batches is
    # ~15 GB (B=32k, m=48, Lmax=2.4k) — past HBM. The probed block is
    # gathered ONCE per step as u8 (cheap: m_pq bytes/entry); only the
    # take runs in slices, and its per-chunk d2 pieces concatenate back
    # to the full [B, Lmax] row for the exact two-key running merge —
    # identical results to the one-shot take at every chunk size.
    # (An earlier variant sliced the gather itself and pre-reduced per
    # chunk with lax.top_k.)
    lmax = blocks.shape[1]
    ch = min(lmax, max(64, (1 << 29) // max(b * m_pq * 8, 1)))

    def step(carry, pi):
        bd, bi = carry
        pl = probe[:, pi]  # [B] list index for this probe rank
        # LUT[b, m, v] for this probe: one batched matmul
        resid = qr - centr[pl]  # [B, d] (rotated space)
        rs = resid.reshape(b, m_pq, ds)
        cross = jnp.einsum(
            "bms,mvs->bmv", rs, codebooks,
            preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST,
        )
        lut = jnp.sum(rs * rs, -1)[..., None] - 2.0 * cross + cbn[None]
        cand = blocks[pl]  # [B, Lmax, m_pq] u8 — one contiguous gather
        cand_ids = block_ids[pl]  # [B, Lmax]
        parts = []
        for c0 in range(0, lmax, ch):
            idx = cand[:, c0 : c0 + ch].astype(jnp.int32)
            got = jnp.take_along_axis(
                lut, idx.transpose(0, 2, 1), axis=2
            )  # [B, m, ch]
            parts.append(jnp.maximum(jnp.sum(got, axis=1), 0.0))
        d2 = parts[0] if len(parts) == 1 else jnp.concatenate(parts, axis=1)
        d2 = jnp.where(cand_ids >= 0, d2, INF)
        ids = jnp.where(cand_ids >= 0, cand_ids, PAD_ID)
        md = jnp.concatenate([bd, d2], axis=1)
        mi = jnp.concatenate([bi, ids], axis=1)
        return topk_dist_id(md, mi, k), None

    bd0 = jnp.full((b, k), INF, jnp.float32)
    bi0 = jnp.full((b, k), PAD_ID, jnp.int32)
    (bd, bi), _ = jax.lax.scan(step, (bd0, bi0), jnp.arange(n_probe))
    return jnp.sqrt(bd), bi


@functools.partial(jax.jit, static_argnames=("k",))
def _rerank(q, codes, scales, cand_d, cand_ids, k: int):
    """Exact re-score of ADC candidates against the u8 code table."""
    safe = jnp.clip(jnp.where(cand_ids == PAD_ID, 0, cand_ids), 0,
                    codes.shape[0] - 1)
    vecs = dequantize(codes[safe], scales[safe])  # [B, R, d]
    d2 = jnp.sum((q[:, None, :] - vecs) ** 2, axis=-1)
    d2 = jnp.where(cand_ids == PAD_ID, INF, d2)
    sd, si = sort_dist_id(d2, cand_ids)
    return jnp.sqrt(sd[:, :k]), si[:, :k]


class IVFPQIndex:
    """Inverted file with product-quantized residual storage."""

    def __init__(
        self,
        dim: int,
        n_lists: int = 0,
        m_pq: int = 16,
        n_probe: int = 8,
        kmeans_iters: int = 10,
        pq_iters: int = 12,
        rerank: int = 0,
        keep_codes: bool | None = None,
        seed: int = 0,
        metric: str = "l2",
        opq: bool = False,
        opq_iters: int = 6,
    ):
        if metric not in ("l2", "cosine"):
            raise ValueError(f"unknown metric {metric!r}")
        if dim % m_pq != 0:
            raise ValueError(f"m_pq {m_pq} must divide dim {dim}")
        self.metric = metric
        self.dim = int(dim)
        self.m_pq = int(m_pq)
        self.n_lists = int(n_lists)
        self.n_probe = int(n_probe)
        self.kmeans_iters = int(kmeans_iters)
        self.pq_iters = int(pq_iters)
        self.rerank = int(rerank)
        # keep the exact u8 codes on device for reranking (defaults to
        # True when rerank > 0)
        self.keep_codes = bool(rerank) if keep_codes is None else keep_codes
        self.seed = seed
        # OPQ: learned orthogonal rotation applied to residuals before
        # the subspace split (ops.pq.opq_train); identity when disabled
        self.opq = bool(opq)
        self.opq_iters = int(opq_iters)
        self.rot = None  # f32[d, d]
        self.centroids = None  # f32[C, d]
        self.codebooks = None  # f32[m_pq, 256, ds]
        self.blocks = None  # u8[C, Lmax, m_pq]
        self.block_ids = None  # i32[C, Lmax]
        self.codes = None  # u8[N, d] exact codes (host/persist; device if keep_codes)
        self.scales = None  # f32[N, 2]
        self._assign = None
        self._n = 0

    def __len__(self) -> int:
        return self._n

    # -- construction --------------------------------------------------

    def train_add(self, vectors: np.ndarray) -> np.ndarray:
        vectors = self._prep(vectors)
        n = vectors.shape[0]
        if self.n_lists <= 0:
            self.n_lists = max(1, int(np.sqrt(n)))
        c = min(self.n_lists, n)
        self.n_lists = c
        self.codes, self.scales = quantize(jnp.asarray(vectors))
        self._n = n
        x = dequantize(self.codes, self.scales)
        rng = np.random.default_rng(self.seed)
        cent, assign = _coarse_kmeans(
            self.codes, self.scales, c, self.kmeans_iters, self.seed
        )
        self.centroids = cent
        self._assign = np.asarray(assign)
        res_flat = x - cent[assign]  # [n, d] residuals
        # PQ training past ~64k rows runs on an evenly-strided subsample:
        # the vmapped Lloyd materializes an [m_pq, Ntrain, 256] distance
        # temp (16 GB at 1M x m16 — past HBM); 64k samples train the
        # codebooks to the same distortion (standard PQ practice, same
        # recipe as models/hnsw.finalize's PQ serving mode)
        ts = min(n, _PQ_TRAIN_MAX)
        if self.opq:
            from ..ops.pq import opq_train

            self.rot, self.codebooks = opq_train(
                res_flat, self.m_pq, pq_iters=self.pq_iters,
                opq_iters=self.opq_iters, seed=self.seed, train_n=ts,
            )
            res_flat = jnp.dot(
                res_flat, self.rot, preferred_element_type=jnp.float32,
                precision=jax.lax.Precision.DEFAULT,  # encoding input
            )
        else:
            self.rot = jnp.eye(self.dim, dtype=jnp.float32)
            res_train = res_flat
            if ts < n:
                pick = jnp.asarray(
                    np.linspace(0, n - 1, ts).round().astype(np.int64)
                )
                res_train = res_flat[pick]
            res_train = res_train.reshape(ts, self.m_pq, self.dim // self.m_pq)
            pq_init = jnp.asarray(
                rng.choice(ts, size=min(256, ts), replace=False).astype(np.int32)
            )
            if ts < 256:  # tiny collections: repeat rows to fill the codebook
                pq_init = jnp.concatenate(
                    [pq_init, jnp.zeros((256 - ts,), jnp.int32)]
                )
            self.codebooks = _pq_train(res_train, pq_init, self.pq_iters)
        # chunked encode for the same temp reason ([Nchunk, m_pq, 256])
        ds_sub = self.dim // self.m_pq
        ch = 1 << 16
        pq_codes = np.concatenate([
            np.asarray(_pq_encode(
                res_flat[s : s + ch].reshape(-1, self.m_pq, ds_sub),
                self.codebooks,
            ))
            for s in range(0, n, ch)
        ])
        self._pack(pq_codes)
        if not self.keep_codes:
            self.codes = np.asarray(self.codes)  # spill to host memory
            self.scales = np.asarray(self.scales)
        return np.arange(n, dtype=np.int32)

    def add(self, vectors: np.ndarray) -> np.ndarray:
        """Incremental add: assign to coarse list, PQ-encode the residual,
        scatter into the list tail (codebooks are NOT retrained)."""
        if self.centroids is None:
            return self.train_add(vectors)
        vectors = self._prep(vectors)
        n_new = vectors.shape[0]
        codes, scales = quantize(jnp.asarray(vectors))
        x = dequantize(codes, scales)
        assign = np.asarray(_assign_jit(x, self.centroids))
        # DEFAULT precision: encoding input, inside PQ's own error
        res = jnp.dot(
            x - self.centroids[jnp.asarray(assign)], self.rot,
            preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.DEFAULT,
        ).reshape(n_new, self.m_pq, self.dim // self.m_pq)
        pq_codes = np.asarray(_pq_encode(res, self.codebooks))
        start = self._n
        self.codes = (
            jnp.concatenate([jnp.asarray(self.codes), codes])
            if self.keep_codes
            else np.concatenate([np.asarray(self.codes), np.asarray(codes)])
        )
        self.scales = (
            jnp.concatenate([jnp.asarray(self.scales), scales])
            if self.keep_codes
            else np.concatenate([np.asarray(self.scales), np.asarray(scales)])
        )
        self._assign = np.concatenate([self._assign, assign])
        self._n += n_new

        counts = np.bincount(self._assign[:start], minlength=self.n_lists)
        order = np.argsort(assign, kind="stable")
        srt = assign[order]
        idx = np.arange(n_new, dtype=np.int64)
        first = np.r_[True, srt[1:] != srt[:-1]] if n_new else np.zeros(0, bool)
        grp = np.maximum.accumulate(np.where(first, idx, 0))
        within = counts[srt] + (idx - grp)
        lmax = int(self.blocks.shape[1])
        if within.size and int(within.max()) >= lmax:
            pad = max(int(within.max()) + 1, 2 * lmax) - lmax
            self.blocks = jnp.pad(self.blocks, ((0, 0), (0, pad), (0, 0)))
            self.block_ids = jnp.pad(
                self.block_ids, ((0, 0), (0, pad)), constant_values=-1
            )
        rows = jnp.asarray(srt.astype(np.int32))
        slots = jnp.asarray(within.astype(np.int32))
        self.blocks = self.blocks.at[rows, slots].set(
            jnp.asarray(pq_codes[order])
        )
        self.block_ids = self.block_ids.at[rows, slots].set(
            jnp.asarray((start + order).astype(np.int32))
        )
        return np.arange(start, start + n_new, dtype=np.int32)

    def _prep(self, vectors: np.ndarray) -> np.ndarray:
        vectors = np.atleast_2d(np.asarray(vectors, np.float32))
        if vectors.shape[-1] != self.dim:
            raise DimensionMismatch(
                f"index dim {self.dim}, got {vectors.shape[-1]}"
            )
        if self.metric == "cosine":
            vectors = np.asarray(normalize(vectors))
        return vectors

    def _pack(self, pq_codes: np.ndarray) -> None:
        c, n = self.n_lists, self._n
        order = np.argsort(self._assign, kind="stable")
        srt = self._assign[order]
        counts = np.bincount(srt, minlength=c)
        starts = np.zeros(c + 1, np.int64)
        np.cumsum(counts, out=starts[1:])
        within = np.arange(n, dtype=np.int64) - starts[srt]
        lmax = max(1, int(counts.max()))
        lmax += min(max(lmax // 4, 8), 1024)
        blocks = np.zeros((c, lmax, self.m_pq), np.uint8)
        bids = np.full((c, lmax), -1, np.int32)
        blocks[srt, within] = pq_codes[order]
        bids[srt, within] = order.astype(np.int32)
        self.blocks = jnp.asarray(blocks)
        self.block_ids = jnp.asarray(bids)

    # -- queries --------------------------------------------------------

    def search(
        self,
        queries: np.ndarray,
        k: int,
        n_probe: int | None = None,
        rerank: int | None = None,
    ) -> tuple[np.ndarray, np.ndarray]:
        """Batched approximate top-k via ADC; optional exact re-rank of
        the top-``rerank`` ADC candidates (needs ``keep_codes``)."""
        if self.centroids is None:
            raise ValueError("index is untrained: call train_add/add first")
        queries = np.atleast_2d(np.asarray(queries, np.float32))
        if self.metric == "cosine":
            queries = np.asarray(normalize(queries))
        q = dequantize(*quantize(jnp.asarray(queries)))
        p = min(n_probe or self.n_probe, self.n_lists)
        r = self.rerank if rerank is None else int(rerank)
        kk = max(k, r)
        d, i = _ivfpq_search(
            q, self.centroids, self.codebooks, self.blocks, self.block_ids,
            self.rot, p, kk,
        )
        if r > 0:
            if not self.keep_codes:
                raise ValueError("rerank requires keep_codes=True")
            d, i = _rerank(q, jnp.asarray(self.codes),
                           jnp.asarray(self.scales), d, i, k)
        return np.asarray(d)[:, :k], np.asarray(i)[:, :k]

    # -- persistence ----------------------------------------------------

    def save(self, path: str) -> None:
        import json
        import os

        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, "params.json"), "w") as f:
            json.dump(
                {
                    "format": "hnsw_rs_tpu.ivfpq.v1",
                    "dim": self.dim, "m_pq": self.m_pq,
                    "n_lists": self.n_lists, "n_probe": self.n_probe,
                    "kmeans_iters": self.kmeans_iters,
                    "pq_iters": self.pq_iters, "rerank": self.rerank,
                    "keep_codes": self.keep_codes, "seed": self.seed,
                    "metric": self.metric, "n": self._n,
                    "opq": self.opq, "opq_iters": self.opq_iters,
                },
                f, indent=2,
            )
        n = self._n
        np.savez_compressed(
            os.path.join(path, "arrays.npz"),
            codes=np.asarray(self.codes)[:n],
            scales=np.asarray(self.scales)[:n],
            assign=np.asarray(self._assign)[:n],
            centroids=np.asarray(self.centroids),
            codebooks=np.asarray(self.codebooks),
            rot=np.asarray(self.rot),
        )

    @classmethod
    def load(cls, path: str) -> "IVFPQIndex":
        import json
        import os

        with open(os.path.join(path, "params.json")) as f:
            meta = json.load(f)
        if meta.get("format") != "hnsw_rs_tpu.ivfpq.v1":
            raise ValueError(f"unknown index format in {path}")
        index = cls(
            meta["dim"], n_lists=meta["n_lists"], m_pq=meta["m_pq"],
            n_probe=meta["n_probe"], kmeans_iters=meta["kmeans_iters"],
            pq_iters=meta["pq_iters"], rerank=meta["rerank"],
            keep_codes=meta["keep_codes"], seed=meta["seed"],
            metric=meta["metric"], opq=meta.get("opq", False),
            opq_iters=meta.get("opq_iters", 6),
        )
        with np.load(os.path.join(path, "arrays.npz")) as z:
            codes = jnp.asarray(z["codes"])
            scales = jnp.asarray(z["scales"])
            index.codes = codes if index.keep_codes else np.asarray(codes)
            index.scales = scales if index.keep_codes else np.asarray(scales)
            index._assign = np.asarray(z["assign"])
            index.centroids = jnp.asarray(z["centroids"])
            index.codebooks = jnp.asarray(z["codebooks"])
            index.rot = (
                jnp.asarray(z["rot"]) if "rot" in z
                else jnp.eye(index.dim, dtype=jnp.float32)
            )
        index._n = int(meta["n"])
        if index._n:
            x = dequantize(jnp.asarray(index.codes), jnp.asarray(index.scales))
            res = jnp.dot(
                x - index.centroids[jnp.asarray(index._assign)], index.rot,
                preferred_element_type=jnp.float32,
                precision=jax.lax.Precision.DEFAULT,  # as in add()
            ).reshape(index._n, index.m_pq, index.dim // index.m_pq)
            index._pack(np.asarray(_pq_encode(res, index.codebooks)))
        return index
