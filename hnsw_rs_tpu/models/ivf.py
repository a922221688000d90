"""IVF-Flat: inverted-file index with exact in-list distances.

A second index family beyond HNSW/Flat, added because it is the natural
accelerator-first ANN design (in the spirit of ScaNN): HNSW's
per-neighbor row gathers are latency bound, while IVF reads whole
*contiguous* cluster blocks — every byte moved is a big sequential copy
and every FLOP is a batched matmul:

1. coarse quantizer: k-means centroids, trained on device (batched
   Lloyd's iterations — assignment is one matmul + argmin, update is one
   scatter-add);
2. storage: points sorted by list, padded per-list to a fixed width, so a
   "probe" is a single [Lmax, d] block load. Blocks are stored QUANTIZED
   (u8 codes + per-point scales, 4x fewer bytes moved per probe) by default;
   ``quantized_blocks=False`` keeps a dequantized f32 copy instead —
   distances are identical either way (dequantization is exact);
3. search: centroid distances [B, C] as a matmul -> top-``n_probe`` lists
   -> gather those blocks -> fused distances -> top-k (dist, id) sort.

Supports incremental :meth:`add` after training — amortized O(1) per
vector: new rows are scattered into per-list TAIL slots of
capacity-grown block buffers (growth is geometric, a full repack happens
only when some list outgrows the shared block width) — plus
:meth:`retrain` (re-run k-means over everything stored when the
distribution has drifted) and :meth:`save`/:meth:`load` (persistence is
a first-class index capability, as in the reference's one family,
``hnsw/src/template.rs:43-131``).

No reference analogue (the reference has only HNSW + a scalar brute-force
helper); quantization/distance semantics are shared with the rest of the
framework (``ops/quant.py``, ``vectors/src/quant.rs`` parity).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..errors import DimensionMismatch
from ..ops.distance import l2sq, normalize
from ..ops.quant import dequantize, quantize, quantize_np
from ..ops.topk import INF, PAD_ID, sort_dist_id

# Dense Lloyd materializes an [N, C] f32 distance block per step; past
# this many bytes the coarse quantizer routes through the cluster
# builder's scale-safe kmeans (subsampled Lloyd + chunked scatter-free
# assignment, build_cluster.kmeans) instead — at 1M x 8192 lists the
# dense block would be 32 GB. The 1 GiB value was sized for a device with
# far less memory than 80 GB (ROADMAP queue 2 item 2). Module-level so
# tests can force the chunked path at toy sizes.
DENSE_KMEANS_LIMIT = 1 << 30


def _coarse_kmeans(codes, scales, c: int, iters: int, seed: int):
    """Coarse-quantizer k-means, scale-dispatched: the dense batched
    Lloyd (seeded random init) under DENSE_KMEANS_LIMIT, the cluster
    builder's subsampled/chunked kmeans above it (deterministic strided
    init). Returns (centroids f32[c, d], assign i32[N])."""
    n = codes.shape[0]
    if n * c * 4 > DENSE_KMEANS_LIMIT:
        from ..build_cluster import kmeans as _kmeans_chunked

        return _kmeans_chunked(codes, scales, c, iters=iters)
    x = dequantize(codes, scales)
    rng = np.random.default_rng(seed)
    init = jnp.asarray(rng.choice(n, size=c, replace=False).astype(np.int32))
    return _kmeans(x, init, c, iters)


@functools.partial(jax.jit, static_argnames=("iters", "c"))
def _kmeans(x: jnp.ndarray, init_idx: jnp.ndarray, c: int, iters: int):
    """Batched Lloyd's k-means on device. x: f32[N, d] -> centroids
    f32[c, d], assignment i32[N]. Empty clusters keep their previous
    centroid."""
    cent = x[init_idx]

    def step(cent, _):
        d2 = (
            jnp.sum(x * x, 1, keepdims=True)
            - 2.0 * jnp.dot(x, cent.T, preferred_element_type=jnp.float32,
                            precision=jax.lax.Precision.HIGHEST)
            + jnp.sum(cent * cent, 1)[None, :]
        )
        assign = jnp.argmin(d2, 1)
        sums = jnp.zeros_like(cent).at[assign].add(x)
        counts = jnp.zeros((c,), jnp.float32).at[assign].add(1.0)
        new = jnp.where(counts[:, None] > 0, sums / jnp.maximum(counts, 1.0)[:, None], cent)
        return new, None

    cent, _ = jax.lax.scan(step, cent, None, length=iters)
    return cent, _assign_jit(x, cent)


@jax.jit
def _assign_jit(x: jnp.ndarray, centroids: jnp.ndarray) -> jnp.ndarray:
    """Nearest-centroid assignment: one matmul + argmin."""
    d2 = (
        jnp.sum(x * x, 1, keepdims=True)
        - 2.0 * jnp.dot(x, centroids.T, preferred_element_type=jnp.float32,
                        precision=jax.lax.Precision.HIGHEST)
        + jnp.sum(centroids * centroids, 1)[None, :]
    )
    return jnp.argmin(d2, 1).astype(jnp.int32)


# One-shot [B, p, Lmax, d] f32 scoring temp cap for _ivf_search: under
# it, every probed list is scored in one fused pass and results get one
# exact (d2, id) sort — the bit-exact path every unit test runs. Above
# it (1M-scale serving batches: 32k queries x Lmax 2k+ x d 96 is ~29 GB),
# the scanned/chunked path below takes over. Like DENSE_KMEANS_LIMIT, the
# value predates 80 GB devices (ROADMAP queue 2 item 2).
DENSE_IVF_SEARCH_LIMIT = 1 << 30


@functools.partial(jax.jit, static_argnames=("n_probe", "k"))
def _ivf_search(q, centroids, blocks, bscales, block_ids, n_probe: int, k: int):
    """q f32[B, d]; blocks u8/f32[C, Lmax, d]; bscales f32[C, Lmax, 2] or
    None (f32 blocks); block_ids i32[C, Lmax].

    Large shapes scan one probed list per step with per-chunk top-k
    pre-reduction: scoring temps stay [B, chunk, d] (~512 MB bound), a
    per-chunk ``lax.top_k`` keeps k survivors (distance ties break by
    in-list position, which equals ascending id within a chunk — lists
    are packed in stable insertion order), and the running merge is the
    exact two-key (d2, id) top-k. Unit-scale shapes keep the one-shot
    bit-exact path (full-probe == exact search, pinned by tests)."""
    from ..ops.topk import topk_dist_id

    b, d = q.shape
    _, lmax, _ = blocks.shape
    cd2 = (
        jnp.sum(q * q, 1, keepdims=True)
        - 2.0 * jnp.dot(q, centroids.T, preferred_element_type=jnp.float32,
                        precision=jax.lax.Precision.HIGHEST)
        + jnp.sum(centroids * centroids, 1)[None, :]
    )
    _, probe = jax.lax.top_k(-cd2, n_probe)  # [B, p] list indices
    if b * n_probe * lmax * d * 4 <= DENSE_IVF_SEARCH_LIMIT:
        cand = blocks[probe]  # [B, p, Lmax, d] — contiguous block gather
        cand_ids = block_ids[probe]  # [B, p, Lmax]
        if bscales is not None:  # quantized blocks: dequantize in-register
            s = bscales[probe]  # [B, p, Lmax, 2]
            cand = cand.astype(jnp.float32) * s[..., 1:2] + s[..., 0:1]
        d2 = l2sq(q[:, None, None, :], cand).reshape(b, n_probe * lmax)
        ids = cand_ids.reshape(b, n_probe * lmax)
        d2 = jnp.where(ids >= 0, d2, INF)
        ids = jnp.where(ids >= 0, ids, PAD_ID)
        sd, si = sort_dist_id(d2, ids)
        return jnp.sqrt(sd[:, :k]), si[:, :k]

    # the probed block is gathered ONCE per step as u8 (its cheap form);
    # only the dequantize+l2sq runs in slices of that materialized array.
    # (Slicing the GATHER itself — blocks[li, c0:c0+ch] — materializes a
    # [C, ch, d] copy of the sliced table per chunk, measured far slower
    # at 1M/B=4096.)
    ch = min(lmax, max(64, (1 << 29) // max(b * d * 4, 1)))

    def step(carry, pi):
        bd, bi = carry
        li = probe[:, pi]  # [B]
        cand = blocks[li]  # [B, Lmax, d] u8 — one contiguous gather
        sc_full = None if bscales is None else bscales[li]
        ids_full = block_ids[li]  # [B, Lmax]
        parts = []
        for c0 in range(0, lmax, ch):
            candc = cand[:, c0 : c0 + ch]
            if sc_full is not None:
                sc = sc_full[:, c0 : c0 + ch]
                candc = (candc.astype(jnp.float32) * sc[..., 1:2]
                         + sc[..., 0:1])
            parts.append(l2sq(q[:, None, :], candc))
        d2 = parts[0] if len(parts) == 1 else jnp.concatenate(parts, axis=1)
        d2 = jnp.where(ids_full >= 0, d2, INF)
        ids = jnp.where(ids_full >= 0, ids_full, PAD_ID)
        md = jnp.concatenate([bd, d2], axis=1)
        mi = jnp.concatenate([bi, ids], axis=1)
        return topk_dist_id(md, mi, k), None

    bd0 = jnp.full((b, k), INF, jnp.float32)
    bi0 = jnp.full((b, k), PAD_ID, jnp.int32)
    (bd, bi), _ = jax.lax.scan(step, (bd0, bi0), jnp.arange(n_probe))
    return jnp.sqrt(bd), bi


class IVFFlatIndex:
    """Inverted-file index with exact (quantized-space) distances."""

    def __init__(
        self,
        dim: int,
        n_lists: int = 0,
        n_probe: int = 8,
        kmeans_iters: int = 10,
        seed: int = 0,
        metric: str = "l2",
        quantized_blocks: bool = True,
    ):
        if metric not in ("l2", "cosine"):
            raise ValueError(f"unknown metric {metric!r}")
        self.metric = metric
        self.dim = int(dim)
        self.n_lists = int(n_lists)
        self.n_probe = int(n_probe)
        self.kmeans_iters = int(kmeans_iters)
        self.seed = seed
        self.quantized_blocks = quantized_blocks
        self.centroids = None
        self.blocks = None  # u8 (or f32) [C, Lmax, d]
        self.bscales = None  # f32[C, Lmax, 2] when quantized_blocks
        self.block_ids = None  # i32[C, Lmax]
        self.codes = None  # u8[cap, d] (source of truth for repack/persist)
        self.scales = None  # f32[cap, 2]
        self._assign = None  # i32[N] host-side list assignment
        self._counts = None  # i64[C] live entries per list
        self._n = 0  # live rows in codes/scales (capacity-padded buffers)

    def __len__(self) -> int:
        return self._n

    # -- construction --------------------------------------------------

    def train_add(self, vectors: np.ndarray) -> np.ndarray:
        """Train the coarse quantizer and add all vectors (bulk build)."""
        vectors = self._prep(vectors)
        n = vectors.shape[0]
        if self.n_lists <= 0:
            self.n_lists = max(1, int(np.sqrt(n)))
        c = min(self.n_lists, n)
        self.n_lists = c
        # quantize on HOST (native C++ kernel, bit-matched to the device
        # path — tests/test_quant.py): uploads u8 codes (4x less than
        # f32 vectors) and keeps the numpy copies _pack needs, instead
        # of fetching the codes back after a device-side quantize
        codes_np, scales_np = quantize_np(vectors)
        self.codes = jnp.asarray(codes_np)
        self.scales = jnp.asarray(scales_np)
        self._n = n
        cent, assign = _coarse_kmeans(
            self.codes, self.scales, c, self.kmeans_iters, self.seed
        )
        self.centroids = cent
        self._assign = np.asarray(assign)
        self._pack(codes_np=codes_np, scales_np=scales_np)
        return np.arange(n, dtype=np.int32)

    def add(self, vectors: np.ndarray) -> np.ndarray:
        """Incremental add after training — amortized O(1) per vector.

        Each new vector is assigned to its nearest centroid and SCATTERED
        into its list's tail slot on device; the world is never repacked.
        The row buffer grows geometrically (doubling), and the shared
        per-list block width grows geometrically when some list fills, so
        the occasional O(N) growth amortizes away. Ids are stable row
        positions. On an untrained index this is :meth:`train_add`."""
        if self.centroids is None:
            return self.train_add(vectors)
        vectors = self._prep(vectors)
        n_new = vectors.shape[0]
        codes, scales = quantize(jnp.asarray(vectors))
        assign = np.asarray(_assign_jit(dequantize(codes, scales), self.centroids))
        start = self._n

        # grow the row buffers (doubling) and append
        cap = int(self.codes.shape[0])
        if start + n_new > cap:
            new_cap = max(start + n_new, 2 * cap)
            self.codes = jnp.concatenate(
                [self.codes,
                 jnp.zeros((new_cap - cap, self.dim), self.codes.dtype)]
            )
            pad_sc = jnp.tile(jnp.asarray([[0.0, 1.0]], jnp.float32),
                              (new_cap - cap, 1))
            self.scales = jnp.concatenate([self.scales, pad_sc])
        self.codes = jax.lax.dynamic_update_slice_in_dim(
            self.codes, codes, start, 0
        )
        self.scales = jax.lax.dynamic_update_slice_in_dim(
            self.scales, scales, start, 0
        )
        self._assign = np.concatenate([self._assign, assign])
        self._n += n_new

        # per-list tail positions for the batch: counts[l] + rank of this
        # row among same-list rows within the batch
        order = np.argsort(assign, kind="stable")
        srt = assign[order]
        idx = np.arange(n_new, dtype=np.int64)
        first = np.r_[True, srt[1:] != srt[:-1]] if n_new else np.zeros(0, bool)
        grp_start = np.maximum.accumulate(np.where(first, idx, 0))
        within = self._counts[srt] + (idx - grp_start)

        lmax_cap = int(self.blocks.shape[1])
        if within.size and int(within.max()) >= lmax_cap:
            self._grow_blocks(int(within.max()) + 1)
        rows = jnp.asarray(srt.astype(np.int32))
        slots = jnp.asarray(within.astype(np.int32))
        new_ids = jnp.asarray((start + order).astype(np.int32))
        if self.quantized_blocks:
            self.blocks = self.blocks.at[rows, slots].set(codes[order])
            self.bscales = self.bscales.at[rows, slots].set(scales[order])
        else:
            self.blocks = self.blocks.at[rows, slots].set(
                dequantize(codes, scales)[order]
            )
        self.block_ids = self.block_ids.at[rows, slots].set(new_ids)
        np.add.at(self._counts, assign, 1)
        return np.arange(start, start + n_new, dtype=np.int32)

    def _grow_blocks(self, need: int) -> None:
        """Widen the shared per-list block width geometrically (pad rows
        keep id -1 / identity scale, so search masking is unchanged)."""
        old = int(self.blocks.shape[1])
        new = max(need, 2 * old, 8)
        pad = new - old
        self.blocks = jnp.pad(self.blocks, ((0, 0), (0, pad), (0, 0)))
        if self.bscales is not None:
            padded = jnp.pad(self.bscales, ((0, 0), (0, pad), (0, 0)))
            self.bscales = padded.at[:, old:, 1].set(1.0)
        self.block_ids = jnp.pad(
            self.block_ids, ((0, 0), (0, pad)), constant_values=-1
        )

    def retrain(self, kmeans_iters: int | None = None) -> "IVFFlatIndex":
        """Re-run k-means over everything stored (distribution drift after
        many :meth:`add` calls) and repack. Ids are unchanged."""
        if self._n == 0:
            raise ValueError("nothing stored to retrain on")
        x = dequantize(self.codes[: self._n], self.scales[: self._n])
        rng = np.random.default_rng(self.seed + 1)
        c = min(self.n_lists, self._n)
        self.n_lists = c
        init = jnp.asarray(
            rng.choice(self._n, size=c, replace=False).astype(np.int32)
        )
        cent, assign = _kmeans(
            x, init, c, kmeans_iters or self.kmeans_iters
        )
        self.centroids = cent
        self._assign = np.asarray(assign)
        self._pack()
        return self

    def _prep(self, vectors: np.ndarray) -> np.ndarray:
        vectors = np.atleast_2d(np.asarray(vectors, np.float32))
        if vectors.shape[-1] != self.dim:
            raise DimensionMismatch(
                f"index dim {self.dim}, got {vectors.shape[-1]}"
            )
        if self.metric == "cosine":
            vectors = np.asarray(normalize(vectors))
        return vectors

    def _pack(self, codes_np: np.ndarray | None = None,
              scales_np: np.ndarray | None = None) -> None:
        """Vectorized repack of codes/scales into padded per-list blocks
        (sorted-by-list, position = (list, within-list rank)), with ~25%
        width headroom so subsequent :meth:`add` calls scatter into tail
        slots instead of repacking. ``codes_np``/``scales_np``: host
        copies when the caller already has them (train_add's host
        quantize) — skips a device->host fetch of the whole code table."""
        c, n, d = self.n_lists, self._n, self.dim
        order = np.argsort(self._assign, kind="stable")
        srt = self._assign[order]
        counts = np.bincount(srt, minlength=c)
        starts = np.zeros(c + 1, np.int64)
        np.cumsum(counts, out=starts[1:])
        within = np.arange(n, dtype=np.int64) - starts[srt]
        lmax = max(1, int(counts.max()))
        lmax += min(max(lmax // 4, 8), 1024)  # add headroom
        bids = np.full((c, lmax), -1, np.int32)
        bids[srt, within] = order.astype(np.int32)
        if codes_np is None:
            codes_np = np.asarray(self.codes[:n])
            scales_np = np.asarray(self.scales[:n])
        if self.quantized_blocks:
            blocks = np.zeros((c, lmax, d), np.uint8)
            bsc = np.zeros((c, lmax, 2), np.float32)
            bsc[..., 1] = 1.0  # identity scale on pad rows
            blocks[srt, within] = codes_np[:n][order]
            bsc[srt, within] = scales_np[:n][order]
            self.blocks = jnp.asarray(blocks)
            self.bscales = jnp.asarray(bsc)
        else:
            blocks = np.zeros((c, lmax, d), np.float32)
            deq = (codes_np[:n].astype(np.float32) * scales_np[:n, 1:2]
                   + scales_np[:n, 0:1])
            blocks[srt, within] = deq[order]
            self.blocks = jnp.asarray(blocks)
            self.bscales = None
        self.block_ids = jnp.asarray(bids)
        self._counts = counts.astype(np.int64)

    # -- persistence ----------------------------------------------------

    def save(self, path: str) -> None:
        """Checkpoint to a directory (``params.json`` + ``arrays.npz``) —
        persistence as a first-class index capability, matching the
        reference's one persisted family (``hnsw/src/template.rs:43-73``).
        The trained centroids and the list assignment are saved, so
        :meth:`load` never re-runs k-means."""
        import json
        import os

        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, "params.json"), "w") as f:
            json.dump(
                {
                    "format": "hnsw_rs_tpu.ivf.v1",
                    "dim": self.dim,
                    "n_lists": self.n_lists,
                    "n_probe": self.n_probe,
                    "kmeans_iters": self.kmeans_iters,
                    "seed": self.seed,
                    "metric": self.metric,
                    "quantized_blocks": self.quantized_blocks,
                    "n": self._n,
                },
                f,
                indent=2,
            )
        n = self._n
        arrays = {
            "codes": np.asarray(self.codes)[:n],
            "scales": np.asarray(self.scales)[:n],
            "assign": np.asarray(self._assign)[:n],
        }
        if self.centroids is not None:
            arrays["centroids"] = np.asarray(self.centroids)
        np.savez_compressed(os.path.join(path, "arrays.npz"), **arrays)

    @classmethod
    def load(cls, path: str) -> "IVFFlatIndex":
        """Restore from :meth:`save`; blocks are repacked from the saved
        codes + assignment (cheap) — k-means is NOT re-run."""
        import json
        import os

        with open(os.path.join(path, "params.json")) as f:
            meta = json.load(f)
        if meta.get("format") != "hnsw_rs_tpu.ivf.v1":
            raise ValueError(f"unknown index format in {path}")
        index = cls(
            meta["dim"],
            n_lists=meta["n_lists"],
            n_probe=meta["n_probe"],
            kmeans_iters=meta["kmeans_iters"],
            seed=meta["seed"],
            metric=meta["metric"],
            quantized_blocks=meta["quantized_blocks"],
        )
        with np.load(os.path.join(path, "arrays.npz")) as z:
            index.codes = jnp.asarray(z["codes"])
            index.scales = jnp.asarray(z["scales"])
            index._assign = np.asarray(z["assign"])
            if "centroids" in z:
                index.centroids = jnp.asarray(z["centroids"])
        index._n = int(meta["n"])
        if index.centroids is not None and index._n:
            index._pack()
        return index

    # -- queries --------------------------------------------------------

    def search(
        self, queries: np.ndarray, k: int, n_probe: int | None = None
    ) -> tuple[np.ndarray, np.ndarray]:
        """Batched top-k: (distances [B, k], ids [B, k])."""
        if self.centroids is None:
            raise ValueError("index is untrained: call train_add/add first")
        queries = np.atleast_2d(np.asarray(queries, np.float32))
        if self.metric == "cosine":
            queries = np.asarray(normalize(queries))
        q = dequantize(*quantize(jnp.asarray(queries)))
        p = min(n_probe or self.n_probe, self.n_lists)
        d, i = _ivf_search(
            q, self.centroids, self.blocks, self.bscales, self.block_ids, p, k
        )
        return np.asarray(d), np.asarray(i)
