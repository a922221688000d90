"""Out-of-core HNSW serving: beam search over a disk-resident index.

The ambition behind the reference's ``HNSWDisk`` (``hnsw/src/disk.rs:
22-109``), whose graph half is stubs (``disk.rs:102-109``): serve an
index LARGER THAN DEVICE MEMORY. Layout (DiskANN-style split):

- upper layers (a ~1/m fraction of nodes) live in memory — they are the
  routing skeleton and tiny;
- layer 0's fixed-slot adjacency is a disk ``memmap`` (the OS page cache
  is the natural LRU for hot graph regions);
- layer 0's vectors page through :class:`..store_paged.BlockStore`'s
  block LRU (arithmetic block offsets, positioned reads).

The beam itself runs HOST-side with the exact flagged-beam semantics of
``search.search_layer`` (same (d2, id) order, same beam-membership +
ring dedup, same termination). Rationale: the paged regime is IO-bound
by construction, and each lockstep iteration needs a random set of
neighbor codes — a device round-trip per iteration pays a launch and a
host→device copy of the codes, versus microseconds of host arithmetic. (The
streaming *exact* search, which IS device-friendly because its reads
are sequential, lives in ``BlockStore.search_streaming``.)

Working set: O(batch × ef + block cache + OS page cache) — independent
of N. Recall parity with the in-memory index is pinned by test
(tests/test_paged.py): identical beam semantics on identical data.
"""

from __future__ import annotations

import json
import os
import threading
from collections import OrderedDict

import numpy as np

from ..params import Params
from ..store_paged import BlockStore, write_block_store

PAD_ID = np.iinfo(np.int32).max
_ADJ_FILE = "layer0.adj"
_UPPER_FILE = "upper.npz"
_POINTS_FILE = "points.blocks"
_META_FILE = "paged.json"


def save_paged(index, path: str) -> None:
    """Write an :class:`..models.hnsw.HNSW` index in the paged layout."""
    index.flush()
    os.makedirs(path, exist_ok=True)
    n = len(index)
    codes = np.asarray(index.points.codes)[:n]
    scales = np.asarray(index.points.scales)[:n]
    levels = np.asarray(index.points.levels)[:n]
    write_block_store(os.path.join(path, _POINTS_FILE), codes, scales, levels)
    adj0 = np.ascontiguousarray(
        np.asarray(index.graph.get_layer(0))[:n], dtype=np.int32
    )
    adj0.tofile(os.path.join(path, _ADJ_FILE))
    upper = {
        f"adj_{i}": np.asarray(index.graph.get_layer(i))[:n]
        for i in range(1, len(index.graph))
    }
    upper["levels"] = levels
    # persist finalize()'s EXACT pivot seed set when it is current: the
    # in-memory selection rule (level>=1 + cluster representatives +
    # strided budget fill, models/hnsw.py finalize) evolves, and the
    # hybrid tier must seed identically to keep exactness vs in-memory
    # (tests/test_paged.py::test_hybrid_paged_matches_in_memory_seeded)
    if getattr(index, "_pivots", None) is not None and index._pivots_n == n:
        upper["pivot_ids"] = np.asarray(index._pivots[0], np.int32)
    np.savez_compressed(os.path.join(path, _UPPER_FILE), **upper)
    with open(os.path.join(path, _META_FILE), "w") as f:
        json.dump(
            {
                "n": int(n),
                "cap0": int(adj0.shape[1]),
                "n_layers": len(index.graph),
                "params": index.params.to_dict(),
            },
            f,
        )


class PagedHNSW:
    """Query-only HNSW over the paged on-disk layout."""

    def __init__(self, path: str, cache_blocks: int = 1024):
        with open(os.path.join(path, _META_FILE)) as f:
            meta = json.load(f)
        self._adj_path = os.path.join(path, _ADJ_FILE)
        self._blocks_path = os.path.join(path, _POINTS_FILE)
        self.n = int(meta["n"])
        self.params = Params.from_dict(meta["params"])
        self.store = BlockStore(
            os.path.join(path, _POINTS_FILE), cache_blocks=cache_blocks
        )
        self.adj0 = np.memmap(
            os.path.join(path, _ADJ_FILE), dtype=np.int32, mode="r",
            shape=(self.n, int(meta["cap0"])),
        )
        with np.load(os.path.join(path, _UPPER_FILE)) as z:
            self.upper = [
                z[f"adj_{i}"] for i in range(1, int(meta["n_layers"]))
            ]
            self.levels = z["levels"]
            self.pivot_ids = (
                z["pivot_ids"] if "pivot_ids" in z.files else None
            )

    def __len__(self) -> int:
        return self.n

    # -- paged vector access -------------------------------------------------

    def _values(self, ids: np.ndarray) -> np.ndarray:
        """Dequantized vectors for a flat id array, block-batched through
        the BlockStore LRU (one decode per touched block)."""
        ids = np.asarray(ids, np.int64).ravel()
        out = np.empty((ids.size, self.store.dim), np.float32)
        blocks = ids // self.store.max_per_block
        pos = ids % self.store.max_per_block
        for b in np.unique(blocks):
            codes, scales, _ = self.store._load_block(int(b))
            sel = blocks == b
            p = pos[sel]
            out[sel] = (
                codes[p].astype(np.float32) * scales[p, 1:2] + scales[p, 0:1]
            )
        return out

    def _d2(self, q: np.ndarray, ids: np.ndarray) -> np.ndarray:
        """Squared L2 from per-row queries to per-row id sets:
        q [B, d], ids [B, K] -> [B, K] (invalid ids give garbage —
        callers mask)."""
        b, k = ids.shape
        vec = self._values(np.clip(ids, 0, self.n - 1)).reshape(b, k, -1)
        diff = vec - q[:, None, :]
        return np.einsum("bkd,bkd->bk", diff, diff, dtype=np.float32)

    # -- query ----------------------------------------------------------------

    def ann_batch(
        self, queries: np.ndarray, n: int, ef: int, max_iters: int | None = None
    ) -> tuple[np.ndarray, np.ndarray]:
        """Batched query with ``search.search_layer`` semantics: greedy
        upper-layer descent, flagged-beam layer 0 paged from disk.
        Returns (distances [B, n], ids [B, n])."""
        from ..ops.quant import quantize

        queries = np.atleast_2d(np.asarray(queries, np.float32))
        if self.params.metric == "cosine":
            nn = np.linalg.norm(queries, axis=-1, keepdims=True)
            queries = queries / np.where(nn > 0, nn, 1.0)
        # queries live in quantized space (template.rs:313)
        c, s = (np.asarray(x) for x in quantize(queries))
        q = c.astype(np.float32) * s[:, 1:2] + s[:, 0:1]
        ef = max(ef, n)
        if max_iters is None:
            max_iters = 2 * ef + 16
        b = q.shape[0]

        cur = np.full((b,), self.params.ep, np.int32)
        cur_d2 = self._d2(q, cur[:, None])[:, 0]
        for adj in reversed(self.upper):  # greedy ef=1 descent
            while True:
                nbrs = np.asarray(adj[cur])  # [B, cap]
                valid = nbrs >= 0
                d2 = np.where(valid, self._d2(q, nbrs), np.inf)
                nids = np.where(valid, nbrs, PAD_ID)
                j = np.lexsort((nids, d2), axis=-1)[:, 0]
                bd = d2[np.arange(b), j]
                bi = nids[np.arange(b), j]
                better = (bd < cur_d2) | ((bd == cur_d2) & (bi < cur))
                if not better.any():
                    break
                cur_d2 = np.where(better, bd, cur_d2)
                cur = np.where(better, bi, cur).astype(np.int32)

        # layer-0 flagged beam (search.search_layer semantics)
        cap = self.adj0.shape[1]
        ring_size = max(2 * cap, 64)
        beam_d2 = np.full((b, ef), np.inf, np.float32)
        beam_ids = np.full((b, ef), PAD_ID, np.int32)
        beam_exp = np.ones((b, ef), bool)
        beam_d2[:, 0] = cur_d2
        beam_ids[:, 0] = cur
        beam_exp[:, 0] = False
        ring = np.full((b, ring_size), PAD_ID, np.int32)
        ring[:, 0] = cur
        rows = np.arange(b)

        for _ in range(max_iters):
            unexp = ~beam_exp
            active = unexp.any(axis=1)
            if not active.any():
                break
            pos = unexp.argmax(axis=1)
            cand = beam_ids[rows, pos]
            beam_exp[rows, pos] = True

            nbrs = np.asarray(self.adj0[np.clip(cand, 0, self.n - 1)])
            valid = (nbrs >= 0) & active[:, None]
            safe = np.where(valid, nbrs, 0)
            known = (safe[:, :, None] == beam_ids[:, None, :]).any(-1) | (
                safe[:, :, None] == ring[:, None, :]
            ).any(-1)
            new = valid & ~known
            ring = np.concatenate(
                [np.where(new, nbrs, PAD_ID), ring[:, : ring_size - cap]], 1
            )
            nd2 = np.where(new, self._d2(q, safe), np.inf)
            nids = np.where(new, nbrs, PAD_ID)

            md = np.concatenate([beam_d2, nd2], 1)
            mi = np.concatenate([beam_ids, nids], 1)
            me = np.concatenate([beam_exp, ~new], 1)
            order = np.lexsort((mi, md), axis=-1)[:, :ef]
            beam_d2 = np.take_along_axis(md, order, 1)
            beam_ids = np.take_along_axis(mi, order, 1)
            beam_exp = np.take_along_axis(me, order, 1)

        return np.sqrt(beam_d2[:, :n]), beam_ids[:, :n]

    def ann_by_vector(self, vector: np.ndarray, n: int, ef: int) -> np.ndarray:
        return self.ann_batch(np.asarray(vector, np.float32)[None], n, ef)[1][0]

    # -- shared host-side helpers for the hybrid tier ------------------------

    def _codes_scales(self, ids: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Raw (codes u8 [K, d], scales f32 [K, 2]) for a flat id array,
        block-batched through the BlockStore LRU."""
        ids = np.asarray(ids, np.int64).ravel()
        codes = np.empty((ids.size, self.store.dim), np.uint8)
        scales = np.empty((ids.size, 2), np.float32)
        blocks = ids // self.store.max_per_block
        pos = ids % self.store.max_per_block
        for b in np.unique(blocks):
            c, s, _ = self.store._load_block(int(b))
            sel = blocks == b
            codes[sel] = c[pos[sel]]
            scales[sel] = s[pos[sel]]
        return codes, scales

    def _packed_rows_host(self, ids: np.ndarray) -> np.ndarray:
        """Packed rows (``search.pack_layer`` byte layout) for ``ids``,
        assembled host-side from the memmap adjacency + paged blocks —
        via the native C++ assembler (``native/fastio.cpp``: one mmap
        pass, BE->LE scale swap in place) when available, else numpy."""
        ids = np.asarray(ids, np.int64).ravel()
        cap = self.adj0.shape[1]
        d = self.store.dim
        from ..native import assemble_packed_rows

        out = assemble_packed_rows(
            self._adj_path, self.n, cap, self._blocks_path, d,
            self.store.max_per_block, ids,
        )
        if out is not None:
            return out
        adj = np.asarray(self.adj0[np.clip(ids, 0, self.n - 1)])  # [K, cap]
        safe = np.where(adj >= 0, adj, 0).ravel()
        codes, scales = self._codes_scales(safe)
        k = ids.size
        return np.concatenate(
            [
                codes.reshape(k, cap * d),
                scales.view(np.uint8).reshape(k, cap * 8),
                adj.astype(np.int32).view(np.uint8).reshape(k, cap * 4),
            ],
            axis=1,
        )


class HybridPagedHNSW(PagedHNSW):
    """Paged serving with a DEVICE hot tier (beats the intent of
    ``hnsw/src/disk.rs:22-109``, whose graph half is stubs).

    Device-resident (bounded by ``hot_bytes``): packed layer-0 rows of the
    highest-in-degree nodes (hub rows serve most beam expansions), a
    global id->hot-slot map, and a pivot skeleton (the level>=1 nodes'
    vectors) that seeds each query's beam with one matmul. Cold
    expansions page their packed row from disk (BlockStore LRU + memmap
    adjacency) and ride one compact host->device staging upload per beam
    iteration, batched across the whole query batch.

    The beam body is the exact ``search._beam_loop`` iteration (same
    (d2, id) order, beam-membership + ring dedup, same termination), so
    results match the in-memory packed index given the same seeds; the
    hot tier only changes WHERE a row is fetched from. Working set:
    O(hot_bytes + batch × ef + block cache) — independent of N.
    """

    def __init__(
        self,
        path: str,
        hot_bytes: int = 512 << 20,
        pivots: int = 8192,
        cache_blocks: int = 1024,
        prefetch: int = 0,
        pq_m: int = 0,
        pq_bits: int = 4,
        pq_iters: int = 12,
    ):
        """``prefetch > 0`` enables speculative cold staging: each beam
        iteration also returns its ``prefetch`` next-best unexpanded
        candidates, whose packed rows a worker thread assembles into a
        host row cache WHILE the device expands the popped ones — the
        next iteration's cold staging then starts from warm rows
        (overlaps disk IO + row assembly with device compute; results
        are bit-identical, prefetch only warms caches).

        ``pq_m > 0`` selects the PQ-TIER mode instead (DiskANN-style
        split, device-native): the device holds PQ-packed layer-0 rows
        (``cap * (pq_m + 4)`` B/point — ~9-13x smaller than exact packed
        rows) + the pivot skeleton; the ENTIRE beam runs on-device with
        gather-free ADC (``search.pq_beam`` / ``ops.pq.adc_score16`` at
        the default ``pq_bits=4``), and exact vectors are paged from
        disk ONCE per batch for the final rerank. This removes the
        exact hot tier's per-iteration host<->device staging entirely
        (its loss mode over a slow host link); results are
        approximate-beam + exact-rerank rather than bit-exact vs
        in-memory, recall-parity gated by tests/benchmarks."""
        super().__init__(path, cache_blocks=cache_blocks)
        import jax.numpy as jnp

        cap = self.adj0.shape[1]
        d = self.store.dim
        self._cap, self._d = cap, d
        self._wrow = cap * (d + 12)
        self.pq_m = int(pq_m)
        self.hits = 0  # hot-tier expansion counters (observability)
        self.misses = 0

        if pq_m > 0:
            self._build_pq_tier(pq_m, pq_bits, pq_iters)
            self.hot_rows = 0
        else:
            h = int(min(self.n, max(1, hot_bytes // self._wrow)))
            # hot set = top in-degree rows, one chunked memmap pass
            indeg = np.zeros(self.n + 1, np.int64)
            ch = 1 << 16
            for lo in range(0, self.n, ch):
                rows = np.asarray(self.adj0[lo : lo + ch])
                v = rows[rows >= 0]
                indeg[: self.n] += np.bincount(v, minlength=self.n)
            hot_ids = np.argpartition(-indeg[: self.n], h - 1)[:h]
            hot_ids.sort()
            slot = np.full(self.n, -1, np.int32)
            slot[hot_ids] = np.arange(h, dtype=np.int32)
            self._slot_host = slot
            self._hot_packed = jnp.asarray(self._packed_rows_host(hot_ids))
            self.hot_rows = h

        # pivot skeleton: the saved index's finalize() seed set when
        # present (exactness vs in-memory requires the SAME seeds — the
        # in-memory rule includes cluster representatives and a strided
        # budget fill the level test below can't reproduce); otherwise
        # level>=1 nodes evenly subsampled / strided-filled to budget
        if self.pivot_ids is not None:
            piv = np.asarray(self.pivot_ids, np.int64)
        else:
            piv = np.flatnonzero(self.levels >= 1)
            if piv.size == 0:
                piv = np.arange(min(self.n, max(1, pivots)))
            if piv.size > pivots:
                pick = np.unique(
                    np.linspace(0, piv.size - 1, pivots)
                    .round().astype(np.int64)
                )
                piv = piv[pick]
            elif piv.size < min(pivots, self.n):
                # mirror finalize()'s budget fill (models/hnsw.py):
                # evenly-strided layer-0 ids top up the seed set
                stride = np.linspace(
                    0, self.n - 1, min(pivots, self.n)
                ).round().astype(np.int64)
                seen = set(piv.tolist())
                fill = [i for i in stride.tolist() if i not in seen]
                piv = np.concatenate([
                    piv.astype(np.int64),
                    np.asarray(fill[: pivots - piv.size], np.int64),
                ])
        pc, ps = self._codes_scales(piv)
        self._pivot_ids = jnp.asarray(piv.astype(np.int32))
        self._pivot_vecs = jnp.asarray(
            pc.astype(np.float32) * ps[:, 1:2] + ps[:, 0:1]
        )

        # speculative prefetch state (see __init__ docstring)
        self.prefetch = int(prefetch)
        self._row_cache: "OrderedDict[int, np.ndarray]" = OrderedDict()
        self._row_cache_cap = 0  # sized per batch in ann_batch
        self._row_lock = threading.Lock()
        self._pf_pool = None  # lazy ThreadPoolExecutor(1)
        self.prefetch_hits = 0

    def _build_pq_tier(self, pq_m: int, pq_bits: int, pq_iters: int) -> None:
        """Train PQ on a paged subsample, encode every stored point
        (sequential block reads), and pack layer 0's neighbor (code, id)
        rows on-device — the one-time cost of the staging-free serving
        mode. Codes live in the same quantized space as the in-memory
        index (``template.rs:313``)."""
        import jax.numpy as jnp

        from ..ops.pq import encode_pq, pack_nibbles, train_pq
        from ..search import pack_layer_pq

        if pq_bits not in (4, 8):
            raise ValueError(f"pq_bits must be 4 or 8, got {pq_bits}")
        m_sub = pq_m if pq_bits == 8 else 2 * pq_m
        if self.store.dim % m_sub != 0:
            raise ValueError(f"{m_sub} subspaces (pq_m {pq_m} at "
                             f"{pq_bits} bits) must divide dim "
                             f"{self.store.dim}")
        n = self.n
        ts = min(n, 65536)
        pick = np.linspace(0, n - 1, ts).round().astype(np.int64)
        cb = train_pq(
            jnp.asarray(self._values(pick)), m_sub, iters=pq_iters,
            seed=0, nv=1 << pq_bits,
        )
        ch = 1 << 16
        parts = []
        for lo in range(0, n, ch):
            ids = np.arange(lo, min(lo + ch, n), dtype=np.int64)
            parts.append(encode_pq(jnp.asarray(self._values(ids)), cb))
        pq_codes = parts[0] if len(parts) == 1 else jnp.concatenate(parts)
        if pq_bits == 4:
            pq_codes = pack_nibbles(pq_codes)
        self._pq_cb = cb
        self._pq_codes = pq_codes
        self._pq_packed = pack_layer_pq(
            jnp.asarray(np.ascontiguousarray(self.adj0)), pq_codes
        )
        self.device_bytes = int(
            self._pq_packed.size + pq_codes.size + cb.size * 4
        )

    def _ann_batch_pq(
        self, q: np.ndarray, n: int, ef: int, max_iters: int,
        expand_e: int, rerank: int,
    ) -> tuple[np.ndarray, np.ndarray]:
        """PQ-tier query: one on-device ADC beam dispatch (zero
        per-iteration staging), then ONE disk-paged exact rerank of the
        top ``rerank`` survivors per query (numpy — the host flops are
        trivial next to the block reads)."""
        import jax.numpy as jnp

        from ..search import pq_beam

        b = q.shape[0]
        bp = 1 << max(6, (b - 1).bit_length())
        qj = jnp.asarray(
            np.concatenate([q, np.zeros((bp - b, q.shape[1]), np.float32)])
            if bp != b else q
        )
        _, beam_ids = _paged_pq_jit(
            self._pq_packed, self._pq_cb, self._pq_codes,
            self._pivot_ids, self._pivot_vecs, qj,
            ef=ef, max_iters=max_iters, expand_e=expand_e,
        )
        r = min(max(n, rerank or ef), int(beam_ids.shape[1]))
        cand = np.asarray(beam_ids[:, :r])[:b]  # [b, r] (one small fetch)
        safe = np.clip(np.where(cand == PAD_ID, 0, cand), 0, self.n - 1)
        vec = self._values(safe.ravel()).reshape(b, r, -1)
        diff = vec - q[:, None, :]
        d2 = np.einsum("brd,brd->br", diff, diff, dtype=np.float32)
        d2 = np.where(cand == PAD_ID, np.inf, d2)
        order = np.lexsort((cand, d2), axis=-1)[:, :n]
        return (
            np.sqrt(np.take_along_axis(d2, order, 1)),
            np.take_along_axis(cand, order, 1),
        )

    def _prefetch_rows(self, ids: np.ndarray) -> None:
        """Worker-thread body: assemble packed rows for ``ids`` into the
        host row cache (skips ids already cached)."""
        with self._row_lock:
            todo = [i for i in ids.tolist() if i not in self._row_cache]
        if not todo:
            return
        rows = self._packed_rows_host(np.asarray(todo, np.int64))
        with self._row_lock:
            for i, r in zip(todo, rows):
                self._row_cache[i] = r
            while len(self._row_cache) > self._row_cache_cap:
                self._row_cache.popitem(last=False)

    def _cold_rows(self, ids: np.ndarray) -> np.ndarray:
        """Packed rows for cold ids, served from the prefetch row cache
        where warm, assembled (and cached) otherwise."""
        out = np.empty((ids.size, self._wrow), np.uint8)
        miss = []
        with self._row_lock:
            for j, i in enumerate(ids.tolist()):
                r = self._row_cache.get(i)
                if r is None:
                    miss.append(j)
                else:
                    self._row_cache.move_to_end(i)
                    out[j] = r
        self.prefetch_hits += ids.size - len(miss)
        if miss:
            rows = self._packed_rows_host(ids[miss])
            out[miss] = rows
            if self.prefetch:
                with self._row_lock:
                    for j, r in zip(miss, rows):
                        self._row_cache[int(ids[j])] = r
                    while len(self._row_cache) > self._row_cache_cap:
                        self._row_cache.popitem(last=False)
        return out

    def ann_batch(
        self, queries: np.ndarray, n: int, ef: int,
        max_iters: int | None = None, expand_e: int = 1,
    ) -> tuple[np.ndarray, np.ndarray]:
        """Batched hybrid query: device beam over the hot tier, cold rows
        staged per iteration. ``expand_e > 1`` pops the E best unexpanded
        entries per iteration in ONE dispatch + ONE cold staging upload —
        the paged regime's per-iteration cost is fixed host round-trips
        (dispatch floor + staging latency), so dispatches/query drops ~E×
        at the same recall-per-ef-or-better (``search._beam_loop`` body_e
        semantics: speculative pops only add candidates). Returns
        (distances [B, n], ids [B, n])."""
        import jax.numpy as jnp

        from ..ops.quant import quantize
        from ..search import _pivot_seeds, init_beam

        queries = np.atleast_2d(np.asarray(queries, np.float32))
        if self.params.metric == "cosine":
            nn = np.linalg.norm(queries, axis=-1, keepdims=True)
            queries = queries / np.where(nn > 0, nn, 1.0)
        c, s = quantize(jnp.asarray(queries))
        q = c.astype(jnp.float32) * s[:, 1:2] + s[:, 0:1]
        ef = max(ef, n)
        if max_iters is None:
            max_iters = 2 * ef + 16
        if self.pq_m:
            return self._ann_batch_pq(
                np.asarray(q), n, ef, max_iters, expand_e, 0
            )
        b = int(q.shape[0])
        cap = self._cap
        e = max(1, min(int(expand_e), ef))
        ring_size = max(2 * cap, 64, e * cap)

        e_d2, e_ids = _pivot_seeds(self._pivot_ids, self._pivot_vecs, q, ef)
        beam_d2, beam_ids, beam_exp = init_beam(e_d2, e_ids, ef)
        k0 = e_ids.shape[1]
        ring = jnp.full((b, ring_size), PAD_ID, jnp.int32)
        ring = jnp.concatenate([e_ids, ring[:, : ring_size - k0]], axis=1) \
            if ring_size > k0 else e_ids[:, :ring_size]

        look = max(0, int(self.prefetch))
        pf_pending = None
        if look:
            self._row_cache_cap = max(
                self._row_cache_cap, 8 * b * max(e, look)
            )
            if self._pf_pool is None:
                from concurrent.futures import ThreadPoolExecutor

                self._pf_pool = ThreadPoolExecutor(
                    1, thread_name_prefix="hyb-prefetch"
                )

        self.dispatches = 0  # per-call round-trip counter (observability)
        for _ in range(max_iters):
            cand, active, beam_exp, spec = _hyb_pick(
                beam_d2, beam_ids, beam_exp, e=e, look=look
            )
            cand_h = np.asarray(cand).reshape(-1)  # [B*E]
            act_h = np.asarray(active).reshape(-1)
            if not act_h.any():
                break
            self.dispatches += 1
            cold_lanes = np.flatnonzero(
                act_h & (self._slot_host[np.clip(cand_h, 0, self.n - 1)] < 0)
            )
            self.misses += int(cold_lanes.size)
            self.hits += int(act_h.sum()) - int(cold_lanes.size)
            # compact cold staging, padded to a pow2 bucket to bound the
            # number of compiled variants
            cpad = max(8, 1 << int(cold_lanes.size - 1).bit_length()) \
                if cold_lanes.size else 8
            lanes = np.full(cpad, b * e, np.int32)  # b*e = out-of-range drop
            lanes[: cold_lanes.size] = cold_lanes
            rows_cold = np.zeros((cpad, self._wrow), np.uint8)
            if cold_lanes.size:
                if pf_pending is not None:
                    pf_pending.result()  # rows may still be in flight
                    pf_pending = None
                rows_cold[: cold_lanes.size] = (
                    self._cold_rows(cand_h[cold_lanes]) if look
                    else self._packed_rows_host(cand_h[cold_lanes])
                )
            beam_d2, beam_ids, beam_exp, ring = _hyb_expand(
                self._hot_packed,
                jnp.asarray(self._slot_host[np.clip(cand_h, 0, self.n - 1)]),
                jnp.asarray(rows_cold), jnp.asarray(lanes),
                beam_d2, beam_ids, beam_exp, ring, q, cand, active,
                cap=cap, d=self._d, e=e,
            )
            if look:
                # speculative staging: assemble the lookahead candidates'
                # cold rows on the worker thread while the device expands
                spec_h = np.asarray(spec).reshape(-1)
                spec_h = spec_h[
                    (spec_h >= 0) & (spec_h < self.n)
                ]
                spec_cold = spec_h[self._slot_host[spec_h] < 0]
                if spec_cold.size:
                    pf_pending = self._pf_pool.submit(
                        self._prefetch_rows, np.unique(spec_cold)
                    )

        beam_d2 = np.asarray(beam_d2)
        beam_ids = np.asarray(beam_ids)
        return np.sqrt(beam_d2[:, :n]), beam_ids[:, :n]


def _lazy_jits():
    import functools

    import jax
    import jax.numpy as jnp

    from ..ops.distance import l2sq
    from ..ops.topk import INF as _INF
    from ..ops.topk import dedup_ids, merge_sorted_dist_id, sort_dist_id
    from ..search import unpack_rows

    @functools.partial(jax.jit, static_argnames=("e", "look"))
    def pick(beam_d2, beam_ids, beam_exp, e, look):
        b, ef = beam_ids.shape
        slot_iota = jnp.arange(ef, dtype=jnp.int32)[None, :]
        unexp = jnp.logical_not(beam_exp)
        if e <= 1 and look == 0:
            active = jnp.any(unexp, axis=1)
            pos = jnp.argmax(unexp, axis=1)
            cand = jnp.take_along_axis(beam_ids, pos[:, None], axis=1)[:, 0]
            hit = jnp.logical_and(active[:, None], slot_iota == pos[:, None])
            exp = jnp.logical_or(beam_exp, hit)
            return cand, active, exp, jnp.zeros((b, 0), jnp.int32)
        # E best unexpanded slots (beam is sorted): search._beam_loop
        # body_e; the next `look` slots after them are the speculative
        # prefetch set (likely pops of the NEXT iteration)
        t = min(e + look, ef)
        pos_t = jax.lax.sort(
            jnp.where(unexp, jnp.broadcast_to(slot_iota, unexp.shape), ef),
            dimension=-1,
        )[:, :t]  # [B, t]; ef = "no such slot"
        pos_e = pos_t[:, :e]
        act_e = pos_e < ef
        cand = jnp.take_along_axis(
            beam_ids, jnp.where(act_e, pos_e, 0), axis=1
        )  # [B, E]
        beam_exp = jnp.logical_or(
            beam_exp,
            jnp.any(slot_iota[:, None, :] == pos_e[:, :, None], axis=1),
        )
        pos_s = pos_t[:, e:]
        spec = jnp.where(
            pos_s < ef,
            jnp.take_along_axis(
                beam_ids, jnp.where(pos_s < ef, pos_s, 0), axis=1
            ),
            jnp.int32(-1),
        )  # [B, look]
        if e <= 1:
            cand, act_e = cand[:, 0], act_e[:, 0]
        return cand, act_e, beam_exp, spec

    @functools.partial(jax.jit, static_argnames=("cap", "d", "e"))
    def expand(hot_packed, slot, rows_cold, lanes, beam_d2, beam_ids,
               beam_exp, ring, q, cand, active, cap, d, e):
        b = q.shape[0]
        rows = hot_packed[jnp.clip(slot, 0, hot_packed.shape[0] - 1)]
        rows = rows.at[lanes].set(rows_cold, mode="drop")
        nbrs, vecs = unpack_rows(rows, cap, d)  # [B*E, cap(, d)]
        # exact search._beam_loop body semantics from here on (body_1 at
        # E=1, body_e otherwise: flatten the E rows, dedup before merge)
        if e > 1:
            nbrs = nbrs.reshape(b, e * cap)
            vecs = vecs.reshape(b, e * cap, -1)
            act = active.reshape(b, e)
            valid = jnp.logical_and(
                nbrs >= 0,
                jnp.broadcast_to(
                    act[:, :, None], (b, e, cap)
                ).reshape(b, e * cap),
            )
        else:
            valid = jnp.logical_and(nbrs >= 0, active[:, None])
        nbrs_safe = jnp.where(valid, nbrs, 0)
        known = jnp.logical_or(
            jnp.any(nbrs_safe[:, :, None] == beam_ids[:, None, :], axis=-1),
            jnp.any(nbrs_safe[:, :, None] == ring[:, None, :], axis=-1),
        )
        new = jnp.logical_and(valid, jnp.logical_not(known))
        ring_size = ring.shape[1]
        ring = jnp.concatenate(
            [jnp.where(new, nbrs, jnp.int32(PAD_ID)),
             ring[:, : ring_size - e * cap]], axis=1
        )
        nd2 = l2sq(q[:, None, :], vecs)
        nd2 = jnp.where(new, nd2, _INF)
        nids = jnp.where(new, nbrs, jnp.int32(PAD_ID))
        if e > 1:
            # the E expanded rows may share neighbors — dedup before the
            # merge so the beam never holds one id twice
            nd2, nids = dedup_ids(nd2, nids)
        nd2, nids, nexp = sort_dist_id(nd2, nids, nids == PAD_ID)
        md2, mids, mexp = merge_sorted_dist_id(
            beam_d2, beam_ids, nd2, nids, beam_exp, nexp
        )
        ef = beam_ids.shape[1]
        return md2[:, :ef], mids[:, :ef], mexp[:, :ef], ring

    return pick, expand


def _paged_pq_jit(*a, **k):
    """Lazy-jitted ``search.pq_beam`` (the whole ADC beam is ONE device
    program — the PQ tier's zero-staging property)."""
    global _paged_pq_jit
    import functools

    import jax

    from ..search import pq_beam

    _paged_pq_jit = functools.partial(
        jax.jit, static_argnames=("ef", "max_iters", "expand_e")
    )(pq_beam)
    return _paged_pq_jit(*a, **k)


def _hyb_pick(*a, **k):
    global _hyb_pick, _hyb_expand
    _hyb_pick, _hyb_expand = _lazy_jits()
    return _hyb_pick(*a, **k)


def _hyb_expand(*a, **k):
    global _hyb_pick, _hyb_expand
    _hyb_pick, _hyb_expand = _lazy_jits()
    return _hyb_expand(*a, **k)
