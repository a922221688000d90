"""The HNSW index — public API parity with the reference's ``HNSW`` struct
(``hnsw/src/template.rs:36-40``): ``new``/``insert_bulk``/``insert_vec``/
``ann_by_vector``/``save``/``load``/``len``/``distance``/``get_point``/
``print_index``/``assert_param_compliance``/``layer_degrees`` — built on
a batched core (dense adjacency + lockstep batched traversal).

State is a pytree of device arrays (codes, scales, per-layer adjacency)
plus host metadata (levels, params); queries run as one jitted batched
pipeline (``search.ann_search``).
"""

from __future__ import annotations

import dataclasses
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np

from ..build import build_index, insert_waves
from ..errors import DimensionMismatch
from ..graphs import LayeredGraph, degrees
from ..ops.quant import dequantize, quantize
from ..params import Params
from ..search import (
    ann_search,
    ann_search_packed,
    ann_search_pq,
    ann_search_seeded,
    ann_search_seeded_plain,
    ann_search_seeded_probe,
    ann_search_seeded_probe_packed,
    pack_layer,
    pack_layer_pq,
)
from ..store import PointStore
from ..utils.progress import ProgressBar


@dataclasses.dataclass
class Point:
    """View of a stored point (the reference's ``Point``,
    ``points/src/point.rs:5-10``)."""

    id: int
    level: int
    values: np.ndarray


@functools.partial(jax.jit, static_argnames=("ef", "k", "max_iters"))
def _ann_jit(adjs, codes, scales, q, ep, ef, k, max_iters):
    return ann_search(adjs, codes, scales, q, ep, ef, k, max_iters)


@functools.partial(
    jax.jit, static_argnames=("ef", "k", "max_iters", "expand_e")
)
def _ann_packed_jit(
    adjs_upper, packed0, codes, scales, q, ep, ef, k, max_iters, expand_e=1
):
    return ann_search_packed(
        adjs_upper, packed0, codes, scales, q, ep, ef, k, max_iters, expand_e
    )


@functools.partial(
    jax.jit, static_argnames=("ef", "k", "max_iters", "expand_e")
)
def _ann_seeded_jit(
    packed0, pivot_ids, pivot_vecs, q, ef, k, max_iters, expand_e=1
):
    return ann_search_seeded(
        packed0, pivot_ids, pivot_vecs, q, ef, k, max_iters, expand_e
    )


@functools.partial(
    jax.jit, static_argnames=("ef", "k", "max_iters", "probes", "expand_e")
)
def _ann_seeded_probe_jit(
    packed0, pivot_ids, pivot_vecs, shortlist, codes, scales, q,
    ef, k, max_iters, probes, expand_e=1,
):
    return ann_search_seeded_probe(
        packed0, pivot_ids, pivot_vecs, shortlist, codes, scales, q,
        ef, k, max_iters, probes, expand_e,
    )


@functools.partial(
    jax.jit,
    static_argnames=("t", "d", "ef", "k", "max_iters", "probes", "expand_e"),
)
def _ann_seeded_probe_packed_jit(
    packed0, pivot_ids, pivot_vecs, shortlist_pack, t, d, q,
    ef, k, max_iters, probes, expand_e=1,
):
    return ann_search_seeded_probe_packed(
        packed0, pivot_ids, pivot_vecs, shortlist_pack, t, d, q,
        ef, k, max_iters, probes, expand_e,
    )


@functools.partial(
    jax.jit, static_argnames=("ef", "k", "max_iters", "rerank", "expand_e")
)
def _ann_pq_jit(
    packed0, codebooks, pq_codes, pivot_ids, pivot_vecs, codes, scales, q,
    ef, k, max_iters, rerank, expand_e=1, rot=None,
):
    return ann_search_pq(
        packed0, codebooks, pq_codes, pivot_ids, pivot_vecs, codes, scales,
        q, ef, k, max_iters, rerank, expand_e, rot,
    )


@functools.partial(
    jax.jit, static_argnames=("ef", "k", "max_iters", "expand_e")
)
def _ann_seeded_plain_jit(
    adj0, table, scales, pivot_ids, pivot_vecs, q, ef, k, max_iters,
    expand_e=1,
):
    return ann_search_seeded_plain(
        adj0, table, scales, pivot_ids, pivot_vecs, q, ef, k, max_iters,
        expand_e,
    )


def _build_shortlist(vecs, codes, scales, t: int, chunk: int = 2048):
    """Per-pivot top-``t`` shortlists (``finalize(pivot_shortlist=T)``):
    each pivot's t nearest stored points via tiled flat searches (pure
    matmul + streaming top-k — [P, N] never materializes).

    The pivot-query batch is CHUNKED: one flat-search dispatch holds a
    [B, tile] f32 distance block, so 32k pivots against a 128k tile is
    a 16 GB temp. 2048-pivot chunks bound it at 1 GB and pipeline as
    independent async dispatches."""
    from .flat import _flat_search_tiled
    from ..ops.distance import point_normsq

    normsq = point_normsq(codes, scales)
    fs = jax.jit(functools.partial(_flat_search_tiled, k=t))
    parts = [
        fs(vecs[lo:lo + chunk], codes, scales, normsq)[1]
        for lo in range(0, vecs.shape[0], chunk)
    ]
    sl = parts[0] if len(parts) == 1 else jnp.concatenate(parts)
    return sl.astype(jnp.int32)


class HNSW:
    """Hierarchical Navigable Small World index on an accelerator."""

    def __init__(
        self,
        m: int,
        ef_cons: int | None = None,
        dim: int = 0,
        params: Params | None = None,
        metric: str = "l2",
        extend_cands: bool = True,
    ):
        if params is None:
            if ef_cons is not None:
                params = Params.from_m_efcons(m, ef_cons, dim)
            else:
                params = Params.from_m(m, dim)
            params.metric = metric
            params.extend_cands = extend_cands
        if params.metric not in ("l2", "cosine"):
            raise ValueError(f"unknown metric {params.metric!r}")
        self.params = params
        self.points = PointStore.empty(params.dim)
        self.graph = LayeredGraph(params.m, 0)
        self._level_rng_calls = 0  # deterministic level stream position
        # serving-path dequantized table cache (see search._gather_vecs);
        # auto-enabled while the f32 copy stays under this many bytes (a
        # value sized for a smaller device, ROADMAP queue 2 item 2)
        self.f32_cache_limit = 2 << 30
        self._f32_table = None
        self._f32_n = -1
        # packed-neighbor serving layout (see search.pack_layer); built by
        # finalize(), invalidated by any graph mutation. serve_expand > 1
        # amortizes beam-iteration fixed costs (search._beam_loop)
        self._packed0 = None
        self._packed_n = -1
        self.serve_expand = 1
        # pivot-seeded serving (finalize(pivots=...)): matmul against
        # the upper-layer skeleton replaces greedy descent at query time
        self._pivots = None
        self._pivots_n = -1
        # per-pivot shortlists (finalize(pivot_shortlist=T)): probed
        # regions' local top-T enter the beam exactly scored at iter 0
        # (search.ann_search_seeded_probe); serve_probes = pivots probed
        self._pivot_shortlist = None
        # packed shortlist table (pack_layer over the shortlist — it is
        # adjacency-shaped): probes wide-row gathers per query instead
        # of probes*T narrow ones (search.ann_search_seeded_probe_packed)
        self._pivot_sl_pack = None
        self.serve_probes = 16
        # cluster-build serving pivots: one representative per k-means
        # cluster (set by insert_bulk(cluster_build=True); finalize seeds
        # from these first — every region covered by construction)
        self._cluster_pivots = None
        # PQ-coded serving (finalize(pq_m=...)): ADC beam over a PQ-packed
        # layer-0 — the beyond-device-memory mode (search.ann_search_pq)
        self._pq = None  # (codebooks, pq_codes, packed0_pq)
        self._pq_n = -1
        self.pq_rerank = 0  # exact re-score width; 0 -> max(4k, ef)
        # pending incremental inserts, batched into waves (amortizes the
        # one-wave-per-insert_vec dispatch); flushed on any read or at
        # pending_flush_size
        self._pending: list[np.ndarray] = []
        self.pending_flush_size = 1024

    # -- basics ------------------------------------------------------------

    def __len__(self) -> int:
        return len(self.points) + len(self._pending)

    @property
    def ep(self) -> int:
        return self.params.ep

    def distance(self, a: int, b: int) -> float:
        """True L2 between stored points (``template.rs:150-152``)."""
        self.flush()
        return self.points.distance(a, b)

    def get_point(self, point_id: int) -> Point | None:
        if point_id < 0 or point_id >= len(self):
            return None
        if point_id >= len(self.points):
            self.flush()
        return Point(
            id=point_id,
            level=int(self.points.levels[point_id]),
            values=self.points.get_values(point_id),
        )

    def _check_dim(self, vectors: np.ndarray) -> None:
        d = vectors.shape[-1]
        if self.params.dim and d != self.params.dim:
            raise DimensionMismatch(
                f"index dimension is {self.params.dim}, got vectors of dimension {d}"
            )

    # -- construction ------------------------------------------------------

    def insert_bulk(
        self,
        vectors: np.ndarray,
        verbose: bool = False,
        **build_kwargs,
    ) -> "HNSW":
        """Bulk build / bulk extend (``insert_bulk``, ``template.rs:388-445``).

        On an empty index this is a from-scratch wave-parallel build; on a
        non-empty index the new points are wave-inserted per layer
        top-down. Returns self.

        ``build_kwargs``: ``wave_base``/``wave_growth``/``wave_cap`` (wave
        schedule — speed vs intra-wave blindness), ``build_expand`` (E>1
        pops per construction-search iteration, ~E× fewer beam iterations
        at held quality — see ``build._wave_layer_step_impl``),
        ``max_iters``.
        """
        self.flush()
        vectors = np.atleast_2d(np.asarray(vectors, np.float32))
        self._check_dim(vectors)
        vectors = self._maybe_normalize(vectors)
        if self.params.dim == 0:
            self.params.dim = int(vectors.shape[-1])
            self.points = PointStore.empty(self.params.dim)
        fresh = len(self) == 0
        new = PointStore.from_vectors(
            vectors, self.params.ml, seed=self._level_seed()
        )
        new_ids = self.points.extend(new)
        if fresh:
            self.graph, ep, packed0, creps = build_index(
                self.points, self.params, verbose=verbose, **build_kwargs
            )
            self._cluster_pivots = creps
            if creps is not None and len(self.points):
                # cluster-built graphs serve poorly through plain
                # hierarchical descent (below the 0.99 gate at any ef on
                # 1M) but clear it pivot-SEEDED. Auto-enable the memory-honest
                # seeded mode (no packed rows) so the default ann_batch
                # is gate-quality; finalize() upgrades/retunes it.
                self.params.ep = ep
                self.finalize(
                    pivots=max(1024, int(1.5 * creps.size)), packed=False
                )
            self.params.ep = ep
            if packed0 is not None:
                # a packed build maintains the serving layout as it goes —
                # keep it: packed serving (finalize()'s layout) for free
                self._packed0 = packed0
                self._packed_n = len(self)
        else:
            self._extend_built(new_ids, verbose=verbose, **build_kwargs)
        return self

    def insert_vec(self, vector: np.ndarray) -> int:
        """Incremental single-vector insert (``insert_vec``,
        ``template.rs:165-173``). Returns the new point id.

        Inserts are BUFFERED and batched into waves: consecutive calls
        accumulate host-side and flush as one wave insert on any read
        (query/save/get_point/distance) or when ``pending_flush_size``
        accumulate — same visible semantics (a point is searchable by the
        time anything can search), ~1000× the sustained insert rate of
        one dispatch per call. Call :meth:`flush` to force application.
        """
        vector = np.asarray(vector, np.float32).reshape(-1)
        self._check_dim(vector[None])
        if self.params.dim == 0:
            self.params.dim = int(vector.shape[-1])
            self.points = PointStore.empty(self.params.dim)
        new_id = len(self)
        self._pending.append(np.asarray(vector, np.float32))
        if len(self._pending) >= self.pending_flush_size:
            self.flush()
        return new_id

    def flush(self) -> "HNSW":
        """Apply buffered :meth:`insert_vec` calls as one wave insert."""
        if not self._pending:
            return self
        vectors = np.stack(self._pending)
        self._pending = []
        # levels for the whole batch come from one seeded draw (the level
        # stream position still advances once per store call, like the
        # bulk path)
        vectors = self._maybe_normalize(vectors)
        new = PointStore.from_vectors(
            vectors, self.params.ml, seed=self._level_seed()
        )
        new_ids = self.points.extend(new)
        if len(self.points) == vectors.shape[0]:  # was empty: fresh build
            self.graph, ep, packed0, creps = build_index(self.points, self.params)
            self._cluster_pivots = creps
            self.params.ep = ep  # (was dropped before: queries entered at 0)
            if packed0 is not None:
                self._packed0 = packed0
                self._packed_n = len(self.points)
            self.params.ep = ep
        else:
            self._extend_built(new_ids, verbose=False)
        return self

    def _maybe_normalize(self, v: np.ndarray) -> np.ndarray:
        if self.params.metric == "cosine":
            from ..ops.distance import normalize

            return np.asarray(normalize(v))
        return v

    def _level_seed(self) -> int:
        # distinct deterministic seed per store call; the reference reuses
        # seed 0 every call (points/src/points.rs:40) which makes every
        # incremental insert draw the *same* level — we keep determinism
        # but advance the stream
        s = self._level_rng_calls
        self._level_rng_calls += 1
        return s

    def _extend_built(self, new_ids: np.ndarray, verbose: bool, **build_kwargs) -> None:
        """Wave-insert new points into an existing graph, per layer
        top-down, and fix up the entry point if a new point exceeds the old
        top level (the reference leaves that dangling — TODO at
        ``template.rs:285-289``; we connect it properly)."""
        levels = self.points.levels
        old_top = len(self.graph) - 1
        new_top = int(levels[new_ids].max())
        self.graph.ensure_nodes(self.points.capacity)
        self.graph.ensure_level(max(old_top, new_top))
        max_iters = build_kwargs.pop("max_iters", None) or 2 * self.params.ef_cons + 16
        # bulk-only knobs have no meaning for incremental extension (the
        # cluster/packed/seeded machinery owns whole layers, not deltas);
        # dropping them lets `insert_bulk(vectors, cluster_build=True)`
        # be called uniformly on fresh AND non-empty indexes
        for bulk_only in (
            "cluster_build", "cluster_kwargs", "packed_build", "pack_lag",
            "build_seeded", "build_pivot_cap", "wave_sort",
        ):
            build_kwargs.pop(bulk_only, None)
        bar = ProgressBar("inserting", len(new_ids), enabled=verbose)
        new_lv = levels[new_ids]
        for layer_nb in range(int(new_lv.max()), -1, -1):
            home = np.asarray(new_ids)[new_lv == layer_nb].astype(np.int32)
            if home.size == 0:
                continue
            insert_waves(
                self.graph, self.points, self.params, home, layer_nb,
                self.params.ep, max_iters, bar, **build_kwargs,
            )
        bar.finish()
        from ..build import repair_connectivity

        repair_connectivity(self.graph, self.points)
        if new_top > old_top:
            self.params.ep = int(new_ids[np.argmax(new_lv)])

    # -- queries -----------------------------------------------------------

    def ann_by_vector(
        self, vector: np.ndarray, n: int, ef: int
    ) -> np.ndarray:
        """Top-n approximate neighbors of one query
        (``ann_by_vector``, ``template.rs:306-335``)."""
        return self.ann_batch(np.asarray(vector, np.float32)[None, :], n, ef)[1][0]

    def ann_batch(
        self,
        queries: np.ndarray,
        n: int,
        ef: int,
        max_iters: int | None = None,
    ) -> tuple[np.ndarray, np.ndarray]:
        """Batched queries — the serving path. Returns
        (distances [B, n], ids [B, n])."""
        self.flush()
        queries = np.atleast_2d(np.asarray(queries, np.float32))
        self._check_dim(queries)
        ef = max(ef, n)
        if max_iters is None:
            max_iters = 2 * ef + 16
        # queries are quantized then dequantized: the index lives in
        # quantized space (template.rs:313)
        queries = self._maybe_normalize(queries)
        # pad the batch to a power-of-two bucket so arbitrary batch sizes
        # reuse a handful of compiled variants
        b = queries.shape[0]
        bp = 1 << max(6, (b - 1).bit_length())
        if bp != b:
            queries = np.concatenate(
                [queries, np.zeros((bp - b, queries.shape[1]), np.float32)]
            )
        qc, qs = quantize(jnp.asarray(queries))
        q = dequantize(qc, qs)
        ep = jnp.asarray(self.params.ep, jnp.int32)
        pack_fresh = self._packed0 is not None and self._packed_n == len(self)
        piv_fresh = self._pivots is not None and self._pivots_n == len(self)
        pq_fresh = self._pq is not None and self._pq_n == len(self)
        if pq_fresh and piv_fresh:
            cb, pq_codes, packed_pq, rot = self._pq
            # default: exact-rescore the FULL beam — one [B, ef] gather +
            # l2sq at the end of the query, ~free next to the beam loop,
            # and ADC ordering noise within a neighborhood is the PQ
            # mode's measured recall wall (|adc-exact| ~ the NN1->NN10
            # gap at d=96/pq_m=24 on clustered data; brute ADC top-40
            # contains only 67% of true top-10 where top-ef-wide rescue
            # reaches 100%)
            rr = self.pq_rerank or max(4 * n, ef)
            d, i = _ann_pq_jit(
                packed_pq, cb, pq_codes, self._pivots[0], self._pivots[1],
                self.points.codes, self.points.scales, q, ef, n, max_iters,
                rr, self.serve_expand, rot,
            )
        elif pack_fresh and piv_fresh and self._pivot_sl_pack is not None:
            d, i = _ann_seeded_probe_packed_jit(
                self._packed0, self._pivots[0], self._pivots[1],
                self._pivot_sl_pack, self._pivot_shortlist.shape[1],
                self.params.dim, q, ef, n, max_iters,
                self.serve_probes, self.serve_expand,
            )
        elif pack_fresh and piv_fresh and self._pivot_shortlist is not None:
            d, i = _ann_seeded_probe_jit(
                self._packed0, self._pivots[0], self._pivots[1],
                self._pivot_shortlist, self.points.codes,
                self.points.scales, q, ef, n, max_iters,
                self.serve_probes, self.serve_expand,
            )
        elif pack_fresh and piv_fresh:
            d, i = _ann_seeded_jit(
                self._packed0, self._pivots[0], self._pivots[1],
                q, ef, n, max_iters, self.serve_expand,
            )
        elif pack_fresh:
            d, i = _ann_packed_jit(
                tuple(self.graph.adjs[1:]), self._packed0,
                self.points.codes, self.points.scales, q, ep,
                ef, n, max_iters, self.serve_expand,
            )
        elif piv_fresh:
            # memory-honest seeded mode (finalize(..., packed=False)):
            # pivot seeds + plain layer-0 gathers — no packed rows held
            d, i = _ann_seeded_plain_jit(
                self.graph.get_layer(0), self._serving_table(),
                self.points.scales, self._pivots[0], self._pivots[1],
                q, ef, n, max_iters, self.serve_expand,
            )
        else:
            table = self._serving_table()
            d, i = _ann_jit(
                tuple(self.graph.adjs), table, self.points.scales,
                q, ep, ef, n, max_iters,
            )
        return np.asarray(d)[:b], np.asarray(i)[:b]

    def refine(
        self,
        rounds: int = 1,
        layer: int = 0,
        hop_w: int = 8,
        pool_p: int = 192,
        use_alg4: bool = True,
        batch: int = 1024,
    ) -> "HNSW":
        """Synchronous NN-descent refinement of a built layer
        (``refine.refine_layer``): every node re-selects its out-row from
        its 2-hop neighborhood via the Algorithm-4 accept chain. Lifts
        graph quality on regimes whose blob granularity fights the
        cluster builder's k-means pools (the measured heavy-tailed
        plateau) with batched gathers + matvecs per round. Invalidates packed/PQ serving layouts for the
        refined layer (re-run :meth:`finalize`); the pivot seed set
        remains valid (it is a property of the points, not the edges).
        Returns self."""
        from ..refine import refine_layer

        self.flush()
        if len(self) == 0:
            return self
        refine_layer(
            self.graph, self.points, layer_nb=layer, rounds=rounds,
            hop_w=hop_w, pool_p=pool_p, use_alg4=use_alg4, batch=batch,
        )
        if layer == 0:
            self._packed0 = None
            self._packed_n = -1
            self._pq = None
            self._pq_n = -1
        return self

    def finalize(
        self,
        expand: int = 1,
        pivots: int = 0,
        packed: bool = True,
        pq_m: int = 0,
        pq_iters: int = 12,
        pq_rerank: int = 0,
        pq_opq: bool = False,
        pq_bits: int = 8,
        pivot_fill: str = "cover",
        pivot_cover: float = 0.25,
        pivot_shortlist: int = 0,
    ) -> "HNSW":
        """Build the packed-neighbor serving layout for layer 0.

        Trades ~``cap*(dim+12)`` bytes per point of extra device memory
        for a ~3·cap× reduction in gather rows per beam expansion — the
        difference between row-rate-bound and bandwidth-bound serving
        where gathers are bound by rows issued rather than bytes.
        Identical query results at ``expand=1``; ``expand`` E>1 pops E
        beam entries per lockstep iteration (see ``search._beam_loop``).

        NOTE: ``pivots`` is absolute state, not a delta — every call sets
        the serving mode from its arguments alone, so ``finalize(expand=E)``
        with the default ``pivots=0`` DISABLES a previously enabled
        pivot-seeded mode (tests/test_search.py codifies this). Pass the
        current pivot count again when adjusting only ``expand``.

        ``pivots`` > 0 additionally enables pivot-SEEDED serving
        (``search.ann_search_seeded``): the highest-level ~``pivots``
        nodes' vectors are cached dense, each query batch takes one
        matmul against them, and the top-ef seed the layer-0 beam —
        replacing the serial upper-layer descent. Recall per ef is
        typically equal or better at materially fewer beam iterations.
        ``pivot_fill="cover"`` (default) reserves a ``pivot_cover``
        fraction of the budget for device k-center picks over the
        stored points (structural picks — level>=1 pool + cluster
        representatives — are capped at the remainder): coverage of the
        low-density regions density-proportional sampling starves — the
        heavy-tailed fix, ``ops/cover.py``. Size ``pivot_cover`` to the
        data's blob granularity: every natural cluster needs a seed, so
        ``budget * pivot_cover`` should be >= the number of natural
        clusters not already holding a structural pivot.
        ``pivot_fill="stride"`` = structural picks to the full budget,
        then evenly-strided ids (density-proportional; ``pivot_cover`` is
        ignored).

        ``pivot_shortlist=T`` (with ``pivots`` > 0) additionally builds
        each pivot's top-``T`` nearest-points shortlist (one tiled flat
        search) and switches serving to the PROBED mode
        (``search.ann_search_seeded_probe``): the ``serve_probes``
        nearest pivots' shortlist members enter the beam exactly scored
        at iteration 0. This is the fix for walk-limited regimes where
        recall was a function of ``max_iters`` alone (heavy-tailed 1M):
        beam MEMBERSHIP, not expansion, is what
        recall@k needs.

        ``pq_m`` > 0 (requires ``pivots`` > 0) enables the PQ-coded
        serving mode instead: a product quantizer with ``pq_m``
        bytes/point is trained on the stored points (deterministic,
        seed-fixed — safe to re-run after :meth:`load`), layer 0 is
        packed as ``cap*(pq_m+4)`` bytes/point of neighbor (code, id)
        rows, and queries run ADC beams with an exact re-score of the
        top ``pq_rerank`` (default ``max(4k, ef/2)``) survivors
        (``search.ann_search_pq``). This replaces the exact packed table
        (``packed`` is forced off) — it is the beyond-device-memory axis:
        at M=24/d=96/pq_m=24 the serving pack shrinks 3.0× and the beam
        fetches no vectors at all. ``pq_opq=True`` trains an OPQ rotation
        first (``ops.pq.opq_train``) — same memory, strictly lower
        quantization error; the ADC beam builds its LUT from ``q @ R``.

        ``pq_bits=4`` keeps ``pq_m`` BYTES per point but splits them into
        ``2 * pq_m`` subspaces with 16-entry codebooks, nibble-packed —
        same memory, and the ADC lookup becomes a gather-free unrolled
        compare-select (``ops.pq.adc_score16``) instead of per-element
        LUT gathers, which were nearly all of the 8-bit PQ beam's cost.

        Re-run after inserts (a stale pack is detected and bypassed,
        never served). Returns self."""
        self.flush()
        if pq_m > 0:
            if pivots <= 0:
                raise ValueError("pq_m > 0 requires pivots > 0 "
                                 "(PQ serving seeds from the pivot table)")
            if pq_bits not in (4, 8):
                raise ValueError(f"pq_bits must be 4 or 8, got {pq_bits}")
            # m_sub subspaces of pq_bits each; pq_m stays BYTES per point
            m_sub = pq_m if pq_bits == 8 else 2 * pq_m
            nv = 1 << pq_bits
            if self.params.dim % m_sub != 0:
                raise ValueError(f"{m_sub} subspaces (pq_m {pq_m} at "
                                 f"{pq_bits} bits) must divide dim "
                                 f"{self.params.dim}")
            packed = False  # the PQ pack replaces the exact-code pack
            if len(self) > 0:
                from ..ops.pq import encode_pq, pack_nibbles, train_pq

                n = len(self)
                x = dequantize(self.points.codes[:n],
                               self.points.scales[:n])
                # train on a deterministic even subsample: the batched
                # Lloyd step materializes a [Ntrain, m_sub, nv] distance
                # temp (vmapped subspaces), which at full million scale
                # is tens of GB; 64k samples train codebooks to the same
                # distortion (standard PQ practice)
                ts = min(n, 65536)
                rot = None
                if pq_opq:
                    # OPQ (``ops.pq.opq_train``): learned orthogonal
                    # rotation before the subspace split; the ADC beam
                    # builds its LUT from q @ R (ann_search_pq)
                    from ..ops.pq import opq_train

                    rot, cb = opq_train(
                        x, m_sub, pq_iters=pq_iters, seed=0, train_n=ts,
                        nv=nv,
                    )
                elif ts < n:
                    pick = jnp.asarray(
                        np.linspace(0, n - 1, ts).round().astype(np.int64)
                    )
                    cb = train_pq(x[pick], m_sub, iters=pq_iters, seed=0,
                                  nv=nv)
                else:
                    cb = train_pq(x, m_sub, iters=pq_iters, seed=0, nv=nv)
                # encode everything in chunks for the same temp reason
                if rot is not None:
                    # DEFAULT precision: encoding input; the PQ beam's
                    # exact rerank owns the returned ranking
                    x = jnp.dot(x, rot, preferred_element_type=jnp.float32,
                                precision=jax.lax.Precision.DEFAULT)
                ch = 1 << 16
                pq_codes = (
                    encode_pq(x, cb) if n <= ch else jnp.concatenate(
                        [encode_pq(x[s : s + ch], cb)
                         for s in range(0, n, ch)]
                    )
                )
                if pq_bits == 4:
                    # stored + packed form is nibble-packed: pq_m bytes
                    # per point either way (search dispatches on nv)
                    pq_codes = pack_nibbles(pq_codes)
                packed_pq = pack_layer_pq(
                    self.graph.get_layer(0)[:n], pq_codes
                )
                self._pq = (cb, pq_codes, packed_pq, rot)
                self._pq_n = n
            self.pq_rerank = int(pq_rerank)
        else:
            self._pq = None
            self._pq_n = -1
        if not packed:
            # memory-honest mode (``packed=False``): drop/skip the
            # cap*(d+12) B/point packed rows; with ``pivots`` > 0 queries
            # use pivot seeds + plain layer-0 gathers
            # (``search.ann_search_seeded_plain``)
            self._packed0 = None
            self._packed_n = -1
        elif len(self.graph) > 0 and self._packed_n != len(self):
            # (a packed build already left a fresh pack — _packed_n
            # matches — so only re-pack after load / plain build / insert)
            self._packed0 = pack_layer(
                self.graph.get_layer(0), self.points.codes, self.points.scales
            )
            self._packed_n = len(self)
        self.serve_expand = int(expand)
        if pivots > 0 and len(self) > 0:
            budget = min(pivots, len(self))
            # structural picks (levels / cluster reps) are capped at
            # (1 - pivot_cover) of the budget under pivot_fill="cover":
            # both pools are density-proportional, and when they consume
            # the whole budget the coverage fill never runs — exactly
            # the measured heavy-tailed failure (tail queries' best seed
            # ~3x further than the true NN, diag_heavy_tailed.py). The
            # reserved share goes to k-center picks over the points.
            cap = budget if pivot_fill == "stride" else max(
                1, budget - int(round(budget * float(pivot_cover)))
            )
            levels = np.asarray(self.points.levels[: len(self)])
            # smallest level whose member count fits the cap; then an
            # even deterministic subsample if even level 1 is too big
            ids = None
            for lv in range(int(levels.max()), 0, -1):
                cand = np.flatnonzero(levels >= lv)
                if cand.size >= min(cap, len(self)) or lv == 1:
                    ids = cand
                    break
            if ids is None or ids.size == 0:  # single-layer graph
                ids = np.arange(len(self))
            if ids.size > cap:
                # exactly `cap` evenly-spaced picks (dedup-safe: size >
                # cap makes the rounded linspace strictly increasing
                # often enough; duplicates are removed and the budget is
                # still met within a couple of ids) — a ceil-stride slice
                # can undershoot the configured budget by ~2x
                pick = np.unique(
                    np.linspace(0, ids.size - 1, cap).round().astype(np.int64)
                )
                ids = ids[pick]
            if self._cluster_pivots is not None:
                # cluster-built graphs: levels carry no structural meaning
                # and level-sampled pivots MISS whole micro-regions (a
                # cluster of s points has no level>=1 member with
                # probability (1-1/M)^s — measured as whole-query recall
                # collapses whose best seed sat ~28x further than the true
                # NN). The build's per-cluster representatives cover every
                # region BY CONSTRUCTION: seed from them first, topping up
                # with the level-based picks to the cap.
                reps = np.asarray(self._cluster_pivots, np.int64)
                if reps.size > cap:
                    pick = np.unique(
                        np.linspace(0, reps.size - 1, cap)
                        .round().astype(np.int64)
                    )
                    reps = reps[pick]
                seen = set(reps.tolist())
                extra = [i for i in np.asarray(ids).tolist()
                         if i not in seen][: max(0, cap - reps.size)]
                ids = np.concatenate([reps, np.asarray(extra, np.int64)])
            if ids.size < budget:
                # FILL the budget: the level>=1 pool alone can be far
                # smaller than the budget (833 nodes at 20k/M=24 vs a
                # 4096 request — the budget silently went unfilled), and
                # level sampling leaves whole micro-regions seedless:
                # measured as whole-query recall losses whose best seed
                # sat ~28x further than the true neighbor.
                need = budget - ids.size
                if pivot_fill == "cover":
                    # k-center fill (ops/cover.py): picks the points
                    # FARTHEST from the current pivot set, covering
                    # low-density regions density-proportional sampling
                    # starves (the heavy-tailed 1M failure mode)
                    from ..ops.cover import kcenter_fill

                    x = dequantize(
                        self.points.codes[: len(self)],
                        self.points.scales[: len(self)],
                    )
                    fill = kcenter_fill(x, np.asarray(ids, np.int64), need)
                else:  # "stride": evenly-strided layer-0 ids
                    stride = np.linspace(
                        0, len(self) - 1, budget
                    ).round().astype(np.int64)
                    seen2 = set(np.asarray(ids).tolist())
                    fill = np.asarray(
                        [i for i in stride.tolist() if i not in seen2][
                            :need
                        ],
                        np.int64,
                    )
                ids = np.concatenate([np.asarray(ids, np.int64), fill])
            ids = jnp.asarray(np.asarray(ids).astype(np.int32))
            vecs = dequantize(self.points.codes[ids], self.points.scales[ids])
            self._pivots = (ids, vecs)
            self._pivots_n = len(self)
            if pivot_shortlist > 0:
                # per-pivot shortlists (ann_search_seeded_probe): each
                # pivot's T nearest stored points via ONE tiled flat
                # search (one matmul per tile + streaming top-k — [P, N]
                # never materializes). Measured motivation: on heavy-tailed 1M
                # the beam's recall was a function of max_iters alone
                # (misses were never-walked-to candidates); probing puts
                # every nearby region's local top-T IN the beam at
                # iteration 0 with exact scores.
                n = len(self)
                self._pivot_shortlist = _build_shortlist(
                    vecs, self.points.codes[:n], self.points.scales[:n],
                    int(pivot_shortlist),
                )
                if packed:
                    # packed shortlist rows (the shortlist is adjacency-
                    # shaped, so pack_layer's row format is reused
                    # verbatim): the probe stage then costs `probes`
                    # wide-row gathers per query instead of probes*T
                    # narrow ones — T=128/probes=16 is 2048 -> 16 rows
                    # (search.ann_search_seeded_probe_packed)
                    self._pivot_sl_pack = pack_layer(
                        self._pivot_shortlist, self.points.codes[:n],
                        self.points.scales[:n],
                    )
                else:
                    self._pivot_sl_pack = None
            else:
                self._pivot_shortlist = None
                self._pivot_sl_pack = None
        elif pivots == 0:
            self._pivots = None
            self._pivots_n = -1
            self._pivot_shortlist = None
            self._pivot_sl_pack = None
        return self

    def _serving_table(self) -> "jnp.ndarray":
        """uint8 codes, or the cached dequantized f32 table when it fits
        (identical distances — dequantization is exact either way)."""
        nbytes = self.points.capacity * max(self.params.dim, 1) * 4
        if nbytes > self.f32_cache_limit:
            return self.points.codes
        if self._f32_table is None or self._f32_n != len(self):
            self._f32_table = dequantize(self.points.codes, self.points.scales)
            self._f32_n = len(self)
        return self._f32_table

    # -- introspection -----------------------------------------------------

    def layer_degrees(self, layer_nb: int) -> np.ndarray:
        """Out-degrees of the layer's member nodes
        (``template.rs:158-163``)."""
        self.flush()
        return self.graph.layer_degrees(layer_nb, self.points.levels)

    def assert_param_compliance(self, verbose: bool = True) -> bool:
        """Degree caps respected and no isolated member nodes
        (``assert_param_compliance``, ``template.rs:341-370``)."""
        self.flush()
        ok = True
        for layer_nb in range(len(self.graph)):
            cap = self.params.layer_cap(layer_nb)
            adj = np.asarray(self.graph.get_layer(layer_nb))
            degs = np.asarray(degrees(self.graph.get_layer(layer_nb)))
            member = self.points.levels >= layer_nb
            if np.any(degs[member] > cap):
                ok = False
                if verbose:
                    print(f"layer {layer_nb}: degree cap {cap} exceeded")
            if int(member.sum()) > 1 and np.any(degs[member] == 0):
                ok = False
                if verbose:
                    bad = np.flatnonzero(member & (degs == 0))
                    print(f"layer {layer_nb}: {bad.size} isolated nodes {bad[:10]}")
            # in-degree: our adjacency is directed, so the reference's
            # undirected min-degree >= 1 check (template.rs:356-367) means
            # both out-degree and in-degree must be nonzero
            if int(member.sum()) > 1:
                indeg = np.bincount(adj[adj >= 0], minlength=self.points.capacity)
                if np.any(indeg[member] == 0):
                    ok = False
                    if verbose:
                        bad = np.flatnonzero(member & (indeg == 0))
                        print(
                            f"layer {layer_nb}: {bad.size} nodes with "
                            f"in-degree 0 {bad[:10]}"
                        )
        if ok and verbose:
            print("Index complies with params.")
        return ok

    def print_index(self) -> None:
        """Dump index stats (``print_index``, ``template.rs:372-385``)."""
        self.flush()
        p = self.params
        print(f"m = {p.m}\nmmax = {p.mmax}\nmmax0 = {p.mmax0}")
        print(f"ml = {p.ml}\nef_cons = {p.ef_cons}")
        print(f"Nb. layers = {len(self.graph)}")
        print(f"Nb. of points = {len(self)}")
        for idx in range(len(self.graph)):
            print(f"Nb. nodes in layer {idx}: {self.graph.nb_nodes(idx, self.points.levels)}")
        print(f"ep: {p.ep}")

    # -- persistence -------------------------------------------------------

    def save(self, path: str) -> None:
        """Checkpoint to a directory: ``params.json`` + ``arrays.npz``
        (the analogue of the reference's points/params/layers directory
        format, ``template.rs:43-73``)."""
        self.flush()
        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, "params.json"), "w") as f:
            json.dump(
                {
                    "format": "hnsw_rs_tpu.v1",
                    "params": self.params.to_dict(),
                    "n_layers": len(self.graph),
                    "level_rng_calls": self._level_rng_calls,
                },
                f,
                indent=2,
            )
        n = len(self)
        arrays = {
            "codes": np.asarray(self.points.codes)[:n],
            "scales": np.asarray(self.points.scales)[:n],
            "levels": np.asarray(self.points.levels)[:n],
        }
        for i in range(len(self.graph)):
            arrays[f"adj_{i}"] = np.asarray(self.graph.get_layer(i))[:n]
        if self._cluster_pivots is not None:
            arrays["cluster_pivots"] = np.asarray(
                self._cluster_pivots, np.int32
            )
        np.savez_compressed(os.path.join(path, "arrays.npz"), **arrays)

    @classmethod
    def load(cls, path: str) -> "HNSW":
        """Restore from :meth:`save` (``template.rs:75-131``)."""
        with open(os.path.join(path, "params.json")) as f:
            meta = json.load(f)
        if meta.get("format") != "hnsw_rs_tpu.v1":
            raise ValueError(f"unknown index format in {path}")
        params = Params.from_dict(meta["params"])
        with np.load(os.path.join(path, "arrays.npz")) as z:
            codes = jnp.asarray(z["codes"])
            scales = jnp.asarray(z["scales"])
            levels = np.asarray(z["levels"])
            adjs = [jnp.asarray(z[f"adj_{i}"]) for i in range(meta["n_layers"])]
            creps = (
                np.asarray(z["cluster_pivots"]) if "cluster_pivots" in z
                else None
            )
        index = cls(params.m, params=params)
        index._cluster_pivots = creps
        index.points = PointStore(codes, scales, levels)
        index.graph = LayeredGraph(params.m, codes.shape[0])
        # populate through the layer API so in-degree caches are created
        # (indeg=None → lazy recompute); assigning .adjs directly leaves
        # _indegs empty and corrupts the next insert's isolate-protection
        if adjs:
            index.graph.ensure_level(len(adjs) - 1)
            for i, adj in enumerate(adjs):
                index.graph.set_layer(i, adj, indeg=None)
        index._level_rng_calls = int(meta.get("level_rng_calls", 1))
        return index
