"""Sharded HNSW: per-device sub-graphs + distributed top-k merge.

The memory scale-out path (SURVEY.md §2.6 / BASELINE.json configs 4-5):
the collection is partitioned into contiguous shards, each shard builds an
independent HNSW sub-graph over its slice, and a query fans out to every
shard — each device runs the same lockstep beam search on its sub-index,
then per-shard top-k candidates are merged with an ``all_gather`` over the
``shard`` mesh axis and a final (dist, id) sort. Communication is XLA
collectives (NCCL over NVLink on GPUs); there is no analogue in the reference (single process,
``hnsw/src/template.rs:422-439`` is its entire "communication layer").

Recall note: searching S independent sub-indexes with the same ``ef`` and
merging is at least as accurate as one monolithic index at equal ef — each
shard's exact sub-top-k is a superset restriction — at the cost of S× the
search work per query (amortized by the per-shard size being N/S).

All per-shard state is stacked on a leading ``[S, ...]`` axis sharded over
the mesh's ``shard`` axis, so the same arrays drive both the shard_map'd
query path and (future) fully-sharded wave builds.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..models.hnsw import HNSW
from ..ops.quant import dequantize, quantize
from ..ops.topk import INF, PAD_ID, sort_dist_id
from ..params import Params
from ..search import ann_search, pack_layer, search_layer_packed
from .mesh import make_mesh


def _local_search(adjs, codes, scales, gids, ep, q, ef, k, max_iters):
    """One shard's search: local beam search, then map local row ids to
    global ids through the shard's owner table."""
    d2, ids = ann_search(adjs, codes, scales, q, ep, ef, k, max_iters)
    safe = jnp.clip(ids, 0, gids.shape[0] - 1)
    gl = jnp.where(ids == PAD_ID, PAD_ID, gids[safe])
    return d2, gl


def sharded_query(mesh, adjs_s, codes_s, scales_s, gids_s, eps_s, q, ef, k, max_iters):
    """Mesh-wide batched query over stacked per-shard state.

    ``adjs_s`` tuple of int32[S, Ns, cap], other per-shard arrays leading
    [S, ...], ``q`` f32[B, d] sharded over ``data``. Each device searches
    its sub-index, then the per-shard top-k merge rides an ``all_gather``
    over the ``shard`` axis + one (dist, id) sort.
    """

    def per_shard(adjs, codes, scales, gids, ep, q):
        vary = lambda x, ax: jax.lax.pcast(x, ax, to="varying")
        adjs = tuple(vary(a[0], ("data",)) for a in adjs)
        codes, scales, gids, ep = (
            vary(x, ("data",))
            for x in (codes[0], scales[0], gids[0], ep[0])
        )
        q = vary(q, ("shard",))
        d2, gl = _local_search(adjs, codes, scales, gids, ep, q, ef, k, max_iters)
        d2_all = jax.lax.all_gather(d2, "shard", axis=1, tiled=True)
        gl_all = jax.lax.all_gather(gl, "shard", axis=1, tiled=True)
        md, mi = sort_dist_id(d2_all, gl_all)
        return md[:, :k], mi[:, :k]

    return jax.shard_map(
        per_shard,
        mesh=mesh,
        in_specs=(
            tuple(P("shard") for _ in adjs_s),
            P("shard"), P("shard"), P("shard"), P("shard"),
            P("data"),
        ),
        out_specs=(P("data"), P("data")),
        check_vma=False,
    )(adjs_s, codes_s, scales_s, gids_s, eps_s, q)


def sharded_query_seeded(
    mesh, packed_s, pivot_ids_s, pivot_vecs_s, gids_s, q,
    ef, k, max_iters, expand_e=1,
):
    """Mesh-wide pivot-seeded query over per-shard packed layouts — the
    single-device serving path (packed rows + pivot seeding,
    ``search.ann_search_seeded``) lifted into the scale-out path: every
    shard runs one matmul against ITS pivot skeleton, seeds its local
    layer-0 beam over ITS packed rows, and the per-shard top-k merge
    rides the same ``all_gather`` + (dist, id) sort as the plain path.

    ``packed_s`` u8[S, Ns, cap*(d+12)]; ``pivot_ids_s`` i32[S, P] (pad
    rows -1); ``pivot_vecs_s`` f32[S, P, d]; ``q`` f32[B, d] sharded over
    ``data``. Returns global-id (sqrt-distance, id) top-k.
    """

    def per_shard(packed, pids, pvecs, gids, q):
        vary = lambda x, ax: jax.lax.pcast(x, ax, to="varying")
        packed, pids, pvecs, gids = (
            vary(x[0], ("data",)) for x in (packed, pids, pvecs, gids)
        )
        q = vary(q, ("shard",))
        d2p = (
            jnp.sum(q * q, 1, keepdims=True)
            - 2.0 * jnp.dot(q, pvecs.T, preferred_element_type=jnp.float32,
                            precision=jax.lax.Precision.HIGHEST)
            + jnp.sum(pvecs * pvecs, 1)[None, :]
        )
        d2p = jnp.where(pids[None, :] >= 0, d2p, INF)  # mask pivot pads
        s = min(ef, pids.shape[0])
        nv, pos = jax.lax.approx_max_k(-d2p, s, recall_target=0.95)
        e_ids = pids[pos]  # [B, s]
        e_d2 = jnp.where(e_ids >= 0, jnp.maximum(-nv, 0.0), INF)
        e_ids = jnp.where(e_ids >= 0, e_ids, PAD_ID)
        beam_d2, beam_ids = search_layer_packed(
            packed, q, e_d2, e_ids, ef, max_iters, expand_e=expand_e
        )
        safe = jnp.clip(beam_ids, 0, gids.shape[0] - 1)
        gl = jnp.where(beam_ids == PAD_ID, PAD_ID, gids[safe])
        d2 = jnp.sqrt(beam_d2)
        d2_all = jax.lax.all_gather(d2[:, :k], "shard", axis=1, tiled=True)
        gl_all = jax.lax.all_gather(gl[:, :k], "shard", axis=1, tiled=True)
        md, mi = sort_dist_id(d2_all, gl_all)
        return md[:, :k], mi[:, :k]

    return jax.shard_map(
        per_shard,
        mesh=mesh,
        in_specs=(
            P("shard"), P("shard"), P("shard"), P("shard"), P("data"),
        ),
        out_specs=(P("data"), P("data")),
        check_vma=False,
    )(packed_s, pivot_ids_s, pivot_vecs_s, gids_s, q)


def sharded_wave_step(
    mesh, adjs_s, indegs_s, codes_s, scales_s, ids_w_s, eps_s,
    *, ef, m, max_iters, layer_nb=0, extend_cands=True, dedup=False,
):
    """One wave of sharded bulk construction: every shard runs the FULL
    fused insertion wave (greedy descent above the home layer, per-layer
    beam search + heuristic + edge apply — ``build._insert_wave_fused``)
    on its local sub-graph concurrently, via shard_map over the ``shard``
    axis — the multi-chip form of the reference's per-layer thread fan-out
    (``hnsw/src/template.rs:403-440``).

    ``adjs_s``/``indegs_s``: tuples (layer 0 first) of [S, Ns, cap_l] /
    [S, Ns] stacks. Returns the updated stacks.
    """
    from ..build import _insert_wave_fused_impl

    def per_shard(adjs, indegs, codes, scales, ids_w, ep):
        adjs = tuple(a[0] for a in adjs)
        indegs = tuple(d[0] for d in indegs)
        codes, scales, ids_w, ep = (
            x[0] for x in (codes, scales, ids_w, ep)
        )
        new_adjs, new_indegs = _insert_wave_fused_impl(
            adjs, indegs, codes, scales, ids_w, ep,
            ef=ef, m=m, max_iters=max_iters, layer_nb=layer_nb,
            extend_cands=extend_cands, dedup=dedup,
        )
        return (
            tuple(a[None] for a in new_adjs),
            tuple(d[None] for d in new_indegs),
        )

    nl = len(adjs_s)
    return jax.shard_map(
        per_shard,
        mesh=mesh,
        in_specs=(
            (P("shard"),) * nl, (P("shard"),) * nl,
            P("shard"), P("shard"), P("shard"), P("shard"),
        ),
        out_specs=((P("shard"),) * nl, (P("shard"),) * nl),
        check_vma=False,
    )(adjs_s, indegs_s, codes_s, scales_s, ids_w_s, eps_s)


class ShardedHNSW:
    """HNSW over a device mesh: one sub-index per shard."""

    def __init__(
        self,
        m: int,
        dim: int,
        n_shards: int,
        ef_cons: int | None = None,
        mesh: Mesh | None = None,
    ):
        self.params = (
            Params.from_m_efcons(m, ef_cons, dim) if ef_cons else Params.from_m(m, dim)
        )
        self.n_shards = int(n_shards)
        self.mesh = mesh if mesh is not None else make_mesh(1, n_shards)
        self.shards: list[HNSW] = []
        self._stacked = None
        self._levels = None  # host i32[S, ns] per-shard point levels
        self._counts = None  # host i64[S] live points per shard
        self._level_calls = 0  # deterministic level-stream position
        # packed + pivot-seeded serving state (finalize()); _pack_n tracks
        # freshness like HNSW._packed_n — any add() invalidates it
        self._packed = None
        self._pack_n = -1
        self.serve_expand = 1
        # per-shard cluster-representative pivot hints (LOCAL row ids,
        # [S, K] -1-padded) from the concurrent cluster build; finalize
        # seeds from them first, like HNSW._cluster_pivots
        self._cluster_reps = None

    def __len__(self) -> int:
        if self._counts is not None:
            return int(self._counts.sum())
        if self._stacked is not None:
            return int(np.sum(np.asarray(self._stacked["gids"]) >= 0))
        return sum(len(s) for s in self.shards)

    # -- build -------------------------------------------------------------

    def insert_bulk(
        self, vectors: np.ndarray, verbose: bool = False,
        concurrent: bool = True, partition_bounds=None, **build_kwargs,
    ) -> "ShardedHNSW":
        """Partition contiguously and build every shard's sub-index.

        ``partition_bounds`` (optional, S+1 ascending ints) overrides the
        even split — caller-directed placement (e.g. locality-aware
        ingest). Skewed bounds are the main producer of the load
        imbalance :meth:`rebalance` repairs.

        ``concurrent=True`` (default): all shards build **simultaneously**
        — each wave is one shard_map'd fused insert step running on every
        device at once (the multi-chip analogue of the reference's thread
        fan-out, ``template.rs:403-440``). ``concurrent=False`` builds the
        shards one by one with the host builder (cross-check path).

        ``cluster_build=True`` with ``concurrent=True`` (default) runs the
        cluster-bulk builder for EVERY shard simultaneously over the mesh
        (``parallel.sharded_cluster`` — the fastest builder per shard,
        shard_map'd). Other ``build_kwargs``
        (wave-schedule knobs, …) forward to the per-shard host builder
        and force the sequential path — the shard_map'd wave step owns
        its own schedule. On a real multi-host pod the sequential path
        runs one-shard-per-host anyway (``parallel.multihost``), so it
        costs one shard's wall-clock, not S of them.

        Calling this on an already-built object REPLACES the index with a
        fresh build over ``vectors``.
        """
        vectors = np.asarray(vectors, np.float32)
        self.shards = []
        self._stacked = None
        self._packed = None
        self._pack_n = -1
        self._cluster_reps = None
        n = vectors.shape[0]
        if partition_bounds is None:
            bounds = np.linspace(0, n, self.n_shards + 1).astype(int)
        else:
            bounds = np.asarray(partition_bounds, int)
            if bounds.shape != (self.n_shards + 1,) or bounds[0] != 0 \
                    or bounds[-1] != n or np.any(np.diff(bounds) < 0):
                raise ValueError(
                    "partition_bounds must be S+1 ascending ints from 0 to n"
                )
        self._offsets = bounds[:-1]
        if concurrent and build_kwargs.pop("cluster_build", False):
            cluster_kwargs = build_kwargs.pop("cluster_kwargs", None) or {}
            if build_kwargs:
                # validate BEFORE the expensive mesh build: a typo'd kwarg
                # must not cost a full build and leave a built object
                raise TypeError(
                    "unsupported kwargs with concurrent cluster build: "
                    f"{sorted(build_kwargs)}"
                )
            self._build_concurrent_cluster(vectors, bounds, cluster_kwargs)
            return self
        if build_kwargs:
            concurrent = False
        if not concurrent:
            for s in range(self.n_shards):
                sub = HNSW(self.params.m, self.params.ef_cons, self.params.dim)
                sub.insert_bulk(
                    vectors[bounds[s] : bounds[s + 1]], verbose=verbose,
                    **build_kwargs,
                )
                self.shards.append(sub)
            self._stack()
            return self
        self._build_concurrent(vectors, bounds)
        return self

    def _build_concurrent(self, vectors: np.ndarray, bounds: np.ndarray) -> None:
        """Shard-parallel wave build over the mesh."""
        import functools

        from ..build import _bucket, wave_schedule
        from ..ops.quant import quantize as _q
        from ..store import sample_levels

        S = self.n_shards
        p = self.params
        ns = int(max(bounds[s + 1] - bounds[s] for s in range(S)))
        d = p.dim
        codes = np.zeros((S, ns, d), np.uint8)
        scales = np.zeros((S, ns, 2), np.float32)
        levels = np.full((S, ns), -1, np.int32)
        gids = np.full((S, ns), -1, np.int32)
        eps = np.zeros((S,), np.int32)
        for s in range(S):
            k = int(bounds[s + 1] - bounds[s])
            c, sc = _q(jnp.asarray(vectors[bounds[s] : bounds[s + 1]]))
            codes[s, :k] = np.asarray(c)
            scales[s, :k] = np.asarray(sc)
            lv = sample_levels(k, p.ml, seed=s)
            levels[s, :k] = lv
            gids[s, :k] = self._offsets[s] + np.arange(k)
            eps[s] = int(np.flatnonzero(lv == lv.max())[0]) if k else 0
        top = int(levels.max())
        shard = NamedSharding(self.mesh, P("shard"))
        dev = lambda x: jax.device_put(jnp.asarray(x), shard)
        codes_d, scales_d = dev(codes), dev(scales)
        eps_d = dev(eps)
        adjs = tuple(
            dev(np.full((S, ns, p.layer_cap(l)), -1, np.int32))
            for l in range(top + 1)
        )
        indegs = tuple(dev(np.zeros((S, ns), np.int32)) for _ in range(top + 1))

        step = jax.jit(
            functools.partial(sharded_wave_step, self.mesh),
            static_argnames=("ef", "m", "max_iters", "layer_nb", "extend_cands"),
        )
        max_iters = 2 * p.ef_cons + 16
        for layer_nb in range(top, -1, -1):
            homes = [
                np.flatnonzero(levels[s] == layer_nb).astype(np.int32)
                for s in range(S)
            ]
            maxhome = max((h.size for h in homes), default=0)
            if maxhome == 0:
                continue
            offs = [0] * S
            for wsize in wave_schedule(maxhome):
                wpad = _bucket(wsize)
                ids_w = np.full((S, wpad), -1, np.int32)
                for s in range(S):
                    take = homes[s][offs[s] : offs[s] + wsize]
                    ids_w[s, : take.size] = take
                    offs[s] += wsize
                adjs, indegs = step(
                    adjs, indegs, codes_d, scales_d, dev(ids_w), eps_d,
                    ef=p.ef_cons, m=p.m, max_iters=max_iters,
                    layer_nb=layer_nb, extend_cands=p.extend_cands,
                )
        self._stacked = {
            "codes": codes_d,
            "scales": scales_d,
            "gids": dev(gids),
            "eps": eps_d,
            "adjs": adjs,
        }
        self._levels = levels
        self._counts = (bounds[1:] - bounds[:-1]).astype(np.int64)

    def _build_concurrent_cluster(
        self, vectors: np.ndarray, bounds: np.ndarray, cluster_kwargs: dict
    ) -> None:
        """Shard-concurrent cluster-bulk build: every layer is one
        clustered bulk pass over its members on EVERY shard at once
        (``parallel.sharded_cluster.sharded_cluster_layer`` — same jitted
        bodies as the single-chip ``build_cluster`` pipeline, recall-gated
        by the same benchmarks). Connectivity is owned by the on-device
        orphan fixpoint; the host repair backstop is per-shard and only
        runs in the sequential path."""
        from ..ops.quant import quantize as _q
        from ..store import sample_levels
        from .sharded_cluster import sharded_cluster_layer

        S = self.n_shards
        p = self.params
        ns = int(max(bounds[s + 1] - bounds[s] for s in range(S)))
        d = p.dim
        codes = np.zeros((S, ns, d), np.uint8)
        scales = np.zeros((S, ns, 2), np.float32)
        levels = np.full((S, ns), -1, np.int32)
        gids = np.full((S, ns), -1, np.int32)
        eps = np.zeros((S,), np.int32)
        for s in range(S):
            k = int(bounds[s + 1] - bounds[s])
            c, sc = _q(jnp.asarray(vectors[bounds[s] : bounds[s + 1]]))
            codes[s, :k] = np.asarray(c)
            scales[s, :k] = np.asarray(sc)
            lv = sample_levels(k, p.ml, seed=s)
            levels[s, :k] = lv
            gids[s, :k] = self._offsets[s] + np.arange(k)
            eps[s] = int(np.flatnonzero(lv == lv.max())[0]) if k else 0
        top = int(levels.max())
        shard = NamedSharding(self.mesh, P("shard"))
        dev = lambda x: jax.device_put(jnp.asarray(x), shard)
        codes_d, scales_d = dev(codes), dev(scales)
        counts = (bounds[1:] - bounds[:-1]).astype(np.int64)

        adjs = []
        reps = None
        for layer_nb in range(top, -1, -1):
            cap = p.layer_cap(layer_nb)
            adj_s = dev(np.full((S, ns, cap), -1, np.int32))
            adj_s, _, r = sharded_cluster_layer(
                self.mesh, codes_d, scales_d, adj_s, counts, levels,
                layer_nb, cap=cap, m=p.m, **cluster_kwargs,
            )
            adjs.append(adj_s)
            if layer_nb == 0:
                reps = r
        adjs.reverse()  # layer 0 first, like every stacked consumer
        self._stacked = {
            "codes": codes_d,
            "scales": scales_d,
            "gids": dev(gids),
            "eps": dev(eps),
            "adjs": tuple(adjs),
        }
        self._levels = levels
        self._counts = counts
        self._cluster_reps = reps

    def _stack(self) -> None:
        """Stack per-shard arrays to [S, ...] with uniform padding."""
        S = self.n_shards
        ns = max(len(s) for s in self.shards)
        nl = max(len(s.graph) for s in self.shards)
        d = self.params.dim
        codes = np.zeros((S, ns, d), np.uint8)
        scales = np.zeros((S, ns, 2), np.float32)
        gids = np.full((S, ns), -1, np.int32)
        eps = np.zeros((S,), np.int32)
        adjs = [
            np.full((S, ns, self.params.layer_cap(l)), -1, np.int32)
            for l in range(nl)
        ]
        for s, sub in enumerate(self.shards):
            k = len(sub)
            codes[s, :k] = np.asarray(sub.points.codes)
            scales[s, :k] = np.asarray(sub.points.scales)
            gids[s, :k] = self._offsets[s] + np.arange(k)
            eps[s] = sub.params.ep
            for l in range(len(sub.graph)):
                adjs[l][s, :k] = np.asarray(sub.graph.get_layer(l))
        shard = NamedSharding(self.mesh, P("shard"))
        dev = lambda x: jax.device_put(jnp.asarray(x), shard)
        self._stacked = {
            "codes": dev(codes),
            "scales": dev(scales),
            "gids": dev(gids),
            "eps": dev(eps),
            "adjs": tuple(dev(a) for a in adjs),
        }
        levels = np.full((S, ns), -1, np.int32)
        for s, sub in enumerate(self.shards):
            levels[s, : len(sub)] = np.asarray(sub.points.levels)[: len(sub)]
        self._levels = levels
        self._counts = np.asarray([len(s) for s in self.shards], np.int64)

    # -- incremental insert ------------------------------------------------

    def add(self, vectors: np.ndarray) -> np.ndarray:
        """Incremental insert into the BUILT sharded index — no rebuild.

        New vectors are assigned round-robin starting from the least-
        loaded shards (keeps shards balanced under skewed add streams),
        appended to each shard's tail rows (stacks grow geometrically),
        and wave-inserted into the existing per-shard sub-graphs with the
        same shard_map'd fused wave step the concurrent builder uses.
        Returns the new points' global ids (stable, insertion-ordered).
        """
        if self._stacked is None:
            raise ValueError("index is empty: call insert_bulk first")
        from ..store import sample_levels

        vectors = np.atleast_2d(np.asarray(vectors, np.float32))
        n_new = vectors.shape[0]
        if n_new == 0:
            return np.zeros((0,), np.int64)
        S = self.n_shards

        # balanced round-robin assignment: least-loaded shards first
        order = np.argsort(self._counts, kind="stable")
        shard_of = order[np.arange(n_new) % S]
        gid0 = int(self._counts.sum())
        new_gids = gid0 + np.arange(n_new)
        lv_new = sample_levels(n_new, self.params.ml, seed=S + self._level_calls)
        self._level_calls += 1
        codes_new, scales_new = quantize(jnp.asarray(vectors))
        self._insert_rows(
            np.asarray(codes_new), np.asarray(scales_new),
            new_gids, lv_new, shard_of,
        )
        return new_gids

    def _insert_rows(
        self, codes_new, scales_new, gids_new, lv_new, shard_of, extra=None,
        dedup=False,
    ) -> np.ndarray:
        """Write pre-quantized rows at shard tails and wave-insert them
        into the existing sub-graphs — the machinery shared by
        :meth:`add` and :meth:`rebalance`. ``extra`` — optional
        ``(shard, row, level)`` int arrays of EXISTING rows to re-wave in
        place (rebalance's repair: their adjacency rows are rebuilt by
        the same fused wave step; pass ``dedup=True`` with it — existing
        nodes still have in-edges, see ``_apply_wave_impl``). Returns the
        new rows' local row ids (aligned with ``gids_new``)."""
        S = self.n_shards
        p = self.params
        st = self._stacked
        self._packed = None  # serving pack goes stale
        self._pack_n = -1
        n_new = int(gids_new.shape[0])

        # per-shard local placements
        k_s = np.bincount(shard_of, minlength=S) if n_new else \
            np.zeros(S, np.int64)
        ns_old = int(self._levels.shape[1])
        need = int((self._counts + k_s).max())
        ns = ns_old if need <= ns_old else max(need, 2 * ns_old)
        shard = NamedSharding(self.mesh, P("shard"))
        dev = lambda x: jax.device_put(x, shard)
        if ns != ns_old:
            pad = ns - ns_old
            st["codes"] = dev(jnp.pad(st["codes"], ((0, 0), (0, pad), (0, 0))))
            st["scales"] = dev(jnp.pad(st["scales"], ((0, 0), (0, pad), (0, 0))))
            st["gids"] = dev(jnp.pad(st["gids"], ((0, 0), (0, pad)),
                                     constant_values=-1))
            st["adjs"] = tuple(
                dev(jnp.pad(a, ((0, 0), (0, pad), (0, 0)),
                            constant_values=-1))
                for a in st["adjs"]
            )
            self._levels = np.pad(self._levels, ((0, 0), (0, pad)),
                                  constant_values=-1)

        # grow the layer stack if a new node draws a new top level
        top_old = len(st["adjs"]) - 1
        lv_max = int(lv_new.max()) if n_new else 0
        if extra is not None and extra[2].size:
            lv_max = max(lv_max, int(extra[2].max()))
        top_new = max(top_old, lv_max)
        for l in range(top_old + 1, top_new + 1):
            st["adjs"] = st["adjs"] + (
                dev(jnp.full((S, ns, p.layer_cap(l)), -1, jnp.int32)),
            )

        # write the new rows (codes/scales/gids/levels) per shard
        eps = np.asarray(st["eps"]).copy()
        local_of = np.empty(n_new, np.int64)
        codes_h = None
        for s in range(S):
            sel = np.flatnonzero(shard_of == s)
            if sel.size == 0:
                continue
            rows = int(self._counts[s]) + np.arange(sel.size)
            local_of[sel] = rows
            st["codes"] = st["codes"].at[s, rows].set(codes_new[sel])
            st["scales"] = st["scales"].at[s, rows].set(scales_new[sel])
            st["gids"] = st["gids"].at[s, rows].set(
                jnp.asarray(gids_new[sel].astype(np.int32))
            )
            self._levels[s, rows] = lv_new[sel]
            self._counts[s] += sel.size
        st["codes"] = dev(st["codes"])
        st["scales"] = dev(st["scales"])
        st["gids"] = dev(st["gids"])
        # NOTE eps are NOT retargeted here even when a new node draws a
        # new per-shard top level: a node becomes the entry point only
        # AFTER its own insertion (below, per layer group). Swapping
        # first points every wave's searches at an edge-less row — the
        # beams never leave it and the old residents end up a directed
        # island (measured: 30/30 unreachable after a 90-onto-30 move).
        # The reference swaps ep after the insert too
        # (hnsw/src/template.rs:403-440).
        ep_lv = np.array([
            int(self._levels[s, int(eps[s])]) for s in range(S)
        ])

        # recompute per-layer in-degrees (not retained post-build), then
        # wave-insert the new homes per layer top-down
        def _indeg(a):
            nsr = a.shape[1]
            flat = jnp.where(a[0] >= 0, a[0], nsr).reshape(-1)
            return jnp.zeros((1, nsr), jnp.int32).at[0, flat].add(
                1, mode="drop"
            )

        indeg_fn = jax.jit(
            jax.shard_map(
                _indeg, mesh=self.mesh, in_specs=P("shard"),
                out_specs=P("shard"), check_vma=False,
            )
        )
        indegs = tuple(indeg_fn(a) for a in st["adjs"])
        adjs = st["adjs"]

        # combined wave members: the new tail rows plus any existing rows
        # the caller wants re-waved in place (rebalance orphans)
        all_sh = np.asarray(shard_of, np.int64)
        all_rows = local_of
        all_lv = np.asarray(lv_new, np.int64)
        if extra is not None:
            all_sh = np.concatenate([all_sh, np.asarray(extra[0], np.int64)])
            all_rows = np.concatenate(
                [all_rows, np.asarray(extra[1], np.int64)]
            )
            all_lv = np.concatenate([all_lv, np.asarray(extra[2], np.int64)])

        from ..build import _bucket, wave_schedule

        step = jax.jit(
            functools.partial(sharded_wave_step, self.mesh),
            static_argnames=(
                "ef", "m", "max_iters", "layer_nb", "extend_cands", "dedup",
            ),
        )
        max_iters = 2 * p.ef_cons + 16
        for layer_nb in range(top_new, -1, -1):
            homes = [
                all_rows[(all_sh == s) & (all_lv == layer_nb)].astype(np.int32)
                for s in range(S)
            ]
            maxhome = max((h.size for h in homes), default=0)
            if maxhome == 0:
                continue
            offs = [0] * S
            for wsize in wave_schedule(maxhome):
                wpad = _bucket(wsize)
                ids_w = np.full((S, wpad), -1, np.int32)
                for s in range(S):
                    take = homes[s][offs[s] : offs[s] + wsize]
                    ids_w[s, : take.size] = take
                    offs[s] += wsize
                adjs, indegs = step(
                    adjs, indegs, st["codes"], st["scales"],
                    dev(jnp.asarray(ids_w)), st["eps"],
                    ef=p.ef_cons, m=p.m, max_iters=max_iters,
                    layer_nb=layer_nb, extend_cands=p.extend_cands,
                    dedup=dedup,
                )
            # freshly-inserted top nodes anchor the REMAINING (lower)
            # layer groups' descents (see the eps NOTE above)
            ep_moved = False
            for s in range(S):
                if homes[s].size and layer_nb > ep_lv[s]:
                    eps[s] = int(homes[s][0])
                    ep_lv[s] = layer_nb
                    ep_moved = True
            if ep_moved:
                st["eps"] = dev(jnp.asarray(eps.astype(np.int32)))
        st["adjs"] = adjs
        return local_of

    # -- rebalancing ---------------------------------------------------------

    def rebalance(self, tol: float = 0.05, verbose: bool = False) -> int:
        """Even out shard loads by MOVING points between sub-graphs.

        Overloaded shards give up their TAIL rows (row storage stays
        dense), the movers' in-edges are scrubbed on device
        (:func:`_scrub_stacked`, compacted rows), alive nodes left
        unreachable by the scrub — an emptied own row at any of their
        layers, or layer-0 in-degree 0 — are re-inserted in place
        (cascading until quiescent), and the movers are re-inserted
        into the deficit shards with their global ids and levels
        preserved: queries before and after see the same id space.
        The reference has no analogue (single process,
        ``hnsw/src/template.rs:422-439``); this is the scale-out
        hardening SURVEY §2.6 implies. Returns the number of points
        moved — 0 when the worst deviation is within ``tol`` of the
        mean shard load.
        """
        if self._stacked is None:
            raise ValueError("index is empty: call insert_bulk first")
        S = self.n_shards
        counts = self._counts.astype(np.int64)
        total = int(counts.sum())
        base, rem_n = divmod(total, S)
        # the currently-largest shards keep the remainder: minimal movement
        order = np.argsort(-counts, kind="stable")
        target = np.full(S, base, np.int64)
        target[order[:rem_n]] += 1
        surplus = counts - target
        n_move = int(surplus[surplus > 0].sum())
        if n_move == 0 or int(np.abs(surplus).max()) <= tol * max(base, 1):
            return 0
        st = self._stacked
        self._packed = None
        self._pack_n = -1
        ns = int(self._levels.shape[1])
        shard = NamedSharding(self.mesh, P("shard"))
        dev = lambda x: jax.device_put(jnp.asarray(x), shard)

        # 1. movers = tail rows of every overloaded shard (tail keeps the
        # surviving rows dense: alive rows are exactly [0, counts))
        rem_rows = np.zeros((S, ns), bool)
        mv_codes, mv_scales, mv_gids, mv_lv = [], [], [], []
        for s in np.flatnonzero(surplus > 0):
            k = int(surplus[s])
            c0 = int(counts[s])
            rem_rows[s, c0 - k : c0] = True
            mv_codes.append(np.asarray(st["codes"][s, c0 - k : c0]))
            mv_scales.append(np.asarray(st["scales"][s, c0 - k : c0]))
            mv_gids.append(
                np.asarray(st["gids"][s, c0 - k : c0]).astype(np.int64)
            )
            mv_lv.append(self._levels[s, c0 - k : c0].astype(np.int32))
            self._levels[s, c0 - k : c0] = -1
            self._counts[s] -= k
        mv_codes = np.concatenate(mv_codes)
        mv_scales = np.concatenate(mv_scales)
        mv_gids = np.concatenate(mv_gids)
        mv_lv = np.concatenate(mv_lv)
        dst = np.empty(n_move, np.int64)
        off = 0
        for s in np.flatnonzero(surplus < 0):
            k = int(-surplus[s])
            dst[off : off + k] = s
            off += k

        # 2. device scrub: edges into movers die, mover rows are wiped,
        # every row left-compacted; dead rows get neutral codes + gid -1
        # so they can never look near nor surface a stale global id
        rem_d = dev(rem_rows)
        changed = np.zeros((S, ns), bool)
        new_adjs = []
        for a in st["adjs"]:
            a, ch = _scrub_stacked(a, rem_d, rem_d)
            new_adjs.append(a)
            changed |= np.asarray(ch)
        st["adjs"] = tuple(new_adjs)
        st["gids"] = _mask_i32(st["gids"], rem_d)
        st["codes"] = _zero_rows(st["codes"], rem_d)
        st["scales"] = _zero_rows(st["scales"], rem_d)

        # source shards whose entry point moved away pick a new one
        eps = np.asarray(st["eps"]).copy()
        for s in np.flatnonzero(surplus > 0):
            c = int(self._counts[s])
            if c and int(eps[s]) >= c:
                eps[s] = int(np.argmax(self._levels[s, :c]))
        st["eps"] = dev(eps.astype(np.int32))

        # 3. repair set: every alive node the scrub touched (lost out-
        # edges at any layer — including emptied rows) plus any node left
        # with layer-0 in-degree 0 (unreachable; the ep is reachable by
        # construction and exempt). They are re-waved IN PLACE: a fresh
        # search + heuristic rebuilds their rows at full out-degree, with
        # dedup=True guarding their surviving in-edges against row
        # duplicates (see _apply_wave_impl). Without this, survivors of a
        # heavy move serve permanently degraded rows — measured as a
        # 1.0 -> 0.95 recall drop at a 37% move.
        eprows = np.zeros((S, ns), bool)
        eprows[np.arange(S), eps.astype(np.int64)] = True
        need = changed | (
            np.asarray(_indeg_stacked(st["adjs"][0]) == 0) & ~eprows
        )
        need &= self._levels >= 0
        extra = None
        o_s, o_r = np.nonzero(need)
        if o_s.size:
            extra = (
                o_s.astype(np.int64), o_r.astype(np.int64),
                self._levels[o_s, o_r].astype(np.int64),
            )
        if verbose:
            print(
                f"rebalance: moving {n_move} points "
                f"({int(surplus[surplus > 0].max())} max surplus), "
                f"re-waving {o_s.size} scrub-affected rows"
            )

        # 4. one shared insert pass: movers into the deficit shards (new
        # tail rows, preserved gids/levels) + repairs in place
        self._insert_rows(
            mv_codes, mv_scales, mv_gids, mv_lv, dst, extra=extra, dedup=True
        )
        return n_move

    # -- serving layouts ---------------------------------------------------

    def finalize(
        self, expand: int = 1, pivots: int = 2048,
        pivot_fill: str = "cover", pivot_cover: float = 0.25,
    ) -> "ShardedHNSW":
        """Build the packed + pivot-seeded serving state per shard — the
        single-device serving stack (``HNSW.finalize``) scaled out:
        each shard gets packed layer-0 rows and its own pivot skeleton
        (its highest-level nodes, evenly subsampled to ``pivots``). A
        stale pack (after :meth:`add`) is detected and bypassed, never
        served. ``pivots`` is per shard and must be > 0 (the seeded path
        replaces upper-layer descent at query time).

        ``pivot_fill``/``pivot_cover`` mirror ``HNSW.finalize``: under
        ``"cover"`` (default) each shard's structural picks are capped at
        ``(1 - pivot_cover)`` of the budget and the rest are k-center
        coverage picks — computed for ALL shards in ONE shard_map'd
        device program (``ops/cover._kcenter`` inlined per shard)."""
        if self._stacked is None:
            raise ValueError("index is empty: call insert_bulk first")
        if pivots <= 0:
            self._packed = None
            self._pack_n = -1
            return self
        st = self._stacked
        S = self.n_shards
        cap = pivots if pivot_fill == "stride" else max(
            1, pivots - int(round(pivots * float(pivot_cover)))
        )

        pack_fn = jax.jit(
            jax.shard_map(
                lambda a, c, sc: pack_layer(a[0], c[0], sc[0])[None],
                mesh=self.mesh,
                in_specs=(P("shard"), P("shard"), P("shard")),
                out_specs=P("shard"),
                check_vma=False,
            )
        )
        packed_s = pack_fn(st["adjs"][0], st["codes"], st["scales"])

        # per-shard pivot ids (HNSW.finalize's selection, shard-local):
        # cluster-build representatives first when the shard was built by
        # the host cluster builder, then level-based picks, then an
        # evenly-strided fill so the BUDGET is actually met (an unfilled
        # budget and level-only sampling both leave micro-regions
        # seedless — the measured whole-query recall failure mode)
        pid = np.full((S, pivots), -1, np.int32)
        need = np.zeros(S, np.int64)
        for s in range(S):
            k = int(self._counts[s])
            lv = self._levels[s, :k]
            ids = None
            for level in range(int(lv.max()) if k else 0, 0, -1):
                cand = np.flatnonzero(lv >= level)
                if cand.size >= min(cap, k) or level == 1:
                    ids = cand
                    break
            if ids is None or ids.size == 0:
                ids = np.arange(k)
            if ids.size > cap:
                pick = np.unique(
                    np.linspace(0, ids.size - 1, cap).round().astype(np.int64)
                )
                ids = ids[pick]
            if self._cluster_reps is not None:
                reps = self._cluster_reps[s]
                reps = reps[reps >= 0]
                reps = reps if reps.size else None
            elif s < len(self.shards) and getattr(
                self.shards[s], "_cluster_pivots", None
            ) is not None:
                reps = self.shards[s]._cluster_pivots
            else:
                reps = None
            if reps is not None:
                # drop representatives whose rows no longer live here
                # (rebalance moves tail rows; shards[] hints are static)
                reps = np.asarray(reps, np.int64)
                reps = reps[reps < k]
                if reps.size > cap:
                    reps = reps[np.unique(
                        np.linspace(0, reps.size - 1, cap)
                        .round().astype(np.int64)
                    )]
                seen = set(reps.tolist())
                extra = [i for i in ids.tolist() if i not in seen]
                ids = np.concatenate([
                    reps, np.asarray(extra[: max(0, cap - reps.size)],
                                     np.int64),
                ])
            if ids.size < min(pivots, k) and pivot_fill == "stride":
                stride = np.linspace(0, k - 1, min(pivots, k)).round() \
                    .astype(np.int64)
                seen2 = set(ids.tolist())
                fill = [i for i in stride.tolist() if i not in seen2]
                ids = np.concatenate([
                    np.asarray(ids, np.int64),
                    np.asarray(fill[: pivots - ids.size], np.int64),
                ])
            need[s] = min(pivots, k) - ids.size
            pid[s, : ids.size] = ids
        if pivot_fill == "cover" and int(need.max()) > 0:
            pid = self._cover_fill_sharded(pid, need)
        shard = NamedSharding(self.mesh, P("shard"))
        pid_d = jax.device_put(jnp.asarray(pid), shard)

        vec_fn = jax.jit(
            jax.shard_map(
                lambda c, sc, ids: jnp.where(
                    (ids[0] >= 0)[:, None],
                    dequantize(
                        c[0][jnp.clip(ids[0], 0, c.shape[1] - 1)],
                        sc[0][jnp.clip(ids[0], 0, c.shape[1] - 1)],
                    ),
                    0.0,
                )[None],
                mesh=self.mesh,
                in_specs=(P("shard"), P("shard"), P("shard")),
                out_specs=P("shard"),
                check_vma=False,
            )
        )
        pvecs = vec_fn(st["codes"], st["scales"], pid_d)
        self._packed = (packed_s, pid_d, pvecs)
        self._pack_n = len(self)
        self.serve_expand = int(expand)
        return self

    def _cover_fill_sharded(
        self, pid: np.ndarray, need: np.ndarray, batch: int = 256
    ) -> np.ndarray:
        """k-center coverage fill for every shard's pivot budget in ONE
        shard_map'd device program (``ops/cover._kcenter`` inlined per
        shard — the single-chip ``HNSW.finalize(pivot_fill="cover")``
        scaled out). ``pid`` int32[S, pivots] structural picks (-1 pad),
        ``need`` int64[S] per-shard fill counts; returns ``pid`` with the
        coverage picks appended per row."""
        from ..ops.cover import _ROWS, _kcenter

        st = self._stacked
        S = self.n_shards
        ns = int(st["codes"].shape[1])
        pivots = pid.shape[1]
        batch = int(min(batch, max(1, int(need.max()))))
        budget = -(-int(need.max()) // batch) * batch
        pb = -(-pivots // batch) * batch
        rows = min(_ROWS, ns)
        c = -(-ns // rows)
        n_pad = c * rows

        def body(codes, scales, pids, cnt):
            x = dequantize(codes[0], scales[0])  # [ns, d]
            d = x.shape[1]
            if n_pad > ns:
                x = jnp.concatenate(
                    [x, jnp.zeros((n_pad - ns, d), jnp.float32)]
                )
            # pad rows AND rows beyond this shard's count start at -inf:
            # the running min never resurrects them, so top_k (max) can
            # only pick live rows
            alive = jnp.arange(n_pad) < cnt[0]
            mind0 = jnp.where(alive, jnp.inf, -jnp.inf).astype(
                jnp.float32
            ).reshape(c, rows)
            pr = pids[0]
            bv = x[jnp.clip(pr, 0, ns - 1)]
            if pb > pivots:
                bv = jnp.concatenate(
                    [bv, jnp.zeros((pb - pivots, d), jnp.float32)]
                )
            bvalid = jnp.concatenate(
                [pr >= 0, jnp.zeros((pb - pivots,), jnp.bool_)]
            )
            picks = _kcenter(
                x.reshape(c, rows, d), bv, bvalid, mind0, budget, batch
            )
            return picks[None]

        fill_fn = jax.jit(
            jax.shard_map(
                body,
                mesh=self.mesh,
                in_specs=(P("shard"), P("shard"), P("shard"), P("shard")),
                out_specs=P("shard"),
                check_vma=False,
            )
        )
        shard = NamedSharding(self.mesh, P("shard"))
        picks = np.asarray(
            fill_fn(
                st["codes"],
                st["scales"],
                jax.device_put(jnp.asarray(pid), shard),
                jax.device_put(
                    jnp.asarray(self._counts.astype(np.int32)), shard
                ),
            )
        )
        pid = pid.copy()
        for s in range(S):
            if need[s] <= 0:
                continue
            k = int(self._counts[s])
            have = set(pid[s][pid[s] >= 0].tolist())
            take = []
            for p in picks[s].tolist():
                # drop picks past the shard's live rows (budget is the
                # max over shards) and exact-duplicate degenerate picks
                if p < k and p not in have:
                    have.add(p)
                    take.append(p)
                    if len(take) == int(need[s]):
                        break
            base = int((pid[s] >= 0).sum())
            pid[s, base : base + len(take)] = take
        return pid

    # -- persistence -------------------------------------------------------

    def save(self, path: str) -> None:
        """Checkpoint the stacked sharded state (persistence parity with
        the single-chip index; the reference persists its one family,
        ``hnsw/src/template.rs:43-73``)."""
        import json
        import os

        if self._stacked is None:
            raise ValueError("index is empty: nothing to save")
        os.makedirs(path, exist_ok=True)
        st = self._stacked
        with open(os.path.join(path, "params.json"), "w") as f:
            json.dump(
                {
                    "format": "hnsw_rs_tpu.sharded.v1",
                    "params": self.params.to_dict(),
                    "n_shards": self.n_shards,
                    "n_layers": len(st["adjs"]),
                    "level_calls": self._level_calls,
                },
                f,
                indent=2,
            )
        arrays = {
            "codes": np.asarray(st["codes"]),
            "scales": np.asarray(st["scales"]),
            "gids": np.asarray(st["gids"]),
            "eps": np.asarray(st["eps"]),
            "levels": self._levels,
            "counts": self._counts,
            "offsets": np.asarray(getattr(self, "_offsets", np.zeros(0))),
        }
        for i, a in enumerate(st["adjs"]):
            arrays[f"adj_{i}"] = np.asarray(a)
        np.savez_compressed(os.path.join(path, "arrays.npz"), **arrays)

    @classmethod
    def load(cls, path: str, mesh: Mesh | None = None) -> "ShardedHNSW":
        """Restore from :meth:`save` onto ``mesh`` (or a fresh
        (1, n_shards) mesh). Call :meth:`finalize` afterwards for the
        packed/seeded serving mode."""
        import json
        import os

        with open(os.path.join(path, "params.json")) as f:
            meta = json.load(f)
        if meta.get("format") != "hnsw_rs_tpu.sharded.v1":
            raise ValueError(f"unknown index format in {path}")
        params = Params.from_dict(meta["params"])
        S = int(meta["n_shards"])
        index = cls(params.m, params.dim, S, mesh=mesh)
        index.params = params
        with np.load(os.path.join(path, "arrays.npz")) as z:
            shard = NamedSharding(index.mesh, P("shard"))
            dev = lambda x: jax.device_put(jnp.asarray(x), shard)
            index._stacked = {
                "codes": dev(z["codes"]),
                "scales": dev(z["scales"]),
                "gids": dev(z["gids"]),
                "eps": dev(z["eps"]),
                "adjs": tuple(
                    dev(z[f"adj_{i}"]) for i in range(meta["n_layers"])
                ),
            }
            index._levels = np.asarray(z["levels"])
            index._counts = np.asarray(z["counts"])
            if z["offsets"].size:
                index._offsets = np.asarray(z["offsets"])
        index._level_calls = int(meta.get("level_calls", 0))
        return index

    # -- query -------------------------------------------------------------

    def ann_batch(
        self, queries: np.ndarray, n: int, ef: int, max_iters: int | None = None
    ) -> tuple[np.ndarray, np.ndarray]:
        """Batched sharded query: returns (distances [B, n], ids [B, n])
        with global ids."""
        queries = np.atleast_2d(np.asarray(queries, np.float32))
        ef = max(ef, n)
        if max_iters is None:
            max_iters = 2 * ef + 16
        qc, qs = quantize(jnp.asarray(queries))
        q = dequantize(qc, qs)
        q = jax.device_put(q, NamedSharding(self.mesh, P("data")))
        # index arrays are passed as jit ARGUMENTS (not via a static self)
        # so a rebuild on the same object never serves a stale executable
        st = self._stacked
        if self._packed is not None and self._pack_n == len(self):
            packed_s, pid_d, pvecs = self._packed
            d, i = _sharded_query_seeded_jit(
                self.mesh, packed_s, pid_d, pvecs, st["gids"], q,
                ef=ef, k=n, max_iters=max_iters,
                expand_e=self.serve_expand,
            )
        else:
            d, i = _sharded_query_jit(
                self.mesh, st["adjs"], st["codes"], st["scales"], st["gids"],
                st["eps"], q, ef=ef, k=n, max_iters=max_iters,
            )
        return np.asarray(d), np.asarray(i)


@jax.jit
def _scrub_stacked(a, rem_edges, rem_rows):
    """Rebalance scrub over stacked adjacency ``a`` int32[S, ns, cap]:
    drop every edge pointing INTO a ``rem_edges`` row, wipe ``rem_rows``
    own rows entirely, then left-compact each row with a STABLE sort on
    validity — within-row order is distance-sorted and must survive
    (slot 0 is "nearest" for ``_apply_wave_impl``'s orphan repair).
    Returns (adjacency, changed) where ``changed`` bool[S, ns] marks the
    SURVIVING rows that lost at least one edge (rebalance's repair set)."""
    S, ns, cap = a.shape
    safe = jnp.clip(a, 0, ns - 1).reshape(S, ns * cap)
    bad = jnp.take_along_axis(rem_edges, safe, axis=1).reshape(S, ns, cap)
    bad = jnp.logical_and(a >= 0, bad)
    changed = jnp.logical_and(jnp.any(bad, axis=-1), ~rem_rows)
    a = jnp.where(bad, jnp.int32(-1), a)
    a = jnp.where(rem_rows[:, :, None], jnp.int32(-1), a)
    key = (a < 0).astype(jnp.int32)
    _, a = jax.lax.sort((key, a), dimension=-1, num_keys=1, is_stable=True)
    return a, changed


@jax.jit
def _indeg_stacked(a):
    """int32[S, ns]: per-shard in-degree of every local row."""
    S, ns, cap = a.shape
    flat = jnp.where(a >= 0, a, ns).reshape(S, ns * cap)
    z = jnp.zeros((S, ns + 1), jnp.int32)
    z = z.at[jnp.arange(S)[:, None], flat].add(1, mode="drop")
    return z[:, :ns]


@jax.jit
def _mask_i32(x, rem):
    return jnp.where(rem, jnp.int32(-1), x)


@jax.jit
def _zero_rows(x, rem):
    return jnp.where(rem[:, :, None], jnp.zeros((), x.dtype), x)


_sharded_query_jit = functools.partial(
    jax.jit, static_argnums=(0,), static_argnames=("ef", "k", "max_iters")
)(sharded_query)

_sharded_query_seeded_jit = functools.partial(
    jax.jit,
    static_argnums=(0,),
    static_argnames=("ef", "k", "max_iters", "expand_e"),
)(sharded_query_seeded)
