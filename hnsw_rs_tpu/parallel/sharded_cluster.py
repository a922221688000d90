"""Shard-concurrent cluster-bulk construction (``ShardedHNSW.insert_bulk
(cluster_build=True)`` on a device mesh).

The single-device cluster-bulk builder (``build_cluster.py``) is the
fastest layer builder; this module runs it
for EVERY shard simultaneously over the mesh's ``shard`` axis — the
multi-chip form of the reference's parallel insert fan-out
(``hnsw/src/template.rs:388-445``), replacing the sequential per-shard
host builds that made ``cluster_build`` force ``concurrent=False``.

Division of labor per phase (mirrors ``build_layer0_clustered`` exactly,
same jitted bodies — quality is recall-gated by the same benchmarks):

1. **prep** (one shard_map dispatch): per-shard device k-means over that
   shard's members + the 1-D spatial projection used to chunk oversized
   clusters.
2. **host**: per-shard ``_split_oversized`` + ``_member_tables`` (numpy,
   member-local — identical code to the single-chip path; on a multi-host
   pod each process handles only ITS shard's table here).
3. **tables** (one dispatch): exact per-row centroids + representatives
   (``_table_centroids``) and nearest-cluster fan-out per shard, with pad
   clusters masked out of the fan-out.
4. **select loop** (host loop of shard_map dispatches): every dispatch
   runs ``_cluster_sel_step_impl`` for one cluster-group batch on EVERY
   shard at once — independent async dispatches pipeline on device.
5. **merge** (one dispatch): per-shard ``_sel_pos`` + global reverse-edge
   union-prune (``_global_merge`` / ``_global_merge_rows``) + in-degree
   recount + the round-varied orphan-repair fixpoint as an on-device
   ``while_loop``.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from ..build_cluster import (
    _cluster_sel_step_impl,
    _member_tables,
    _orphan_repair,
    _sel_pos,
    _split_oversized,
    _table_centroids,
)
from ..ops.quant import dequantize
from ..ops.topk import INF
from ..utils.logging import get_logger

__all__ = ["sharded_cluster_layer"]

_log = get_logger("parallel.sharded_cluster")


def _unwrap(fn):
    """The build_cluster bodies are jitted at module scope; inside a
    shard_map'd program we inline their traced form."""
    return getattr(fn, "__wrapped__", fn)


# ---------------------------------------------------------------------------
# phase 1: per-shard k-means over members + split projection


# Dead-centroid sentinel: the assignment score is x.c - |c|^2/2, so a
# centroid at (DEAD, DEAD, ...) scores ~ -d*DEAD^2/2 and never wins
# argmax for any real point; empty clusters KEEP their centroid in
# _lloyd_iter, so a dead centroid stays dead through every iteration.
# (d * DEAD^2 / 2 must stay inside f32: 2048 * 1e30 / 2 ~ 1e33 < 3.4e38.)
_DEAD_CENT = 1.0e15


def _prep_shard(codes, scales, rows, rcount, k: int, iters: int,
                train_per_cluster: int, chunk: int, ppc: int):
    """Per-shard body: k-means assignment for this shard's members.

    ``rows`` i32[Rpad] member LOCAL row ids (-1 pad), ``rcount`` i32[]
    true member count. Mirrors ``build_cluster.kmeans`` with the sample
    indices computed against ``rcount`` instead of a static length (the
    stacked member axis is padded to the max across shards; linspace
    picks must never land on pad rows), and with a PER-SHARD effective
    centroid count ``ksh = ceil(rcount / ppc)``: the static shape stays
    ``k`` (derived from the largest shard) but centroids ``>= ksh`` are
    dead sentinels, so a small shard is clustered at the same
    points-per-cluster granularity as the big ones rather than
    over-fragmented into ~rcount/k-point pools. Returns (assign
    i32[Rpad] vs the FINAL centroids, proj f32[Rpad])."""
    from ..build_cluster import _assign_only, _lloyd_iter

    rpad = rows.shape[0]
    safe = jnp.clip(rows, 0, codes.shape[0] - 1)
    mcodes = codes[safe]
    mscales = scales[safe]

    train_n = min(rpad, max(k * train_per_cluster, 4096))
    cnt = jnp.maximum(rcount, 1).astype(jnp.float32)
    ksh = jnp.clip((rcount + ppc - 1) // ppc, 1, k)  # traced per-shard k
    # evenly-spaced picks over the LIVE member prefix (rows are dense
    # member-first by construction)
    tpos = jnp.clip(
        jnp.round(
            jnp.arange(train_n, dtype=jnp.float32)
            * (cnt - 1.0) / max(train_n - 1, 1)
        ).astype(jnp.int32),
        0, rpad - 1,
    )
    tcodes, tscales = mcodes[tpos], mscales[tpos]
    ipos = jnp.clip(
        jnp.round(
            jnp.arange(k, dtype=jnp.float32) * (cnt - 1.0)
            / jnp.maximum(ksh - 1, 1).astype(jnp.float32)
        ).astype(jnp.int32),
        0, rpad - 1,
    )
    cent = dequantize(mcodes[ipos], mscales[ipos])
    cent = jnp.where(
        (jnp.arange(k, dtype=jnp.int32) >= ksh)[:, None], _DEAD_CENT, cent
    )
    tchunk = min(chunk, train_n)
    for _ in range(max(iters, 1)):
        cent, _ = _unwrap(_lloyd_iter)(tcodes, tscales, cent, tchunk)
    assign = _unwrap(_assign_only)(
        mcodes, mscales, cent, min(chunk, rpad)
    )

    # split projection: one fixed random direction (build_cluster uses
    # rng(11); the direction only has to be a consistent spatial key)
    d = codes.shape[1]
    r = jnp.asarray(
        np.random.default_rng(11).standard_normal(d).astype(np.float32)
    )
    proj = jnp.einsum("nd,d->n", dequantize(mcodes, mscales), r,
                      precision=jax.lax.Precision.DEFAULT)  # a sort key
    return assign, proj


# ---------------------------------------------------------------------------
# phase 3: exact table centroids + nearest-cluster fan-out per shard


def _tables_shard(codes, scales, tpad, rchunk: int, c_fan: int):
    """Per-shard body: (centroids, reps) for every member-table row plus
    the nearest-cluster fan-out, pad clusters masked out. ``tpad``
    i32[Kpad, smax] LOCAL ids (-1 pad)."""
    cent, reps = _unwrap(_table_centroids)(codes, scales, tpad, rchunk)
    live = jnp.any(tpad >= 0, axis=1)  # [Kpad]
    k = cent.shape[0]
    c2 = jnp.sum(cent * cent, axis=1)
    # DEFAULT precision: neighbor-cluster choice, a pool heuristic the
    # recall gate owns (as build_cluster._nbr_clusters)
    cd2 = jnp.maximum(
        c2[:, None] + c2[None, :]
        - 2.0 * jnp.dot(cent, cent.T, preferred_element_type=jnp.float32,
                        precision=jax.lax.Precision.DEFAULT),
        0.0,
    )
    # pad clusters sit at the origin-mean — masked from everyone's
    # fan-out (and a pad ROW's own fan-out is irrelevant: no queries).
    # Self is prepended exactly, the rest via approx_max_k — same
    # rationale as build_cluster._nbr_clusters (exact [K, K] top_k is a
    # measured multi-second stage at build scale)
    iota = jnp.arange(k, dtype=jnp.int32)
    if c_fan == 1:
        return iota[:, None], reps
    cd2 = jnp.where(live[None, :], cd2, INF)
    cd2 = jnp.where(iota[None, :] == iota[:, None], INF, cd2)
    if k > 256:
        _, nbr = jax.lax.approx_max_k(-cd2, c_fan - 1, recall_target=0.95)
    else:
        _, nbr = jax.lax.top_k(-cd2, c_fan - 1)
    nbrcl = jnp.concatenate([iota[:, None], nbr.astype(jnp.int32)], axis=1)
    return nbrcl, reps


# ---------------------------------------------------------------------------
# phase 5: per-shard global merge + orphan fixpoint


def _merge_shard(adj, qflat, sel_d2, sel_ids, rows, codes, scales,
                 slots: int, rchunk: int, rows_mode: bool,
                 heuristic: bool, repair_rounds: int):
    """Per-shard body: row map + union-prune merge + in-degree recount +
    the round-varied orphan-repair fixpoint (on-device ``while_loop`` —
    per-shard convergence, no host sync per round)."""
    from ..build_cluster import _global_merge, _global_merge_rows, _recount_indeg

    n = adj.shape[0]
    pos = _unwrap(_sel_pos)(qflat, n)
    if rows_mode:
        adj = _unwrap(_global_merge_rows)(
            adj, pos, qflat, sel_d2, sel_ids, rows, codes, scales,
            slots, rchunk, heuristic,
        )
    else:
        adj = _unwrap(_global_merge)(
            adj, pos, qflat, sel_d2, sel_ids, codes, scales,
            slots, rchunk, heuristic,
        )
    indeg = _unwrap(_recount_indeg)(adj)

    def orphaned(adj, indeg):
        outdeg = jnp.sum(adj >= 0, axis=1)
        return jnp.any(jnp.logical_and(outdeg > 0, indeg == 0))

    def cond(state):
        r, adj, indeg = state
        return jnp.logical_and(r < repair_rounds, orphaned(adj, indeg))

    def body(state):
        r, adj, indeg = state
        # round-varied target slot (see _orphan_repair): switch over the
        # static round variants so the traced body stays shape-stable
        adj, indeg = jax.lax.switch(
            jnp.minimum(r, repair_rounds - 1),
            [
                functools.partial(_unwrap(_orphan_repair), round_=i)
                for i in range(repair_rounds)
            ],
            adj, indeg,
        )
        return r + 1, adj, indeg

    _, adj, indeg = jax.lax.while_loop(
        cond, body, (jnp.int32(0), adj, indeg)
    )
    return adj, indeg


# ---------------------------------------------------------------------------
# the layer driver


def sharded_cluster_layer(
    mesh,
    codes_s,
    scales_s,
    adj_s,
    counts: np.ndarray,
    levels: np.ndarray,
    layer_nb: int,
    cap: int,
    m: int,
    fanout: int = 12,
    pool_p: int = 512,
    points_per_cluster: int = 256,
    kmeans_iters: int = 4,
    smax_headroom: float = 1.75,
    batch_queries: int = 4096,
    pool_approx: bool = False,
    merge_heuristic: bool = True,
    select_alg4: bool = True,
    merge_slots: int = 0,
    exact_layers: int = 0,
    train_per_cluster: int = 8,
    repair_rounds: int = 10,
):
    """Cluster-build layer ``layer_nb`` of every shard concurrently.

    ``codes_s`` u8[S, ns, d] / ``scales_s`` f32[S, ns, 2] / ``adj_s``
    i32[S, ns, cap] stacked over the mesh's ``shard`` axis; ``counts``
    host i64[S] live rows per shard; ``levels`` host i32[S, ns] per-row
    levels (-1 dead). Returns (adj_s, indeg_s, reps host i32[S, Kmax]
    with -1 pads — layer-0 serving pivot hints per shard).

    ``merge_slots`` mirrors the single-chip knob (0 = ``2 * cap``).
    ``exact_layers`` is accepted for cluster_kwargs compatibility with
    the single-chip builder but IGNORED here: the shard_map pipeline
    runs the clustered select on every layer (per-shard upper layers
    are small, and a shard-lockstep exact path would gain nothing —
    the shard axis already amortizes the fixed machinery).
    """
    S, ns, d = codes_s.shape
    shard = NamedSharding(mesh, P("shard"))
    dev = lambda x: jax.device_put(jnp.asarray(x), shard)

    # member rows per shard (local ids, host)
    mems = []
    for s in range(S):
        c = int(counts[s])
        if layer_nb == 0:
            mems.append(np.arange(c, dtype=np.int32))
        else:
            mems.append(
                np.flatnonzero(levels[s, :c] >= layer_nb).astype(np.int32)
            )
    rmax = max((mm.size for mm in mems), default=0)
    if rmax == 0:
        return adj_s, None, None
    rpad = -(-rmax // 8) * 8
    rows = np.full((S, rpad), -1, np.int32)
    for s, mm in enumerate(mems):
        rows[s, : mm.size] = mm
    rcounts = np.asarray([mm.size for mm in mems], np.int32)

    k = max(1, min(rpad, -(-rmax // points_per_cluster)))
    chunk = min(16384, rpad)

    prep = jax.jit(
        jax.shard_map(
            lambda c, sc, r, rc: tuple(
                x[None] for x in _prep_shard(
                    c[0], sc[0], r[0], rc[0], k=k, iters=kmeans_iters,
                    train_per_cluster=train_per_cluster, chunk=chunk,
                    ppc=points_per_cluster,
                )
            ),
            mesh=mesh,
            in_specs=(P("shard"), P("shard"), P("shard"), P("shard")),
            out_specs=(P("shard"), P("shard")),
            check_vma=False,
        ),
    )
    assign_s, proj_s = prep(
        codes_s, scales_s, dev(rows), dev(rcounts)
    )
    assign_h = np.asarray(assign_s)
    proj_h = np.asarray(proj_s)

    # host: per-shard split + member tables (identical code to the
    # single-chip builder; member-local ids mapped through rows)
    smax = max(8, int(np.ceil(rpad / k * smax_headroom / 8)) * 8)
    tables, ks = [], []
    for s in range(S):
        nm = int(rcounts[s])
        if nm == 0:
            tables.append(np.full((0, smax), -1, np.int32))
            ks.append(0)
            continue
        a = assign_h[s, :nm].copy()
        # prep's k-means ran with the GLOBAL k centroids on every shard
        # (k is derived from rmax, the largest shard), so assignments are
        # already in [0, k) — no clamp. A shard with nm < rmax simply
        # leaves some clusters empty; empty rows become pad clusters
        # (all -1), masked by _tables_shard's `live` and the select
        # qids mask. (Clamping to a re-derived per-shard ksh < k used to
        # merge every real cluster with id >= ksh into one megacluster.)
        a, ksp = _split_oversized(a, k, smax, keys=proj_h[s, :nm])
        t, ov = _member_tables(a, ksp, smax)
        if ov:
            raise AssertionError(
                f"member-table overflow ({ov}) after _split_oversized"
            )
        t = np.where(t >= 0, mems[s][np.clip(t, 0, nm - 1)], -1)
        tables.append(t.astype(np.int32))
        ks.append(ksp)
    kmax = max(ks)
    rch = min(1024, max(8, 1 << max(kmax - 1, 1).bit_length()))
    kpad = -(-kmax // rch) * rch
    tpad = np.full((S, kpad, smax), -1, np.int32)
    for s in range(S):
        tpad[s, : ks[s]] = tables[s]
    tpad_d = dev(tpad)

    c_fan = min(fanout, kmax)
    tabf = jax.jit(
        jax.shard_map(
            lambda c, sc, t: tuple(
                x[None] for x in _tables_shard(
                    c[0], sc[0], t[0], rchunk=rch, c_fan=c_fan,
                )
            ),
            mesh=mesh,
            in_specs=(P("shard"), P("shard"), P("shard")),
            out_specs=(P("shard"), P("shard")),
            check_vma=False,
        ),
    )
    nbrcl_s, reps_s = tabf(codes_s, scales_s, tpad_d)

    # select loop: one dispatch per cluster-group batch, every shard at
    # once; per-shard pads (-1 cluster lanes) are masked inside the body
    g = max(1, batch_queries // smax)
    selp = min(max(pool_p, m), c_fan * smax)
    sel = jax.jit(
        jax.shard_map(
            lambda c, sc, t, nb, cl: tuple(
                x[None] for x in _cluster_sel_step_impl(
                    c[0], sc[0], t[0], nb[0], cl[0], m=m, pool_p=selp,
                    pool_approx=pool_approx, select_alg4=select_alg4,
                )
            ),
            mesh=mesh,
            in_specs=(P("shard"),) * 5,
            out_specs=(P("shard"),) * 3,
            check_vma=False,
        ),
    )
    sels = []
    for base in range(0, kmax, g):
        cl = np.full((S, g), -1, np.int32)
        for s in range(S):
            take = max(0, min(g, ks[s] - base))
            if take:
                cl[s, :take] = np.arange(base, base + take, dtype=np.int32)
        sels.append(sel(codes_s, scales_s, tpad_d, nbrcl_s, dev(cl)))
    qflat = jnp.concatenate([x[0] for x in sels], axis=1)
    sel_d2 = jnp.concatenate([x[1] for x in sels], axis=1)
    sel_ids = jnp.concatenate([x[2] for x in sels], axis=1)
    del sels

    rows_mode = layer_nb != 0
    rlim = 16384 if merge_heuristic else 65536
    if rows_mode:
        rchunk = min(rlim, max(1024, 1 << max(rmax - 1, 1).bit_length()))
        mrows = np.full((S, -(-rmax // rchunk) * rchunk), -1, np.int32)
        for s, mm in enumerate(mems):
            mrows[s, : mm.size] = mm
        mrows_d = dev(mrows)
    else:
        rchunk = min(rlim, max(1024, 1 << max(ns - 1, 1).bit_length()))
        mrows_d = dev(np.zeros((S, 1), np.int32))  # unused lane
    merge = jax.jit(
        jax.shard_map(
            lambda a, q, sd, si, r, c, sc: tuple(
                x[None] for x in _merge_shard(
                    a[0], q[0], sd[0], si[0], r[0], c[0], sc[0],
                    slots=merge_slots or 2 * cap, rchunk=rchunk,
                    rows_mode=rows_mode,
                    heuristic=merge_heuristic, repair_rounds=repair_rounds,
                )
            ),
            mesh=mesh,
            in_specs=(P("shard"),) * 7,
            out_specs=(P("shard"),) * 2,
            check_vma=False,
        ),
        donate_argnums=(0,),
    )
    adj_s, indeg_s = merge(
        adj_s, qflat, sel_d2, sel_ids, mrows_d, codes_s, scales_s
    )

    # The on-device fixpoint is capped at repair_rounds per shard; unlike
    # the single-chip builder there is no host repair_connectivity
    # backstop here, so surface any residual orphans instead of assuming
    # convergence (S scalars).
    resid = np.asarray(
        jax.jit(
            jax.shard_map(
                lambda a, i: jnp.sum(
                    jnp.logical_and(jnp.sum(a[0] >= 0, axis=1) > 0,
                                    i[0] == 0)
                )[None],
                mesh=mesh,
                in_specs=(P("shard"), P("shard")),
                out_specs=P("shard"),
                check_vma=False,
            )
        )(adj_s, indeg_s)
    )
    if resid.sum():
        _log.warning(
            "orphan fixpoint hit the %d-round cap on layer %d with "
            "unreachable rows remaining per shard: %s",
            repair_rounds, layer_nb, resid.tolist(),
        )

    reps = None
    if layer_nb == 0:
        reps_h = np.asarray(reps_s)[:, :kpad]
        reps = np.full((S, kpad), -1, np.int32)
        for s in range(S):
            r = reps_h[s, : ks[s]]
            reps[s, : ks[s]] = np.where(r >= 0, r, -1)
    return adj_s, indeg_s, reps
