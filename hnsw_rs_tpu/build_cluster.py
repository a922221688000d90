"""Cluster-bulk layer-0 construction (``insert_bulk(cluster_build=True)``).

The wave builder's throughput ceiling is the construction beam search: a
lockstep ``while_loop`` that runs to its iteration cap for every query
and costs
~sequential-depth x dispatch no matter how good the seeds are. At BULK
build time the graph is not needed to FIND candidate neighbors — the
dataset itself is: this module replaces the per-wave beam searches with

1. device k-means over the dataset (a few Lloyd iterations; assignment
   is one matmul per chunk, centroid update a row scatter-add);
2. per-cluster DENSE candidate pools: each point's pool is the members
   of its cluster's ``fanout`` nearest clusters, scored against the
   whole cluster's members with ONE batched matmul (the per-cluster
   member tables are disjoint, so pools carry no duplicates and need no
   dedup sort — the wave path's measured pool-build wall);
3. the SAME oracle-pinned Algorithm-4 accept chain
   (``heuristic._accept_from_pool``) as the wave builder for neighbor
   selection, then a GLOBAL apply: one pass writing every own row, one
   sorted sweep resolving all reverse edges (:func:`_global_merge`), one
   in-degree recount and one orphan-repair pass — instead of replaying
   the wave apply per batch (435 O(N) passes at 1M).

Graph SEMANTICS differ from the wave build exactly the way any
insertion-order change does (and cluster mates CAN select each other,
which lockstep waves cannot); quality is therefore recall-GATED by the
benchmarks, not structure-pinned. Upper layers (a few % of points) still use the exact
wave path — they are where reference navigation semantics live
(``hnsw/src/template.rs:403-440``); this module is the bulk-throughput
analogue of the reference's parallel insert fan-out at
``template.rs:388-445``.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from .heuristic import _accept_from_pool
from .ops.quant import dequantize
from .ops.topk import INF, PAD_ID, sort_dist_id

__all__ = ["kmeans", "build_layer0_clustered"]


# ---------------------------------------------------------------------------
# device k-means


@functools.partial(jax.jit, static_argnames=("chunk",))
def _lloyd_iter(codes, scales, cent, chunk: int):
    """One Lloyd iteration, chunked over points: returns (new centroids,
    assignment against the INPUT centroids). Assignment is argmax of
    ``x.c - |c|^2/2`` (ordering-equal to argmin ``|x-c|^2``; ties ->
    lowest cluster id, deterministic). Empty clusters keep their old
    centroid."""
    n, d = codes.shape
    k = cent.shape[0]
    npad = -(-n // chunk) * chunk
    ids = jnp.arange(npad, dtype=jnp.int32).reshape(-1, chunk)
    half_c2 = 0.5 * jnp.sum(cent * cent, axis=1)  # [K]

    def step(carry, idc):
        sums, cnts = carry
        valid = idc < n
        safe = jnp.clip(idc, 0, n - 1)
        vec = dequantize(codes[safe], scales[safe])  # [chunk, d]
        # DEFAULT precision (TF32 allowed on the GPU): the assignment only
        # groups points into build pools; the pool distances that rank
        # neighbors run at HIGHEST and the recall gate owns the result
        score = (
            jnp.dot(vec, cent.T, preferred_element_type=jnp.float32,
                    precision=jax.lax.Precision.DEFAULT)
            - half_c2[None, :]
        )
        a = jnp.argmax(score, axis=1).astype(jnp.int32)
        a = jnp.where(valid, a, k)  # pad rows -> dropped
        sums = sums.at[a].add(vec, mode="drop")
        cnts = cnts.at[a].add(1, mode="drop")
        return (sums, cnts), a

    (sums, cnts), assign = jax.lax.scan(
        step, (jnp.zeros((k, d), jnp.float32), jnp.zeros((k,), jnp.int32)), ids
    )
    new_cent = jnp.where(
        (cnts > 0)[:, None], sums / jnp.maximum(cnts, 1)[:, None], cent
    )
    return new_cent, assign.reshape(npad)[:n]


@functools.partial(jax.jit, static_argnames=("chunk",))
def _assign_only(codes, scales, cent, chunk: int):
    """Assignment against fixed centroids, chunked — no centroid-update
    scatter-add (a full-N ``_lloyd_iter`` pass is scatter-dominated, so
    training on a subsample and assigning everything here is cheaper)."""
    n = codes.shape[0]
    k = cent.shape[0]
    npad = -(-n // chunk) * chunk
    ids = jnp.arange(npad, dtype=jnp.int32).reshape(-1, chunk)
    half_c2 = 0.5 * jnp.sum(cent * cent, axis=1)

    def step(_, idc):
        safe = jnp.clip(idc, 0, n - 1)
        vec = dequantize(codes[safe], scales[safe])
        # DEFAULT precision: pool assignment only (see _lloyd_iter)
        score = (
            jnp.dot(vec, cent.T, preferred_element_type=jnp.float32,
                    precision=jax.lax.Precision.DEFAULT)
            - half_c2[None, :]
        )
        return None, jnp.argmax(score, axis=1).astype(jnp.int32)

    _, assign = jax.lax.scan(step, None, ids)
    return assign.reshape(npad)[:n]


@functools.partial(jax.jit, static_argnames=("iters", "chunk", "tchunk"))
def _kmeans_fused(codes, scales, sel, init, iters: int, chunk: int,
                  tchunk: int):
    """The whole kmeans pipeline — subsample gather, ``iters`` unrolled
    Lloyd passes, full-N assignment — as ONE compiled program. The eager
    pipeline's cost was per-op dispatch and host round-trips, not flops
    (the math itself is ~2 TFLOP at 1M); a single dispatch removes every
    intermediate round-trip."""
    tcodes, tscales = codes[sel], scales[sel]
    cent = dequantize(tcodes[init], tscales[init])
    for _ in range(iters):
        cent, _ = _lloyd_iter(tcodes, tscales, cent, tchunk)
    return cent, _assign_only(codes, scales, cent, chunk=chunk)


def kmeans(codes, scales, k: int, iters: int = 4, chunk: int = 16384,
           train_per_cluster: int = 8):
    """Deterministic device k-means: evenly-spaced point init, ``iters``
    Lloyd iterations over an evenly-strided TRAINING SUBSAMPLE of
    ``~train_per_cluster * k`` points (the standard k-means recipe at
    scale — centroid quality is statistically identical and the Lloyd
    passes, whose centroid-update scatter-add is the measured cost, run
    on n/8 of the data), then one scatter-free full-N assignment pass.
    All of it runs as one fused jit dispatch (:func:`_kmeans_fused`);
    the strided subsample/init indices are tiny host-numpy uploads so
    the selection is bit-identical to the historical host computation.
    Returns (centroids f32[K, d], assign i32[N] against the FINAL
    centroids)."""
    n = codes.shape[0]
    chunk = min(chunk, max(n, 1))
    train_n = min(n, max(k * train_per_cluster, 4096))
    if train_n < n:
        sel = np.linspace(0, n - 1, train_n).round().astype(np.int32)
    else:
        sel = np.arange(n, dtype=np.int32)
    tchunk = min(chunk, train_n)
    init = np.linspace(0, train_n - 1, k).round().astype(np.int32)
    return _kmeans_fused(
        codes, scales, jnp.asarray(sel), jnp.asarray(init),
        max(iters, 1), chunk, tchunk,
    )


def _split_oversized(
    assign_np: np.ndarray, k: int, smax: int, keys: np.ndarray | None = None
):
    """Split clusters with more than ``smax`` members into pseudo-clusters
    of at most ``smax``, chunked in ``keys`` order (a 1-D spatial
    projection) so each chunk is a coherent sub-blob with its own
    distinguishable centroid (:func:`_table_centroids` recomputes exact
    per-chunk centroids afterwards — identical sibling centroids would
    tie at d2=0 and crowd the whole nearest-cluster fanout).

    Without the split, overflow members were queries but never
    CANDIDATES: points in dense regions could not form edges among
    themselves in either direction — measured at 1M (subsampled k-means,
    ~20% overflow) as serving recall collapsing to ~0.69 against a 0.99
    gate. Returns (new_assign, k_total)."""
    counts = np.bincount(assign_np, minlength=k)
    big = np.flatnonzero(counts > smax)
    if big.size == 0:
        return assign_np, k
    new_assign = assign_np.copy()
    order = np.argsort(assign_np, kind="stable")
    starts = np.searchsorted(assign_np[order], np.arange(k))
    nxt = k
    for c in big:
        s, cnt = int(starts[c]), int(counts[c])
        ids = order[s : s + cnt]
        if keys is not None:
            ids = ids[np.argsort(keys[ids], kind="stable")]
        for off in range(smax, cnt, smax):
            new_assign[ids[off : off + smax]] = nxt
            nxt += 1
    return new_assign, nxt


@functools.partial(jax.jit, static_argnames=("rchunk",))
def _table_centroids(codes, scales, table, rchunk: int):
    """Exact per-member-table-row centroids f32[K, d] (pad rows -> 0)
    plus each row's REPRESENTATIVE (the member nearest its row centroid,
    i32[K], -1 for empty rows), chunked over rows to bound the
    [rchunk, smax, d] dequantize temp. Representatives are the serving
    pivot set for cluster-built graphs (every region covered by
    construction — ``HNSW.finalize``)."""
    n = codes.shape[0]
    k2, smax = table.shape
    rows = table.reshape(-1, rchunk, smax)  # caller pads k2 to rchunk mult

    def step(_, rws):
        safe = jnp.clip(rws, 0, n - 1).reshape(-1)
        v = dequantize(codes[safe], scales[safe]).reshape(
            rchunk, smax, -1
        )
        msk = (rws >= 0)[..., None]
        s = jnp.sum(jnp.where(msk, v, 0.0), axis=1)
        c = jnp.sum(msk, axis=1).astype(jnp.float32)
        mean = s / jnp.maximum(c, 1.0)
        d2 = jnp.sum((v - mean[:, None, :]) ** 2, axis=-1)
        d2 = jnp.where(msk[..., 0], d2, INF)
        pos = jnp.argmin(d2, axis=1)
        rep = jnp.take_along_axis(rws, pos[:, None], axis=1)[:, 0]
        return None, (mean, rep)

    _, (cent, reps) = jax.lax.scan(step, None, rows)
    return (
        cent.reshape(-1, cent.shape[-1])[:k2],
        reps.reshape(-1)[:k2],
    )


@functools.partial(jax.jit, static_argnames=("c_fan",))
def _nbr_clusters(cent, c_fan: int):
    """Nearest-cluster fan-out i32[K, c_fan], self exactly first: the
    self column is masked out of an ``approx_max_k`` pick of the
    ``c_fan - 1`` nearest others and prepended (see call site — exact
    top_k on [K, K] is a full per-row sort; neighbor-cluster choice is a pool heuristic the recall gate owns, self-inclusion is
    the only exact requirement)."""
    k = cent.shape[0]
    c2 = jnp.sum(cent * cent, axis=1)
    # DEFAULT precision: picks neighbor clusters for the pools, a
    # heuristic the recall gate owns
    cd2 = jnp.maximum(
        c2[:, None] + c2[None, :]
        - 2.0 * jnp.dot(cent, cent.T, preferred_element_type=jnp.float32,
                        precision=jax.lax.Precision.DEFAULT),
        0.0,
    )
    iota = jnp.arange(k, dtype=jnp.int32)
    if c_fan == 1:
        return iota[:, None]
    cd2 = jnp.where(iota[None, :] == iota[:, None], INF, cd2)
    if k > 256:
        _, nbr = jax.lax.approx_max_k(-cd2, c_fan - 1, recall_target=0.95)
    else:
        _, nbr = jax.lax.top_k(-cd2, c_fan - 1)
    return jnp.concatenate(
        [iota[:, None], nbr.astype(jnp.int32)], axis=1
    )


def _member_tables(assign_np: np.ndarray, k: int, smax: int):
    """Host-side [K, Smax] member table (pad -1), fully vectorized (a
    per-cluster python loop costs seconds at k~10k on this 1-core host).
    Returns (table, n_overflow); after :func:`_split_oversized` no
    cluster exceeds ``smax``, so ``n_overflow`` is 0 (the builder
    asserts it — overflowing members would silently lose coverage)."""
    order = np.argsort(assign_np, kind="stable").astype(np.int32)
    sa = assign_np[order]
    starts = np.searchsorted(sa, np.arange(k))
    cnt = np.searchsorted(sa, np.arange(k) + 1) - starts
    rank = np.arange(order.size, dtype=np.int64) - starts[sa]
    keep = rank < smax
    table = np.full((k, smax), -1, np.int32)
    table[sa[keep], rank[keep]] = order[keep]
    overflow = int(np.sum(np.maximum(cnt - smax, 0)))
    return table, overflow


# ---------------------------------------------------------------------------
# per-cluster-group selection step: pool -> accept chain
#
# Selection and application are two phases ON PURPOSE: cluster pools
# contain not-yet-processed points (that is what makes them better than
# wave pools), so per-batch own-row writes would WIPE reverse edges that
# earlier batches added to a later point's row. Phase A below writes
# every own row in one global pass over the full selection; phase B
# (:func:`_global_merge`) then resolves ALL reverse edges in one sorted
# sweep, recounts the in-degree ledger, and runs one orphan-repair pass.


def _cluster_sel_step_impl(
    codes, scales, member, nbrcl, cl_ids, m: int,
    pool_p: int, pool_approx: bool = False, select_alg4: bool = True,
):
    """Selected layer-0 neighbors for every member of ``cl_ids``'
    clusters (one dispatch). ``member`` i32[K, Smax] (pad -1), ``nbrcl``
    i32[K, C] nearest-cluster ids (self first), ``cl_ids`` i32[G] this
    group's clusters (pad -1). Every point appears in exactly one member
    row (:func:`_split_oversized` chunks any cluster above Smax into
    pseudo-clusters, so member tables never overflow — asserted by the
    builder). ``select_alg4=False`` skips the Algorithm-4 accept chain
    here and emits the m NEAREST pool candidates instead, leaving ALL
    diversity pruning to the merge phase's union accept chain (a
    recall-gated speed knob — the final row composition is still
    Algorithm 4 over own+incoming). Returns (qflat i32[G*NQ],
    sel_d2 [G*NQ, m], sel_ids [G*NQ, m])."""
    n = codes.shape[0]
    g, _ = cl_ids.shape[0], None
    smax = member.shape[1]
    c_fan = nbrcl.shape[1]

    cl_safe = jnp.clip(cl_ids, 0, member.shape[0] - 1)
    qids = jnp.where((cl_ids >= 0)[:, None], member[cl_safe], -1)  # [G, S]
    nq = qids.shape[1]
    nb = nbrcl[cl_safe]  # [G, C]
    cand = member[jnp.clip(nb, 0, member.shape[0] - 1)]  # [G, C, Smax]
    cand = jnp.where((nb >= 0)[:, :, None], cand, -1).reshape(g, c_fan * smax)
    cs = c_fan * smax

    qsafe = jnp.clip(qids, 0, n - 1)
    qvec = dequantize(codes[qsafe.reshape(-1)], scales[qsafe.reshape(-1)])
    qvec = qvec.reshape(g, nq, -1)  # [G, NQ, d]
    csafe = jnp.clip(cand, 0, n - 1)
    cvec = dequantize(codes[csafe.reshape(-1)], scales[csafe.reshape(-1)])
    cvec = cvec.reshape(g, cs, -1)  # [G, CS, d]

    # dense pool distances, one batched matmul per group (the direct
    # |q-c|^2 diff-square form would materialize [G, NQ, CS, d])
    qq = jnp.sum(qvec * qvec, axis=2)  # [G, NQ]
    cc = jnp.sum(cvec * cvec, axis=2)  # [G, CS]
    qc = jax.lax.dot_general(
        qvec, cvec, (((2,), (2,)), ((0,), (0,))),
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )  # [G, NQ, CS]
    d2 = jnp.maximum(qq[:, :, None] + cc[:, None, :] - 2.0 * qc, 0.0)

    # one fused mask pass over the [G, NQ, CS] distances (table pads,
    # invalid query lanes, self-matches all -> INF); candidate IDS are
    # gathered AFTER top-k from the per-group [CS] table — materializing
    # a [G, NQ, CS] id array before selection is a pure
    # memory-bandwidth pass
    bad = jnp.logical_or(
        jnp.logical_or((cand < 0)[:, None, :], (qids < 0)[:, :, None]),
        cand[:, None, :] == qids[:, :, None],  # self
    )
    d2 = jnp.where(bad, INF, d2)

    # top-P pool per query; re-sorted to the exact (d2, id) lex order the
    # accept chain requires (top_k breaks distance ties by position — only
    # the P-th-boundary tie can differ from a full lex sort, a pool-
    # selection detail the recall gate owns)
    p = min(max(pool_p, m), cs)  # >= m: the selection slices pool[:, :m]
    if pool_approx and p < cs:
        # lax.approx_max_k: pool selection is already an approximation
        # the recall gate owns (on the GPU it falls back to an exact
        # sort, ROADMAP queue 1 item 2)
        nv, pos = jax.lax.approx_max_k(-d2, p, recall_target=0.95)
        pos = pos.astype(jnp.int32)
    else:
        nv, pos = jax.lax.top_k(-d2, p)  # [G, NQ, P]
    pool_ids = jax.vmap(lambda c, s: c[s])(cand, pos)  # [G, NQ, P]
    pool_d2 = (-nv).reshape(g * nq, p)
    # INF lanes are underfull-pool pads (every real candidate was masked
    # or the table ran short) — their gathered id is arbitrary: PAD it
    pool_ids = jnp.where(
        jnp.isinf(pool_d2), PAD_ID, pool_ids.reshape(g * nq, p)
    )
    pool_d2, pool_ids = sort_dist_id(pool_d2, pool_ids)

    qflat = qids.reshape(g * nq)
    if select_alg4:
        sel_d2, sel_ids = _accept_from_pool(
            codes, scales, qvec.reshape(g * nq, -1), pool_d2, pool_ids, m,
            keep_pruned=True,
        )
    else:
        sel_d2, sel_ids = pool_d2[:, :m], pool_ids[:, :m]
    return qflat, sel_d2, sel_ids


_cluster_sel_step = functools.partial(
    jax.jit, static_argnames=("m", "pool_p", "pool_approx", "select_alg4"),
)(_cluster_sel_step_impl)


def _exact_sel_step_impl(
    codes, scales, qids, mem_all, m: int, pool_p: int,
    select_alg4: bool = True,
):
    """Exact-pool variant of :func:`_cluster_sel_step_impl` for SMALL
    layers: candidates are ALL layer members (``mem_all`` i32[NM_pad],
    pad -1), scored against the query chunk ``qids`` i32[B] (pad -1)
    with one matmul — no k-means, no member tables, no cluster
    fan-out. The pool is a strict superset of any cluster pool, so
    selection quality is >= the clustered path's; everything downstream
    (phase A row map, global merge, orphan repair) is unchanged. Same
    (qflat, sel_d2, sel_ids) contract, PAD/INF conventions, and (d2, id)
    lex order as the clustered step.

    Motivation: the upper layers hold ~4% of the points, but the
    clustered pass's fixed per-pass machinery (k-means, member tables,
    fan-out) dominated their cost even for layers of a few dozen
    members."""
    n = codes.shape[0]
    b = qids.shape[0]
    qsafe = jnp.clip(qids, 0, n - 1)
    qvec = dequantize(codes[qsafe], scales[qsafe])  # [B, d]
    csafe = jnp.clip(mem_all, 0, n - 1)
    cvec = dequantize(codes[csafe], scales[csafe])  # [NM, d]

    qq = jnp.sum(qvec * qvec, axis=1)  # [B]
    cc = jnp.sum(cvec * cvec, axis=1)  # [NM]
    qc = jax.lax.dot_general(
        qvec, cvec, (((1,), (1,)), ((), ())),
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )  # [B, NM]
    d2 = jnp.maximum(qq[:, None] + cc[None, :] - 2.0 * qc, 0.0)
    bad = jnp.logical_or(
        jnp.logical_or((mem_all < 0)[None, :], (qids < 0)[:, None]),
        mem_all[None, :] == qids[:, None],  # self
    )
    d2 = jnp.where(bad, INF, d2)

    p = min(max(pool_p, m), mem_all.shape[0])
    nv, pos = jax.lax.top_k(-d2, p)  # [B, P]
    pool_ids = mem_all[pos.astype(jnp.int32)]
    pool_d2 = -nv
    pool_ids = jnp.where(jnp.isinf(pool_d2), PAD_ID, pool_ids)
    pool_d2, pool_ids = sort_dist_id(pool_d2, pool_ids)

    if select_alg4:
        sel_d2, sel_ids = _accept_from_pool(
            codes, scales, qvec, pool_d2, pool_ids, m, keep_pruned=True,
        )
    else:
        sel_d2, sel_ids = pool_d2[:, :m], pool_ids[:, :m]
    return qids, sel_d2, sel_ids


_exact_sel_step = functools.partial(
    jax.jit, static_argnames=("m", "pool_p", "select_alg4"),
)(_exact_sel_step_impl)


@functools.partial(jax.jit, static_argnames=("n",))
def _sel_pos(qflat, n: int):
    """Phase A: the row -> selection-index map ``pos`` i32[n] (-1 for rows
    with no query). ONE narrow i32 scatter — the earlier phase-A design
    scattered the own rows (int32[N, cap]) AND the selection distances
    (f32[N, m]) into full tables, and a wide-row scatter at N rows was a
    large share of the 1M build. The merge now GATHERS each row's
    own selection through ``pos`` instead (gather+select rewrite), and the
    in-degree ledger is recounted from the final adjacency in one
    histogram pass."""
    t = qflat.shape[0]
    rows = jnp.where(qflat >= 0, qflat, n)
    return jnp.full((n,), -1, jnp.int32).at[rows].set(
        jnp.arange(t, dtype=jnp.int32), mode="drop"
    )


@functools.partial(
    jax.jit, static_argnames=("slots", "rchunk", "heuristic"),
    donate_argnames=("adj",),
)
def _global_merge(adj, pos, qflat, sel_d2, sel_ids, codes, scales,
                  slots: int, rchunk: int, heuristic: bool = True):
    """Phase B, ONE dispatch: global reverse-edge union-prune.

    A per-batch apply would replay ``_apply_wave_impl`` ~435 times at 1M
    (each pass pays an O(N) orphan sort, an exd2 gather-scan, and a
    [E, 3*cap]-wide sort for its slice of edges). The
    cluster build owns EVERY layer-0 row, so the whole reverse pass
    collapses into one sorted sweep:

    1. flatten all (target, d2, source) reverse edges and 3-key sort
       them — every target's incoming edges become a contiguous run,
       BEST-first (the per-batch path dropped slot-overflow edges
       arbitrarily; here overflow drops the d2-WORST, strictly better);
    2. per-target run offsets via one searchsorted over the sorted keys;
    3. rewrite rows in ``rchunk`` blocks: union own selection (ids AND
       distances gathered straight from the selection arrays through the
       ``pos`` row map — zero scatters, zero distance recomputes) with
       the first ``slots`` incoming, dedup mutual selections,
       (d2, id)-sort, keep ``cap``.

    ``heuristic=True`` (default): each row's final composition is the
    Algorithm-4 accept chain over the sorted union (``keep_pruned``,
    ``m=cap``) — the reference's ``prune_connections`` semantics. A
    plain nearest-cap union (``heuristic=False``) builds a directed
    kNN graph whose dense regions are poorly navigable: measured at 1M
    as serving recall FLAT at ~0.70-0.74 across ef 40-96 against the
    0.99 gate. Diversity
    of the row, not just proximity, is what lets beams ENTER a
    neighborhood from outside.

    In-degree protection during pruning is dropped (the per-batch path
    protected indeg==1 neighbors); global competition plus the
    orphan-repair pass (:func:`_orphan_repair`) and the host backstop
    (``build.repair_connectivity``) own connectivity instead — the
    cluster build's quality contract is recall-gated, not
    structure-pinned (module docstring)."""
    n, cap = adj.shape
    t, m = sel_ids.shape
    e = t * m
    ok = jnp.logical_and(sel_ids != PAD_ID, (qflat >= 0)[:, None])
    tgt0 = jnp.where(ok, sel_ids, n).reshape(e)
    src0 = jnp.broadcast_to(qflat[:, None], (t, m)).reshape(e)
    ed20 = jnp.where(ok, sel_d2, INF).reshape(e)
    tgt_s, ed2_s, src_s = jax.lax.sort(
        (tgt0, ed20, src0), dimension=0, num_keys=3
    )
    bounds = jnp.searchsorted(tgt_s, jnp.arange(n + 1, dtype=jnp.int32))
    starts, ends = bounds[:-1], bounds[1:]

    npad = -(-n // rchunk) * rchunk
    pad_r = npad - n
    adj_p = jnp.concatenate(
        [adj, jnp.full((pad_r, cap), -1, jnp.int32)]
    ) if pad_r else adj
    pos_p = jnp.concatenate(
        [pos, jnp.full((pad_r,), -1, jnp.int32)]
    ) if pad_r else pos
    starts_p = jnp.concatenate(
        [starts, jnp.zeros((pad_r,), starts.dtype)]
    ) if pad_r else starts
    ends_p = jnp.concatenate(
        [ends, jnp.zeros((pad_r,), ends.dtype)]
    ) if pad_r else ends

    iota_s = jnp.arange(slots, dtype=jnp.int32)[None, :]

    def chunk_body(ci, adjc):
        base = ci * rchunk
        posc = jax.lax.dynamic_slice(pos_p, (base,), (rchunk,))
        psafe = jnp.clip(posc, 0, max(t - 1, 0))
        raw = sel_ids[psafe]  # [rchunk, m] own selection via the row map
        okc = jnp.logical_and((posc >= 0)[:, None], raw != PAD_ID)
        ex_ids = jnp.where(okc, raw, -1)
        ex_d2 = jnp.where(okc, sel_d2[psafe], INF)
        s = jax.lax.dynamic_slice(starts_p, (base,), (rchunk,))
        cnt = jax.lax.dynamic_slice(ends_p, (base,), (rchunk,)) - s
        off = jnp.clip(s[:, None] + iota_s, 0, e - 1 if e else 0)
        take = iota_s < jnp.minimum(cnt, slots)[:, None]
        inc_ids = jnp.where(take, src_s[off], -1)
        inc_d2 = jnp.where(take, ed2_s[off], INF)
        # mutual selection: the incoming source already sits in the own
        # row — a second copy would burn a unique slot in every beam's
        # top-k (measured as a flat ~0.65 recall ceiling); set-insert no-op
        dup = jnp.any(
            inc_ids[:, :, None] == jnp.where(ex_ids >= 0, ex_ids, n)[:, None, :],
            axis=-1,
        )
        inc_ids = jnp.where(dup, -1, inc_ids)
        inc_d2 = jnp.where(dup, INF, inc_d2)
        uni_ids = jnp.concatenate(
            [jnp.where(ex_ids >= 0, ex_ids, PAD_ID),
             jnp.where(inc_ids >= 0, inc_ids, PAD_ID)], axis=1
        )
        uni_d2 = jnp.concatenate([ex_d2, inc_d2], axis=1)
        uni_d2, uni_ids = sort_dist_id(uni_d2, uni_ids)
        if heuristic:
            rows = jnp.clip(
                base + jnp.arange(rchunk, dtype=jnp.int32), 0,
                codes.shape[0] - 1,
            )
            tvec = dequantize(codes[rows], scales[rows])
            acc_d2, acc_ids = _accept_from_pool(
                codes, scales, tvec, uni_d2, uni_ids, cap,
                keep_pruned=True,
            )
            new = jnp.where(acc_ids == PAD_ID, -1, acc_ids)
        else:
            new = jnp.where(
                uni_ids[:, :cap] == PAD_ID, -1, uni_ids[:, :cap]
            )
        return jax.lax.dynamic_update_slice(adjc, new, (base, 0))

    adj_p = jax.lax.fori_loop(0, npad // rchunk, chunk_body, adj_p)
    return adj_p[:n] if pad_r else adj_p


@functools.partial(
    jax.jit, static_argnames=("slots", "rchunk", "heuristic"),
    donate_argnames=("adj",),
)
def _global_merge_rows(adj, pos, qflat, sel_d2, sel_ids, rows,
                       codes, scales, slots: int, rchunk: int,
                       heuristic: bool = True):
    """Member-subset variant of :func:`_global_merge` for UPPER layers:
    only ``rows`` (this layer's members, pad -1, i32[R_pad]) can change,
    so the union-prune gathers/rewrites R rows instead of sweeping all N
    (a layer-1 pass touches ~N/m rows instead of N). Row writes go
    through a narrow per-chunk scatter — fine at member counts (wide-row
    scatters only hurt at millions of rows)."""
    n, cap = adj.shape
    t, m = sel_ids.shape
    e = t * m
    ok = jnp.logical_and(sel_ids != PAD_ID, (qflat >= 0)[:, None])
    tgt0 = jnp.where(ok, sel_ids, n).reshape(e)
    src0 = jnp.broadcast_to(qflat[:, None], (t, m)).reshape(e)
    ed20 = jnp.where(ok, sel_d2, INF).reshape(e)
    tgt_s, ed2_s, src_s = jax.lax.sort(
        (tgt0, ed20, src0), dimension=0, num_keys=3
    )
    iota_s = jnp.arange(slots, dtype=jnp.int32)[None, :]
    r_pad = rows.shape[0]

    def chunk_body(ci, adjc):
        base = ci * rchunk
        rc = jax.lax.dynamic_slice(rows, (base,), (rchunk,))
        valid = rc >= 0
        rsafe = jnp.clip(rc, 0, n - 1)
        posc = jnp.where(valid, pos[rsafe], -1)
        psafe = jnp.clip(posc, 0, max(t - 1, 0))
        raw = sel_ids[psafe]  # [R, m] own selection via the row map
        okc = jnp.logical_and((posc >= 0)[:, None], raw != PAD_ID)
        ex_ids = jnp.where(okc, raw, -1)
        ex_d2 = jnp.where(okc, sel_d2[psafe], INF)
        s = jnp.searchsorted(tgt_s, rsafe).astype(jnp.int32)
        cnt = jnp.searchsorted(tgt_s, rsafe, side="right").astype(
            jnp.int32
        ) - s
        cnt = jnp.where(valid, cnt, 0)
        off = jnp.clip(s[:, None] + iota_s, 0, e - 1 if e else 0)
        take = iota_s < jnp.minimum(cnt, slots)[:, None]
        inc_ids = jnp.where(take, src_s[off], -1)
        inc_d2 = jnp.where(take, ed2_s[off], INF)
        dup = jnp.any(
            inc_ids[:, :, None] == jnp.where(ex_ids >= 0, ex_ids, n)[:, None, :],
            axis=-1,
        )
        inc_ids = jnp.where(dup, -1, inc_ids)
        inc_d2 = jnp.where(dup, INF, inc_d2)
        uni_ids = jnp.concatenate(
            [jnp.where(ex_ids >= 0, ex_ids, PAD_ID),
             jnp.where(inc_ids >= 0, inc_ids, PAD_ID)], axis=1
        )
        uni_d2 = jnp.concatenate([ex_d2, inc_d2], axis=1)
        uni_d2, uni_ids = sort_dist_id(uni_d2, uni_ids)
        if heuristic:
            tvec = dequantize(codes[rsafe], scales[rsafe])
            acc_d2, acc_ids = _accept_from_pool(
                codes, scales, tvec, uni_d2, uni_ids, cap,
                keep_pruned=True,
            )
            new = jnp.where(acc_ids == PAD_ID, -1, acc_ids)
        else:
            new = jnp.where(
                uni_ids[:, :cap] == PAD_ID, -1, uni_ids[:, :cap]
            )
        return adjc.at[jnp.where(valid, rc, n)].set(new, mode="drop")

    return jax.lax.fori_loop(0, r_pad // rchunk, chunk_body, adj)


@jax.jit
def _any_orphan(adj, indeg):
    """True iff any connected node (outdeg > 0) has in-degree 0."""
    outdeg = jnp.sum(adj >= 0, axis=1)
    return jnp.any(jnp.logical_and(outdeg > 0, indeg == 0))


@jax.jit
def _recount_indeg(adj):
    n = adj.shape[0]
    flat = jnp.where(adj >= 0, adj, n).reshape(-1)
    return jnp.zeros((n,), jnp.int32).at[flat].add(1, mode="drop")


@functools.partial(
    jax.jit, static_argnames=("round_",), donate_argnames=("adj", "indeg")
)
def _orphan_repair(adj, indeg, round_: int = 0):
    """One global orphan-repair pass (the step-3 logic of
    ``build._apply_wave_impl``, standalone): every connected node
    (outdeg > 0) with indeg == 0 is force-written into an out-neighbor's
    worst slot, ranked to avoid slot collisions.

    ``round_`` picks WHICH out-neighbor (slot ``round_`` of the orphan's
    row, falling back to slot 0 when empty): with a fixed target the
    pass is a deterministic fixpoint — >cap orphans colliding on one
    target re-rank identically every round and the losers stay orphaned
    forever, and two mutually-evicting full rows livelock (measured at
    1M as a non-converging repair that fell through to the host sweep's
    full-adjacency fetch). Varying the slot per round spreads collisions over
    distinct targets, so iterating rounds converges."""
    n, cap = adj.shape
    outdeg = jnp.sum(adj >= 0, axis=1)
    orphan = jnp.logical_and(outdeg > 0, indeg == 0)
    alt = adj[:, min(round_, cap - 1)]
    tchoice = jnp.where(alt >= 0, alt, adj[:, 0])
    tfix = jnp.where(orphan, tchoice, n)
    all_ids = jnp.arange(n, dtype=jnp.int32)
    tfix_s, src_s = jax.lax.sort((tfix, all_ids), dimension=0, num_keys=1)
    ffirst = jnp.concatenate(
        [tfix_s[:1] < n,
         jnp.logical_and(tfix_s[1:] < n, tfix_s[1:] != tfix_s[:-1])]
    )
    frank = all_ids - jax.lax.cummax(jnp.where(ffirst, all_ids, -1))
    fslot = cap - 1 - jnp.clip(frank, 0, cap - 1)
    f_ok = jnp.logical_and(tfix_s < n, frank < cap)
    frow = jnp.where(f_ok, tfix_s, n)
    evicted = adj[jnp.clip(frow, 0, n - 1), fslot]
    evicted = jnp.where(jnp.logical_and(f_ok, evicted >= 0), evicted, n)
    indeg = indeg.at[evicted].add(-1, mode="drop")
    adj = adj.at[frow, fslot].set(
        jnp.where(f_ok, src_s, -1), mode="drop"
    )
    indeg = indeg.at[jnp.where(f_ok, src_s, n)].add(1, mode="drop")
    return adj, indeg


def build_layer0_clustered(
    graph,
    store,
    params,
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
    exact_layers: int = 65536,
    bar=None,
    layer_nb: int = 0,
    member_ids: np.ndarray | None = None,
) -> None:
    """Build layer ``layer_nb`` of ``graph`` for ``member_ids`` (defaults
    to ALL points — layer 0) with the cluster-bulk pipeline (module
    docstring). Mutates ``graph`` in place; the layer must be empty (the
    cluster phase owns every member row + the in-degree ledger).

    Upper layers (``member_ids`` = points with level >= layer_nb) use the
    exact same machinery over the member SUBSET: k-means over members,
    member tables carry global ids, and the reverse merge rewrites only
    member rows (:func:`_global_merge_rows`). This replaced the
    upper-layer wave path in the cluster build — the ramped waves' lockstep
    beam searches were most of the wave build's time for ~4% of the
    points.

    ``merge_slots`` (0 = ``2 * cap``): incoming reverse-edge slots per
    row in the merge union. The merge's cost is its per-row vector
    gathers ([rchunk, m + slots] rows per chunk), so slots is a direct
    build-speed knob; mean in-degree is ``m``, so truncation only
    touches hub rows (d2-worst incoming drop first).

    ``exact_layers``: upper layers (``member_ids`` given, ``layer_nb >
    0``) with at most this many members skip the cluster machinery
    entirely — every member's pool is ALL members, scored with chunked
    matmuls (:func:`_exact_sel_step_impl`); the merge/repair phases
    are unchanged. At 1M/M=24 every upper layer (41.5k members and
    below) takes this path."""
    n = len(store)
    if n == 0:
        return
    codes, scales = store.codes[:n], store.scales[:n]
    if member_ids is None:
        nm = n
        mem = None
        mcodes, mscales = codes, scales
    else:
        mem = np.asarray(member_ids, np.int32)
        nm = mem.size
        if nm == 0:
            return
        mem_dev = jnp.asarray(mem)
        mcodes, mscales = codes[mem_dev], scales[mem_dev]
    adj = graph.get_layer(layer_nb)
    m = params.m
    cap = graph.layer_cap(layer_nb)

    if mem is not None and layer_nb > 0 and nm <= exact_layers:
        # exact small-layer path: upper layers hold ~4.3% of the points
        # but each clustered pass pays the full fixed machinery (k-means,
        # split, member tables, centroid pass, fan-out top-k, a select
        # loop) even for a layer of a few dozen members. For
        # nm <= exact_layers the all-members pool
        # is one chunked matmul per batch: exact, fewer dispatches,
        # and a strict superset of any cluster pool.
        nm_pad = max(256, 1 << (nm - 1).bit_length())
        mem_pad = np.full((nm_pad,), -1, np.int32)
        mem_pad[:nm] = mem
        mem_all = jnp.asarray(mem_pad)
        bq = min(batch_queries, nm_pad)
        sels = []
        for base in range(0, nm, bq):
            qc = np.full((bq,), -1, np.int32)
            take = min(bq, nm - base)
            qc[:take] = mem[base : base + take]
            sels.append(_exact_sel_step(
                codes, scales, jnp.asarray(qc), mem_all,
                m=m, pool_p=pool_p, select_alg4=select_alg4,
            ))
            if bar is not None:
                bar.inc(take)
    else:
        k = max(1, min(nm, -(-nm // points_per_cluster)))
        cent, assign = kmeans(mcodes, mscales, k, iters=kmeans_iters)

        smax = max(8, int(np.ceil(nm / k * smax_headroom / 8)) * 8)
        # spatial key for chunking oversized clusters: one random
        # projection (member-local), fetched once — 4 B/member
        proj = np.asarray(jnp.einsum(
            "nd,d->n",
            dequantize(mcodes, mscales),
            jnp.asarray(np.random.default_rng(11).standard_normal(
                mcodes.shape[1]).astype(np.float32)),
            precision=jax.lax.Precision.DEFAULT,  # a sort key only
        ))
        assign_np, k = _split_oversized(np.asarray(assign), k, smax,
                                        keys=proj)
        table, overflow = _member_tables(assign_np, k, smax)
        if mem is not None:
            # member tables / overflow lists hold member-LOCAL positions:
            # map to global point ids (the select step gathers by global
            # id)
            table = np.where(table >= 0, mem[np.clip(table, 0, nm - 1)],
                             -1)
        # exact per-row centroids AFTER the split (Lloyd centroids are
        # stale for pseudo-clusters, and identical sibling centroids
        # would tie)
        rch = min(1024, max(8, 1 << max(k - 1, 1).bit_length()))
        kpad = -(-k // rch) * rch
        tpad = np.full((kpad, smax), -1, np.int32)
        tpad[:k] = table  # global ids either way; gathers hit the store
        cent, reps_dev = _table_centroids(
            codes, scales, jnp.asarray(tpad), rchunk=rch
        )
        cent = cent[:k]

        # nearest clusters per cluster, self FIRST by construction:
        # exact lax.top_k over the [K, K] matrix is a full per-row sort;
        # the fan-out is a candidate-pool
        # heuristic the recall gate owns, so approx_max_k picks the
        # c_fan-1 non-self neighbors and the self column (the one entry
        # that is load-bearing — cluster mates MUST see each other) is
        # prepended exactly
        c_fan = min(fanout, k)
        nbrcl = _nbr_clusters(cent, c_fan)

        # coverage invariant: _split_oversized chunks every cluster above
        # Smax into pseudo-clusters, so the member tables hold EVERY
        # point (overflow handling used to live here as extra query
        # items — the split makes it structurally impossible, and dead
        # overflow lanes doubled every select batch's query width)
        if overflow:
            raise AssertionError(
                f"member-table overflow ({overflow}) after _split_oversized"
            )

        member_dev = jnp.asarray(table)
        g = max(1, batch_queries // smax)

        # phase SELECT: neighbors for every point, one cluster-group
        # batch per dispatch (member counts per batch drive the progress
        # bar)
        row_counts = np.sum(table >= 0, axis=1)
        sels = []
        for base in range(0, k, g):
            cl = np.full((g,), -1, np.int32)
            take = min(g, k - base)
            cl[:take] = np.arange(base, base + take, dtype=np.int32)
            sels.append(_cluster_sel_step(
                codes, scales, member_dev, nbrcl, jnp.asarray(cl),
                m=m, pool_p=pool_p, pool_approx=pool_approx,
                select_alg4=select_alg4,
            ))
            if bar is not None:
                bar.inc(int(np.sum(row_counts[base : base + take])))

    # phase A: the row -> selection-index map (one narrow scatter; the
    # merge gathers own rows/distances through it — no wide scatters)
    qflat = jnp.concatenate([s[0] for s in sels])
    sel_d2 = jnp.concatenate([s[1] for s in sels])
    sel_ids = jnp.concatenate([s[2] for s in sels])
    del sels
    pos = _sel_pos(qflat, n=n)

    # phase B: global reverse-edge union-prune (one dispatch), then
    # recount the in-degree ledger and repair orphans. The heuristic
    # union keeps per-chunk [R, C, d] accept-gather temps bounded via a
    # smaller row chunk.
    rlim = 16384 if merge_heuristic else 65536
    slots = merge_slots or 2 * cap
    if mem is None:
        rchunk = min(rlim, max(1024, 1 << (n - 1).bit_length()))
        adj = _global_merge(
            adj, pos, qflat, sel_d2, sel_ids, codes, scales,
            slots=slots, rchunk=rchunk, heuristic=merge_heuristic,
        )
    else:
        rchunk = min(rlim, max(1024, 1 << (nm - 1).bit_length()))
        rows = np.full((-(-nm // rchunk) * rchunk,), -1, np.int32)
        rows[:nm] = mem
        adj = _global_merge_rows(
            adj, pos, qflat, sel_d2, sel_ids, jnp.asarray(rows),
            codes, scales, slots=slots, rchunk=rchunk,
            heuristic=merge_heuristic,
        )
    indeg = _recount_indeg(adj)
    # iterate orphan repair to convergence ON DEVICE: an eviction can
    # itself orphan a node whose only in-edge sat in the evicted slot,
    # and ONE leftover orphan makes build.repair_connectivity pull the
    # full adjacency host-side (192 MB at 1M)
    for r in range(10):
        adj, indeg = _orphan_repair(adj, indeg, round_=r)
        if not bool(_any_orphan(adj, indeg)):
            break
    graph.set_layer(layer_nb, adj, indeg)
    if layer_nb == 0:
        # per-cluster serving pivots: one representative per cluster
        # (finalize() seeds from them — level-sampled pivots miss whole
        # micro-regions on cluster-built graphs)
        reps = np.asarray(reps_dev[:k])
        return reps[reps >= 0].astype(np.int32)
    return None
