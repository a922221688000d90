"""Batched neighbor-selection heuristic (HNSW Algorithm 4).

Faithful array reimplementation of ``Searcher::select_heuristic``
(``hnsw/src/template/searcher.rs:109-153``) with ``extend_cands`` and
``keep_pruned`` both true, as the insert path uses it
(``inserter.rs:115-123``):

1. candidates := the beam from ``search_layer`` (the reference's
   ``select_setup``, ``results.rs:105-111``), extended with every
   candidate's current graph neighbors
   (``extend_candidates_with_neighbors``, ``results.rs:122-146``),
   deduplicated, sorted by (dist-to-query, id);
2. walk the pool best-first: accept candidate ``e`` iff
   ``(d(e,q), id_e) < (min_s d(e,s), id_s*)`` over already-selected ``s``
   (``get_nearest_from_selected``, ``results.rs:69-77``) — the first
   candidate is accepted unconditionally (``searcher.rs:125-126``), stop
   at ``m`` accepted;
3. keep_pruned: backfill rejected candidates in (dist, id) order up to
   ``m`` (``searcher.rs:141-146``).

The accept loop is evaluated in static chunks of G candidates: all
distances the sequential accept chain can need are precomputed with two
matmuls per chunk ([B, G, m] vs already-selected and the [B, G, G]
intra-chunk pairwise matrix), then the chain resolves exactly with a
first-passer loop of [B, G] elementwise updates — one iteration per
acceptance, no per-acceptance matvec (see the inline note in
:func:`select_heuristic`); pool distances are computed in fixed-size
tiles so no [B, C, d] temp ever materializes (C = ef*(1+cap) reaches
thousands at large ``ef_cons``).
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp

from .ops.distance import l2sq
from .ops.quant import dequantize
from .ops.topk import INF, PAD_ID, dedup_ids, sort_dist_id
from .search import _gather_vecs

_D2_CHUNK = 256  # pool-distance tile: bounds gather temps to [B, 256, d]
_ACCEPT_CHUNK = int(os.environ.get("HNSW_ACCEPT_CHUNK", "128"))


def _chunked_d2(codes, scales, q, ids):
    """Distances from each query to a wide id set [B, E], computed in
    fixed-size chunks so the [B, E, d] gather temp never materializes
    (E = ef*cap can reach thousands; a single gather blows HBM)."""
    b, e = ids.shape
    pad = (-e) % _D2_CHUNK
    idsp = jnp.pad(ids, ((0, 0), (0, pad)))
    chunks = idsp.reshape(b, -1, _D2_CHUNK)

    def step(_, ch):
        vecs = _gather_vecs(codes, scales, ch)
        return None, l2sq(q[:, None, :], vecs)

    _, out = jax.lax.scan(step, None, jnp.moveaxis(chunks, 1, 0))
    return jnp.moveaxis(out, 0, 1).reshape(b, e + pad)[:, :e]


def build_candidate_pool(
    adj: jnp.ndarray,
    codes: jnp.ndarray,
    scales: jnp.ndarray,
    q: jnp.ndarray,
    cand_d2: jnp.ndarray,
    cand_ids: jnp.ndarray,
    extend: bool,
    forbid: jnp.ndarray | None,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Sorted, deduplicated candidate pool [B, C] for the heuristic.

    C = ef + ef*cap when ``extend`` (neighbors of every candidate join the
    pool with their true distance to ``q``), else ef.
    """
    if extend:
        safe = jnp.clip(jnp.where(cand_ids == PAD_ID, 0, cand_ids), 0, adj.shape[0] - 1)
        nbrs = adj[safe]  # [B, ef, cap]
        nvalid = jnp.logical_and(nbrs >= 0, (cand_ids != PAD_ID)[:, :, None])
        b, ef, cap = nbrs.shape
        nbrs = nbrs.reshape(b, ef * cap)
        nvalid = nvalid.reshape(b, ef * cap)
        nd2 = _chunked_d2(codes, scales, q, jnp.where(nvalid, nbrs, 0))
        nd2 = jnp.where(nvalid, nd2, INF)
        nids = jnp.where(nvalid, nbrs, PAD_ID)
        pool_d2 = jnp.concatenate([cand_d2, nd2], axis=1)
        pool_ids = jnp.concatenate([cand_ids, nids], axis=1)
    else:
        pool_d2, pool_ids = cand_d2, cand_ids
    if forbid is not None:
        bad = pool_ids == forbid[:, None]
        pool_d2 = jnp.where(bad, INF, pool_d2)
        pool_ids = jnp.where(bad, PAD_ID, pool_ids)
    pool_d2, pool_ids = dedup_ids(pool_d2, pool_ids)
    return sort_dist_id(pool_d2, pool_ids)


_POOL_PACK_CHUNK = 8  # beam entries decoded per scan step: bounds the
# [B, ech, cap, d] dequantize/l2sq temp to a few hundred MB at build sizes


def build_candidate_pool_packed(
    packed: jnp.ndarray,
    q: jnp.ndarray,
    cand_d2: jnp.ndarray,
    cand_ids: jnp.ndarray,
    extend: bool,
    forbid: jnp.ndarray | None,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """:func:`build_candidate_pool` over the packed-neighbor layout
    (``search.pack_layer``): ONE wide row gather per beam entry supplies
    its neighbors' ids, codes AND scales, so the extend step costs
    ``B*ef`` row gathers instead of ``B*ef*cap`` — the same row-rate
    argument as serving, applied to construction. Distances
    are bit-identical to the plain path (same codes/scales feed the same
    dequantize + l2sq)."""
    if not extend:
        pool_d2, pool_ids = cand_d2, cand_ids
        if forbid is not None:
            bad = pool_ids == forbid[:, None]
            pool_d2 = jnp.where(bad, INF, pool_d2)
            pool_ids = jnp.where(bad, PAD_ID, pool_ids)
        pool_d2, pool_ids = dedup_ids(pool_d2, pool_ids)
        return sort_dist_id(pool_d2, pool_ids)
    b, ef = cand_ids.shape
    n, wrow = packed.shape
    d = q.shape[1]
    cap = wrow // (d + 12)
    ech = min(_POOL_PACK_CHUNK, ef)
    nch = -(-ef // ech)
    efp = nch * ech
    idsp = jnp.pad(cand_ids, ((0, 0), (0, efp - ef)), constant_values=PAD_ID)
    chunks = jnp.moveaxis(idsp.reshape(b, nch, ech), 1, 0)  # [nch, B, ech]

    def step(_, ch):
        rows = packed[jnp.clip(ch, 0, n - 1)]  # [B, ech, wrow] u8
        crow = rows[..., : cap * d].reshape(b, ech, cap, d)
        srow = jax.lax.bitcast_convert_type(
            rows[..., cap * d : cap * (d + 8)].reshape(b, ech, cap, 2, 4),
            jnp.float32,
        )
        nbrs = jax.lax.bitcast_convert_type(
            rows[..., cap * (d + 8) :].reshape(b, ech, cap, 4), jnp.int32
        )
        nd2 = l2sq(q[:, None, None, :], dequantize(crow, srow))
        return None, (nbrs, nd2)

    _, (nbrs_t, nd2_t) = jax.lax.scan(step, None, chunks)
    nbrs = jnp.moveaxis(nbrs_t, 0, 1).reshape(b, efp, cap)[:, :ef]
    nd2 = jnp.moveaxis(nd2_t, 0, 1).reshape(b, efp, cap)[:, :ef]
    nvalid = jnp.logical_and(nbrs >= 0, (cand_ids != PAD_ID)[:, :, None])
    nbrs = nbrs.reshape(b, ef * cap)
    nvalid = nvalid.reshape(b, ef * cap)
    nd2 = jnp.where(nvalid, nd2.reshape(b, ef * cap), INF)
    nids = jnp.where(nvalid, nbrs, PAD_ID)
    pool_d2 = jnp.concatenate([cand_d2, nd2], axis=1)
    pool_ids = jnp.concatenate([cand_ids, nids], axis=1)
    if forbid is not None:
        bad = pool_ids == forbid[:, None]
        pool_d2 = jnp.where(bad, INF, pool_d2)
        pool_ids = jnp.where(bad, PAD_ID, pool_ids)
    pool_d2, pool_ids = dedup_ids(pool_d2, pool_ids)
    return sort_dist_id(pool_d2, pool_ids)


def select_heuristic(
    adj: jnp.ndarray,
    codes: jnp.ndarray,
    scales: jnp.ndarray,
    q: jnp.ndarray,
    cand_d2: jnp.ndarray,
    cand_ids: jnp.ndarray,
    m: int,
    extend_cands: bool = True,
    keep_pruned: bool = True,
    forbid: jnp.ndarray | None = None,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Batched Algorithm-4 neighbor selection.

    q: f32[B, d]; cand_d2/cand_ids: [B, ef] beam output. Returns the
    selected neighbors as sorted ``(d2 [B, m], ids [B, m])`` padded with
    (inf, PAD_ID).
    """
    pool_d2, pool_ids = build_candidate_pool(
        adj, codes, scales, q, cand_d2, cand_ids, extend_cands, forbid
    )
    return _accept_from_pool(codes, scales, q, pool_d2, pool_ids, m, keep_pruned)


def select_heuristic_packed(
    packed: jnp.ndarray,
    codes: jnp.ndarray,
    scales: jnp.ndarray,
    q: jnp.ndarray,
    cand_d2: jnp.ndarray,
    cand_ids: jnp.ndarray,
    m: int,
    extend_cands: bool = True,
    keep_pruned: bool = True,
    forbid: jnp.ndarray | None = None,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """:func:`select_heuristic` with the extend pool built from the
    packed-neighbor layout (identical results; ~cap× fewer gather rows in
    the pool build — the construction-path hot spot)."""
    pool_d2, pool_ids = build_candidate_pool_packed(
        packed, q, cand_d2, cand_ids, extend_cands, forbid
    )
    return _accept_from_pool(codes, scales, q, pool_d2, pool_ids, m, keep_pruned)


def _accept_from_pool(
    codes: jnp.ndarray,
    scales: jnp.ndarray,
    q: jnp.ndarray,
    pool_d2: jnp.ndarray,
    pool_ids: jnp.ndarray,
    m: int,
    keep_pruned: bool,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Resolve the Algorithm-4 accept chain over a sorted, deduplicated
    candidate pool (see module docstring for the chunked pairwise-resolve
    design)."""
    b, c = pool_ids.shape
    d = q.shape[1]

    # Chunked PAIRWISE-RESOLVE accept loop. The accept chain is sequential
    # in principle (candidate p's test depends on every acceptance at
    # positions < p), but within a static chunk of G candidates every
    # distance the chain can ever need is one of:
    #   (a) candidate -> already-selected (previous chunks): one [B, G, m]
    #       matmul at chunk entry, reduced to a running (min d2, tie-min
    #       id) per candidate;
    #   (b) candidate -> candidate within the chunk: one [B, G, G]
    #       matmul (the pairwise matrix P).
    # The chain then resolves with a first-passer while_loop that iterates
    # only on acceptances (<= m per query; lockstep cost = Σ_chunks
    # max-acceptances-per-chunk ≈ m + slack) whose body is pure [B, G]
    # elementwise work plus one P-row gather — no per-acceptance matvec.
    # (A G-step scan resolving every position is NOT faster: G tiny steps
    # cost the same wall-clock as ~m heavier ones — measured.)
    # G trades chunk count (lockstep cost = Σ_chunks max-acceptances) against
    # the [B, G, G] pairwise temp (1 GB at B=4096/G=256); 128 was the
    # sweet spot on the previous accelerator and is unmeasured on the GPU;
    # HNSW_ACCEPT_CHUNK overrides for experiments.
    g = min(_ACCEPT_CHUNK, c)
    nchunks = -(-c // g)
    cp = nchunks * g
    pool_d2p = jnp.pad(pool_d2, ((0, 0), (0, cp - c)), constant_values=INF)
    pool_idsp = jnp.pad(pool_ids, ((0, 0), (0, cp - c)), constant_values=PAD_ID)

    sel_vecs0 = jnp.zeros((b, m, d), jnp.float32)
    sel_ids0 = jnp.full((b, m), PAD_ID, jnp.int32)
    sel_valid0 = jnp.zeros((b, m), bool)
    nacc0 = jnp.zeros((b,), jnp.int32)
    stop0 = jnp.full((b,), cp, jnp.int32)  # position of the m-th acceptance

    m_iota = jnp.arange(m, dtype=jnp.int32)[None, None, :]

    # EARLY-EXIT chunk loop: the pool is sorted by (d2, id) and the m
    # acceptances (plus all processed-and-rejected backfill candidates)
    # land in the first few chunks for nearly every query, so iterating
    # all C/G chunks wastes most of the per-chunk gather+matmul work.
    # A while_loop stops as soon as EVERY query has m acceptances;
    # unprocessed chunk positions can never be accepted (pass mask needs
    # nacc < m) nor backfilled (rejected needs pos < stop, and stop is
    # already set), so the early exit is EXACT.
    # valid_chunks: chunks at/after which the pool is all-PAD for EVERY
    # query are exact no-ops (cvalid false everywhere -> empty pass mask)
    # and the sort guarantees PADs are a suffix — skip them. dedup turns
    # the ~ef*cap raw pool's heavy duplicate tail into PADs, so this cuts
    # the chunk sweep to ceil(max-unique-count / G) instead of C/G.
    npad_tail = jnp.sum(
        jnp.cumsum(
            jnp.flip(jnp.all(pool_idsp == PAD_ID, axis=0)), axis=0
        ) == jnp.arange(1, cp + 1)
    )
    valid_chunks = -((-(cp - npad_tail)) // g)

    def chunk_cond(carry):
        ci = carry[0]
        nacc = carry[4]
        return jnp.logical_and(ci < valid_chunks, jnp.any(nacc < m))

    def chunk_body(carry):
        ci, sel_vecs, sel_ids, sel_valid, nacc, stop, accepted = carry
        cbase = ci * g
        cd2 = jax.lax.dynamic_slice(pool_d2p, (0, cbase), (b, g))
        cids = jax.lax.dynamic_slice(pool_idsp, (0, cbase), (b, g))
        cvecs = _gather_vecs(
            codes, scales, jnp.where(cids == PAD_ID, 0, cids)
        )  # [B, G, d]
        cvalid = cids != PAD_ID
        cnormsq = jnp.sum(cvecs * cvecs, axis=-1)  # [B, G]

        # (a) running near = (min_s d(e, s), tie-min id) vs the selected
        # set from previous chunks, as a matmul (the broadcast form would
        # materialize a [B, G, m, d] temp, gigabytes per eval)
        es = jax.lax.dot_general(
            cvecs, sel_vecs, (((2,), (2,)), ((0,), (0,))),
            preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST,
        )  # [B, G, m]
        snormsq = jnp.sum(sel_vecs * sel_vecs, axis=-1)  # [B, m]
        d2s = jnp.maximum(
            cnormsq[:, :, None] + snormsq[:, None, :] - 2.0 * es, 0.0
        )
        d2s = jnp.where(sel_valid[:, None, :], d2s, INF)
        near_d2 = jnp.min(d2s, axis=-1)  # [B, G]
        near_id = jnp.min(
            jnp.where(d2s == near_d2[..., None], sel_ids[:, None, :], PAD_ID),
            axis=-1,
        )

        # (b) intra-chunk pairwise distances, one matmul
        cc = jax.lax.dot_general(
            cvecs, cvecs, (((2,), (2,)), ((0,), (0,))),
            preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST,
        )  # [B, G, G]
        P = jnp.maximum(cnormsq[:, :, None] + cnormsq[:, None, :] - 2.0 * cc, 0.0)

        # resolve the chain iterating only on ACCEPTANCES (<= m per query;
        # lockstep cost = Σ_chunks max-acceptances-per-chunk, ~m + slack):
        # each iteration accepts the first passer in pool order and folds
        # that candidate's precomputed P row into the running min — a [B, G]
        # row gather, no per-iteration matvec. A once-failed candidate
        # fails forever (the selected set only grows), so re-testing the
        # mask each iteration is exact.
        def pass_mask(near_d2, near_id, nacc_r, taken):
            ok = (cd2 < near_d2) | ((cd2 == near_d2) & (cids < near_id))
            return cvalid & ~taken & ok & (nacc_r < m)[:, None]

        def rcond(s):
            return jnp.any(s[6])

        def rbody(s):
            rm_d2, rm_id, nacc_r, stop_r, taken, _, pm = s
            has = jnp.any(pm, axis=1)
            f = jnp.argmax(pm, axis=1)  # first passer (pool order)
            e_id = jnp.take_along_axis(cids, f[:, None], axis=1)[:, 0]
            taken = jnp.logical_or(taken, pm & (g_iota == f[:, None]))
            nacc_r = nacc_r + has.astype(jnp.int32)
            stop_r = jnp.where(has & (nacc_r == m), cbase + f, stop_r)
            prow = jnp.take_along_axis(P, f[:, None, None], axis=1)[:, 0]
            prow = jnp.where(has[:, None], prow, INF)
            closer = prow < rm_d2
            tie = prow == rm_d2
            rm_id = jnp.where(
                closer, e_id[:, None],
                jnp.where(tie, jnp.minimum(rm_id, e_id[:, None]), rm_id),
            )
            rm_d2 = jnp.where(closer, prow, rm_d2)
            pm = pass_mask(rm_d2, rm_id, nacc_r, taken)
            return (rm_d2, rm_id, nacc_r, stop_r, taken, has, pm)

        g_iota = jnp.arange(g, dtype=jnp.int32)[None, :]
        taken0 = jnp.zeros((b, g), bool)
        pm0 = pass_mask(near_d2, near_id, nacc, taken0)
        (_, _, nacc, stop, taken, _, _) = jax.lax.while_loop(
            rcond, rbody,
            (near_d2, near_id, nacc, stop, taken0,
             jnp.zeros((b,), bool), pm0),
        )

        # pack this chunk's acceptances into the selected arrays: slot =
        # entry count + rank among accepted; the [B, G, m] one-hot is a
        # matmul that scatters vectors without a [B, G, m, d] temp
        nacc_in = nacc - jnp.sum(taken, axis=1)
        slot = nacc_in[:, None] + jnp.cumsum(taken.astype(jnp.int32), axis=1) - 1
        onehot = jnp.logical_and(taken[:, :, None], slot[:, :, None] == m_iota)
        upd = jnp.any(onehot, axis=1)  # [B, m]
        ids_new = jnp.sum(jnp.where(onehot, cids[:, :, None], 0), axis=1)
        vecs_new = jax.lax.dot_general(
            onehot.astype(jnp.float32), cvecs, (((1,), (1,)), ((0,), (0,))),
            preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST,
        )  # [B, m, d]
        sel_ids = jnp.where(upd, ids_new, sel_ids)
        sel_vecs = jnp.where(upd[:, :, None], vecs_new, sel_vecs)
        sel_valid = jnp.logical_or(sel_valid, upd)
        accepted = jax.lax.dynamic_update_slice(accepted, taken, (0, cbase))
        return (ci + 1, sel_vecs, sel_ids, sel_valid, nacc, stop, accepted)

    accepted0 = jnp.zeros((b, cp), bool)
    (_, _, _, _, nacc, stop, accepted) = jax.lax.while_loop(
        chunk_cond, chunk_body,
        (jnp.int32(0), sel_vecs0, sel_ids0, sel_valid0, nacc0, stop0,
         accepted0),
    )
    accepted = accepted[:, :c]

    # keep_pruned backfill: processed-and-rejected candidates (positions
    # before the m-th acceptance, not accepted) in pool order fill the
    # remaining slots. Early stop (nacc == m) implies no backfill, so the
    # unprocessed tail is correctly excluded.
    if keep_pruned:
        pos = jnp.arange(c, dtype=jnp.int32)[None, :]
        rejected = (
            (pool_ids != PAD_ID) & ~accepted & (pos < stop[:, None])
        )
        rej_rank = jnp.cumsum(rejected.astype(jnp.int32), axis=1) - 1
        fill = jnp.maximum(m - nacc, 0)[:, None]
        in_final = jnp.logical_or(
            accepted, jnp.logical_and(rejected, rej_rank < fill)
        )
    else:
        in_final = accepted
    out_d2 = jnp.where(in_final, pool_d2, INF)
    out_ids = jnp.where(in_final, pool_ids, PAD_ID)
    out_d2, out_ids = sort_dist_id(out_d2, out_ids)
    return out_d2[:, :m], out_ids[:, :m]
