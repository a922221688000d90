"""Batched lockstep graph traversal — the query/build hot path.

Batched redesign of the reference's ``Searcher``
(``hnsw/src/template/searcher.rs``). The reference walks one query at a time
through pointer-chased node sets using ``BTreeSet`` priority queues; here a
whole batch of queries traverses in lockstep inside a ``lax.while_loop``:

- The ``selected``/``candidates`` queue pair
  (``hnsw/src/template/results.rs:26-33``) collapses into a single sorted
  **flagged beam** per query: fixed ``ef``-wide arrays ``(d2, id, expanded)``
  ordered by (dist asc, id asc) — the ``Dist`` total order of
  ``graph/src/dist.rs:30-38``. The best *unexpanded* entry is the reference's
  ``candidates.pop_first()``; "no unexpanded entry in the beam" is the
  reference's termination test "best candidate worse than worst selected"
  (``searcher.rs:35-44``): any candidate outside the current top-``ef`` can
  never be selected, so expanding it only wastes work.
- The per-query ``visited`` ``IntSet`` becomes a dense bool[B, N] matrix
  updated with batched scatters.
- Neighbor expansion is a batched adjacency-row gather + fused
  dequantize-L2 (``quant.rs:14-37``) over [B, cap, d].
- Every loop has a static trip bound (XLA requirement); queries that
  converge early are masked out, and the loop exits when the whole batch
  has converged.

``search_layer`` keeps the reference's cross-layer contract: the returned
beam seeds the next (lower) layer's search (``searcher.rs:100-101``).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .ops.distance import l2sq
from .ops.pq import adc_score, adc_score16, pq_lut
from .ops.quant import dequantize
from .ops.topk import (
    INF,
    PAD_ID,
    SENTINEL,
    dedup_ids,
    merge_sorted_dist_id,
    sort_dist_id,
)


def _gather_vecs(codes: jnp.ndarray, scales: jnp.ndarray, ids: jnp.ndarray) -> jnp.ndarray:
    """Dequantized vectors for (possibly invalid) ids; invalid rows are
    garbage and must be masked by the caller via distances.

    ``codes`` may be the uint8 code table (dequantized on the fly with
    ``scales``) or an already-dequantized float32 table (the serving-path
    cache: skips the per-gather u8->f32 conversion, ~25% of the beam
    loop's cost, at 4x the memory — worth it whenever the table fits)."""
    safe = jnp.clip(ids, 0, codes.shape[0] - 1)
    if codes.dtype == jnp.uint8:
        return dequantize(codes[safe], scales[safe])
    return codes[safe]


def _pack_exp_id(ids: jnp.ndarray, exp: jnp.ndarray) -> jnp.ndarray:
    """Pack the beam's ``expanded`` flag into the id's LSB: ``2*id + exp``
    for real ids, PAD_ID unchanged. Order-preserving under the (d2, id)
    lexicographic compare — every real id in a merge is unique (the beam
    dedups, and ``known`` masking keeps new candidates disjoint from it),
    so comparing ``2*id + e`` orders exactly like comparing ``id`` — which
    lets the per-iteration bitonic merge carry TWO operand arrays instead
    of three (each operand is ~a third of the merge's elementwise work).
    Requires ``2*id + 1 < PAD_ID``, i.e. N < 2^30."""
    return jnp.where(ids == PAD_ID, PAD_ID, 2 * ids + exp.astype(jnp.int32))


def _unpack_exp_id(packed: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Inverse of :func:`_pack_exp_id`; PAD entries decode as expanded."""
    pad = packed == PAD_ID
    ids = jnp.where(pad, PAD_ID, packed >> 1)
    exp = jnp.logical_or(pad, (packed & 1) == 1)
    return ids, exp


def _row_min_dist_id(d2: jnp.ndarray, ids: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """(min d2, min id among argmins) along the last axis — the Dist-order
    minimum with id tie-break."""
    min_d2 = jnp.min(d2, axis=-1)
    min_id = jnp.min(
        jnp.where(d2 == min_d2[..., None], ids, PAD_ID), axis=-1
    )
    return min_d2, min_id


def greedy_descent(
    adj: jnp.ndarray,
    codes: jnp.ndarray,
    scales: jnp.ndarray,
    q: jnp.ndarray,
    cur_d2: jnp.ndarray,
    cur_ids: jnp.ndarray,
    forbid: jnp.ndarray | None = None,
    max_iters: int = 128,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Batched ef=1 layer traversal: strict-improvement hill climb.

    Semantics of ``search_layer`` with ``ef = 1`` (``searcher.rs:23-103``):
    move to the neighbor nearest to ``q`` iff it is strictly better than the
    current node under the (dist, id) order; stop otherwise. Used for the
    upper-layer descent of both query (``template.rs:322-324``) and insert
    (``inserter.rs:70-89``) paths.

    q: f32[B, d]; cur_d2/cur_ids: [B] current position; forbid: optional [B]
    id to never move to (a node must not route through itself during build).
    """
    n = codes.shape[0]

    def body(state):
        cur_d2, cur_ids, moved, it = state
        safe = jnp.clip(cur_ids, 0, n - 1)
        nbrs = adj[safe]  # [B, cap]
        valid = nbrs >= 0
        if forbid is not None:
            valid = jnp.logical_and(valid, nbrs != forbid[:, None])
        vecs = _gather_vecs(codes, scales, nbrs)  # [B, cap, d]
        d2 = l2sq(q[:, None, :], vecs)
        d2 = jnp.where(valid, d2, INF)
        nids = jnp.where(valid, nbrs, PAD_ID)
        best_d2, best_id = _row_min_dist_id(d2, nids)
        better = jnp.logical_or(
            best_d2 < cur_d2,
            jnp.logical_and(best_d2 == cur_d2, best_id < cur_ids),
        )
        return (
            jnp.where(better, best_d2, cur_d2),
            jnp.where(better, best_id, cur_ids),
            better,
            it + 1,
        )

    # strict lexicographic improvement cannot cycle, but keep a static
    # safety bound anyway: any future distance nondeterminism (e.g. a bf16
    # fast path) must degrade to a long walk, not a hang
    def cond(state):
        return jnp.logical_and(jnp.any(state[2]), state[3] < max_iters)

    # init `moved` as all-True *derived from the carry* (not a fresh
    # constant) so its varying-axes type matches the body output when the
    # loop runs inside shard_map
    cur_d2, cur_ids, _, _ = jax.lax.while_loop(
        cond, body, (cur_d2, cur_ids, cur_ids == cur_ids, jnp.zeros((), jnp.int32))
    )
    return cur_d2, cur_ids


def init_beam(
    entry_d2: jnp.ndarray, entry_ids: jnp.ndarray, ef: int
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Build an ef-wide sorted flagged beam from entry points [B, k].

    Mirrors ``extend_candidates_with_selected`` seeding
    (``searcher.rs:33-34``): entries start unexpanded. Invalid entries must
    already carry (inf, PAD_ID); they get expanded=True so they never fire.
    """
    b, k = entry_ids.shape
    if k < ef:
        pad_d2 = jnp.full((b, ef - k), INF, entry_d2.dtype)
        pad_ids = jnp.full((b, ef - k), PAD_ID, entry_ids.dtype)
        entry_d2 = jnp.concatenate([entry_d2, pad_d2], axis=1)
        entry_ids = jnp.concatenate([entry_ids, pad_ids], axis=1)
    d2, ids = sort_dist_id(entry_d2, entry_ids)
    d2, ids = d2[:, :ef], ids[:, :ef]
    expanded = ids == PAD_ID
    return d2, ids, expanded


def _beam_loop(
    fetch,
    n: int,
    cap: int,
    q: jnp.ndarray,
    entry_d2: jnp.ndarray,
    entry_ids: jnp.ndarray,
    ef: int,
    max_iters: int,
    forbid: jnp.ndarray | None = None,
    ring_size: int = 0,
    expand_e: int = 1,
    scored: bool = False,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Shared flagged-beam loop; ``fetch(cand_ids [B]) -> (nbrs [B, cap],
    vecs f32[B, cap, d])`` supplies each expanded node's neighbor ids and
    their dequantized vectors (plain gather or packed-row layouts).

    ``scored=True`` switches the fetch contract to ``fetch(cand_ids [B])
    -> (nbrs [B, cap], d2 f32[B, cap])`` — the candidates arrive already
    scored (the PQ/ADC layouts, where no candidate vector exists to
    recompute against) and the loop's own ``l2sq`` is skipped.

    ``expand_e`` > 1 expands the E best unexpanded entries per iteration
    (``fetch`` then sees [B*E] and returns [B*E, cap] shapes). E=1 is the
    reference's exact pop-one semantics (``searcher.rs:35-44``); E>1 is a
    lockstep-friendly serving mode: per-iteration fixed costs (sort,
    dispatch) amortize over E pops, the discovered set is a superset of
    some E=1 prefix (extra speculative pops can only add candidates), and
    termination is unchanged — recall per ef is the same or better, at
    ~E× fewer iterations. Build searches keep E=1 (oracle-pinned)."""
    b, _ = q.shape
    if ring_size <= 0:
        ring_size = max(2 * cap, 64, expand_e * cap)
    beam_d2, beam_ids, beam_exp = init_beam(entry_d2, entry_ids, ef)

    # ring of recently-discovered ids, seeded with the entries
    k0 = entry_ids.shape[1]
    ring = jnp.full((b, max(ring_size, k0)), PAD_ID, jnp.int32)
    ring = jnp.concatenate([entry_ids, ring[:, : ring_size - k0]], axis=1) \
        if ring_size > k0 else entry_ids[:, :ring_size]

    slot_iota = jnp.arange(ef, dtype=jnp.int32)[None, :]

    def cond(state):
        it, _, _, beam_exp, _ = state
        return jnp.logical_and(it < max_iters, jnp.any(~beam_exp))

    def body_1(state):
        it, beam_d2, beam_ids, beam_exp, ring = state
        unexp = jnp.logical_not(beam_exp)
        active = jnp.any(unexp, axis=1)  # [B]
        # first unexpanded slot = best candidate (beam is sorted)
        pos = jnp.argmax(unexp, axis=1)  # [B]
        cand = jnp.take_along_axis(beam_ids, pos[:, None], axis=1)[:, 0]
        # mark it expanded
        hit = jnp.logical_and(active[:, None], slot_iota == pos[:, None])
        beam_exp = jnp.logical_or(beam_exp, hit)

        nbrs, pay = fetch(jnp.clip(cand, 0, n - 1))  # [B, cap], [B, cap(, d)]
        valid = jnp.logical_and(nbrs >= 0, active[:, None])
        if forbid is not None:
            valid = jnp.logical_and(valid, nbrs != forbid[:, None])
        nbrs_safe = jnp.where(valid, nbrs, 0)
        known = jnp.logical_or(
            jnp.any(nbrs_safe[:, :, None] == beam_ids[:, None, :], axis=-1),
            jnp.any(nbrs_safe[:, :, None] == ring[:, None, :], axis=-1),
        )
        new = jnp.logical_and(valid, jnp.logical_not(known))
        ring = jnp.concatenate(
            [jnp.where(new, nbrs, PAD_ID), ring[:, : ring_size - cap]], axis=1
        )

        nd2 = pay if scored else l2sq(q[:, None, :], pay)
        nd2 = jnp.where(new, nd2, INF)
        nids = jnp.where(new, nbrs, PAD_ID)

        # sort the cap new candidates (narrow), then bitonic-MERGE into
        # the already-sorted beam: log passes instead of the full
        # (ef+cap)-wide sort's log² — the dominant per-iteration cost.
        # The expanded flag rides the id's LSB (see _pack_exp_id): the
        # cap-sort carries 2 operands instead of 3 (a new entry is
        # unexpanded iff it is real, so the flag needs no sort payload)
        # and the merge network moves 2 arrays instead of 3.
        nd2, nids = sort_dist_id(nd2, nids)
        md2, mpk = merge_sorted_dist_id(
            beam_d2,
            _pack_exp_id(beam_ids, beam_exp),
            nd2,
            _pack_exp_id(nids, nids == PAD_ID),
        )
        mids, mexp = _unpack_exp_id(mpk[:, :ef])
        return (it + 1, md2[:, :ef], mids, mexp, ring)

    e = expand_e

    def body_e(state):
        it, beam_d2, beam_ids, beam_exp, ring = state
        unexp = jnp.logical_not(beam_exp)
        # positions of the E best unexpanded slots (beam is sorted): sort
        # masked slot indices ascending and take the first E
        pos_e = jax.lax.sort(
            jnp.where(unexp, jnp.broadcast_to(slot_iota, unexp.shape), ef),
            dimension=-1,
        )[:, :e]  # [B, E]; ef = "no such slot"
        act_e = pos_e < ef
        cand = jnp.take_along_axis(
            beam_ids, jnp.where(act_e, pos_e, 0), axis=1
        )  # [B, E]
        beam_exp = jnp.logical_or(
            beam_exp, jnp.any(slot_iota[:, None, :] == pos_e[:, :, None], axis=1)
        )

        nbrs, pay = fetch(jnp.clip(cand, 0, n - 1).reshape(-1))
        nbrs = nbrs.reshape(b, e * cap)
        pay = pay.reshape(b, e * cap) if scored else pay.reshape(b, e * cap, -1)
        valid = jnp.logical_and(
            nbrs >= 0,
            jnp.broadcast_to(act_e[:, :, None], (b, e, cap)).reshape(b, e * cap),
        )
        if forbid is not None:
            valid = jnp.logical_and(valid, nbrs != forbid[:, None])
        nbrs_safe = jnp.where(valid, nbrs, 0)
        known = jnp.logical_or(
            jnp.any(nbrs_safe[:, :, None] == beam_ids[:, None, :], axis=-1),
            jnp.any(nbrs_safe[:, :, None] == ring[:, None, :], axis=-1),
        )
        new = jnp.logical_and(valid, jnp.logical_not(known))
        ring = jnp.concatenate(
            [jnp.where(new, nbrs, PAD_ID), ring[:, : ring_size - e * cap]],
            axis=1,
        )

        nd2 = pay if scored else l2sq(q[:, None, :], pay)
        nd2 = jnp.where(new, nd2, INF)
        nids = jnp.where(new, nbrs, PAD_ID)
        # the E expanded rows may share neighbors — dedup before the merge
        # so the beam never holds one id twice
        nd2, nids = dedup_ids(nd2, nids)

        # sort candidates, then bitonic-merge into the sorted beam (see
        # body_1; expanded flag packed into the id LSB)
        nd2, nids = sort_dist_id(nd2, nids)
        md2, mpk = merge_sorted_dist_id(
            beam_d2,
            _pack_exp_id(beam_ids, beam_exp),
            nd2,
            _pack_exp_id(nids, nids == PAD_ID),
        )
        mids, mexp = _unpack_exp_id(mpk[:, :ef])
        return (it + 1, md2[:, :ef], mids, mexp, ring)

    body = body_1 if e <= 1 else body_e

    _, beam_d2, beam_ids, _, _ = jax.lax.while_loop(
        cond, body, (jnp.int32(0), beam_d2, beam_ids, beam_exp, ring)
    )
    return beam_d2, beam_ids


def search_layer(
    adj: jnp.ndarray,
    codes: jnp.ndarray,
    scales: jnp.ndarray,
    q: jnp.ndarray,
    entry_d2: jnp.ndarray,
    entry_ids: jnp.ndarray,
    ef: int,
    max_iters: int,
    forbid: jnp.ndarray | None = None,
    ring_size: int = 0,
    expand_e: int = 1,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Batched beam search over one layer (HNSW Algorithm 2;
    ``searcher.rs:23-103``).

    Returns the sorted beam ``(d2 [B, ef], ids [B, ef])`` — the reference's
    ``selected`` set, which the caller hands to the next layer.

    One loop iteration = one ``candidates.pop_first()`` expansion for every
    query in the batch: gather the best unexpanded beam entry's adjacency
    row, drop already-known neighbors, fused dequantize-L2 to the queries,
    and merge into the beam with one two-key sort.

    **Visited-set design.** The reference's per-query ``IntSet`` would be a
    bool[B, N] matrix here, but its per-iteration scatter/gather would
    dominate the loop. Instead, "already known" =
    *currently in the beam* (broadcast compare, exact) OR *in a small ring
    buffer of the last ``ring_size`` discovered ids* (approximate). This is
    exact, not approximate, in effect: the merged top-ef beam only ever
    improves, so a node once evicted can never re-enter it — a
    re-discovered node costs one wasted distance row at worst and is
    dropped again by the merge. The ring only bounds that waste.
    """
    n = codes.shape[0]
    cap = adj.shape[1]

    def fetch(cand_safe):
        nbrs = adj[cand_safe]  # [B, cap]
        vecs = _gather_vecs(codes, scales, jnp.where(nbrs >= 0, nbrs, 0))
        return nbrs, vecs

    return _beam_loop(
        fetch, n, cap, q, entry_d2, entry_ids, ef, max_iters, forbid,
        ring_size, expand_e,
    )


def pack_layer(
    adj: jnp.ndarray, codes: jnp.ndarray, scales: jnp.ndarray
) -> jnp.ndarray:
    """Build the packed-neighbor serving layout for one layer: ONE fused
    u8 row per node holding its neighbors' codes, scales and ids.

    On a machine whose row gather is bound by the rate at which rows are
    issued rather than by bytes, the beam loop's per-expansion cost is
    ~(number of gathers) × B × t_row. Packing every
    node's neighbors' codes, scales AND ids into a single byte row turns
    ~3*cap gathers per expansion into ONE; the scale/id fields are
    bitcast back out of the gathered bytes in-register. Distances stay
    bit-identical: the same u8 codes and f32 scales feed the same
    dequantize.

    Row layout (width cap*(d+12) bytes): ``codes u8[cap*d] | scales
    f32-bytes[cap*8] | ids i32-bytes[cap*4]`` — built with the inverse
    bitcast, so decode round-trips exactly. A serving-time memory trade
    selected via :meth:`models.hnsw.HNSW.finalize`.

    Assembled in row CHUNKS (scan + dynamic_update_slice): a one-shot
    gather materializes ~2x the table transiently, which at million
    scale (multi-GB tables) is the difference between fitting device
    memory and ResourceExhausted. The output buffer is allocated at EXACTLY [n, wrow]
    and the last chunk is written at the OVERLAPPING offset n-ch (its
    leading rows recompute identical bytes — the row is a pure function
    of the adjacency row) instead of padding to a multiple of ch and
    slicing ``out[:n]`` at the end: that final slice is a second
    full-table copy, the 2x cliff this chunking exists to avoid.
    """
    n, cap = adj.shape
    d = codes.shape[1]
    wrow = cap * (d + 12)
    if n == 0:
        return jnp.zeros((0, wrow), jnp.uint8)
    ch = max(1, min(n, (64 << 20) // max(wrow, 1)))  # ~64 MB chunks
    nch = -(-n // ch)
    # chunk start offsets; the tail chunk starts at n-ch (overlap, exact)
    offs = jnp.minimum(jnp.arange(nch) * ch, n - ch)

    def step(out, off):
        a = jax.lax.dynamic_slice_in_dim(adj, off, ch, 0)
        safe = jnp.where(a >= 0, a, 0)
        pk_codes = codes[safe].reshape(ch, cap * d)
        sc_bytes = jax.lax.bitcast_convert_type(
            scales[safe], jnp.uint8
        ).reshape(ch, cap * 8)
        id_bytes = jax.lax.bitcast_convert_type(a, jnp.uint8).reshape(
            ch, cap * 4
        )
        row = jnp.concatenate([pk_codes, sc_bytes, id_bytes], axis=1)
        return jax.lax.dynamic_update_slice_in_dim(out, row, off, 0), None

    out0 = jnp.zeros((n, wrow), jnp.uint8)
    out, _ = jax.lax.scan(step, out0, offs)
    return out


def comb_table(codes: jnp.ndarray, scales: jnp.ndarray) -> jnp.ndarray:
    """Combined per-point byte table ``u8[N, d+8]`` = ``codes ‖
    f32-bytes(scales)`` — one gather instead of two when (code, scale)
    pairs are fetched together (the build-time incremental repack)."""
    n = codes.shape[0]
    sc_bytes = jax.lax.bitcast_convert_type(scales, jnp.uint8).reshape(n, 8)
    return jnp.concatenate([codes, sc_bytes], axis=1)


def empty_packed(n: int, cap: int, d: int) -> jnp.ndarray:
    """Packed table for an all-empty graph: id region = SENTINEL bytes
    (0xFF), code/scale regions zero (masked by ids at decode — scale 0.0
    dequantizes to 0.0, never NaN)."""
    return jnp.concatenate(
        [
            jnp.zeros((n, cap * (d + 8)), jnp.uint8),
            jnp.full((n, cap * 4), 255, jnp.uint8),  # -1 little-endian
        ],
        axis=1,
    )


def unpack_rows(
    row: jnp.ndarray, cap: int, d: int
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Decode packed rows (``pack_layer`` layout, any leading shape) into
    (neighbor ids [..., cap], dequantized vectors f32[..., cap, d]) —
    pure in-register bitcasts, no gathers."""
    lead = row.shape[:-1]
    crow = row[..., : cap * d].reshape(*lead, cap, d)
    srow = jax.lax.bitcast_convert_type(
        row[..., cap * d : cap * (d + 8)].reshape(*lead, cap, 2, 4),
        jnp.float32,
    )  # [..., cap, 2]
    nbrs = jax.lax.bitcast_convert_type(
        row[..., cap * (d + 8) :].reshape(*lead, cap, 4), jnp.int32
    )  # [..., cap]
    return nbrs, dequantize(crow, srow)


def search_layer_packed(
    packed: jnp.ndarray,
    q: jnp.ndarray,
    entry_d2: jnp.ndarray,
    entry_ids: jnp.ndarray,
    ef: int,
    max_iters: int,
    ring_size: int = 0,
    expand_e: int = 1,
    forbid: jnp.ndarray | None = None,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """:func:`search_layer` over the packed-neighbor layout — identical
    semantics and distances (at ``expand_e=1``), ONE gather row per
    expansion instead of ~3*cap; ``expand_e>1`` pops E entries per
    iteration (see :func:`_beam_loop`). ``forbid`` masks one id per query
    (the construction-path self-exclusion)."""
    n, w = packed.shape
    d = q.shape[1]
    cap = w // (d + 12)

    def fetch(cand_safe):
        row = packed[cand_safe]  # [R, cap*(d+12)] u8 — the ONLY gather
        return unpack_rows(row, cap, d)

    return _beam_loop(
        fetch, n, cap, q, entry_d2, entry_ids, ef, max_iters, forbid,
        ring_size, expand_e,
    )


def pack_layer_pq(adj: jnp.ndarray, pq_codes: jnp.ndarray) -> jnp.ndarray:
    """PQ variant of :func:`pack_layer`: one fused u8 row per node holding
    its neighbors' PQ codes and ids — ``cap*(m_pq+4)`` bytes/point instead
    of ``cap*(d+12)``, the layout that lets packed-row serving reach
    collections whose exact-code pack would not fit HBM (e.g. at
    M=24/d=96/m_pq=24: 1,728 B/point vs 5,184). Same chunked assembly and
    exact-size output as :func:`pack_layer`; row layout ``pqcodes
    u8[cap*m_pq] | ids i32-bytes[cap*4]``. Distances are ADC lookups
    against the per-query LUT (:func:`~hnsw_rs_tpu.ops.pq.pq_lut`), so
    this layout carries no scales at all."""
    n, cap = adj.shape
    m_pq = pq_codes.shape[1]
    wrow = cap * (m_pq + 4)
    if n == 0:
        return jnp.zeros((0, wrow), jnp.uint8)
    ch = max(1, min(n, (64 << 20) // max(wrow, 1)))  # ~64 MB chunks
    nch = -(-n // ch)
    offs = jnp.minimum(jnp.arange(nch) * ch, n - ch)

    def step(out, off):
        a = jax.lax.dynamic_slice_in_dim(adj, off, ch, 0)
        safe = jnp.where(a >= 0, a, 0)
        pk = pq_codes[safe].reshape(ch, cap * m_pq)
        id_bytes = jax.lax.bitcast_convert_type(a, jnp.uint8).reshape(
            ch, cap * 4
        )
        row = jnp.concatenate([pk, id_bytes], axis=1)
        return jax.lax.dynamic_update_slice_in_dim(out, row, off, 0), None

    out0 = jnp.zeros((n, wrow), jnp.uint8)
    out, _ = jax.lax.scan(step, out0, offs)
    return out


def unpack_rows_pq(
    row: jnp.ndarray, cap: int, m_pq: int
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Decode :func:`pack_layer_pq` rows (any leading shape) into
    (neighbor ids [..., cap], PQ codes u8[..., cap, m_pq]) — pure
    in-register bitcasts, no gathers."""
    lead = row.shape[:-1]
    codes = row[..., : cap * m_pq].reshape(*lead, cap, m_pq)
    nbrs = jax.lax.bitcast_convert_type(
        row[..., cap * m_pq :].reshape(*lead, cap, 4), jnp.int32
    )  # [..., cap]
    return nbrs, codes


def search_layer_pq(
    packed: jnp.ndarray,
    lut: jnp.ndarray,
    m_pq: int,
    entry_d2: jnp.ndarray,
    entry_ids: jnp.ndarray,
    ef: int,
    max_iters: int,
    ring_size: int = 0,
    expand_e: int = 1,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """:func:`search_layer` over the PQ-packed layout: traversal order and
    termination are the exact beam semantics, but candidate distances are
    ADC approximations read from ``lut`` (f32[B, m_pq, 256], one per
    query) — no candidate vector is ever fetched. Recall is therefore
    gated by tests/benchmarks rather than oracle-pinned; the final top-k
    is exact-rescored by the caller (:func:`ann_search_pq`)."""
    n, w = packed.shape
    cap = w // (m_pq + 4)
    b = lut.shape[0]
    # nv is static inside jit: 16-entry LUTs mean nibble-packed 4-bit
    # codes scored gather-free (ops.pq.adc_score16); 256 is the classic
    # 8-bit take_along_axis path
    score = adc_score16 if lut.shape[2] == 16 else adc_score

    def fetch(cand_safe):  # [R] with R = b*e
        row = packed[cand_safe]  # the ONLY gather
        nbrs, codes = unpack_rows_pq(row, cap, m_pq)  # [R, cap(, m_pq)]
        d2 = score(lut, codes.reshape(b, -1, m_pq))  # [b, R/b*cap]
        return nbrs, d2.reshape(*nbrs.shape)

    # q placeholder: a scored loop never computes l2sq, it only reads the
    # batch size off the array's leading axis
    return _beam_loop(
        fetch, n, cap, lut[:, :, 0], entry_d2, entry_ids, ef, max_iters,
        None, ring_size, expand_e, scored=True,
    )


def pq_beam(
    packed0: jnp.ndarray,
    codebooks: jnp.ndarray,
    pq_codes: jnp.ndarray,
    pivot_ids: jnp.ndarray,
    pivot_vecs: jnp.ndarray,
    q: jnp.ndarray,
    ef: int,
    max_iters: int,
    expand_e: int = 1,
    rot: "jnp.ndarray | None" = None,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Pivot-seeded ADC beam over a PQ-packed layer 0 — the shared head
    of :func:`ann_search_pq`, also used standalone by the paged hybrid
    tier (``models/paged.py``), whose exact rerank pages vectors from
    disk instead of an HBM code table. Returns the full (beam_d2,
    beam_ids) — ADC-scored, callers rerank."""
    qr = q if rot is None else jnp.dot(
        q, rot, preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,  # feeds the ADC table
    )
    lut = pq_lut(qr, codebooks)  # [B, m_sub, nv]
    # seed SELECTION uses the exact pivot table (small, dense); seed
    # SCORES entering the beam are ADC so eviction decisions compare
    # like against like
    _, e_ids = _pivot_seeds(pivot_ids, pivot_vecs, q, ef)
    safe = jnp.clip(jnp.where(e_ids == PAD_ID, 0, e_ids), 0,
                    pq_codes.shape[0] - 1)
    score = adc_score16 if codebooks.shape[1] == 16 else adc_score
    e_d2 = score(lut, pq_codes[safe])
    e_d2 = jnp.where(e_ids == PAD_ID, INF, e_d2)
    # bytes per point in the packed rows: nibble-packed for 4-bit
    # codebooks (ops.pq.pack_nibbles), one byte per subspace for 8-bit
    pq_b = pq_codes.shape[1]
    return search_layer_pq(
        packed0, lut, pq_b, e_d2, e_ids, ef, max_iters, expand_e=expand_e
    )


def ann_search_pq(
    packed0: jnp.ndarray,
    codebooks: jnp.ndarray,
    pq_codes: jnp.ndarray,
    pivot_ids: jnp.ndarray,
    pivot_vecs: jnp.ndarray,
    codes: jnp.ndarray,
    scales: jnp.ndarray,
    q: jnp.ndarray,
    ef: int,
    k: int,
    max_iters: int,
    rerank: int,
    expand_e: int = 1,
    rot: "jnp.ndarray | None" = None,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Pivot-seeded serving over the PQ-packed layout — the >HBM-scale
    memory axis of graph serving (the packed exact-code layout costs
    ``cap*(d+12)`` B/point; this one ``cap*(m_pq+4)`` + ``m_pq`` for the
    seed-score table + the exact codes kept for reranking).

    ``rot`` (optional f32[d, d]): OPQ rotation the codes were trained
    under (``ops.pq.opq_train``) — the ADC LUT is then built from
    ``q @ rot`` (``||qR - xR|| = ||q - x||``); seed selection and the
    exact rerank stay in the original space.

    Pipeline: pivot seed selection (exact matmul, as
    :func:`ann_search_seeded`), seeds RE-scored with ADC so the beam
    compares one consistent distance space, ADC beam over the PQ rows,
    then an exact re-score of the top ``max(k, rerank)`` survivors
    against the u8 code table (one narrow gather per survivor — the only
    exact-code access on the whole path). No reference analogue
    (``vectors/src/quant.rs`` stops at 1 byte/dim); recall is gated by
    tests/test_pq_serving.py and benchmarks."""
    beam_d2, beam_ids = pq_beam(
        packed0, codebooks, pq_codes, pivot_ids, pivot_vecs, q, ef,
        max_iters, expand_e, rot,
    )
    r = min(max(k, rerank), beam_ids.shape[1])
    cand = beam_ids[:, :r]
    csafe = jnp.clip(jnp.where(cand == PAD_ID, 0, cand), 0,
                     codes.shape[0] - 1)
    vecs = dequantize(codes[csafe], scales[csafe])  # [B, r, d]
    d2 = l2sq(q[:, None, :], vecs)
    d2 = jnp.where(cand == PAD_ID, INF, d2)
    sd, si = sort_dist_id(d2, cand)
    return jnp.sqrt(sd[:, :k]), si[:, :k]


def ann_search_seeded(
    packed0: jnp.ndarray,
    pivot_ids: jnp.ndarray,
    pivot_vecs: jnp.ndarray,
    q: jnp.ndarray,
    ef: int,
    k: int,
    max_iters: int,
    expand_e: int = 1,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Pivot-seeded serving: ONE matmul against a few thousand pivot
    points (the upper-layer skeleton) replaces the serial greedy descent,
    and its top-ef seeds the layer-0 beam directly.

    Rationale: the hierarchy's upper layers are a pointer-chase (tens of
    sequential gather rounds); an all-pivots distance matrix is one dense
    [B, P] matmul, and starting the beam with ef GOOD candidates instead of
    one skips the coarse navigation phase entirely. Same layer-0 beam
    semantics afterwards (``search_layer_packed``); the reference's
    hierarchy role (``template.rs:306-335``, layers > 0) is what this
    replaces at serving time. Seed selection uses ``lax.top_k`` (position
    tie-break) — entry choice is heuristic, results still come from the
    exact (d2, id)-ordered beam.

    Numeric-form note: seed distances use the expanded matmul form
    ``|q|² - 2q·p + |p|²`` (clamped at 0), while the beam recomputes
    neighbor distances with the direct ``l2sq`` diff-square form. A seed
    that survives into the final top-k therefore carries the matmul-form
    distance, which can differ in ULPs from the packed path's for the
    same id — downstream exact-distance comparisons must not assume
    bit-parity with :func:`ann_search_packed`.
    """
    # approx_max_k inside _pivot_seeds: seed selection tolerates
    # approximation — the beam refines whatever it is handed. On the GPU
    # approx_max_k falls back to an exact sort (ROADMAP queue 1 item 2)
    e_d2, e_ids = _pivot_seeds(pivot_ids, pivot_vecs, q, ef)
    beam_d2, beam_ids = search_layer_packed(
        packed0, q, e_d2, e_ids, ef, max_iters, expand_e=expand_e
    )
    return jnp.sqrt(beam_d2[:, :k]), beam_ids[:, :k]


def _top_ef_dedup_oversampled(md2, mids, ef: int):
    """Deduplicated top-ef of a wide (d2, id) candidate pool:
    4x-oversampled ``approx_max_k`` FIRST, then dedup + exact (d2, id)
    sort of the survivors — the :func:`_pivot_seeds_pos` two-stage
    recipe applied to the probe merge. The full-width passes this
    replaces (a [B, probes*T + ef] id-sort for dedup plus a same-width
    two-key sort) are a top cost of probed serving at high T·probes
    (8k+ lanes per query at T=256/probes=32).

    Reducing BEFORE dedup means duplicate ids (overlapping probed
    shortlists) crowd the oversampled pool — 4x oversampling hedges
    that, and the crowding is worst exactly where the graph walk is
    strongest (a dense region's shortlists overlap because its points
    are near many probed pivots; such queries converge by walk alone).
    A true top-ef candidate is otherwise lost only if it falls outside
    the approx top-4ef, far into approx_max_k's high-recall regime;
    the heavy-tailed recall ladders gate the effect."""
    s = min(4 * ef, md2.shape[1])
    if md2.shape[1] > s:
        nv, idx = jax.lax.approx_max_k(-md2, s, recall_target=0.95)
        md2 = -nv
        mids = jnp.take_along_axis(mids, idx, axis=1)
    md2, mids = dedup_ids(md2, mids)
    return sort_dist_id(md2, mids)


def ann_search_seeded_probe(
    packed0: jnp.ndarray,
    pivot_ids: jnp.ndarray,
    pivot_vecs: jnp.ndarray,
    shortlist: jnp.ndarray,
    codes: jnp.ndarray,
    scales: jnp.ndarray,
    q: jnp.ndarray,
    ef: int,
    k: int,
    max_iters: int,
    probes: int,
    expand_e: int = 1,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Pivot-seeded serving with SHORTLIST PROBING — the IVF-flavored
    seed stage for regimes where beam WALKS can't reach every true
    neighbor in bounded iterations (measured on heavy-tailed 1M: recall
    was a function of max_iters alone — ef 256 vs 2048 identical — i.e.
    misses were candidates the beam never walked to, sitting behind a
    shell of closer-but-useless dense-region expansions).

    ``shortlist`` i32[P, T]: each pivot's T nearest stored points
    (built once by ``finalize(pivot_shortlist=T)`` as one tiled flat
    search — one matmul per tile). At query time the ``probes`` nearest pivots'
    shortlist members are scored EXACTLY (one narrow row gather + fused
    dequant-l2sq, chunked) and merged into the seed set: a true NN in
    any probed region's shortlist is IN the beam from iteration 0 with
    its exact distance — recall@k needs beam MEMBERSHIP, not expansion.
    Sparse regions (where walks fail) have geometrically WIDE
    shortlists, dense regions are covered by the graph — complementary
    by construction. Beyond the reference (its serving is the serial
    per-query descent, ``hnsw/src/searcher.rs``); same exact
    (d2, id)-ordered beam afterwards."""
    b = q.shape[0]
    e_d2, e_ids, pos = _pivot_seeds_pos(pivot_ids, pivot_vecs, q, ef)
    s = min(probes, pos.shape[1])
    cand = shortlist[pos[:, :s]].reshape(b, -1)  # [B, S]; -1 pads
    safe = jnp.clip(jnp.where(cand >= 0, cand, 0), 0, codes.shape[0] - 1)
    # chunked exact scoring: bounds the [B, ch, d] dequantized temp
    ch = min(64, safe.shape[1])
    parts = []
    for i in range(0, safe.shape[1], ch):
        c = safe[:, i : i + ch]
        vec = dequantize(codes[c], scales[c])  # [B, ch, d]
        parts.append(l2sq(q[:, None, :], vec))
    d2s = jnp.concatenate(parts, axis=1) if len(parts) > 1 else parts[0]
    d2s = jnp.where(cand >= 0, d2s, INF)
    ids = jnp.where(cand >= 0, cand, PAD_ID)
    md2 = jnp.concatenate([e_d2, d2s], axis=1)
    mids = jnp.concatenate([e_ids, ids], axis=1)
    md2, mids = _top_ef_dedup_oversampled(md2, mids, ef)
    beam_d2, beam_ids = search_layer_packed(
        packed0, q, md2[:, :ef], mids[:, :ef], ef, max_iters,
        expand_e=expand_e,
    )
    return jnp.sqrt(beam_d2[:, :k]), beam_ids[:, :k]


def ann_search_seeded_probe_packed(
    packed0: jnp.ndarray,
    pivot_ids: jnp.ndarray,
    pivot_vecs: jnp.ndarray,
    shortlist_pack: jnp.ndarray,
    t: int,
    d: int,
    q: jnp.ndarray,
    ef: int,
    k: int,
    max_iters: int,
    probes: int,
    expand_e: int = 1,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """:func:`ann_search_seeded_probe` over a PACKED shortlist table
    (``pack_layer(shortlist, codes, scales)`` — the shortlist IS an
    adjacency-shaped i32[P, T], so the packed serving layout reuses the
    beam's row format verbatim).

    Same candidates, same exact scores, ~T× fewer gather rows: the
    narrow path issues B×(probes·T) single-point gathers, this path
    issues B×probes
    wide-row gathers and decodes codes/scales/ids in-register
    (:func:`unpack_rows`). At T=128/probes=16 that is 2048 → 16 rows
    per query — the difference between the probe stage owning the
    gather budget and it riding along with the beam. Scoring loops one
    probe at a time so the dequantized [B, T, d] f32 temp stays
    ~bounded (an all-probes [B, S, d] temp is tens of GB at serving
    batch)."""
    b = q.shape[0]
    e_d2, e_ids, pos = _pivot_seeds_pos(pivot_ids, pivot_vecs, q, ef)
    s = min(probes, pos.shape[1])
    ch = min(64, t)  # bound the dequantized f32 temp at [B, ch, d]
    d2_parts, id_parts = [e_d2], [e_ids]
    for i in range(s):
        rows = shortlist_pack[pos[:, i]]  # [B, T*(d+12)] u8 — ONE gather
        crow = rows[:, : t * d].reshape(b, t, d)  # u8 codes
        srow = jax.lax.bitcast_convert_type(
            rows[:, t * d : t * (d + 8)].reshape(b, t, 2, 4), jnp.float32
        )  # [B, T, 2]
        ids_i = jax.lax.bitcast_convert_type(
            rows[:, t * (d + 8) :].reshape(b, t, 4), jnp.int32
        )  # [B, T]
        for c0 in range(0, t, ch):
            vec = dequantize(crow[:, c0 : c0 + ch], srow[:, c0 : c0 + ch])
            d2_c = l2sq(q[:, None, :], vec)  # [B, ch]
            idc = ids_i[:, c0 : c0 + ch]
            d2_parts.append(jnp.where(idc >= 0, d2_c, INF))
            id_parts.append(jnp.where(idc >= 0, idc, PAD_ID))
    md2 = jnp.concatenate(d2_parts, axis=1)
    mids = jnp.concatenate(id_parts, axis=1)
    md2, mids = _top_ef_dedup_oversampled(md2, mids, ef)
    beam_d2, beam_ids = search_layer_packed(
        packed0, q, md2[:, :ef], mids[:, :ef], ef, max_iters,
        expand_e=expand_e,
    )
    return jnp.sqrt(beam_d2[:, :k]), beam_ids[:, :k]


def _pivot_seeds(pivot_ids, pivot_vecs, q, ef):
    """Top-ef pivot seeds per query (see :func:`_pivot_seeds_pos`)."""
    e_d2, e_ids, _ = _pivot_seeds_pos(pivot_ids, pivot_vecs, q, ef)
    return e_d2, e_ids


def _pivot_seeds_pos(pivot_ids, pivot_vecs, q, ef):
    """Top-ef pivot seeds per query: one matmul + two-stage top-k.
    Returns (d2, ids, POSITIONS into the pivot table — the shortlist
    probe rows).

    Stage 1 is ``approx_max_k`` OVERSAMPLED 2x (a bucketed top-k where
    the backend has one; on the GPU it falls back to an exact sort —
    ROADMAP queue 1 item 2); stage 2 exactly sorts the 2*ef survivors ([B, 2ef] — cheap).
    A true top-ef seed is then lost only if it falls outside the approx
    top-2ef, which is far into approx_max_k's high-recall regime —
    single-stage approx at recall_target=0.95 measurably dropped the
    true-nearest seed for ~1 query in 20, and on heavy-tailed data a
    tail query's ONE in-blob seed being dropped is a whole-query miss
    Seed selection stays
    heuristic (ties/ULP order unspecified); results still come from the
    exact (d2, id)-ordered beam."""
    d2p = (
        jnp.sum(q * q, 1, keepdims=True)
        - 2.0 * jnp.dot(q, pivot_vecs.T, preferred_element_type=jnp.float32,
                        precision=jax.lax.Precision.HIGHEST)
        + jnp.sum(pivot_vecs * pivot_vecs, 1)[None, :]
    )
    d2p = jnp.where(pivot_ids[None, :] >= 0, d2p, INF)
    p = pivot_ids.shape[0]
    s = min(ef, p)
    s2 = min(2 * s, p)
    nv, pos = jax.lax.approx_max_k(-d2p, s2, recall_target=0.95)
    if s2 > s:  # exact refine of the oversampled pool
        nv, sub = jax.lax.top_k(nv, s)
        pos = jnp.take_along_axis(pos, sub, axis=1)
    e_ids = pivot_ids[pos]
    e_d2 = jnp.where(e_ids >= 0, jnp.maximum(-nv, 0.0), INF)
    e_ids = jnp.where(e_ids >= 0, e_ids, PAD_ID)
    return e_d2, e_ids, pos


def ann_search_seeded_plain(
    adj0: jnp.ndarray,
    codes: jnp.ndarray,
    scales: jnp.ndarray,
    pivot_ids: jnp.ndarray,
    pivot_vecs: jnp.ndarray,
    q: jnp.ndarray,
    ef: int,
    k: int,
    max_iters: int,
    expand_e: int = 1,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Pivot-seeded serving WITHOUT the packed layout — the memory-honest
    mode: index memory is just codes (+ optional f32 table) + adjacency +
    the pivot table (~within 2× of the raw index), no ``cap*(d+12)``
    bytes/point packed rows. Pivot seeding still removes the upper-layer
    descent (the iteration-count lever), so the only cost vs the packed
    path is ~(1+2·cap) narrow gather rows per expansion instead of one
    wide one — at large batch the narrow-row gather rate saturates and
    this is expected within a small factor of packed QPS
    (benchmarks/bench_serving_memory.py measures it). Same results as
    :func:`ann_search_seeded` given the same seeds."""
    e_d2, e_ids = _pivot_seeds(pivot_ids, pivot_vecs, q, ef)
    beam_d2, beam_ids = search_layer(
        adj0, codes, scales, q, e_d2, e_ids, ef, max_iters,
        expand_e=expand_e,
    )
    return jnp.sqrt(beam_d2[:, :k]), beam_ids[:, :k]


def seed_entry(
    codes: jnp.ndarray, scales: jnp.ndarray, q: jnp.ndarray, ep: jnp.ndarray
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Distance of every query to the global entry point — the search seed
    (``template.rs:316-319`` / ``inserter.rs:53-68``)."""
    b = q.shape[0]
    ep_ids = jnp.broadcast_to(jnp.asarray(ep, jnp.int32), (b,))
    ep_vec = _gather_vecs(codes, scales, ep_ids)
    d2 = l2sq(q, ep_vec)
    return d2[:, None], ep_ids[:, None]


def ann_search(
    adjs: tuple[jnp.ndarray, ...],
    codes: jnp.ndarray,
    scales: jnp.ndarray,
    q: jnp.ndarray,
    ep: jnp.ndarray,
    ef: int,
    k: int,
    max_iters: int,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Full batched query pipeline (``HNSW::ann_by_vector``,
    ``template.rs:306-335``): seed at the entry point, greedy ef=1 descent
    through layers top..1, beam search with width ``ef`` at layer 0, return
    the top-k (d2, ids).

    ``adjs`` is ordered layer 0 first. Jittable; ef/k/max_iters static.
    """
    entry_d2, entry_ids = seed_entry(codes, scales, q, ep)
    cur_d2, cur_ids = entry_d2[:, 0], entry_ids[:, 0]
    for adj in reversed(adjs[1:]):
        cur_d2, cur_ids = greedy_descent(adj, codes, scales, q, cur_d2, cur_ids)
    beam_d2, beam_ids = search_layer(
        adjs[0], codes, scales, q, cur_d2[:, None], cur_ids[:, None], ef, max_iters
    )
    return jnp.sqrt(beam_d2[:, :k]), beam_ids[:, :k]


def ann_search_packed(
    adjs_upper: tuple[jnp.ndarray, ...],
    packed0: jnp.ndarray,
    codes: jnp.ndarray,
    scales: jnp.ndarray,
    q: jnp.ndarray,
    ep: jnp.ndarray,
    ef: int,
    k: int,
    max_iters: int,
    expand_e: int = 1,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """:func:`ann_search` with the hot layer-0 beam running over the
    packed-neighbor layout (``adjs_upper`` = layers 1.. ordered bottom-up;
    upper-layer descent traffic is negligible and stays on plain gathers).
    Identical results to :func:`ann_search` at ``expand_e=1``."""
    entry_d2, entry_ids = seed_entry(codes, scales, q, ep)
    cur_d2, cur_ids = entry_d2[:, 0], entry_ids[:, 0]
    for adj in reversed(adjs_upper):
        cur_d2, cur_ids = greedy_descent(adj, codes, scales, q, cur_d2, cur_ids)
    beam_d2, beam_ids = search_layer_packed(
        packed0, q, cur_d2[:, None], cur_ids[:, None], ef, max_iters,
        expand_e=expand_e,
    )
    return jnp.sqrt(beam_d2[:, :k]), beam_ids[:, :k]
