"""Wave-parallel bulk index construction.

Batched redesign of ``HNSW::insert_bulk`` (``hnsw/src/template.rs:388-
445``). The reference partitions each layer's home nodes across OS threads
that race on per-node mutexes (``graph/src/graph.rs:9``); here the same
top-down layer schedule is kept, but each layer's home nodes are inserted
in **waves**: every node in a wave runs the full insertion pipeline
(greedy descent above, beam search + select_heuristic at its layers,
``inserter.rs:40-126``) in lockstep against the same immutable graph
snapshot, then all of the wave's edges are applied at once as functional
array updates — deterministic conflict resolution instead of locks.

Wave updates per layer (the analogue of ``make_connections`` /
``prune_connections`` / ``make_pruned_connections``,
``template.rs:196-251``):

1. each inserted node's own adjacency row is set to its heuristic-selected
   neighbors;
2. reverse edges are applied with a sort-based group-by-target: all
   (target, source, d2) triples are sorted by (target, d2, source), ranked
   within their target run, scattered into per-target slots, unioned with
   the target's existing row, and the union is pruned to the layer's
   degree cap keeping the (d2, id)-nearest — exactly the reference's
   ``select_simple`` prune trigger/effect (``template.rs:209-238``,
   ``template.rs:614-621``) applied eagerly.

Wave sizes grow geometrically (small waves while the graph is sparse so
early nodes see each other; large waves once the graph can absorb them),
padded to a few static bucket sizes to bound XLA recompilation.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from .graphs import LayeredGraph
from .heuristic import select_heuristic, select_heuristic_packed
from .ops.quant import dequantize
from .ops.topk import INF, PAD_ID, SENTINEL
from .params import Params
from .search import (
    _pivot_seeds,
    comb_table,
    empty_packed,
    greedy_descent,
    pack_layer,
    search_layer,
    search_layer_packed,
    seed_entry,
)
from .store import PointStore
from .utils.progress import ProgressBar

# Packed-build knobs. The packed layer-0 table costs cap*(d+12) bytes per
# point of extra device memory during the build; it is enabled ('auto')
# whenever that stays under the limit below. The limit bounds the table
# so that it, the wave transients (~2 GB at W=4096/M=24) and the
# adjacency stacks fit together in device memory; it was sized for a
# device with far less memory than 80 GB and still carries that value
# until it is derived from memory_stats()["bytes_limit"] (ROADMAP queue 2
# item 2). Above it a 1M x M=24 build (5.2 GB table) runs unpacked.
# _FIX_CAP bounds the orphan-repair rows repacked per
# wave; overflow (pathological hub floods only — ramped builds see zero
# orphans) sets a stale flag that triggers a full host-side repack
# (checked every _STALE_CHECK_EVERY waves and at layer boundaries),
# keeping packed rows consistent with the adjacency.
PACKED_BUILD_LIMIT = int(3.5 * (1 << 30))
# Deferred-repack mode (pack_lag > 1) never runs the in-wave incremental
# repack, so its peak is ONE table + the wave transients — no 2x-table
# repack temps — and its limit is correspondingly higher. The fused wave
# program's transients (packed pool decode, pool sorts, accept-loop
# pairwise temps, beams/seeds: ~3 GB together at W=4096/M=24) still sit
# on top of the table. Same old-device value as PACKED_BUILD_LIMIT.
PACKED_DEFERRED_LIMIT = int(4.0 * (1 << 30))
_FIX_CAP = 4096
_STALE_CHECK_EVERY = 16


# ---------------------------------------------------------------------------
# wave scheduling


def wave_schedule(count: int, base: int = 16, growth: float = 0.5, cap: int = 4096):
    """Split ``count`` home nodes into geometrically growing wave sizes.

    Early waves are small so the layer's graph densifies before large
    lockstep batches (which cannot see each other) arrive.
    """
    sizes = []
    done = 0
    while done < count:
        w = min(max(base, int(done * growth)), cap, count - done)
        sizes.append(w)
        done += w
    return sizes


def _bucket(w: int, buckets=(16, 64, 256, 1024, 4096)) -> int:
    """Pad a wave size up to a static bucket to bound recompilation.
    Above the largest bucket (wave_cap > 4096), round up to the next
    power of two."""
    for b in buckets:
        if w <= b:
            return b
    return 1 << (w - 1).bit_length()


# ---------------------------------------------------------------------------
# device-side wave steps (jitted, static over shapes / layer index)


def _wave_layer_step_impl(
    adj,
    codes,
    scales,
    ids_w,
    entry_d2,
    entry_ids,
    ef: int,
    m: int,
    max_iters: int,
    extend_cands: bool = True,
    expand_e: int = 1,
    packed=None,
):
    """One layer of the insertion pipeline for a whole wave
    (``Inserter::traverse_layers_below`` body, ``inserter.rs:91-126``):
    beam search with ``ef_cons`` then select_heuristic(m, extend=True,
    keep_pruned=True). Returns (neighbors_d2 [W, m], neighbors_ids [W, m],
    next-layer entry = the heuristic's selected set).

    ``expand_e`` > 1 pops E beam entries per lockstep iteration in the
    construction search (see ``search._beam_loop``): the candidate set
    discovered is a superset of some E=1 prefix, so graph quality holds
    while iteration count drops ~E× — a build-throughput knob
    (``HNSW.insert_bulk(build_expand=...)``). E=1 is the oracle-pinned
    reference semantics.

    ``packed`` (optional): the layer's packed-neighbor table
    (``search.pack_layer`` layout, kept incrementally up to date by
    ``_apply_wave_impl``). When given, the beam search and the heuristic
    extend pool each read ONE wide row per expansion instead of ~cap
    narrow ones — identical results, ~cap× fewer gather rows."""
    safe = jnp.clip(ids_w, 0, codes.shape[0] - 1)
    q = dequantize(codes[safe], scales[safe])
    if packed is not None:
        beam_d2, beam_ids = search_layer_packed(
            packed, q, entry_d2, entry_ids, ef, max_iters,
            expand_e=expand_e, forbid=ids_w,
        )
        sel_d2, sel_ids = select_heuristic_packed(
            packed, codes, scales, q, beam_d2, beam_ids, m,
            extend_cands=extend_cands, keep_pruned=True, forbid=ids_w,
        )
        return sel_d2, sel_ids
    beam_d2, beam_ids = search_layer(
        adj, codes, scales, q, entry_d2, entry_ids, ef, max_iters,
        forbid=ids_w, expand_e=expand_e,
    )
    sel_d2, sel_ids = select_heuristic(
        adj, codes, scales, q, beam_d2, beam_ids, m,
        extend_cands=extend_cands, keep_pruned=True, forbid=ids_w,
    )
    return sel_d2, sel_ids


def _pack_rows(comb, adj, rows, d: int):
    """Packed u8 rows (``search.pack_layer`` layout) for ``rows`` read
    from the FINAL adjacency + the combined code‖scale byte table
    (``search.comb_table``). ``rows`` int32[R]; out-of-range rows produce
    garbage the caller drops at scatter time."""
    n, cap = adj.shape
    r = rows.shape[0]
    nbr = adj[jnp.clip(rows, 0, n - 1)]  # [R, cap]
    safe = jnp.where(nbr >= 0, nbr, 0)
    cs = comb[safe]  # [R, cap, d+8] u8 — the only per-neighbor gather
    pk_codes = cs[..., :d].reshape(r, cap * d)
    pk_scales = cs[..., d:].reshape(r, cap * 8)
    id_bytes = jax.lax.bitcast_convert_type(nbr, jnp.uint8).reshape(r, cap * 4)
    return jnp.concatenate([pk_codes, pk_scales, id_bytes], axis=1)


def _apply_wave_impl(adj, indeg, codes, scales, ids_w, nbr_d2, nbr_ids,
                     packed=None, comb=None, repack=True, set_own=True,
                     dedup=False):
    """Apply one wave's connections at one layer, functionally.

    ``dedup=True`` extends the set_own=False duplicate guard to the
    set_own path: required when ``ids_w`` are EXISTING nodes being
    re-waved in place (``ShardedHNSW.rebalance``) — they still have
    in-edges, so a reverse edge can land in a row that already holds
    the id. A no-op for fresh nodes (undiscoverable until applied).

    ``ids_w`` int32[W] (invalid lanes < 0), ``nbr_ids``/``nbr_d2`` [W, m]
    heuristic output (PAD_ID/inf padded), ``indeg`` int32[N] running
    in-degree of every node at this layer. Returns (new adjacency,
    new indeg).

    ``set_own=False`` (cluster-bulk apply, ``build_cluster.py``): skip
    step 1 — own rows and their in-degree contributions were already
    written for EVERY point in one global pass, because cluster pools
    contain not-yet-processed points: a later per-batch own-row SET would
    wipe reverse edges earlier batches added to that row (the wave path
    never sees this — in-wave nodes are undiscoverable until applied).
    Only the reverse-edge union-prune + orphan repair run here.

    Connectivity invariants (replacing the reference's undirected
    isolate_node protection, ``graph/src/graph.rs:85-94``, which refuses
    to remove a node's last edge): (a) the union prune never evicts a
    neighbor whose only in-edge is this row (``indeg == 1``); (b) a new
    node dropped by *every* target's prune is force-written into its
    nearest neighbor's worst slot. Without these, directed adjacency
    slowly sheds reachability as later waves' reverse edges outcompete
    earlier nodes.
    """
    n, cap = adj.shape
    w, m = nbr_ids.shape
    lane_valid = (ids_w >= 0)[:, None]
    nbr_ok = jnp.logical_and(nbr_ids != PAD_ID, lane_valid)

    if set_own:
        if dedup:
            # re-wave mode: the member's OLD out-edges are about to be
            # overwritten — release their in-degree contributions first
            # (fresh nodes have empty rows, so this stays a no-op there)
            old = jnp.take(
                adj, jnp.where(ids_w >= 0, ids_w, n), axis=0,
                mode="fill", fill_value=SENTINEL,
            )
            indeg = indeg.at[jnp.where(old >= 0, old, n)].add(-1, mode="drop")
        # 1. own rows: heuristic neighbors, sentinel-padded to cap
        own = jnp.where(nbr_ok, nbr_ids, SENTINEL)
        if m < cap:
            own = jnp.concatenate(
                [own, jnp.full((w, cap - m), SENTINEL, jnp.int32)], axis=1
            )
        rows_idx = jnp.where(ids_w >= 0, ids_w, n)  # n = oob -> drop
        adj = adj.at[rows_idx].set(own[:, :cap], mode="drop")
        # own rows are fresh (new nodes had empty rows): every target
        # gains one
        indeg = indeg.at[jnp.where(nbr_ok, nbr_ids, n)].add(1, mode="drop")

    # 2. reverse edges, sort-based group-by-target. A single 1-key sort of
    # (target, edge-permutation) groups the edges; payloads are fetched by
    # permutation afterwards (each extra sort operand costs ~30% on a 64k
    # 1-D sort, and within-group order doesn't matter: the union prune
    # below row-sorts by (d2, id) anyway).
    e = w * m
    tgt0 = jnp.where(nbr_ok, nbr_ids, n).reshape(e)
    src0 = jnp.broadcast_to(ids_w[:, None], (w, m)).reshape(e)
    ed20 = jnp.where(nbr_ok, nbr_d2, INF).reshape(e)
    idx = jnp.arange(e, dtype=jnp.int32)
    tgt, perm = jax.lax.sort((tgt0, idx), dimension=0, num_keys=1)
    src = src0[perm]
    ed2 = ed20[perm]
    valid = tgt < n

    first = jnp.concatenate(
        [valid[:1], jnp.logical_and(valid[1:], tgt[1:] != tgt[:-1])]
    )
    grp_start = jax.lax.cummax(jnp.where(first, idx, -1))
    pos = idx - grp_start  # rank of this edge within its target's run
    # every per-target row below lives at the target's *first edge
    # position* (grp_start), keeping ex/inc/new_rows/targets_u aligned
    row_e = jnp.where(valid, grp_start, e)

    # 2x cap slots: unsorted within-group order means slot overflow drops
    # an *arbitrary* (not worst) incoming edge, so leave headroom; >2*cap
    # same-target incoming in one wave is vanishingly rare, and the prune
    # keeps the (d2, id)-nearest cap of whatever lands
    slots = 2 * cap
    inc_ids = jnp.full((e, slots), SENTINEL, jnp.int32)
    inc_d2 = jnp.full((e, slots), INF, jnp.float32)
    pos_c = jnp.where(pos < slots, pos, slots)  # overflow -> dropped
    inc_ids = inc_ids.at[row_e, pos_c].set(src, mode="drop")
    inc_d2 = inc_d2.at[row_e, pos_c].set(ed2, mode="drop")

    targets_u = jnp.where(first, tgt, n)  # unique targets (others -> n)
    ex = jnp.take(adj, targets_u, axis=0, mode="fill", fill_value=SENTINEL)
    if not set_own or dedup:
        # cluster-bulk apply: the target's row may ALREADY contain an
        # incoming source (mutual selection — phase A wrote every own row
        # before any reverse edge). Adding it again would put the id in
        # the row TWICE; beams then propose both copies (the within-row
        # lanes pass the known mask together) and the final top-k loses
        # unique slots to duplicates — measured as a flat ~0.65 recall
        # ceiling. An existing edge is a set-insert no-op: drop it.
        dup = jnp.any(
            inc_ids[:, :, None] == jnp.where(ex >= 0, ex, n)[:, None, :],
            axis=-1,
        )
        inc_ids = jnp.where(dup, SENTINEL, inc_ids)
        inc_d2 = jnp.where(dup, INF, inc_d2)
    # distances target -> existing neighbors (recomputed; the reference
    # recomputes them too in prune_connections, template.rs:224-230),
    # CHUNKED over the e = W*m lanes: the one-shot [E, cap, d] f32 temp
    # reaches ~1.8 GB at W=4096/m=24, the apply stage's peak-memory
    # cliff at million scale
    tsafe = jnp.clip(targets_u, 0, n - 1 if n else 0)
    exsafe = jnp.clip(ex, 0, codes.shape[0] - 1)
    ech = 8192
    epad = -(-e // ech) * ech
    t_ch = jnp.pad(tsafe, (0, epad - e)).reshape(-1, ech)
    ex_ch = jnp.pad(exsafe, ((0, epad - e), (0, 0))).reshape(-1, ech, cap)

    def _exd2_step(_, args):
        tc, xc = args
        tvec = dequantize(codes[tc], scales[tc])  # [ech, d]
        exvec = dequantize(codes[xc], scales[xc])  # [ech, cap, d]
        return None, jnp.sum((tvec[:, None, :] - exvec) ** 2, axis=-1)

    _, exd2 = jax.lax.scan(_exd2_step, None, (t_ch, ex_ch))
    exd2 = exd2.reshape(epad, cap)[:e]
    exd2 = jnp.where(ex >= 0, exd2, INF)
    # protected: this row holds that neighbor's only in-edge — evicting it
    # would orphan the neighbor (isolate_node semantics)
    ex_prot = jnp.logical_and(ex >= 0, jnp.take(indeg, exsafe) <= 1)

    uni_ids = jnp.concatenate([jnp.where(ex >= 0, ex, PAD_ID),
                               jnp.where(inc_ids >= 0, inc_ids, PAD_ID)], axis=1)
    uni_d2 = jnp.concatenate([exd2, inc_d2], axis=1)
    uni_prot = jnp.concatenate(
        [ex_prot, jnp.zeros_like(inc_ids, dtype=bool)], axis=1
    )
    # sort protected entries first, then by (d2, id); keep the first cap
    uni_d2, uni_ids = _prot_sort(uni_prot, uni_d2, uni_ids)
    new_rows = jnp.where(uni_ids[:, :cap] == PAD_ID, SENTINEL, uni_ids[:, :cap])

    # in-degree delta: -1 every surviving old entry, +1 every new entry
    indeg = indeg.at[jnp.where(ex >= 0, ex, n)].add(-1, mode="drop")
    indeg = indeg.at[jnp.where(new_rows >= 0, new_rows, n)].add(1, mode="drop")
    # most reverse-edge candidates lose the prune and leave the target's
    # row IDENTICAL — track that so the packed-repack below skips them
    # (the repack scatter is row-rate-bound; unchanged rows are pure waste)
    tgt_changed = jnp.any(
        new_rows != jnp.where(ex >= 0, ex, SENTINEL), axis=1
    )
    adj = adj.at[targets_u].set(new_rows, mode="drop")

    # 3. orphan repair. Two cases slip past the indeg<=1 protection: a new
    # node whose reverse edge lost *every* target's prune, and an old node
    # whose two in-edges were evicted by two different rows pruned in the
    # same wave (each saw indeg == 2). Any connected node (outdeg > 0)
    # with indeg == 0 is force-written into its nearest out-neighbor's
    # worst slot — one edge each, ranked to avoid slot collisions.
    outdeg = jnp.sum(adj >= 0, axis=1)
    orphan = jnp.logical_and(outdeg > 0, indeg == 0)
    tfix = jnp.where(orphan, adj[:, 0], n)  # slot 0 = nearest (rows sorted)
    all_ids = jnp.arange(n, dtype=jnp.int32)
    tfix_s, src_s = jax.lax.sort((tfix, all_ids), dimension=0, num_keys=1)
    ffirst = jnp.concatenate(
        [tfix_s[:1] < n, jnp.logical_and(tfix_s[1:] < n, tfix_s[1:] != tfix_s[:-1])]
    )
    frank = all_ids - jax.lax.cummax(jnp.where(ffirst, all_ids, -1))
    fslot = cap - 1 - jnp.clip(frank, 0, cap - 1)
    f_ok = jnp.logical_and(tfix_s < n, frank < cap)
    frow = jnp.where(f_ok, tfix_s, n)
    evicted = adj[jnp.clip(frow, 0, n - 1), fslot]
    evicted = jnp.where(jnp.logical_and(f_ok, evicted >= 0), evicted, n)
    indeg = indeg.at[evicted].add(-1, mode="drop")
    adj = adj.at[frow, fslot].set(
        jnp.where(f_ok, src_s, SENTINEL), mode="drop"
    )
    indeg = indeg.at[jnp.where(f_ok, src_s, n)].add(1, mode="drop")
    if packed is None:
        return adj, indeg
    if not repack:
        # deferred-repack mode (pack_lag > 1): the host refreshes the
        # whole table every pack_lag waves instead; rows written this
        # wave serve (at most that) stale until then — the same blindness
        # window the wave schedule already tolerates
        return adj, indeg, packed, jnp.asarray(False)

    # 4. incremental repack of the packed-neighbor table: every row this
    # wave rewrote — own rows, reverse-edge targets, and the (compacted)
    # orphan-repair target rows — is rebuilt from the FINAL adjacency via
    # the combined code‖scale table. frow is n-wide but almost always
    # empty; compact its valid entries (a sorted prefix, since frow is
    # derived from the ascending tfix_s) to _FIX_CAP lanes and flag the
    # pathological overflow so the host can do a full repack.
    d = codes.shape[1]
    fix_rows = jnp.where(f_ok, frow, n)[: _FIX_CAP]
    # stale iff any repair landed BEYOND the repacked prefix (f_ok is not
    # guaranteed to be prefix-compact when one target absorbs > cap
    # orphans, so test positions, not the count)
    stale = jnp.any(f_ok[_FIX_CAP:]) if f_ok.shape[0] > _FIX_CAP \
        else jnp.asarray(False)
    targets_rp = jnp.where(tgt_changed, targets_u, n)  # unchanged -> drop
    rows = jnp.concatenate([rows_idx, targets_rp, fix_rows])
    upd = _pack_rows(comb, adj, rows, d)
    # SELECT-rewrite instead of a row scatter: a narrow i32 scatter builds
    # the row->update index map, then the new table is one wide gather +
    # elementwise select over the donated buffer: faster than the direct
    # [R, cap*(d+12)] scatter (wide-row scatters do not pipeline;
    # gather+select runs at bandwidth) and bit-identical.
    idx = jnp.full((n,), -1, jnp.int32).at[rows].set(
        jnp.arange(rows.shape[0], dtype=jnp.int32), mode="drop"
    )
    packed = jnp.where(
        (idx >= 0)[:, None], upd[jnp.clip(idx, 0, rows.shape[0] - 1)], packed
    )
    return adj, indeg, packed, stale


def _prot_sort(prot, d2, ids):
    """Three-key sort: protected-first, then (d2 asc, id asc)."""
    key0 = jnp.where(prot, jnp.int32(0), jnp.int32(1))
    _, sd2, sids = jax.lax.sort((key0, d2, ids), dimension=-1, num_keys=3)
    return sd2, sids


_wave_layer_step = functools.partial(
    jax.jit,
    static_argnames=("ef", "m", "max_iters", "extend_cands", "expand_e"),
)(_wave_layer_step_impl)
_apply_wave = jax.jit(_apply_wave_impl)


def _insert_wave_fused_impl(
    adjs: tuple,
    indegs: tuple,
    codes,
    scales,
    ids_w,
    ep,
    ef: int,
    m: int,
    max_iters: int,
    layer_nb: int,
    extend_cands: bool = True,
    expand_e: int = 1,
    packed0=None,
    comb=None,
    repack: bool = True,
    pivot_ids=None,
    pivot_vecs=None,
    stop_layer: int = 0,
    dedup: bool = False,
):
    """One whole wave as a single dispatch: greedy descent above the home
    layer, then (beam search -> select_heuristic -> apply) for every layer
    from ``layer_nb`` down to 0. All searches read the pre-wave graph
    snapshot; updates land functionally at the end (adjacency/in-degree
    buffers are donated, so XLA updates them in place).

    ``adjs``/``indegs`` are full layer stacks ordered layer 0 first;
    returns the updated stacks. One dispatch per wave instead of ~2+3*L —
    fewer launches, and XLA can overlap the per-layer stages.

    ``packed0``/``comb`` (optional, together): layer 0's packed-neighbor
    table + the combined code‖scale byte table. Layer-0 search/heuristic
    then read packed rows (≥10× fewer gather rows — the build hot path)
    and the apply step repacks exactly the rows it rewrote. Returns
    ``(adjs, indegs, packed0, stale)`` in that mode.
    """
    safe = jnp.clip(ids_w, 0, codes.shape[0] - 1)
    q = dequantize(codes[safe], scales[safe])
    if pivot_vecs is not None and layer_nb == 0:
        # SEEDED construction (build_seeded): every level>=1 node is
        # already inserted before any layer-0 home wave, so one matmul
        # against that skeleton hands the beam ef GOOD seeds instead of
        # one descent entry — the lockstep beam loop (which runs to its
        # iteration cap) then needs far fewer discovery iterations at
        # equal pool quality. The serving-side analogue is ann_search_seeded.
        entry_d2, entry_ids = _pivot_seeds(pivot_ids, pivot_vecs, q, ef)
    else:
        e_d2, e_ids = seed_entry(codes, scales, q, ep)
        cur_d2, cur_ids = e_d2[:, 0], e_ids[:, 0]
        for lam in range(len(adjs) - 1, layer_nb, -1):
            cur_d2, cur_ids = greedy_descent(
                adjs[lam], codes, scales, q, cur_d2, cur_ids, forbid=ids_w
            )
        entry_d2, entry_ids = cur_d2[:, None], cur_ids[:, None]

    # stop_layer > 0 (cluster-bulk mode): insert only at layers >=
    # stop_layer — layer 0 is built afterwards by build_cluster, which
    # owns every layer-0 row and its in-degree ledger
    new_adjs = list(adjs)
    new_indegs = list(indegs)
    results = []
    for lam in range(layer_nb, stop_layer - 1, -1):
        sel_d2, sel_ids = _wave_layer_step_impl(
            adjs[lam], codes, scales, ids_w, entry_d2, entry_ids,
            ef=ef, m=m, max_iters=max_iters, extend_cands=extend_cands,
            expand_e=expand_e,
            packed=packed0 if lam == 0 else None,
        )
        results.append((lam, sel_d2, sel_ids))
        entry_d2, entry_ids = sel_d2, sel_ids
    stale = jnp.asarray(False)
    for lam, sel_d2, sel_ids in results:
        if lam == 0 and packed0 is not None:
            new_adjs[0], new_indegs[0], packed0, stale = _apply_wave_impl(
                adjs[0], indegs[0], codes, scales, ids_w, sel_d2, sel_ids,
                packed=packed0, comb=comb, repack=repack, dedup=dedup,
            )
        else:
            new_adjs[lam], new_indegs[lam] = _apply_wave_impl(
                adjs[lam], indegs[lam], codes, scales, ids_w, sel_d2, sel_ids,
                dedup=dedup,
            )
    if packed0 is None:
        return tuple(new_adjs), tuple(new_indegs)
    return tuple(new_adjs), tuple(new_indegs), packed0, stale


_insert_wave_fused = functools.partial(
    jax.jit,
    static_argnames=(
        "ef", "m", "max_iters", "layer_nb", "extend_cands", "expand_e",
        "stop_layer", "dedup",
    ),
    donate_argnames=("adjs", "indegs"),
)(_insert_wave_fused_impl)

_insert_wave_fused_pk = functools.partial(
    jax.jit,
    static_argnames=(
        "ef", "m", "max_iters", "layer_nb", "extend_cands", "expand_e",
        "repack", "dedup",
    ),
    donate_argnames=("adjs", "indegs", "packed0"),
)(_insert_wave_fused_impl)


# ---------------------------------------------------------------------------
# connectivity backstop


@functools.partial(jax.jit, static_argnames=("n",))
def _any_bad_jit(adj, indeg, levels_dev, layer_nb, n):
    """True iff any layer member has out-degree 0 or in-degree 0."""
    member = levels_dev[:n] >= layer_nb
    outdeg = jnp.sum(adj[:n] >= 0, axis=1)
    bad = member & ((outdeg == 0) | ((indeg[:n] == 0) & (outdeg > 0)))
    return jnp.any(bad)


def _fill_empty_member_rows(
    graph: LayeredGraph, store: PointStore, layer_nb: int,
    member: np.ndarray,
) -> int:
    """Device-side ``select_simple`` fill for layer members whose row is
    empty: each gets its ``min(cap, |member|-1)`` nearest members as
    out-neighbors via the tiled flat search. Only the bad-row MASK and
    the few bad rows' results cross the device->host pipe. Returns the
    number of rows filled."""
    import functools as _ft

    from .models.flat import _flat_search_tiled
    from .ops.distance import point_normsq

    n = len(store)
    adj = graph.get_layer(layer_nb)
    empty = np.zeros(n, bool)
    empty[member] = True
    empty &= np.asarray(jnp.sum(adj[:n] >= 0, axis=1) == 0)  # 1 B/point
    bad = np.flatnonzero(empty).astype(np.int32)
    if bad.size == 0:
        return 0
    cap = adj.shape[1]
    mem_dev = jnp.asarray(member.astype(np.int32))
    mcodes = store.codes[mem_dev]
    mscales = store.scales[mem_dev]
    normsq = point_normsq(mcodes, mscales)
    bpad = 1 << max(3, int(bad.size - 1).bit_length())
    qid = np.full(bpad, int(bad[0]), np.int32)
    qid[: bad.size] = bad
    qd = jnp.asarray(qid)
    q = dequantize(store.codes[qd], store.scales[qd])
    k = min(cap + 1, int(member.size))
    _, ti = jax.jit(_ft.partial(_flat_search_tiled, k=k))(
        q, mcodes, mscales, normsq
    )
    loc = np.asarray(ti)[: bad.size]  # member-LOCAL indices, small fetch
    rows = np.full((bad.size, cap), -1, np.int32)
    for i, x in enumerate(bad):
        ids = member[loc[i][loc[i] >= 0]]
        ids = ids[ids != x][:cap]
        rows[i, : ids.size] = ids
    adj = adj.at[jnp.asarray(bad)].set(jnp.asarray(rows))
    graph.set_layer(layer_nb, adj, indeg=None)  # recount lazily
    return int(bad.size)


def repair_connectivity(
    graph: LayeredGraph, store: PointStore, max_rounds: int = 5
) -> int:
    """Enforce the reference's min-degree invariant globally.

    The in-jit orphan repair in :func:`_apply_wave_impl` is slot-bounded:
    when one wave floods a near-empty layer (hundreds of nodes whose
    nearest neighbor is the same hub), more orphans map to a target than
    it has slots, and a few member nodes end the build with in-degree 0
    (or, evicted hard enough, out-degree 0). The reference's undirected
    graph cannot express this state (``assert_param_compliance`` demands
    min degree >= 1, ``template.rs:356-367``), so after a build/extend we
    sweep each layer on the host and fix the stragglers:

    - a member with an empty row gets its ``min(cap, k)`` nearest members
      as out-neighbors (``select_simple`` semantics);
    - a member with in-degree 0 is written into its nearest member's row
      — into a free slot if any, else evicting the farthest neighbor
      whose own in-degree exceeds 1.

    Host-side and O(bad_nodes * N) — this is a rarely-triggered backstop,
    not a hot path (zero bad nodes in normal ramped builds). Returns the
    number of repairs applied.
    """
    import jax.numpy as jnp

    levels = np.asarray(store.levels)
    n = len(store)
    levels_dev = jnp.asarray(levels, jnp.int8)
    fixes = 0
    for layer_nb in range(len(graph)):
        member = np.flatnonzero(levels >= layer_nb)
        if member.size <= 1:
            continue
        # detect ON DEVICE first — one scalar fetch; the full adjacency
        # only crosses the (slow) device->host pipe when something is
        # actually broken, which ramped builds never trigger
        if not bool(
            _any_bad_jit(
                graph.get_layer(layer_nb), graph.indeg(layer_nb),
                levels_dev, layer_nb, n,
            )
        ):
            continue
        # device-side pre-pass: pure orphans (indeg==0, outdeg>0) are
        # fixable in-jit; the host sweep below costs a FULL adjacency
        # fetch — only fall through for the cases the jit pass cannot
        # express (outdeg==0 members needing nearest-member rows)
        from .build_cluster import _any_orphan, _orphan_repair

        adj_dev, indeg_dev = graph.get_layer(layer_nb), graph.indeg(layer_nb)
        for r in range(10):
            adj_dev, indeg_dev = _orphan_repair(adj_dev, indeg_dev, round_=r)
            if not bool(_any_orphan(adj_dev, indeg_dev)):
                break
        graph.set_layer(layer_nb, adj_dev, indeg_dev)
        if not bool(
            _any_bad_jit(adj_dev, indeg_dev, levels_dev, layer_nb, n)
        ):
            continue
        # still bad after the orphan fixpoint -> members with EMPTY rows.
        # Fill them on device (select_simple semantics: the cap nearest
        # members via the tiled flat search) — the bad-row MASK is a 1 B/
        # point fetch; the old full-adjacency fetch was 96-192 MB at 1M
        from .utils.logging import get_logger

        log = get_logger("repair")
        filled = _fill_empty_member_rows(graph, store, layer_nb, member)
        log.warning(
            "repair_connectivity layer %d: %d empty member rows filled "
            "on device", layer_nb, filled,
        )
        if filled:
            fixes += filled
            adj_dev = graph.get_layer(layer_nb)
            indeg_dev = graph.indeg(layer_nb)
            for r in range(10):
                adj_dev, indeg_dev = _orphan_repair(adj_dev, indeg_dev,
                                                    round_=r)
                if not bool(_any_orphan(adj_dev, indeg_dev)):
                    break
            graph.set_layer(layer_nb, adj_dev, indeg_dev)
            if not bool(
                _any_bad_jit(adj_dev, indeg_dev, levels_dev, layer_nb, n)
            ):
                continue
        adj_dev = graph.get_layer(layer_nb)
        indeg_dev = graph.indeg(layer_nb)
        n_orph = int(jnp.sum(jnp.logical_and(
            jnp.sum(adj_dev >= 0, axis=1) > 0, indeg_dev == 0
        )))
        log.warning(
            "repair_connectivity layer %d: falling back to the host sweep, "
            "%d residual orphans (full adjacency fetch)", layer_nb, n_orph,
        )
        adj_full = np.asarray(graph.get_layer(layer_nb))
        adj = adj_full[:n].copy()
        vals = None  # dequantized member table, built lazily per layer
        changed = False
        for _ in range(max_rounds):
            outdeg = (adj[member] >= 0).sum(1)
            indeg = np.bincount(adj[adj >= 0], minlength=n)
            bad_out = member[outdeg == 0]
            bad_in = member[(indeg[member] == 0) & (outdeg > 0)]
            if bad_out.size == 0 and bad_in.size == 0:
                break
            if vals is None:
                codes = np.asarray(store.codes)[:n]
                scales = np.asarray(store.scales)[:n]
                vals = (
                    codes[member].astype(np.float32) * scales[member, 1:2]
                    + scales[member, 0:1]
                )
            changed = True
            for x in np.concatenate([bad_out, bad_in]):
                xi = np.searchsorted(member, x)
                d2x = np.einsum(
                    "md,md->m", vals - vals[xi], vals - vals[xi],
                    dtype=np.float32,
                )
                d2x[xi] = np.inf
                order = member[np.argsort(d2x, kind="stable")]
                if (adj[x] >= 0).sum() == 0:  # empty row: nearest members
                    k = min(adj.shape[1], order.size)
                    adj[x, :k] = order[:k]
                    fixes += 1
                # reverse edge into the nearest member's row
                t = int(order[0])
                if x in adj[t]:
                    continue
                free = np.flatnonzero(adj[t] < 0)
                if free.size:
                    adj[t, free[0]] = x
                else:
                    evictable = np.flatnonzero(indeg[adj[t]] > 1)
                    slot = int(evictable[-1]) if evictable.size else adj.shape[1] - 1
                    adj[t, slot] = x
                fixes += 1
        if changed:
            adj_full = adj_full.copy()
            adj_full[:n] = adj
            graph.set_layer(layer_nb, jnp.asarray(adj_full), indeg=None)
    return fixes


# ---------------------------------------------------------------------------
# host orchestration


class PackedBuildState:
    """Host-side carrier for the build-time packed layer-0 table.

    ``packed0`` is donated through every wave dispatch (updated in place);
    ``comb`` is the read-only combined code‖scale byte table. Staleness
    (the rare orphan-repair overflow, see ``_apply_wave_impl``) is OR-
    accumulated as a DEVICE scalar so waves never block on a host sync;
    :meth:`maybe_refresh` fetches it at checkpoints and does a full
    repack when set — so packed rows can lag the adjacency by at most
    ``_STALE_CHECK_EVERY`` waves, and only in hub-flood stress shapes
    (ramped builds see zero orphan repairs).
    """

    def __init__(self, packed0, comb, lag: int = 1):
        self.packed0 = packed0
        self.comb = comb
        self.lag = int(lag)  # 1 = exact per-wave repack; K>1 = full
        # repack every K waves (see _apply_wave_impl's repack=False note)
        self.dirty = 0  # waves since the table was last known-fresh
        self._stale_accum = jnp.asarray(False)

    def note_stale(self, stale) -> None:
        self._stale_accum = jnp.logical_or(self._stale_accum, stale)

    def note_wave(self, graph: LayeredGraph, store: PointStore) -> None:
        """Per-wave bookkeeping in deferred mode: refresh every `lag`."""
        self.dirty += 1
        if self.dirty >= self.lag:
            self.refresh(graph, store)

    def maybe_refresh(self, graph: LayeredGraph, store: PointStore) -> None:
        if self.dirty or bool(self._stale_accum):  # scalar fetch
            self.refresh(graph, store)

    def refresh(self, graph: LayeredGraph, store: PointStore) -> None:
        n = self.packed0.shape[0]
        self.packed0 = None  # release the old table BEFORE packing: two
        # live multi-GB tables + gather temps would blow HBM at 1M
        self.packed0 = pack_layer(
            graph.get_layer(0)[:n], store.codes[:n], store.scales[:n]
        )
        self._stale_accum = jnp.asarray(False)
        self.dirty = 0


def insert_waves(
    graph: LayeredGraph,
    store: PointStore,
    params: Params,
    home_ids: np.ndarray,
    layer_nb: int,
    ep: int,
    max_iters: int,
    bar: ProgressBar | None = None,
    wave_base: int = 16,
    wave_growth: float = 0.5,
    wave_cap: int = 4096,
    build_expand: int = 1,
    packed_state: "PackedBuildState | None" = None,
    pivots: tuple | None = None,
    stop_layer: int = 0,
) -> None:
    """Insert ``home_ids`` (all of level == layer_nb) wave by wave.

    Mutates ``graph`` in place (functionally replacing its layer arrays).
    The per-layer analogue of the thread fan-out at
    ``template.rs:403-440``. ``packed_state`` (optional) carries the
    incrementally-maintained packed layer-0 table through the waves.
    """
    codes, scales = store.codes, store.scales
    nlayers = len(graph)
    ep_dev = jnp.asarray(ep, jnp.int32)
    piv_ids, piv_vecs = pivots if pivots is not None else (None, None)
    off = 0
    wave_i = 0
    for wsize in wave_schedule(len(home_ids), wave_base, wave_growth, wave_cap):
        wave = home_ids[off : off + wsize]
        off += wsize
        wpad = _bucket(wsize)
        ids_w = np.full((wpad,), -1, np.int32)
        ids_w[:wsize] = wave
        ids_w = jnp.asarray(ids_w)

        adjs = tuple(graph.get_layer(l) for l in range(nlayers))
        indegs = tuple(graph.indeg(l) for l in range(nlayers))
        if packed_state is not None:
            new_adjs, new_indegs, packed0, stale = _insert_wave_fused_pk(
                adjs, indegs, codes, scales, ids_w, ep_dev,
                ef=params.ef_cons, m=params.m, max_iters=max_iters,
                layer_nb=layer_nb, extend_cands=params.extend_cands,
                expand_e=build_expand,
                packed0=packed_state.packed0, comb=packed_state.comb,
                repack=packed_state.lag <= 1,
                pivot_ids=piv_ids, pivot_vecs=piv_vecs,
            )
            packed_state.packed0 = packed0
            packed_state.note_stale(stale)
            wave_i += 1
            # graph must be current BEFORE a potential full refresh reads it
            for lam in range(nlayers):
                graph.set_layer(lam, new_adjs[lam], new_indegs[lam])
            if packed_state.lag > 1:
                packed_state.note_wave(graph, store)
            elif wave_i % _STALE_CHECK_EVERY == 0:
                packed_state.maybe_refresh(graph, store)
            if bar is not None:
                bar.inc(wsize)
            continue
        else:
            new_adjs, new_indegs = _insert_wave_fused(
                adjs, indegs, codes, scales, ids_w, ep_dev,
                ef=params.ef_cons, m=params.m, max_iters=max_iters,
                layer_nb=layer_nb, extend_cands=params.extend_cands,
                expand_e=build_expand,
                pivot_ids=piv_ids, pivot_vecs=piv_vecs,
                stop_layer=stop_layer,
            )
        for lam in range(nlayers):
            graph.set_layer(lam, new_adjs[lam], new_indegs[lam])
        if bar is not None:
            bar.inc(wsize)
    if packed_state is not None:
        packed_state.maybe_refresh(graph, store)


def build_index(
    store: PointStore,
    params: Params,
    verbose: bool = False,
    max_iters: int | None = None,
    wave_base: int = 16,
    wave_growth: float = 0.5,
    wave_cap: int = 4096,
    build_expand: int = 1,
    packed_build: bool | str = "auto",
    pack_lag: int = 1,
    wave_sort: bool = False,
    build_seeded: bool = False,
    build_pivot_cap: int = 8192,
    cluster_build: bool = False,
    cluster_kwargs: dict | None = None,
) -> tuple[LayeredGraph, int, "jnp.ndarray | None"]:
    """Build the full layered graph for ``store`` (``insert_bulk``,
    ``template.rs:388-445``): per layer top-down, wave-insert that layer's
    home nodes. Returns (graph, entry_point, packed0).

    ``packed_build``: maintain a packed-neighbor layer-0 table
    (``search.pack_layer`` layout) ACROSS the build and run layer-0
    construction searches + heuristic pools over it — one wide row gather
    per expansion instead of ~cap narrow ones, the dominant build cost
    where gathers are bound by rows issued. 'auto' enables it while
    the table stays under ``PACKED_BUILD_LIMIT`` bytes. The final table
    is returned (it IS the serving pack — ``HNSW.finalize``'s layout —
    so a packed build gets packed serving for free); None when disabled.

    ``cluster_build``: replace the layer-0 wave pipeline with the
    cluster-bulk pass (``build_cluster.py`` — device k-means + dense
    candidate pools + the same accept/apply machinery; no construction
    beam searches on the bulk of the data). Upper layers keep the exact
    wave path. Graph quality is recall-gated, not structure-pinned;
    ``cluster_kwargs`` forwards to ``build_layer0_clustered``.

    ``pack_lag``: 1 (default) repacks the rows each wave rewrote inside
    the wave dispatch — EXACT, the graph is bit-identical to the plain
    path. K > 1 defers to one full repack every K waves — the measured
    cheaper schedule (the per-wave incremental repack processes ~W*m*cap
    gather lanes whether or not rows changed); rows then serve up to K
    waves stale, the same blindness window the wave schedule already
    tolerates, so use it for bulk builds
    where throughput matters and the recall gate is measured anyway.
    """
    n = len(store)
    levels = store.levels
    top = int(levels.max()) if n else 0
    graph = LayeredGraph(params.m, n)
    graph.ensure_level(top)
    # EP: a node of the top layer (the reference picks an arbitrary one,
    # template.rs:283-284; we pick the first for determinism)
    ep = int(np.flatnonzero(levels == top)[0]) if n else 0
    if max_iters is None:
        max_iters = 2 * params.ef_cons + 16

    d = int(store.codes.shape[1])
    cap0 = graph.layer_cap(0)
    packed_bytes = n * cap0 * (d + 12)
    auto_limit = PACKED_BUILD_LIMIT if pack_lag <= 1 else PACKED_DEFERRED_LIMIT
    use_packed = not cluster_build and (
        packed_build is True
        or (packed_build == "auto" and 0 < packed_bytes <= auto_limit)
    )
    state = (
        PackedBuildState(
            empty_packed(n, cap0, d), comb_table(store.codes, store.scales),
            lag=pack_lag,
        )
        if use_packed
        else None
    )

    # wave_sort: order each layer's home nodes by a 1-D random projection
    # so lockstep waves hold spatially-coherent queries — per-chunk
    # max-acceptance and beam-convergence divergence tightens (the
    # while_loops run to the max over the wave). Changes the insertion
    # order, so the graph differs from the input-order build (quality
    # measured, not pinned); default off.
    proj = None
    if wave_sort and n:
        r = np.random.default_rng(7).standard_normal(d).astype(np.float32)
        rd = jnp.asarray(r)
        cdot = jnp.einsum(
            "nd,d->n", store.codes[:n].astype(jnp.float32), rd,
            precision=jax.lax.Precision.DEFAULT,  # a sort key only
        )
        proj = np.asarray(
            store.scales[:n, 0] * float(r.sum()) + store.scales[:n, 1] * cdot
        )

    # build_seeded: layer-0 construction searches start from ef pivot
    # seeds (the already-inserted level>=1 skeleton) instead of one
    # greedy-descent entry — pair with a tighter max_iters for the
    # throughput win (the lockstep beam runs to its cap)
    pivots = None
    if build_seeded and top >= 1:
        piv = np.flatnonzero(levels >= 1).astype(np.int32)
        if piv.size > build_pivot_cap > 0:
            # cap the seed set (even deterministic subsample, the same
            # policy as HNSW.finalize): the seed stage materializes
            # [W, P] distance temps inside the fused wave program —
            # ~1.7 GB at W=4096 x P=41.5k (every level>=1 node at 1M),
            # which next to a 5+ GB packed table can be the difference
            # between fitting device memory and ResourceExhausted. The
            # build only needs seeds GOOD ENOUGH to feed efc-wide pools.
            pick = np.unique(
                np.linspace(0, piv.size - 1, build_pivot_cap)
                .round().astype(np.int64)
            )
            piv = piv[pick]
        if piv.size:
            piv_dev = jnp.asarray(piv)
            pivots = (
                piv_dev,
                dequantize(store.codes[piv_dev], store.scales[piv_dev]),
            )

    if cluster_build:
        # cluster-bulk mode (build_cluster.py): EVERY layer is one
        # clustered bulk pass over its members — no construction beam
        # searches at all (the upper layers hold ~4% of the points but
        # their ramped waves were most of the wave build's time)
        from .build_cluster import build_layer0_clustered

        # bar total counts every layer pass's members (each layer is its
        # own clustered bulk pass), not just the n layer-0 rows
        total = n + sum(
            int(np.sum(levels >= l)) for l in range(1, top + 1)
        )
        bar = ProgressBar("building HNSW index", total, enabled=verbose)
        for layer_nb in range(top, 0, -1):
            mem = np.flatnonzero(levels >= layer_nb).astype(np.int32)
            build_layer0_clustered(
                graph, store, params, bar=bar, layer_nb=layer_nb,
                member_ids=mem, **(cluster_kwargs or {}),
            )
        cluster_pivots = build_layer0_clustered(
            graph, store, params, bar=bar, **(cluster_kwargs or {})
        )
        bar.finish()
        repair_connectivity(graph, store)
        return graph, ep, None, cluster_pivots

    bar = ProgressBar("building HNSW index", n, enabled=verbose)
    for layer_nb in range(top, -1, -1):
        home = np.flatnonzero(levels == layer_nb).astype(np.int32)
        if proj is not None and home.size > 1:
            home = home[np.argsort(proj[home], kind="stable")]
        insert_waves(
            graph, store, params, home, layer_nb, ep, max_iters, bar,
            wave_base, wave_growth, wave_cap, build_expand,
            packed_state=state,
            pivots=pivots if layer_nb == 0 else None,
        )
    bar.finish()
    fixes = repair_connectivity(graph, store)
    if state is not None and fixes:
        state.refresh(graph, store)  # host repair bypassed the tracking
    return graph, ep, (state.packed0 if state is not None else None), None
