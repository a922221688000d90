"""Graph refinement: synchronous NN-descent rounds over a built layer.

One round recomputes every node's out-row from its 2-hop OUT-neighborhood
(own row + the first ``hop_w`` slots of each out-neighbor's row), scored
exactly and re-selected with the oracle-pinned Algorithm-4 accept chain
(``heuristic._accept_from_pool``, ``keep_pruned`` fill — the reference's
``prune_connections`` semantics, ``hnsw/src/template.rs`` Algorithm 4
applied to a richer pool). This is the classic NN-descent local join
(Dong et al., WWW'11) restricted to the directed out-graph, which after
the cluster builder's reverse-edge union merge already carries both edge
directions' information.

Why it exists: the cluster-bulk builder's pools are k-means-local — on
regimes whose natural blob granularity fights the clustering (measured:
heavy-tailed Zipf blobs + scale spread, where serving recall plateaued
at ~0.92 @ ef=48 / 0.99 only at ef=512), some true kNN edges never enter
any pool, and no serving-side budget recovers them. One refinement round
gives every node a pool its CURRENT neighborhood votes for — exactly the
edges the k-means pools missed; reads are batched row gathers + one
matvec per node batch, all on device.

Shape discipline: the round is fully synchronous (every chunk
reads the OLD adjacency, writes a fresh buffer — deterministic, no
intra-round order effects), chunks are contiguous row ranges written
with ``dynamic_update_slice`` (no wide scatters), and the
[R, P, d] pool temp is bounded by the (batch, hop_w) knobs.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from .heuristic import _accept_from_pool
from .ops.quant import dequantize
from .ops.topk import INF, PAD_ID, dedup_ids, sort_dist_id

__all__ = ["refine_layer"]


@functools.partial(
    jax.jit, static_argnames=("r", "hop_w", "pool_p", "cap", "use_alg4"),
)
def _refine_chunk_impl(codes, scales, adj, off, r, hop_w, pool_p, cap,
                       use_alg4):
    """New rows [r, cap] for nodes ``off .. off+r`` from the old ``adj``.
    ``off`` is TRACED (one compiled program serves every chunk); ``r`` is
    static, and the caller clamps ``off`` to ``n - r`` so the ragged tail
    reuses the same shape (overlap rows recompute identically — both
    reads see the OLD adjacency)."""
    n = adj.shape[0]
    rows = off + jnp.arange(r, dtype=jnp.int32)
    own = jax.lax.dynamic_slice_in_dim(adj, off, r, 0)  # [r, cap]
    own_safe = jnp.where(own >= 0, own, 0)
    hop = adj[own_safe][:, :, :hop_w]  # [r, cap, hop_w]
    hop = jnp.where(own[:, :, None] >= 0, hop, -1)
    pool = jnp.concatenate([own, hop.reshape(r, -1)], axis=1)  # [r, P]
    pool = jnp.where(pool == rows[:, None], -1, pool)  # drop self
    psafe = jnp.clip(jnp.where(pool >= 0, pool, 0), 0, n - 1)

    qvec = dequantize(codes[rows], scales[rows])  # [r, d]
    pvec = dequantize(
        codes[psafe.reshape(-1)], scales[psafe.reshape(-1)]
    ).reshape(r, pool.shape[1], -1)  # [r, P, d]
    # expanded matmul form: the diff-square form would materialize the
    # same [r, P, d] temp anyway, the dot is a matmul
    qc = jax.lax.dot_general(
        qvec[:, None, :], pvec, (((2,), (2,)), ((0,), (0,))),
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )[:, 0, :]  # [r, P]
    d2 = jnp.maximum(
        jnp.sum(qvec * qvec, 1)[:, None]
        + jnp.sum(pvec * pvec, 2) - 2.0 * qc, 0.0,
    )
    d2 = jnp.where(pool >= 0, d2, INF)
    ids = jnp.where(pool >= 0, pool, PAD_ID)
    d2, ids = dedup_ids(d2, ids)
    d2, ids = sort_dist_id(d2, ids)
    p = min(max(pool_p, cap), ids.shape[1])
    d2, ids = d2[:, :p], ids[:, :p]
    if use_alg4:
        _, sel = _accept_from_pool(
            codes, scales, qvec, d2, ids, cap, keep_pruned=True
        )
    else:
        sel = ids[:, :cap]
    return jnp.where(sel == PAD_ID, -1, sel)


def refine_layer(
    graph,
    store,
    layer_nb: int = 0,
    rounds: int = 1,
    hop_w: int = 8,
    pool_p: int = 192,
    use_alg4: bool = True,
    batch: int = 1024,
    bar=None,
) -> None:
    """Run ``rounds`` synchronous NN-descent rounds over layer
    ``layer_nb`` of ``graph`` in place, then recount in-degrees and
    re-run the device orphan-repair fixpoint (refinement can evict a
    node's last in-edge, same as the merge — reuses
    ``build_cluster._orphan_repair``)."""
    from .build_cluster import _any_orphan, _orphan_repair, _recount_indeg

    n = len(store)
    if n == 0 or rounds <= 0:
        return
    codes, scales = store.codes[:n], store.scales[:n]
    adj = graph.get_layer(layer_nb)[:n]
    cap = adj.shape[1]
    r = min(batch, n)
    for _ in range(rounds):
        parts = []
        done = 0
        while done < n:
            off = min(done, n - r)  # clamped tail reuses the one program
            rowsnew = _refine_chunk_impl(
                codes, scales, adj, jnp.int32(off), r=r, hop_w=hop_w,
                pool_p=pool_p, cap=cap, use_alg4=use_alg4,
            )
            take = min(r, n - done)
            parts.append(rowsnew[done - off : done - off + take])
            done += take
            if bar is not None:
                bar.inc(take)
        adj = jnp.concatenate(parts) if len(parts) > 1 else parts[0]
    indeg = _recount_indeg(adj)
    for rd in range(10):
        adj, indeg = _orphan_repair(adj, indeg, round_=rd)
        if not bool(_any_orphan(adj, indeg)):
            break
    graph.set_layer(layer_nb, adj, indeg)
