"""Coverage-driven pivot selection: batch-greedy k-center fill.

Density-proportional pivot sampling (strided ids, level-sampled nodes,
k-means representatives) starves low-density regions: on heavy-tailed
1M data the rare-cluster queries' best seed sits ~3x further away than
their true neighbor and the layer-0 beam cannot close that gap at any
iteration cap (recall plateaus at 0.95 while BFS reachability is 1.0,
i.e. seeds, not the graph, are the failure). k-center (farthest-point) fill picks the points FARTHEST
from the current pivot set — exactly the uncovered regions — giving a
2-approximate k-center cover over the data regardless of density.

Runs entirely on device as ONE jitted program: the point table is
chunked along N (``lax.map``) so no [N, P] distance matrix is ever
materialized, and the greedy rounds are a ``lax.scan`` whose body is
(top_k over the running min-distance table) -> (matmul distance update).

No reference analogue: the Rust reference serves via hierarchical
descent only (``hnsw/src/searcher.rs``); pivot seeding is this
framework's device-native serving mode and k-center fill is its coverage
guarantee.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

# N-chunk height: bounds every temp at [_ROWS, batch] or [_ROWS, d].
_ROWS = 65536


@functools.partial(jax.jit, static_argnames=("budget", "batch"))
def _kcenter(x, base_vecs, base_valid, mind0, budget, batch):
    """Greedy k-center picks over chunked points.

    x: f32[C, R, d] (padded point table), base_vecs: f32[Pb, d] (padded
    existing pivots, Pb a multiple of ``batch``), base_valid: bool[Pb],
    mind0: f32[C, R] (-inf at pad rows, +inf elsewhere; donated).
    Returns int32[budget] flat indices into x (budget % batch == 0).
    """
    c, r, d = x.shape
    xn = jnp.sum(x * x, axis=-1)  # [C, R]

    def mind_vs(vecs, vmask):
        """min over valid j of ||x - vecs_j||^2, chunked along N."""
        vn = jnp.sum(vecs * vecs, axis=-1)

        def one(args):
            xr, xnr = args
            # DEFAULT precision: k-center picks pivots, which only seed
            # the beam; the beam's own distances rank the results
            dot = jnp.dot(xr, vecs.T, preferred_element_type=jnp.float32,
                          precision=lax.Precision.DEFAULT)
            d2 = xnr[:, None] + vn[None, :] - 2.0 * dot
            d2 = jnp.where(vmask[None, :], d2, jnp.inf)
            return jnp.min(d2, axis=1)

        return lax.map(one, (x, xn))  # [C, R]

    # distance to the existing pivot set, batch columns at a time
    def base_body(mind, i):
        vecs = lax.dynamic_slice_in_dim(base_vecs, i * batch, batch, 0)
        msk = lax.dynamic_slice_in_dim(base_valid, i * batch, batch, 0)
        return jnp.minimum(mind, mind_vs(vecs, msk)), None

    mind, _ = lax.scan(
        base_body, mind0, jnp.arange(base_vecs.shape[0] // batch)
    )

    def body(mind, _):
        _, top = lax.top_k(mind.reshape(-1), batch)  # farthest first
        vecs = x.reshape(-1, d)[top]
        mind = jnp.minimum(
            mind, mind_vs(vecs, jnp.ones((batch,), jnp.bool_))
        )
        mind = (
            mind.reshape(-1).at[top].set(-jnp.inf).reshape(c, r)
        )  # picked rows never re-picked
        return mind, top.astype(jnp.int32)

    _, picks = lax.scan(body, mind, None, length=budget // batch)
    return picks.reshape(-1)


def kcenter_fill(
    x: jnp.ndarray,
    base_ids: np.ndarray,
    need: int,
    batch: int = 256,
) -> np.ndarray:
    """Pick ``need`` coverage pivots from ``x`` (f32[N, d] device array)
    farthest from ``base_ids``'s rows, batch-greedily. Returns int64
    ids, deduped against ``base_ids`` (exact-duplicate points can tie
    at distance 0 in degenerate data; the unique guard keeps the pivot
    set a set — the returned count can then fall below ``need``)."""
    n, d = x.shape
    base_ids = np.asarray(base_ids, np.int64)
    need = int(min(need, max(0, n - base_ids.size)))
    if need <= 0:
        return np.zeros((0,), np.int64)
    batch = int(min(batch, need))
    rows = min(_ROWS, n)
    c = -(-n // rows)
    n_pad = c * rows
    if n_pad > n:
        x = jnp.concatenate(
            [x, jnp.zeros((n_pad - n, d), jnp.float32)], axis=0
        )
    xc = x.reshape(c, rows, d)
    # pad rows start at -inf so min() pins them unpickable forever
    valid = (np.arange(n_pad) < n).reshape(c, rows)
    mind0 = jnp.where(jnp.asarray(valid), jnp.inf, -jnp.inf).astype(
        jnp.float32
    )
    pb = max(batch, -(-base_ids.size // batch) * batch)
    # assemble the (padded) base pivot matrix on device — no host
    # round-trip
    if base_ids.size:
        bv = x[jnp.asarray(base_ids)]
        if pb > base_ids.size:
            bv = jnp.concatenate(
                [bv, jnp.zeros((pb - base_ids.size, d), jnp.float32)]
            )
    else:
        bv = jnp.zeros((pb, d), jnp.float32)
    bvalid = np.arange(pb) < base_ids.size
    budget = -(-need // batch) * batch
    picks = np.asarray(
        _kcenter(
            xc,
            jnp.asarray(bv),
            jnp.asarray(bvalid),
            mind0,
            budget,
            batch,
        )
    ).astype(np.int64)[:need]
    keep = ~np.isin(picks, base_ids)
    return np.unique(picks[keep])
