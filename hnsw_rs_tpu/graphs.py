"""Layered graph topology as dense fixed-slot adjacency arrays.

device-native redesign of the reference's ``Graph``/``Layers``
(``graph/src/graph.rs:12-16``, ``graph/src/layers.rs:8-11``). The reference
stores one ``IntMap<NodeID, Arc<Mutex<IntSet<NodeID>>>>`` per layer and
serializes it as fixed ``m``-slot rows padded with ``NodeID::MAX``
(``graph/src/graph.rs:168-181``) — that on-disk layout *is* the in-memory
layout here: each layer is a dense ``int32[N, cap]`` array in HBM whose row
``i`` lists node ``i``'s neighbors, padded with ``SENTINEL`` (-1). Layer 0
has ``cap = 2m``, upper layers ``cap = m`` (``graph/src/layers.rs:48-59``).

Key representational shifts vs the reference:

- **No per-node locks.** The bulk builder applies whole waves of edge
  updates as functional array scatters (see ``build.py``), so there is
  nothing to lock; determinism replaces the reference's racy-but-benign
  mutex dance (``hnsw/src/template.rs:403-440``).
- **Directed adjacency.** The reference keeps edges symmetric and, when
  pruning node ``j``, also removes ``j`` from its ex-neighbors' sets
  (``graph/src/graph.rs:128-137``). Dense rows make the *outgoing* list the
  unit of state (as in hnswlib), so pruning one row does not mutate others;
  reverse edges are added explicitly at insert time. Recall parity is
  validated end-to-end by the GloVe gate (``hnsw/src/template.rs:519-572``).
- **Membership is derived**, not stored: node ``i`` belongs to layer ``l``
  iff ``levels[i] >= l``; a freshly-added node simply has an all-sentinel
  row (the analogue of ``Graph::add_node`` with an empty set,
  ``graph/src/graph.rs:31-35``).

The small per-edge mutation API (``add_edge`` etc.) exists for parity and
tests; it uses functional ``.at[].set`` updates and *undirected* semantics
like the reference. The hot build path never goes through it.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from .errors import IsolatedNode, MExceeded, NodeNotInGraph, SelfConnection
from .ops.topk import SENTINEL


def empty_adjacency(n: int, cap: int) -> jnp.ndarray:
    """All-sentinel adjacency for ``n`` nodes with degree cap ``cap``."""
    return jnp.full((n, cap), SENTINEL, dtype=jnp.int32)


def degrees(adj: jnp.ndarray) -> jnp.ndarray:
    """Out-degree of every row: count of non-sentinel slots."""
    return jnp.sum(adj >= 0, axis=-1).astype(jnp.int32)


def row_insert(row: jnp.ndarray, value: int) -> jnp.ndarray:
    """Insert ``value`` into the first sentinel slot of a row (set
    semantics: no-op if already present). Pure function."""
    present = jnp.any(row == value)
    free = row < 0
    slot = jnp.argmax(free)  # first free slot
    can = jnp.logical_and(jnp.logical_not(present), jnp.any(free))
    return jnp.where(
        jnp.logical_and(can, jnp.arange(row.shape[0]) == slot), value, row
    )


def row_remove(row: jnp.ndarray, value: int) -> jnp.ndarray:
    """Remove ``value`` from a row, replacing it with the sentinel."""
    return jnp.where(row == value, SENTINEL, row)


class LayeredGraph:
    """Stack of dense adjacency layers (the reference's ``Layers``,
    ``graph/src/layers.rs:8-11``).

    ``adjs[l]`` is an ``int32[N, cap_l]`` jax array; all layers share the
    same row space of ``N`` global node ids.
    """

    def __init__(self, m: int, n: int = 0):
        self.m = int(m)
        self.n = int(n)
        self.adjs: list[jnp.ndarray] = []
        self._indegs: list[jnp.ndarray | None] = []

    # -- structure ---------------------------------------------------------

    def __len__(self) -> int:
        return len(self.adjs)

    def layer_cap(self, layer_nb: int) -> int:
        """Degree cap: ``2m`` at layer 0, ``m`` above
        (``graph/src/layers.rs:48-59``)."""
        return self.m * 2 if layer_nb == 0 else self.m

    def ensure_level(self, level: int) -> None:
        """Grow the layer stack so layers ``0..=level`` exist
        (``Layers::add_level``, ``graph/src/layers.rs:48-59``)."""
        while len(self.adjs) <= level:
            self.adjs.append(empty_adjacency(self.n, self.layer_cap(len(self.adjs))))
            self._indegs.append(jnp.zeros((self.n,), jnp.int32))

    def ensure_nodes(self, n: int) -> None:
        """Grow every layer's row space to at least ``n`` rows."""
        if n <= self.n:
            return
        grown = []
        for adj in self.adjs:
            pad = jnp.full((n - adj.shape[0], adj.shape[1]), SENTINEL, jnp.int32)
            grown.append(jnp.concatenate([adj, pad], axis=0))
        self.adjs = grown
        # new rows are empty, so cached in-degrees stay valid zero-padded
        self._indegs = [
            None if d is None else jnp.concatenate(
                [d, jnp.zeros((n - d.shape[0],), jnp.int32)]
            )
            for d in self._indegs
        ]
        self.n = n

    def get_layer(self, layer_nb: int) -> jnp.ndarray:
        if layer_nb >= len(self.adjs):
            raise IndexError(f"layer {layer_nb} not found")
        return self.adjs[layer_nb]

    def set_layer(
        self, layer_nb: int, adj: jnp.ndarray, indeg: jnp.ndarray | None = None
    ) -> None:
        """Replace a layer's adjacency (and optionally its known in-degree
        vector; pass None to invalidate the cache)."""
        self.adjs[layer_nb] = adj
        self._indegs[layer_nb] = indeg

    def indeg(self, layer_nb: int) -> jnp.ndarray:
        """In-degree of every node at a layer (cached; recomputed with one
        scatter-add when a compat mutation invalidated it). Needed by the
        builder's isolate-protection (see ``build._apply_wave``)."""
        if self._indegs[layer_nb] is None:
            adj = self.adjs[layer_nb]
            n = adj.shape[0]
            flat = jnp.where(adj >= 0, adj, n).reshape(-1)
            self._indegs[layer_nb] = (
                jnp.zeros((n,), jnp.int32).at[flat].add(1, mode="drop")
            )
        return self._indegs[layer_nb]

    # -- compat per-edge API (tests / small updates; undirected like the
    # -- reference's Graph, graph/src/graph.rs:37-52) ----------------------

    def _check(self, layer_nb: int, node: int) -> None:
        if node < 0 or node >= self.n:
            raise NodeNotInGraph(node)

    def add_edge(self, layer_nb: int, a: int, b: int) -> None:
        """Undirected edge insert; rejects self-loops
        (``graph/src/graph.rs:37-52``) and raises :class:`MExceeded` when an
        endpoint's row is full (the reference declares the variant,
        ``graph/src/errors.rs:8``, but silently relies on set growth; dense
        rows make the cap real, so enforce it instead of dropping edges)."""
        if a == b:
            raise SelfConnection(a)
        self._check(layer_nb, a)
        self._check(layer_nb, b)
        adj = self.adjs[layer_nb]
        rows = np.asarray(adj[jnp.asarray([a, b])])
        for node, other, row in ((a, b, rows[0]), (b, a, rows[1])):
            if other not in row and not np.any(row < 0):
                raise MExceeded(node, int(row.shape[0]))
        adj = adj.at[a].set(row_insert(adj[a], b))
        adj = adj.at[b].set(row_insert(adj[b], a))
        self.adjs[layer_nb] = adj
        self._indegs[layer_nb] = None

    def remove_edge(self, layer_nb: int, a: int, b: int) -> None:
        """Undirected edge removal (``graph/src/graph.rs:72-83``)."""
        self._check(layer_nb, a)
        self._check(layer_nb, b)
        adj = self.adjs[layer_nb]
        adj = adj.at[a].set(row_remove(adj[a], b))
        adj = adj.at[b].set(row_remove(adj[b], a))
        self.adjs[layer_nb] = adj
        self._indegs[layer_nb] = None

    def neighbors(self, layer_nb: int, node: int) -> np.ndarray:
        """Valid neighbor ids of ``node`` (``graph/src/graph.rs:96-125``)."""
        self._check(layer_nb, node)
        row = np.asarray(self.adjs[layer_nb][node])
        return row[row >= 0]

    def degree(self, layer_nb: int, node: int) -> int:
        self._check(layer_nb, node)
        return int(np.sum(np.asarray(self.adjs[layer_nb][node]) >= 0))

    def isolate_node(self, layer_nb: int, node: int, strict: bool = False) -> None:
        """Remove ``node``'s edges in both directions, skipping any
        neighbor that would drop to degree 0 (``Graph::isolate_node``,
        ``graph/src/graph.rs:85-94``). With ``strict=True``, a refused
        removal raises :class:`IsolatedNode` (the error variant the
        reference declares at ``graph/src/errors.rs:6``) instead of
        silently keeping the edge."""
        self._check(layer_nb, node)
        for nb in self.neighbors(layer_nb, node):
            if self.degree(layer_nb, int(nb)) > 1:
                self.remove_edge(layer_nb, node, int(nb))
            elif strict:
                raise IsolatedNode(int(nb))

    def replace_neighbors(self, layer_nb: int, node: int, new_neighbors) -> None:
        """Replace ``node``'s outgoing list (directed analogue of
        ``Graph::replace_neighbors``, ``graph/src/graph.rs:128-137``)."""
        self._check(layer_nb, node)
        adj = self.adjs[layer_nb]
        cap = adj.shape[1]
        new = np.full((cap,), SENTINEL, dtype=np.int32)
        uniq = [int(x) for x in dict.fromkeys(int(v) for v in new_neighbors) if int(x) >= 0]
        new[: min(len(uniq), cap)] = uniq[:cap]
        self.adjs[layer_nb] = adj.at[node].set(jnp.asarray(new))
        self._indegs[layer_nb] = None

    # -- test factories ----------------------------------------------------

    @classmethod
    def make_rand(cls, n: int, m: int, n_edges: int, seed: int = 0) -> "LayeredGraph":
        """Random single-layer graph for tests (``make_rand_graph``,
        ``graph/src/graph.rs:254-273``)."""
        g = cls(m, n)
        g.ensure_level(0)
        rng = np.random.default_rng(seed)
        added = 0
        while added < n_edges:
            a, b = (int(x) for x in rng.integers(0, n, 2))
            if (
                a == b
                or b in g.neighbors(0, a)
                or g.degree(0, a) >= g.layer_cap(0)
                or g.degree(0, b) >= g.layer_cap(0)
            ):
                continue
            g.add_edge(0, a, b)
            added += 1
        return g

    # -- introspection -----------------------------------------------------

    def layer_degrees(self, layer_nb: int, levels: np.ndarray) -> np.ndarray:
        """Out-degrees of the nodes belonging to ``layer_nb``
        (``HNSW::layer_degrees``, ``hnsw/src/template.rs:158-163``)."""
        degs = np.asarray(degrees(self.adjs[layer_nb]))
        member = np.asarray(levels) >= layer_nb
        return degs[member]

    def nb_nodes(self, layer_nb: int, levels: np.ndarray) -> int:
        return int(np.sum(np.asarray(levels) >= layer_nb))
