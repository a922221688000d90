"""Query data-parallelism over a replicated index.

The serving fan-out: the index arrays (codes/scales/adjacency) are
replicated on every device, the query batch is sharded over the mesh's
``data`` axis, and the jitted search pipeline runs SPMD with zero
collectives (results come back sharded over the batch). This is the
device-native answer to the reference's one-query-at-a-time single-thread
serving loop (``hnsw/src/template.rs:306-335``, README ~300 req/s)."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..models.hnsw import HNSW, _ann_jit
from ..ops.quant import dequantize, quantize


class ReplicatedHNSW:
    """Wraps a built :class:`HNSW` for data-parallel batched queries."""

    def __init__(self, index: HNSW, mesh: Mesh):
        self.index = index
        self.mesh = mesh
        rep = NamedSharding(mesh, P())
        self.adjs = tuple(
            jax.device_put(a, rep) for a in index.graph.adjs
        )
        self.codes = jax.device_put(index._serving_table(), rep)
        self.scales = jax.device_put(index.points.scales, rep)
        self.ep = jax.device_put(
            jnp.asarray(index.params.ep, jnp.int32), rep
        )

    def ann_batch(
        self, queries: np.ndarray, n: int, ef: int, max_iters: int | None = None
    ) -> tuple[np.ndarray, np.ndarray]:
        queries = np.atleast_2d(np.asarray(queries, np.float32))
        ef = max(ef, n)
        if max_iters is None:
            max_iters = 2 * ef + 16
        # cosine indexes store unit-normalized points; normalize queries the
        # same way HNSW.ann_batch does so distances are the 2-2cos values
        queries = self.index._maybe_normalize(queries)
        qc, qs = quantize(jnp.asarray(queries))
        q = jax.device_put(
            dequantize(qc, qs), NamedSharding(self.mesh, P("data"))
        )
        d, i = _ann_jit(
            self.adjs, self.codes, self.scales, q, self.ep, ef, n, max_iters
        )
        return np.asarray(d), np.asarray(i)
