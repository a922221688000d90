"""Query-path benchmarks: HNSW lockstep beam vs Flat (matmul brute force) vs
IVF-Flat, QPS over batch sizes and ef/probe settings, with recall against
exact ground truth. No reference analogue (the reference serves one query
at a time, README ~300 req/s).

Run: python benchmarks/bench_query.py [--cpu] [--quick]
"""

import os
import sys

from common import bench_device, setup_jax

QUICK = "--quick" in sys.argv
jax = setup_jax(cpu="--cpu" in sys.argv)

import functools

import jax.numpy as jnp
import numpy as np

from hnsw_rs_tpu import HNSW, FlatIndex, IVFFlatIndex
from hnsw_rs_tpu.models.hnsw import _ann_jit
from hnsw_rs_tpu.models.flat import _flat_search
from hnsw_rs_tpu.models.ivf import _ivf_search
from hnsw_rs_tpu.ops.quant import dequantize, quantize
from hnsw_rs_tpu.utils import brute_force_nns, load_glove_array

root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_, stored = load_glove_array(os.path.join(root, "test-data", "store.txt"))
_, queries = load_glove_array(os.path.join(root, "test-data", "queries.txt"))
K = 10

index = HNSW(12, dim=stored.shape[1])
index.insert_bulk(stored)
truth = brute_force_nns(queries, index.points.codes, index.points.scales, K)

flat = FlatIndex(stored.shape[1])
flat.add(stored)
ivf = IVFFlatIndex(stored.shape[1], n_lists=32)
ivf.train_add(stored)


def recall(ids):
    return np.mean([len(set(a.tolist()) & set(t.tolist())) / K for a, t in zip(ids, truth)])


BATCHES = [4096] if QUICK else [4096, 16384, 65536]
print(f"{'benchmark':55s} {'time':>10s}      {'QPS':>12s}")
for B in BATCHES:
    reps = -(-B // queries.shape[0])
    big = np.tile(queries, (reps, 1))[:B]
    q = dequantize(*quantize(jnp.asarray(big)))

    for ef in (40, 64):
        _, ann = index.ann_batch(queries, K, ef)
        r = recall(ann)
        adjs = tuple(index.graph.adjs)
        table = index._serving_table()
        bench_device(
            f"HNSW B={B} ef={ef} (recall {r:.3f})",
            lambda q: jnp.sum(_ann_jit(adjs, table, index.points.scales, q,
                                       jnp.asarray(index.params.ep, jnp.int32),
                                       ef, K, 2 * ef + 16)[1]),
            q, unit_count=B,
        )

    bench_device(
        f"Flat (matmul) B={B} (recall 1.000)",
        lambda q: jnp.sum(_flat_search(q, flat.codes, flat.scales, flat._normsq, K, False)[1]),
        q, unit_count=B,
    )

    _, ids = ivf.search(queries, K, n_probe=8)
    r = recall(ids)
    bench_device(
        f"IVF-Flat B={B} probe=8/32 (recall {r:.3f})",
        lambda q: jnp.sum(_ivf_search(q, ivf.centroids, ivf.blocks, ivf.bscales, ivf.block_ids, 8, K)[1]),
        q, unit_count=B,
    )
