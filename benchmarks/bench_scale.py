"""Scale benchmark: bulk build + recall/QPS at N=100k (clustered
synthetic data, the SIFT-like regime of BASELINE configs 2-3 where graph
search actually beats brute force).

Run: python benchmarks/bench_scale.py [--cpu] [--quick] [--n 100000]
"""

import sys
import time

from common import setup_jax

QUICK = "--quick" in sys.argv
jax = setup_jax(cpu="--cpu" in sys.argv)

import functools

import jax.numpy as jnp
import numpy as np

from hnsw_rs_tpu import HNSW, FlatIndex
from hnsw_rs_tpu.models.hnsw import _ann_jit
from hnsw_rs_tpu.utils import brute_force_nns

N = 20_000 if QUICK else 100_000
if "--n" in sys.argv:
    N = int(sys.argv[sys.argv.index("--n") + 1])
D, K, NQ = 64, 10, 256
M, EF_CONS = 16, 64

rng = np.random.default_rng(0)
n_clusters = max(64, N // 100)
centers = rng.random((n_clusters, D), np.float32)
assign = rng.integers(0, n_clusters, N)
vectors = (centers[assign] + rng.normal(0, 0.05, (N, D))).astype(np.float32)
qassign = rng.integers(0, n_clusters, NQ)
queries = (centers[qassign] + rng.normal(0, 0.05, (NQ, D))).astype(np.float32)

print(f"N={N} d={D} M={M} ef_cons={EF_CONS}", flush=True)


def build():
    idx = HNSW(M, ef_cons=EF_CONS, dim=D)
    idx.insert_bulk(vectors)
    jax.block_until_ready(idx.graph.adjs)
    return idx


t0 = time.time()
index = build()  # includes compilation on a cold cache
print(f"build (cold) {time.time() - t0:.1f}s", flush=True)
t0 = time.time()
index = build()
dt = time.time() - t0
print(f"build (warm) {dt:.1f}s = {N / dt:.0f} vec/s", flush=True)

truth = brute_force_nns(queries, index.points.codes, index.points.scales, K)

adjs = tuple(index.graph.adjs)
table = index._serving_table()
ep = jnp.asarray(index.params.ep, jnp.int32)


@functools.partial(jax.jit, static_argnames=("ef",))
def search_sum(q, ef):
    d, i = _ann_jit(adjs, table, index.points.scales, q, ep, ef, K, 2 * ef + 16)
    return jnp.sum(i)


B = 16384
big = np.tile(queries, (-(-B // NQ), 1))[:B]
from hnsw_rs_tpu.ops.quant import dequantize, quantize

q = dequantize(*quantize(jnp.asarray(big)))

print(f"{'ef':>4s} {'recall@10':>10s} {'QPS':>12s}")
for ef in (16, 32, 64, 128):
    _, ann = index.ann_batch(queries, K, ef)
    rec = np.mean([len(set(a) & set(t)) / K for a, t in zip(ann, truth)])
    jax.block_until_ready(search_sum(q, ef))
    t0 = time.time()
    it = 0
    while time.time() - t0 < 3.0:
        jax.block_until_ready(search_sum(q, ef))
        it += 1
    qps = B * it / (time.time() - t0)
    print(f"{ef:4d} {rec:10.3f} {qps:12.0f}", flush=True)

# flat exact baseline at this scale
flat = FlatIndex(D)
flat.add(vectors)
from hnsw_rs_tpu.models.flat import _flat_search


def flat_sum(q):
    return jnp.sum(_flat_search(q, flat.codes, flat.scales, flat._normsq, K, False)[1])


f = jax.jit(flat_sum)
jax.block_until_ready(f(q))
t0 = time.time()
it = 0
while time.time() - t0 < 3.0:
    jax.block_until_ready(f(q))
    it += 1
print(f"flat exact: {B * it / (time.time() - t0):12.0f} qps", flush=True)
