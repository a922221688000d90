"""Index build/insert benchmarks — the ``hnsw`` criterion suite analogue
(``hnsw/benches/hnsw_benchmarks.rs:8-55``): single insert into a built
index and full bulk build, M in {32, 64, 128} (plus the default 12),
on the bundled GloVe data tiled to 10k rows.

Run: python benchmarks/bench_hnsw.py [--cpu] [--quick]
"""

import os
import sys
import time

from common import bench_host, setup_jax

QUICK = "--quick" in sys.argv
jax = setup_jax(cpu="--cpu" in sys.argv)

import numpy as np

from hnsw_rs_tpu import HNSW
from hnsw_rs_tpu.utils import load_glove_array

root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_, stored = load_glove_array(os.path.join(root, "test-data", "store.txt"))
N = 2000 if QUICK else 10000
reps = -(-N // stored.shape[0])
rng = np.random.default_rng(0)
vectors = np.tile(stored, (reps, 1))[:N] + rng.normal(0, 0.01, (N, stored.shape[1])).astype(np.float32)

MS = [12, 32] if QUICK else [12, 32, 64, 128]

print(f"{'benchmark':55s} {'time':>10s}      {'rate':>12s}")
for m in MS:
    def build():
        idx = HNSW(m, dim=vectors.shape[1])
        idx.insert_bulk(vectors)
        jax.block_until_ready(idx.graph.adjs)
        return idx

    index = build()  # warm compiles
    t0 = time.time()
    index = build()
    dt = time.time() - t0
    print(f"{f'full build N={N} M={m}':55s} {dt * 1e3:10.1f} ms   {N / dt:14.0f} /s")

    one = vectors[0] + 0.01
    bench_host(
        f"single insert into N={N} M={m}",
        lambda: index.insert_vec(one),
        seconds=3.0,
    )
