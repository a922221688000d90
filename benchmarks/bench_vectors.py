"""Distance-kernel microbenchmarks — the ``vectors`` criterion suite
analogue (``vectors/benches/vector_benchmarks.rs:1-73``): L2 one-to-one
and one-to-many, full precision vs quantized, dims {8..2048} — but batched
(one scalar pair at a time would only measure dispatch).

Run: python benchmarks/bench_vectors.py [--cpu] [--quick]
"""

import sys

from common import bench_device, setup_jax

QUICK = "--quick" in sys.argv
jax = setup_jax(cpu="--cpu" in sys.argv)

import jax.numpy as jnp
import numpy as np

from hnsw_rs_tpu.ops import (
    dequantize,
    l2sq,
    pairwise_l2sq_exact,
    pairwise_l2sq_mxu,
    quantize,
)

DIMS = [8, 32, 128, 512] if QUICK else [8, 32, 128, 512, 1024, 2048]
B = 4096  # pairs per call
C = 128  # candidates for one-to-many (the reference's dist2many uses 128)

rng = np.random.default_rng(0)
print(f"{'kernel':55s} {'time':>10s}      {'throughput':>12s}")
for d in DIMS:
    a = jnp.asarray(rng.random((B, d), np.float32))
    b = jnp.asarray(rng.random((B, d), np.float32))
    bench_device(
        f"full L2 1-to-1 d={d} (x{B})",
        lambda a, b: jnp.sum(l2sq(a, b)), a, b, unit_count=B,
    )
    ca, sa = quantize(a)
    cb, sb = quantize(b)
    bench_device(
        f"quant L2 1-to-1 d={d} (x{B})",
        lambda ca, sa, cb, sb: jnp.sum(l2sq(dequantize(ca, sa), dequantize(cb, sb))),
        ca, sa, cb, sb, unit_count=B,
    )
    many = jnp.asarray(rng.random((C, d), np.float32))
    cm, sm = quantize(many)
    bench_device(
        f"quant L2 1-to-{C} d={d} (x{B})",
        lambda a, cm, sm: jnp.sum(pairwise_l2sq_exact(a, cm, sm)),
        a, cm, sm, unit_count=B * C,
    )
    bench_device(
        f"quant L2 1-to-{C} d={d} matmul (x{B})",
        lambda a, cm, sm: jnp.sum(pairwise_l2sq_mxu(a, cm, sm)),
        a, cm, sm, unit_count=B * C,
    )
