"""Headline benchmark: batched HNSW query QPS at recall@10 >= 0.99 at
million scale (BASELINE configs 2-3), on one GPU.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline",
"device_kind", "power_limit_w"}. vs_baseline divides by the reference's
published ~300 req/s single-thread query rate (README.md); the metric
string also carries the measured single-core C++ build rate from
hnsw_rs_tpu/native/baseline_hnsw.cpp. Refuses to run without a GPU.

Dataset: seeded synthetic clustered vectors (SIFT-like regime; the loader
for ann-benchmarks files is hnsw_rs_tpu.utils.datasets
.load_ann_benchmarks_hdf5). Ground truth is exact quantized-space top-k
computed on device, matching the reference's quality gate
(hnsw/src/template.rs:531-541).

Caching: the built index and ground truth are cached under .bench_cache/
(gitignored) keyed by config, so repeat runs skip the build; build
throughput is measured only when building fresh, and the cached rate is
reported otherwise (HNSW_BENCH_FRESH=1 forces a fresh build).

Env knobs: HNSW_BENCH_N (default 1_000_000), HNSW_BENCH_QUICK=1 (100k).
"""

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)


def main() -> None:
    import functools

    import jax
    import jax.numpy as jnp
    import numpy as np

    from hnsw_rs_tpu import HNSW
    from hnsw_rs_tpu.models.flat import _flat_search_tiled
    from hnsw_rs_tpu.models.hnsw import _ann_seeded_jit
    from hnsw_rs_tpu.ops.distance import point_normsq
    from hnsw_rs_tpu.ops.quant import dequantize, quantize
    from hnsw_rs_tpu.utils.cache import enable_compile_cache
    from hnsw_rs_tpu.utils.datasets import synthetic_clustered
    from hnsw_rs_tpu.utils.device import (
        nvidia_smi_cards, power_limit_w, require_gpu,
    )

    enable_compile_cache()
    card = nvidia_smi_cards()[0]
    dev = require_gpu()[0]

    N = int(os.environ.get("HNSW_BENCH_N", "1000000"))
    if os.environ.get("HNSW_BENCH_QUICK"):
        N = 100_000
    # M=24/efc=128 and PIVOTS=16384: cluster builds emit ~N/96 per-cluster
    # representatives and the pivot budget must cover them, or
    # micro-regions go seedless. The timed batch is NQ unique queries
    # (duplicate-tiled batches share beam paths); recall is measured on
    # the first NQ_RECALL of them against exact ground truth.
    D, K, M, EF_CONS, NQ, NQ_RECALL, PIVOTS = 96, 10, 24, 128, 32768, 4096, 16384
    cache = os.path.join(ROOT, ".bench_cache")
    tag = f"n{N}_d{D}_m{M}_efc{EF_CONS}"
    idx_dir = os.path.join(cache, f"idx_{tag}")
    gt_path = os.path.join(cache, f"gt_n{N}_d{D}_q{NQ_RECALL}.npz")
    meta_path = os.path.join(cache, f"meta_{tag}.json")
    os.makedirs(cache, exist_ok=True)

    ds = synthetic_clustered(N, D, n_queries=NQ, seed=42)

    meta = {}
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)

    fresh = bool(os.environ.get("HNSW_BENCH_FRESH"))
    if os.path.isdir(idx_dir) and "build_rate" in meta and not fresh:
        index = HNSW.load(idx_dir)
        build_rate = meta["build_rate"]
    else:
        def timed_build():
            t0 = time.perf_counter()
            idx = HNSW(M, ef_cons=EF_CONS, dim=D)
            # cluster-bulk build (build_cluster.py), recall-gated by this
            # benchmark's >=0.99 serving gate below. select_alg4=False
            # picks the nearest m and leaves diversity pruning to the
            # merge; merge_slots=48 (= cap) truncates only hub rows.
            idx.insert_bulk(
                ds.train, cluster_build=True,
                cluster_kwargs={"pool_p": 96, "points_per_cluster": 96,
                                "fanout": 5, "select_alg4": False,
                                "merge_slots": 48},
            )
            jax.block_until_ready(idx.graph.adjs)
            return idx, time.perf_counter() - t0

        index, first_s = timed_build()  # pays the compiles when cold
        index, build_s = timed_build()  # compile-cache warm: real rate
        build_rate = N / build_s
        index.save(idx_dir)
        meta["build_rate"] = build_rate
        meta["build_s"] = build_s
        meta["build_s_cold"] = first_s

    # single-core C++ baseline, measured on a 50k slice (the full-N
    # sequential build would take hours). Rates fall slowly with N, so a
    # 50k-slice rate flatters the baseline. Any concurrent process on the
    # host lowers it and inflates the x-factor.
    if "cpu_build_vps" not in meta:
        from hnsw_rs_tpu.native import baseline_build_rate

        nb = min(N, 50_000)
        r = baseline_build_rate(ds.train[:nb], m=M, ef_cons=EF_CONS)
        meta["cpu_build_vps"] = round(r[1], 1) if r else None
        meta["cpu_build_n"] = nb
    with open(meta_path, "w") as f:
        json.dump(meta, f)

    # exact quantized-space ground truth (cached)
    if os.path.exists(gt_path):
        truth = np.load(gt_path)["ids"]
    else:
        qq = dequantize(*quantize(jnp.asarray(ds.test[:NQ_RECALL])))
        normsq = point_normsq(index.points.codes, index.points.scales)
        _, ti = jax.jit(functools.partial(_flat_search_tiled, k=K))(
            qq, index.points.codes, index.points.scales, normsq
        )
        truth = np.asarray(ti)[:, :K]
        np.savez_compressed(gt_path, ids=truth)

    index.finalize(pivots=PIVOTS)  # packed rows + pivot-seeded serving
    packed0 = index._packed0
    pivot_ids, pivot_vecs = index._pivots
    truth_sets = [set(t) for t in truth]
    q1k = dequantize(*quantize(jnp.asarray(ds.test[:NQ_RECALL])))

    # cheapest (ef, max_iters) clearing the 0.99 recall gate, in
    # ascending cost order (cost ~ max_iters)
    cands = [
        (16, 8), (24, 10), (24, 12), (32, 16), (40, 20), (40, 24),
        (48, 24), (48, 28), (48, 32), (64, 40), (64, 56), (96, 80),
        (128, 112), (192, 200), (256, 280),
    ]
    chosen = None
    for ef, mi in cands:
        _, ann = _ann_seeded_jit(packed0, pivot_ids, pivot_vecs, q1k,
                                 ef, K, mi, 1)
        recall = float(
            np.mean([len(set(a) & t) / K for a, t in zip(np.asarray(ann),
                                                         truth_sets)])
        )
        if recall >= 0.99:
            chosen = (ef, mi, recall)
            break
    gate_met = chosen is not None
    if not gate_met:
        # never report a sub-gate recall under a ">=0.99" label: the
        # metric string below switches to BELOW-GATE and vs_baseline is
        # zeroed so a silent quality regression cannot masquerade as a
        # healthy headline
        chosen = (ef, mi, recall)
    ef, max_iters, recall = chosen

    q = dequantize(*quantize(jnp.asarray(ds.test)))  # NQ unique queries
    search = functools.partial(_ann_seeded_jit, packed0, pivot_ids,
                               pivot_vecs, q, ef, K, max_iters)
    jax.block_until_ready(search())  # compile + warm
    t0 = time.perf_counter()
    iters = 0
    while time.perf_counter() - t0 < 5.0 or iters < 3:
        jax.block_until_ready(search())
        iters += 1
    qps = NQ * iters / (time.perf_counter() - t0)

    cpu_bv = meta.get("cpu_build_vps")
    bx = f", {build_rate / cpu_bv:.1f}x 1-core C++ {cpu_bv:.0f} vec/s" if cpu_bv else ""
    # device bytes per point held by this serving mode (packed rows +
    # pivot table + codes/scales/adjacency)
    serve_bytes = int(packed0.size + pivot_vecs.size * 4 + pivot_ids.size * 4
                      + N * D + N * 8)
    for a in index.graph.adjs:
        serve_bytes += N * a.shape[1] * 4
    bpp = serve_bytes / N
    gate_label = "recall@10>=0.99" if gate_met else "recall@10 BELOW GATE 0.99"
    print(
        json.dumps(
            {
                "metric": (
                    f"QPS/chip at {gate_label}, N={N} d={D} synthetic-"
                    f"clustered (M={M}, pivot-seeded ef={ef} "
                    f"mi={max_iters}, recall={recall:.3f}, "
                    f"{bpp:.0f} B/point serving memory; build "
                    f"{build_rate:.0f} vec/s{bx})"
                ),
                "value": round(qps, 1),
                "unit": "qps",
                "vs_baseline": 0.0 if not gate_met else round(qps / 300.0, 2),
                "device_kind": dev.device_kind,
                "power_limit_w": power_limit_w(card),
            }
        )
    )


if __name__ == "__main__":
    main()
