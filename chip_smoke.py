#!/usr/bin/env python3
"""On-card smoke run of the HNSW build-and-serve path.

    python chip_smoke.py [--seed S]          # one GPU: device, parity, hnsw, families
    python chip_smoke.py --four-cards        # ShardedHNSW over four GPUs, nothing else

Every phase prints one JSON line with the card's name and power limit;
the last line is ``{"ok": true, "device": {...}}`` and nothing more. The
run exits non-zero, without that line, when JAX finds no GPU or when any
phase's check fails. The times it prints are bring-up observations of
one run, not benchmark numbers.

Phases (one process, so later phases reuse earlier compilations):

1. ``device``   the first JAX device must be a GPU; never falls back.
2. ``parity``   the distance matmul, the exact flat top-k and the plain
   graph traversal against independent numpy references.
3. ``hnsw``     1M x 96 clustered points: cluster-bulk build (cold and
   warm), pivot-seeded serving of 32,768 queries at recall@10 >= 0.99,
   incremental insert, save/load round trip.
4. ``families`` Flat, IVF-Flat, IVF-PQ, HNSW PQ serving and the GloVe
   evaluation CLI at 100k x 96.
5. ``four_cards`` (only with ``--four-cards``) a 4M-point ShardedHNSW,
   one 1M shard of the one-card regime per card, against exact truth
   over all 4M points.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import io
import json
import os
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from hnsw_rs_tpu.eval_glove import main as eval_glove_main  # noqa: E402
from hnsw_rs_tpu.eval_glove import recall_at_k  # noqa: E402
from hnsw_rs_tpu.models.flat import FlatIndex, _flat_search_tiled  # noqa: E402
from hnsw_rs_tpu.models.hnsw import HNSW  # noqa: E402
from hnsw_rs_tpu.ops.distance import pairwise_l2sq_mxu, point_normsq  # noqa: E402
from hnsw_rs_tpu.ops.quant import dequantize, quantize  # noqa: E402
from hnsw_rs_tpu.utils.cache import enable_compile_cache  # noqa: E402
from hnsw_rs_tpu.utils.datasets import synthetic_clustered  # noqa: E402
from hnsw_rs_tpu.utils.device import nvidia_smi_cards  # noqa: E402

K = 10
GATE = 0.99  # recall@10 the serving path must reach
# (ef, max_iters) in ascending cost; the first that reaches GATE is used
LADDER = (
    (16, 8), (24, 10), (24, 12), (32, 16), (40, 20), (40, 24),
    (48, 24), (48, 28), (48, 32), (64, 40), (64, 56), (96, 80),
    (128, 112), (192, 200), (256, 280),
)
# the cluster-bulk build configuration of the 1M headline cell (bench.py)
CLUSTER_KWARGS = {"pool_p": 96, "points_per_cluster": 96, "fanout": 5,
                  "select_alg4": False, "merge_slots": 48}
# the rounding the f32 affine distance expansion may add, per entry,
# relative to |q|^2 + |x|^2 (TF32 contractions exceed it by ~100x)
REL_TOL = 1e-5
GLOVE_STORE = os.path.join(ROOT, "test-data", "store.txt")
GLOVE_QUERIES = os.path.join(ROOT, "test-data", "queries.txt")


class SmokeFailure(AssertionError):
    """A phase's check failed."""


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


class Run:
    """Emits one JSON line per phase with the card, timings and the
    compile seconds spent inside the phase."""

    def __init__(self, cards: list[str]):
        self.cards = cards
        self.compile_s = 0.0
        self.compiles = 0
        jax.monitoring.register_event_duration_secs_listener(self._on_event)

    def _on_event(self, event: str, duration: float, *args, **kwargs) -> None:
        if event == "/jax/core/compile/backend_compile_duration":
            self.compile_s += duration
            self.compiles += 1

    def phase(self, name: str, fn, *args, **kwargs) -> dict:
        t0, c0, n0 = time.perf_counter(), self.compile_s, self.compiles
        out = fn(*args, **kwargs)
        dev = jax.devices()[0]
        line = {
            "phase": name,
            "ok": True,
            "device_kind": dev.device_kind,
            "card": self.cards[0],
            **out,
            "phase_seconds": time.perf_counter() - t0,
            "compile_seconds": self.compile_s - c0,
            "compiles": self.compiles - n0,
        }
        print(json.dumps(line), flush=True)
        return out


def _peak_bytes(dev) -> int | None:
    stats = dev.memory_stats()
    return None if stats is None else stats.get("peak_bytes_in_use")


def _dequant_np(codes, scales) -> np.ndarray:
    """The stored f32 values (the library's ``dequantize``) on the host."""
    c = np.asarray(codes, np.float32)
    s = np.asarray(scales, np.float32)
    return c * s[:, 1:2] + s[:, 0:1]


def _topk_f64(q: np.ndarray, x: np.ndarray, k: int, chunk: int = 131072):
    """Exact float64 top-k (d2, ids) of ``q`` over ``x`` (both f64)."""
    q2 = np.sum(q * q, axis=1)[:, None]
    best_d = np.full((q.shape[0], 0), np.inf)
    best_i = np.zeros((q.shape[0], 0), np.int64)
    for lo in range(0, x.shape[0], chunk):
        xc = x[lo:lo + chunk]
        d = q2 + np.sum(xc * xc, axis=1)[None] - 2.0 * (q @ xc.T)
        kk = min(k, d.shape[1])
        part = np.argpartition(d, kk - 1, axis=1)[:, :kk]
        best_d = np.concatenate([best_d, np.take_along_axis(d, part, 1)], 1)
        best_i = np.concatenate([best_i, part + lo], 1)
        order = np.lexsort((best_i, best_d), axis=1)[:, :k]
        best_d = np.take_along_axis(best_d, order, 1)
        best_i = np.take_along_axis(best_i, order, 1)
    return best_d, best_i


# -- phases -----------------------------------------------------------------


def device_phase(need: int = 1, platform: str = "gpu",
                 cache_dir: str | None = None) -> dict:
    """Refuse to run anywhere but on ``need`` devices of ``platform``."""
    devs = jax.devices()
    check(devs[0].platform == platform,
          f"JAX found no {platform}: first device is {devs[0].platform!r} "
          f"({devs[0].device_kind})")
    check(len(devs) >= need, f"need {need} {platform} devices, "
          f"JAX sees {len(devs)}")
    return {
        "jax": jax.__version__,
        "xla_flags": os.environ.get("XLA_FLAGS", ""),
        "compile_cache": cache_dir,
        "platform": devs[0].platform,
        "count": len(devs),
    }


def parity_phase(train: np.ndarray, test: np.ndarray, n_pair: int = 131072,
                 nq_pair: int = 4096, nq_flat: int = 256,
                 glove_m: int = 12) -> dict:
    """Library kernels against float64 numpy at real widths, with JAX's
    default matmul precision, exactly as the library runs them."""
    out = {}
    # 1. the affine distance matmul: within REL_TOL of float64 truth
    xc, xs = quantize(jnp.asarray(train[:n_pair]))
    qq = dequantize(*quantize(jnp.asarray(test[:nq_pair])))
    got = np.asarray(jax.jit(pairwise_l2sq_mxu)(qq, xc, xs))
    x64 = _dequant_np(xc, xs).astype(np.float64)
    q64 = np.asarray(qq, np.float64)
    x2 = np.sum(x64 * x64, axis=1)
    worst = 0.0
    for lo in range(0, q64.shape[0], 512):
        qb = q64[lo:lo + 512]
        q2 = np.sum(qb * qb, axis=1)[:, None]
        ref = np.maximum(q2 + x2[None] - 2.0 * (qb @ x64.T), 0.0)
        worst = max(worst, float(np.max(
            np.abs(got[lo:lo + 512] - ref) / (REL_TOL * (q2 + x2[None]))
        )))
    check(worst <= 1.0, f"pairwise_l2sq_mxu error {worst:.3g}x the "
          f"{REL_TOL} tolerance: the contraction ran below f32")
    out["l2_shape"] = [int(q64.shape[0]), int(x64.shape[0]), int(x64.shape[1])]
    out["l2_err_over_tol"] = worst
    del got

    # 2. exact tiled flat top-k over the whole collection
    codes, scales = quantize(jnp.asarray(train))
    qf = dequantize(*quantize(jnp.asarray(test[:nq_flat])))
    _, ids = jax.jit(functools.partial(_flat_search_tiled, k=K))(
        qf, codes, scales, point_normsq(codes, scales))
    ids = np.asarray(ids)
    x64 = _dequant_np(codes, scales).astype(np.float64)
    q64 = np.asarray(qf, np.float64)
    ref_d, ref_i = _topk_f64(q64, x64, K)
    bad = 0
    for b in range(q64.shape[0]):
        if np.array_equal(ids[b], ref_i[b]):
            continue
        got_d = np.sum((x64[ids[b]] - q64[b]) ** 2, axis=1)
        tol = REL_TOL * (np.sum(q64[b] ** 2) + np.sum(x64[ids[b]] ** 2, 1))
        # a differing id must tie the reference's distance at that rank
        if len(set(ids[b].tolist())) != K or np.any(
                np.abs(got_d - ref_d[b]) > tol):
            bad += 1
    check(bad == 0, f"flat top-{K}: {bad}/{q64.shape[0]} queries differ "
          "from float64 truth beyond distance ties")
    out["flat_shape"] = [int(q64.shape[0]), int(x64.shape[0])]
    del x64, codes, scales

    # 3. the plain reference traversal against the scalar oracle
    out["traversal_mismatches"] = traversal_parity(glove_m)
    check(out["traversal_mismatches"] == 0,
          f"ann_search differs from the oracle on "
          f"{out['traversal_mismatches']} GloVe queries")
    return out


def traversal_parity(m: int = 12, ef: int = 64) -> int:
    """``search.ann_search`` (the jitted plain traversal) on the bundled
    GloVe set against ``tests/oracle.py``: greedy descent through the
    upper layers, then the flagged beam on layer 0. Returns the number
    of queries whose top-k ids differ other than at exact ties."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from oracle import beam_search_oracle, d2, greedy_oracle

    from hnsw_rs_tpu.search import ann_search
    from hnsw_rs_tpu.utils import load_glove_array

    _, store = load_glove_array(GLOVE_STORE)
    _, queries = load_glove_array(GLOVE_QUERIES)
    index = HNSW(m, dim=store.shape[1]).insert_bulk(store)
    n = len(index)
    codes, scales = index.points.codes[:n], index.points.scales[:n]
    adjs = tuple(a[:n] for a in index.graph.adjs)
    q = dequantize(*quantize(jnp.asarray(queries)))
    fn = jax.jit(functools.partial(ann_search, ef=ef, k=K, max_iters=4 * n))
    _, got = fn(adjs, codes, scales, q, jnp.asarray(index.params.ep, jnp.int32))
    got = np.asarray(got)
    X = _dequant_np(codes, scales)
    A = [np.asarray(a) for a in adjs]
    qn = np.asarray(q)
    bad = 0
    for b in range(qn.shape[0]):
        cur = index.params.ep
        for adj in reversed(A[1:]):
            cur = greedy_oracle(adj, X, qn[b], cur)[1]
        beam = beam_search_oracle(A[0], X, qn[b], [(d2(qn[b], X[cur]), cur)], ef)
        want = [i for _, i in beam[:K]]
        if got[b].tolist() == want:
            continue
        dg = [d2(qn[b], X[i]) for i in got[b]]
        if sorted(set(got[b].tolist())) != sorted(got[b].tolist()) or any(
                g != w for g, (w, _) in zip(dg, beam[:K])):
            bad += 1
    return bad


def hnsw_phase(train: np.ndarray, test: np.ndarray, m: int = 24,
               ef_cons: int = 128, pivots: int = 16384, n_recall: int = 4096,
               ladder=LADDER, cluster_kwargs=CLUSTER_KWARGS,
               n_insert: int = 64, n_reload: int = 256, seed: int = 0) -> dict:
    """The main path through the public ``HNSW`` API."""
    n, d = train.shape

    def build():
        t0 = time.perf_counter()
        idx = HNSW(m, ef_cons=ef_cons, dim=d)
        idx.insert_bulk(train, cluster_build=True,
                        cluster_kwargs=dict(cluster_kwargs))
        jax.block_until_ready(idx.graph.adjs)
        return idx, time.perf_counter() - t0

    first, cold_s = build()
    del first
    index, warm_s = build()
    check(len(index) == n, f"built {len(index)} of {n} points")

    # exact truth: the tiled flat search over the stored codes
    codes, scales = index.points.codes[:n], index.points.scales[:n]
    normsq = point_normsq(codes, scales)
    qr = dequantize(*quantize(jnp.asarray(test[:n_recall])))
    flat = jax.jit(functools.partial(_flat_search_tiled, k=K))
    truth = np.asarray(flat(qr, codes, scales, normsq)[1])
    t0 = time.perf_counter()
    jax.block_until_ready(flat(qr, codes, scales, normsq))
    flat_s = time.perf_counter() - t0

    index.finalize(pivots=pivots)
    tried, chosen = [], None
    for ef, mi in ladder:
        _, ids = index.ann_batch(test[:n_recall], K, ef, max_iters=mi)
        rec = recall_at_k(ids, truth, K)
        tried.append([ef, mi, rec])
        if rec >= GATE:
            chosen = (ef, mi, rec)
            break
    check(chosen is not None,
          f"no (ef, max_iters) reached recall@{K} {GATE}: {tried}")
    ef, mi, rec = chosen

    # the whole query batch through ann_batch (host in, host out) ...
    _, ids = index.ann_batch(test, K, ef, max_iters=mi)
    check(ids.shape == (test.shape[0], K) and ids.min() >= 0
          and ids.max() < n, f"bad ids from the {test.shape[0]}-query batch")
    batch_s = []
    for _ in range(3):
        t0 = time.perf_counter()
        index.ann_batch(test, K, ef, max_iters=mi)
        batch_s.append(time.perf_counter() - t0)
    # ... and the serving program alone on device-resident queries
    from hnsw_rs_tpu.models.hnsw import _ann_seeded_jit

    q_all = dequantize(*quantize(jnp.asarray(test)))
    serve = functools.partial(_ann_seeded_jit, index._packed0,
                              *index._pivots, q_all, ef, K, mi,
                              index.serve_expand)
    jax.block_until_ready(serve())
    device_s = []
    for _ in range(3):
        t0 = time.perf_counter()
        jax.block_until_ready(serve())
        device_s.append(time.perf_counter() - t0)
    del q_all

    # incremental insert: every new point is its own nearest neighbor
    rng = np.random.default_rng(seed + 7)
    new = (test[-n_insert:] + rng.normal(0, 0.01, (n_insert, d))
           ).astype(np.float32)
    new_ids = [index.insert_vec(v) for v in new]
    check(new_ids == list(range(n, n + n_insert)),
          f"insert_vec ids {new_ids[:3]}... expected from {n}")
    found = [int(index.ann_by_vector(v, K, ef=max(64, ef))[0]) for v in new]
    misses = sum(f != i for f, i in zip(found, new_ids))
    check(misses == 0, f"{misses}/{n_insert} inserted vectors not at rank 0")

    # save/load round trip answers identically
    qs = test[:n_reload]
    _, before = index.ann_batch(qs, K, ef)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        index.save(tmp)
        loaded = HNSW.load(tmp)
        io_s = time.perf_counter() - t0
    _, after = loaded.ann_batch(qs, K, ef)
    check(len(loaded) == n + n_insert and np.array_equal(before, after),
          "ann_batch ids differ after save/load")
    packed0 = index._packed0
    return {
        "n": n, "d": d, "m": m, "ef_cons": ef_cons, "pivots": pivots,
        "queries": int(test.shape[0]),
        "build_seconds_cold": cold_s,
        "build_seconds_warm": warm_s,
        "ladder": tried,
        "ef": ef, "max_iters": mi, "recall_at_10": rec,
        "ann_batch_seconds": batch_s,
        "qps_ann_batch": test.shape[0] / min(batch_s),
        "serve_device_seconds": device_s,
        "qps_device": test.shape[0] / min(device_s),
        "flat_tiled_seconds": flat_s,
        "flat_tiled_shape": [n_recall, n, d],
        "packed0_bytes": None if packed0 is None else int(packed0.nbytes),
        "insert_rank0": f"{n_insert - misses}/{n_insert}",
        "save_load_seconds": io_s,
        "peak_bytes_in_use": _peak_bytes(jax.devices()[0]),
        "observations_not_benchmark": True,
    }


def families_phase(train: np.ndarray, test: np.ndarray, m: int = 24,
                   ef_cons: int = 128, pivots: int = 2048,
                   cluster_kwargs=CLUSTER_KWARGS, pq_m: int = 24,
                   glove_ef: int = 100) -> dict:
    """Every other public index family answers; recall is reported
    against float64 truth, with no threshold."""
    from hnsw_rs_tpu.models.ivf import IVFFlatIndex
    from hnsw_rs_tpu.models.ivfpq import IVFPQIndex

    d = train.shape[1]
    codes, scales = quantize(jnp.asarray(train))
    q64 = np.asarray(dequantize(*quantize(jnp.asarray(test))), np.float64)
    _, truth = _topk_f64(q64, _dequant_np(codes, scales).astype(np.float64), K)
    del codes, scales
    out = {"n": int(train.shape[0]), "queries": int(test.shape[0])}

    flat = FlatIndex(d)
    flat.add(train)
    out["flat_recall"] = recall_at_k(flat.search(test, K)[1], truth, K)

    ivf = IVFFlatIndex(d)
    ivf.train_add(train)
    out["ivf_flat_recall"] = recall_at_k(ivf.search(test, K)[1], truth, K)

    m_pq = next(v for v in (16, 12, 8, 6, 4, 2, 1) if d % v == 0)
    ivfpq = IVFPQIndex(d, m_pq=m_pq, rerank=4 * K)
    ivfpq.train_add(train)
    out["ivf_pq_recall"] = recall_at_k(ivfpq.search(test, K)[1], truth, K)

    h = HNSW(m, ef_cons=ef_cons, dim=d)
    h.insert_bulk(train, cluster_build=True,
                  cluster_kwargs=dict(cluster_kwargs))
    h.finalize(pivots=pivots, pq_m=pq_m, pq_bits=4)
    out["hnsw_pq4_recall"] = recall_at_k(h.ann_batch(test, K, 64)[1], truth, K)

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = eval_glove_main(["--store", GLOVE_STORE, "--queries",
                              GLOVE_QUERIES, "--ef", str(glove_ef),
                              "--quiet"])
    check(rc == 0, f"eval_glove returned {rc}")
    rows = [ln.split() for ln in buf.getvalue().splitlines()]
    hits = [r for r in rows if len(r) == 3 and r[0] == str(glove_ef)]
    check(hits, f"eval_glove printed no ef={glove_ef} row")
    out["eval_glove_recall"] = float(hits[0][1])
    return out


def sharded_regime(n_shards: int, n_per_shard: int, d: int,
                   n_queries: int, seed: int):
    """``n_shards`` independent draws of the one-card clustered regime,
    concatenated so that each contiguous shard holds one of them: every
    card sees the 1M cell's data (clusters of ~100 points), queries come
    from all of them. (One ``synthetic_clustered`` over all points caps
    its cluster count, and a contiguous split would leave each shard a
    few dozen points per cluster — a different regime, in which the 1M
    cluster-build configuration does not reach the gate.)"""
    parts = [synthetic_clustered(n_per_shard, d,
                                 n_queries=n_queries // n_shards,
                                 seed=seed + s) for s in range(n_shards)]
    return (np.concatenate([p.train for p in parts]),
            np.concatenate([p.test for p in parts]))


def four_cards_phase(train: np.ndarray, test: np.ndarray, n_shards: int = 4,
                     m: int = 24, ef_cons: int = 128, pivots: int = 16384,
                     ladder=LADDER, cluster_kwargs=CLUSTER_KWARGS,
                     platform: str = "gpu") -> dict:
    """A ShardedHNSW with one shard per card, against exact truth over
    the whole collection."""
    from hnsw_rs_tpu.parallel.mesh import make_mesh
    from hnsw_rs_tpu.parallel.sharded import ShardedHNSW

    devs = [dv for dv in jax.devices() if dv.platform == platform]
    check(len(devs) >= n_shards, f"need {n_shards} {platform} devices, "
          f"have {len(devs)}")
    n, d = train.shape
    mesh = make_mesh(n_data=1, n_shard=n_shards, devices=devs)
    t0 = time.perf_counter()
    index = ShardedHNSW(m, d, n_shards=n_shards, ef_cons=ef_cons, mesh=mesh)
    index.insert_bulk(train, cluster_build=True,
                      cluster_kwargs=dict(cluster_kwargs))
    jax.block_until_ready(index._stacked["adjs"])
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    index.finalize(pivots=pivots)
    jax.block_until_ready(index._packed)
    finalize_s = time.perf_counter() - t0

    # every per-shard array holds exactly one shard on each card
    st = index._stacked
    placed = {"codes": st["codes"], "scales": st["scales"],
              "gids": st["gids"], "packed0": index._packed[0],
              "pivot_vecs": index._packed[2]}
    placed.update({f"adj_{i}": a for i, a in enumerate(st["adjs"])})
    want = {dv.id for dv in devs[:n_shards]}
    for name, arr in placed.items():
        shards = arr.addressable_shards
        check({s.device.id for s in shards} == want
              and all(s.data.shape[0] == 1 for s in shards),
              f"{name} is not one shard per card: "
              f"{[(s.device.id, s.data.shape) for s in shards]}")

    # exact truth over all n points, on the first card
    codes, scales = quantize(jnp.asarray(train))
    normsq = point_normsq(codes, scales)
    flat = jax.jit(functools.partial(_flat_search_tiled, k=K))
    truth = np.concatenate([
        np.asarray(flat(dequantize(*quantize(jnp.asarray(test[lo:lo + 4096]))),
                        codes, scales, normsq)[1])
        for lo in range(0, test.shape[0], 4096)
    ])
    del codes, scales, normsq

    tried, chosen = [], None
    for ef, mi in ladder:
        t0 = time.perf_counter()
        _, ids = index.ann_batch(test, K, ef, max_iters=mi)
        rec = recall_at_k(ids, truth, K)
        tried.append([ef, mi, rec, time.perf_counter() - t0])
        if rec >= GATE:
            chosen = (ef, mi, rec)
            break
    check(chosen is not None,
          f"no (ef, max_iters) reached recall@{K} {GATE}: {tried}")
    ef, mi, rec = chosen
    t0 = time.perf_counter()
    index.ann_batch(test, K, ef, max_iters=mi)
    warm_s = time.perf_counter() - t0
    return {
        "n": n, "d": d, "shards": n_shards, "queries": int(test.shape[0]),
        "cards": [dv.device_kind for dv in devs[:n_shards]],
        "build_seconds": build_s, "finalize_seconds": finalize_s,
        "ladder": tried, "ef": ef, "max_iters": mi, "recall_at_10": rec,
        "ann_batch_seconds_warm": warm_s,
        "shards_on_distinct_cards": True,
        "peak_bytes_in_use": [_peak_bytes(dv) for dv in devs[:n_shards]],
        "observations_not_benchmark": True,
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the synthetic data")
    p.add_argument("--four-cards", action="store_true",
                   help="run only the four-card ShardedHNSW phase")
    args = p.parse_args(argv)

    cache_dir = enable_compile_cache()
    run = Run(nvidia_smi_cards())
    need = 4 if args.four_cards else 1
    run.phase("device", device_phase, need, "gpu", cache_dir)
    if args.four_cards:
        train, test = sharded_regime(4, 1_000_000, 96, 8192, args.seed)
        run.phase("four_cards", four_cards_phase, train, test)
    else:
        ds = synthetic_clustered(1_000_000, 96, n_queries=32768,
                                 seed=args.seed)
        run.phase("parity", parity_phase, ds.train, ds.test)
        run.phase("hnsw", hnsw_phase, ds.train, ds.test, seed=args.seed)
        del ds
        small = synthetic_clustered(100_000, 96, n_queries=1024,
                                    seed=args.seed + 1)
        run.phase("families", families_phase, small.train, small.test)
    for card in run.cards:
        print(f"card: {card}")
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
