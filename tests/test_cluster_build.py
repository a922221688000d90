"""Cluster-bulk builder (build_cluster.py): quality and invariants.

The cluster build is recall-GATED, not structure-pinned (module
docstring): these tests assert serving recall lands in the wave build's
family on clustered data, plus the structural invariants the apply
machinery must uphold (no self-loops, no duplicate row entries, no
orphans, in-degree ledger consistent with the adjacency).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from hnsw_rs_tpu import HNSW
from hnsw_rs_tpu.models.flat import _flat_search_tiled
from hnsw_rs_tpu.ops.distance import point_normsq
from hnsw_rs_tpu.ops.quant import dequantize, quantize
from hnsw_rs_tpu.utils.datasets import synthetic_clustered

N, D, K = 4000, 32, 10


@pytest.fixture(scope="module")
def built():
    ds = synthetic_clustered(N, D, n_queries=128, seed=11)
    idx = HNSW(12, ef_cons=48, dim=D)
    idx.insert_bulk(ds.train, cluster_build=True)
    qq = dequantize(*quantize(jnp.asarray(ds.test)))
    normsq = point_normsq(idx.points.codes, idx.points.scales)
    _, ti = jax.jit(functools.partial(_flat_search_tiled, k=K))(
        qq, idx.points.codes, idx.points.scales, normsq
    )
    truth = np.asarray(ti)[:, :K]
    return ds, idx, truth


def _recall(idx, ds, truth, ef):
    _, ids = idx.ann_batch(np.asarray(ds.test), K, ef)
    return float(np.mean([len(set(a) & set(t)) / K
                          for a, t in zip(ids, truth)]))


def test_cluster_build_recall_in_wave_family(built):
    ds, idx, truth = built
    # wave build on this data/config measures ~0.99 at ef=32; the cluster
    # build must land in the same family (gate set with slack for the
    # recall-gated, structure-free contract)
    assert _recall(idx, ds, truth, 32) >= 0.95
    assert _recall(idx, ds, truth, 64) >= 0.97


def test_cluster_rows_are_sets_without_self_loops(built):
    _, idx, _ = built
    adj0 = np.asarray(idx.graph.get_layer(0))
    n = len(idx)
    assert not np.any(adj0 == np.arange(n)[:, None]), "self-loop"
    for r in range(0, n, 97):  # sampled rows: no duplicate ids
        row = adj0[r][adj0[r] >= 0]
        assert row.size == np.unique(row).size, f"dup in row {r}"


def test_cluster_indeg_ledger_matches_adjacency(built):
    _, idx, _ = built
    adj0 = np.asarray(idx.graph.get_layer(0))
    n = len(idx)
    indeg = np.zeros(n, np.int64)
    np.add.at(indeg, adj0[adj0 >= 0], 1)
    assert np.array_equal(np.asarray(idx.graph.indeg(0)[:n]), indeg)
    # every connected node reachable-in (no orphans): outdeg>0 -> indeg>0
    outdeg = (adj0 >= 0).sum(1)
    assert not np.any((outdeg > 0) & (indeg == 0)), "orphan"


def test_cluster_build_seeded_serving_and_persistence(built, tmp_path):
    ds, idx, truth = built
    idx.finalize(pivots=256)
    r = _recall(idx, ds, truth, 48)
    assert r >= 0.95
    idx.save(str(tmp_path / "cl"))
    idx2 = HNSW.load(str(tmp_path / "cl"))
    idx2.finalize(pivots=256)
    assert _recall(idx2, ds, truth, 48) == r


def test_cluster_build_noalg4_recall_and_invariants():
    """select_alg4=False (the bench.py headline config): nearest-m
    select, with ALL diversity pruning left to the merge union chain.
    Measured at 1M as unchanged-or-better recall at a faster select;
    this pins the small-N recall
    family plus the row invariants for that path."""
    ds = synthetic_clustered(N, D, n_queries=128, seed=11)
    idx = HNSW(12, ef_cons=48, dim=D)
    idx.insert_bulk(ds.train, cluster_build=True,
                    cluster_kwargs={"select_alg4": False})
    qq = dequantize(*quantize(jnp.asarray(ds.test)))
    normsq = point_normsq(idx.points.codes, idx.points.scales)
    _, ti = jax.jit(functools.partial(_flat_search_tiled, k=K))(
        qq, idx.points.codes, idx.points.scales, normsq
    )
    truth = np.asarray(ti)[:, :K]
    assert _recall(idx, ds, truth, 32) >= 0.95
    adj0 = np.asarray(idx.graph.get_layer(0))[: len(idx)]
    n = len(idx)
    assert not np.any(adj0 == np.arange(n)[:, None]), "self-loop"
    outdeg = (adj0 >= 0).sum(1)
    indeg = np.zeros(n, np.int64)
    np.add.at(indeg, adj0[adj0 >= 0], 1)
    assert not np.any((outdeg > 0) & (indeg == 0)), "orphan"
    for r in range(0, n, 97):
        row = adj0[r][adj0[r] >= 0]
        assert row.size == np.unique(row).size, f"dup in row {r}"


def test_cluster_overflow_chunks_cover_every_point():
    """Megacluster regression: members beyond 2*smax per cluster were
    silently dropped (empty rows, unreachable points — found at 1M as
    ~10% coverage loss). A tiny smax_headroom forces every cluster into
    multiple overflow chunks; every point must still get a row."""
    ds = synthetic_clustered(3000, 24, n_queries=64, seed=13)
    idx = HNSW(8, ef_cons=32, dim=24)
    idx.insert_bulk(
        ds.train, cluster_build=True,
        cluster_kwargs={"smax_headroom": 0.2, "points_per_cluster": 1024},
    )
    adj0 = np.asarray(idx.graph.get_layer(0))[: len(idx)]
    outdeg = (adj0 >= 0).sum(1)
    assert int((outdeg == 0).sum()) == 0, "dropped overflow members"
    for r in range(0, len(idx), 131):  # rows stay duplicate-free
        row = adj0[r][adj0[r] >= 0]
        assert row.size == np.unique(row).size
    qq = dequantize(*quantize(jnp.asarray(ds.test)))
    normsq = point_normsq(idx.points.codes, idx.points.scales)
    _, ti = jax.jit(functools.partial(_flat_search_tiled, k=K))(
        qq, idx.points.codes, idx.points.scales, normsq
    )
    truth = np.asarray(ti)[:, :K]
    r = _recall(idx, ds, truth, 48)
    assert r >= 0.9, r


def test_exact_sel_step_matches_numpy_oracle():
    """_exact_sel_step (the small-layer path): with select_alg4=False
    the selection must be exactly the m nearest OTHER members in
    quantized space, (d2, id) lex-ordered, PAD-padded — checked against
    a brute-force numpy oracle, including pad query lanes and member
    pads."""
    from hnsw_rs_tpu.build_cluster import _exact_sel_step
    from hnsw_rs_tpu.ops.topk import PAD_ID

    rng = np.random.default_rng(7)
    n, d, m = 61, 8, 5
    vecs = rng.standard_normal((n, d)).astype(np.float32)
    codes, scales = quantize(jnp.asarray(vecs))
    deq = np.asarray(dequantize(codes, scales), np.float64)

    # members: a strided subset, padded to 64; queries: all members
    # (+ two pad lanes)
    mem = np.arange(0, n, 2, dtype=np.int32)  # 31 members
    mem_pad = np.full((64,), -1, np.int32)
    mem_pad[: mem.size] = mem
    qids = np.full((mem.size + 2,), -1, np.int32)
    qids[: mem.size] = mem

    qflat, sel_d2, sel_ids = _exact_sel_step(
        codes, scales, jnp.asarray(qids), jnp.asarray(mem_pad),
        m=m, pool_p=16, select_alg4=False,
    )
    sel_d2, sel_ids = np.asarray(sel_d2), np.asarray(sel_ids)
    assert np.array_equal(np.asarray(qflat), qids)
    for i, q in enumerate(qids):
        if q < 0:
            assert np.all(sel_ids[i] == PAD_ID), "pad lane must stay PAD"
            continue
        others = mem[mem != q]
        d2 = np.sum((deq[others] - deq[q]) ** 2, axis=1)
        order = np.lexsort((others, d2))[:m]
        assert np.array_equal(sel_ids[i], others[order]), f"query {q}"
        np.testing.assert_allclose(sel_d2[i], d2[order], rtol=1e-5)
