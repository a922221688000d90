"""Mesh-parallel tests on the 8-device virtual CPU mesh: query DP over a
replicated index and sharded sub-index search with distributed top-k merge
(the device-native analogue of the reference's concurrency test,
``graph/src/graph.rs:463-486``)."""

import numpy as np
import jax

from hnsw_rs_tpu import HNSW, FlatIndex
from hnsw_rs_tpu.parallel import ReplicatedHNSW, ShardedHNSW, make_mesh
from hnsw_rs_tpu.utils import gen_rand_vecs

N, DIM, M = 400, 16, 8


def test_mesh_has_8_devices():
    assert len(jax.devices()) == 8


def test_replicated_dp_matches_single_device():
    vecs = gen_rand_vecs(N, DIM, seed=0)
    index = HNSW(M, dim=DIM)
    index.insert_bulk(vecs)
    queries = gen_rand_vecs(16, DIM, seed=1)
    d1, i1 = index.ann_batch(queries, 5, 40)
    mesh = make_mesh(n_data=8, n_shard=1)
    rep = ReplicatedHNSW(index, mesh)
    d2, i2 = rep.ann_batch(queries, 5, 40)
    np.testing.assert_array_equal(i1, i2)
    np.testing.assert_allclose(d1, d2, rtol=1e-6)


def test_sharded_index_recall():
    vecs = gen_rand_vecs(N, DIM, seed=2)
    queries = gen_rand_vecs(16, DIM, seed=3)
    mesh = make_mesh(n_data=2, n_shard=4)
    sharded = ShardedHNSW(M, DIM, n_shards=4, mesh=mesh)
    sharded.insert_bulk(vecs)
    assert len(sharded) == N
    d, ids = sharded.ann_batch(queries, 10, 60)
    # ground truth over the same quantized space
    flat = FlatIndex(DIM)
    flat.add(vecs)
    _, truth = flat.search(queries, 10, exact=True)
    recall = np.mean(
        [len(set(a) & set(b)) / 10.0 for a, b in zip(ids, truth)]
    )
    assert recall > 0.95, f"sharded recall {recall}"
    # distances sorted ascending, global ids valid
    assert np.all(np.diff(d, axis=1) >= 0)
    assert np.all((ids >= 0) & (ids < N))


def test_sharded_self_queries():
    vecs = gen_rand_vecs(N, DIM, seed=4)
    mesh = make_mesh(n_data=1, n_shard=8)
    sharded = ShardedHNSW(M, DIM, n_shards=8, mesh=mesh)
    sharded.insert_bulk(vecs)
    _, ids = sharded.ann_batch(vecs[:64], 1, 40)
    hit = np.mean(ids[:, 0] == np.arange(64))
    assert hit > 0.97, f"sharded self-recall {hit}"

def test_replicated_cosine_matches_single_device():
    # regression: ReplicatedHNSW used to skip cosine query normalization,
    # returning raw-L2 distances instead of the 2-2cos values
    vecs = gen_rand_vecs(N, DIM, seed=7) + 0.5
    index = HNSW(M, dim=DIM, metric="cosine")
    index.insert_bulk(vecs)
    queries = gen_rand_vecs(16, DIM, seed=8) * 3.0  # deliberately unnormalized
    d1, i1 = index.ann_batch(queries, 5, 40)
    rep = ReplicatedHNSW(index, make_mesh(n_data=8, n_shard=1))
    d2, i2 = rep.ann_batch(queries, 5, 40)
    np.testing.assert_array_equal(i1, i2)
    np.testing.assert_allclose(d1, d2, rtol=1e-5)

def test_sharded_rebuild_serves_new_index():
    # regression: the query jit used to reach the stacked arrays through a
    # static `self`, so a second insert_bulk served the STALE executable
    from hnsw_rs_tpu.parallel import ShardedHNSW

    mesh = make_mesh(n_data=1, n_shard=4)
    idx = ShardedHNSW(M, DIM, n_shards=4, mesh=mesh)
    first = gen_rand_vecs(128, DIM, seed=20)
    idx.insert_bulk(first)
    q = first[:8]
    d1, i1 = idx.ann_batch(q, 1, 32)
    np.testing.assert_array_equal(i1[:, 0], np.arange(8))  # self-match
    # rebuild with DIFFERENT vectors; the same queries must now resolve
    # against the new collection (shifted so old self-matches are wrong)
    second = gen_rand_vecs(128, DIM, seed=21) + 2.0
    idx.insert_bulk(second)
    d2, i2 = idx.ann_batch(second[:8], 1, 32)
    np.testing.assert_array_equal(i2[:, 0], np.arange(8))
    assert float(d2[:, 0].max()) < 1e-3  # exact self-match on NEW data


def _recall(ids, truth, k=10):
    return float(np.mean([len(set(a) & set(b)) / k for a, b in zip(ids, truth)]))


def test_sharded_seeded_serving_and_incremental_add(tmp_path):
    # round-2 serving stack (packed rows + pivot seeding) lifted into the
    # scale-out path, plus rebuild-free incremental add and save/load
    vecs = gen_rand_vecs(N, DIM, seed=7)
    queries = gen_rand_vecs(16, DIM, seed=8)
    mesh = make_mesh(n_data=2, n_shard=4)
    sharded = ShardedHNSW(M, DIM, n_shards=4, mesh=mesh)
    sharded.insert_bulk(vecs)
    flat = FlatIndex(DIM)
    flat.add(vecs)
    _, truth = flat.search(queries, 10, exact=True)
    _, ids_plain = sharded.ann_batch(queries, 10, 60)
    r_plain = _recall(ids_plain, truth)

    sharded.finalize(pivots=64)
    assert sharded._packed is not None
    _, ids_seeded = sharded.ann_batch(queries, 10, 60)
    r_seeded = _recall(ids_seeded, truth)
    # seeded-sharded >= plain-sharded recall at equal ef (the pivot seeds
    # start the beam from ef good candidates instead of one entry point)
    assert r_seeded >= r_plain - 1e-9, (r_seeded, r_plain)
    assert r_seeded > 0.9

    # rebuild-free incremental add: stable new gids, findable immediately
    more = gen_rand_vecs(48, DIM, seed=9)
    gids = sharded.add(more)
    assert len(sharded) == N + 48
    assert gids[0] == N and gids[-1] == N + 47
    _, self_ids = sharded.ann_batch(more[:16], 1, 40)
    assert np.mean(self_ids[:, 0] == gids[:16]) >= 0.9
    # ground truth over the EXTENDED collection (new points can displace
    # old true neighbors — comparing vs the stale truth would undercount)
    flat2 = FlatIndex(DIM)
    flat2.add(np.concatenate([vecs, more]))
    _, truth2 = flat2.search(queries, 10, exact=True)
    # the stale pack is bypassed, never served (plain path answers)
    _, ids_after = sharded.ann_batch(queries, 10, 60)
    assert _recall(ids_after, truth2) >= r_plain - 0.05
    # re-finalize restores the seeded path over the grown index
    sharded.finalize(pivots=64)
    _, ids_re = sharded.ann_batch(queries, 10, 60)
    assert _recall(ids_re, truth2) >= r_plain - 0.05

    # save/load round-trip answers identically
    sharded.save(str(tmp_path / "sh"))
    back = ShardedHNSW.load(str(tmp_path / "sh"), mesh=mesh)
    assert len(back) == N + 48
    _, ids_back = back.ann_batch(queries, 10, 60)
    np.testing.assert_array_equal(ids_back, ids_after)
    back.finalize(pivots=64)
    _, ids_back_seeded = back.ann_batch(queries, 10, 60)
    np.testing.assert_array_equal(ids_back_seeded, ids_re)


def test_sharded_add_balances_shards():
    vecs = gen_rand_vecs(N, DIM, seed=10)
    mesh = make_mesh(n_data=1, n_shard=8)
    sharded = ShardedHNSW(M, DIM, n_shards=8, mesh=mesh)
    sharded.insert_bulk(vecs)
    before = sharded._counts.copy()
    sharded.add(gen_rand_vecs(80, DIM, seed=11))
    after = sharded._counts
    assert int(after.sum()) == N + 80
    # round-robin from least-loaded: spread stays within 1 of each other
    # relative to the pre-add spread
    assert int(after.max() - after.min()) <= int(before.max() - before.min()) + 1


def test_sharded_cover_fill_pivots():
    """finalize(pivot_fill="cover") fills each shard's pivot budget with
    one shard_map'd k-center program: budgets met (min(pivots, count)),
    no duplicates, no dead rows, and seeded recall holds (the sharded
    analogue of HNSW.finalize's coverage fill, ops/cover.py)."""
    vecs = gen_rand_vecs(480, DIM, seed=7)
    queries = gen_rand_vecs(24, DIM, seed=8)
    mesh = make_mesh(n_data=1, n_shard=4)
    sharded = ShardedHNSW(M, DIM, n_shards=4, mesh=mesh)
    # skewed placement: per-shard budgets differ (64/64/50/30)
    sharded.insert_bulk(
        vecs, concurrent=False, partition_bounds=[0, 300, 400, 450, 480]
    )
    flat = FlatIndex(DIM)
    flat.add(vecs)
    _, truth = flat.search(queries, 10, exact=True)

    sharded.finalize(pivots=64, pivot_cover=0.5)
    pid = np.asarray(sharded._packed[1])
    for s, row in enumerate(pid):
        live = row[row >= 0]
        k = int(sharded._counts[s])
        assert live.size == min(64, k), (s, live.size, k)
        assert np.unique(live).size == live.size
        assert live.max(initial=0) < k
    _, ids = sharded.ann_batch(queries, 10, 60)
    assert _recall(ids, truth) > 0.9
