"""Concurrent (shard_map) sharded build vs the sequential per-shard host
builder: same recall class, valid global ids, balanced shard occupancy."""

import numpy as np

from hnsw_rs_tpu import FlatIndex
from hnsw_rs_tpu.parallel import ShardedHNSW, make_mesh
from hnsw_rs_tpu.utils import gen_rand_vecs

N, DIM, M = 480, 16, 8


def recall(ids, truth):
    return np.mean([len(set(a) & set(t)) / len(t) for a, t in zip(ids, truth)])


def test_concurrent_matches_sequential_quality():
    vecs = gen_rand_vecs(N, DIM, seed=0)
    queries = gen_rand_vecs(24, DIM, seed=1)
    flat = FlatIndex(DIM)
    flat.add(vecs)
    _, truth = flat.search(queries, 10, exact=True)

    mesh = make_mesh(n_data=1, n_shard=4)
    conc = ShardedHNSW(M, DIM, n_shards=4, mesh=mesh)
    conc.insert_bulk(vecs, concurrent=True)
    assert len(conc) == N
    _, ids_c = conc.ann_batch(queries, 10, 60)
    rc = recall(ids_c, truth)

    seq = ShardedHNSW(M, DIM, n_shards=4, mesh=make_mesh(1, 4))
    seq.insert_bulk(vecs, concurrent=False)
    _, ids_s = seq.ann_batch(queries, 10, 60)
    rs = recall(ids_s, truth)

    # measured headroom: both paths sit at 1.0 on this config — keep the
    # gate tight so a real quality regression cannot hide in slack
    assert rc > 0.97, f"concurrent recall {rc}"
    assert rc >= rs - 0.02, f"concurrent {rc} vs sequential {rs}"
    assert np.all((ids_c >= 0) & (ids_c < N))


def test_concurrent_build_self_queries():
    vecs = gen_rand_vecs(N, DIM, seed=2)
    mesh = make_mesh(n_data=2, n_shard=4)
    sharded = ShardedHNSW(M, DIM, n_shards=4, mesh=mesh)
    sharded.insert_bulk(vecs)
    _, ids = sharded.ann_batch(vecs[:64], 1, 40)
    assert np.mean(ids[:, 0] == np.arange(64)) > 0.97


def test_cluster_build_kwargs_route_to_host_builder():
    """cluster_build=True with concurrent=False takes the per-shard host
    builder and lands in the same recall family as the wave paths."""
    vecs = gen_rand_vecs(N, DIM, seed=4)
    queries = gen_rand_vecs(24, DIM, seed=5)
    flat = FlatIndex(DIM)
    flat.add(vecs)
    _, truth = flat.search(queries, 10, exact=True)

    idx = ShardedHNSW(M, DIM, n_shards=4, mesh=make_mesh(1, 4))
    idx.insert_bulk(vecs, cluster_build=True, concurrent=False)
    assert len(idx) == N and len(idx.shards) == 4  # sequential path taken
    _, ids = idx.ann_batch(queries, 10, 60)
    r = recall(ids, truth)
    assert r > 0.95, f"cluster sharded recall {r}"
    # seeded serving still composes on top
    idx.finalize(pivots=64)
    _, ids2 = idx.ann_batch(queries, 10, 60)
    assert recall(ids2, truth) > 0.9


def test_prep_shard_per_shard_granularity():
    """The per-shard prep k-means clusters every shard at the same
    points-per-cluster granularity: a shard with 1/4 the members must use
    ~1/4 the centroids (the rest are dead sentinels), not the global k
    (over-fragmented ~1-point pools) nor a clamp-merged megacluster (the
    round-3 bug: every cluster id >= ksh collapsed into ksh-1)."""
    import jax.numpy as jnp

    from hnsw_rs_tpu.ops.quant import quantize
    from hnsw_rs_tpu.parallel.sharded_cluster import _prep_shard

    rng = np.random.default_rng(11)
    n, d, ppc = 512, 16, 16
    codes, scales = quantize(jnp.asarray(rng.random((n, d), np.float32)))
    k = -(-n // ppc)  # global k from the largest shard

    # small shard: 128 live members -> ksh = 8 effective centroids
    rows = np.full(n, -1, np.int32)
    rows[:128] = np.arange(128)
    assign, _ = _prep_shard(
        codes, scales, jnp.asarray(rows), jnp.int32(128),
        k=k, iters=2, train_per_cluster=8, chunk=256, ppc=ppc,
    )
    live = np.asarray(assign)[:128]
    ksh = -(-128 // ppc)
    assert live.max() < ksh, f"assignment {live.max()} >= ksh {ksh}"
    assert len(np.unique(live)) >= ksh // 2, "degenerate clustering"

    # full shard: all k centroids live, same as the single-chip kmeans
    full_assign, _ = _prep_shard(
        codes, scales, jnp.asarray(np.arange(n, dtype=np.int32)),
        jnp.int32(n), k=k, iters=2, train_per_cluster=8, chunk=256, ppc=ppc,
    )
    assert len(np.unique(np.asarray(full_assign))) > k // 2


def test_concurrent_cluster_build_uneven_shards():
    """Uneven partition_bounds: the shard_map'd cluster build must stay
    in the sequential path's recall family when shard sizes differ 5x
    (the round-3 clamp bug degraded exactly this case)."""
    vecs = gen_rand_vecs(960, DIM, seed=8)
    queries = gen_rand_vecs(24, DIM, seed=9)
    flat = FlatIndex(DIM)
    flat.add(vecs)
    _, truth = flat.search(queries, 10, exact=True)

    idx = ShardedHNSW(M, DIM, n_shards=4, mesh=make_mesh(1, 4))
    idx.insert_bulk(
        vecs, cluster_build=True, partition_bounds=[0, 600, 760, 880, 960],
        cluster_kwargs=dict(points_per_cluster=24, fanout=4, pool_p=64),
    )
    assert len(idx) == 960
    _, ids = idx.ann_batch(queries, 10, 60)
    r = recall(ids, truth)
    assert r > 0.95, f"uneven-shard cluster recall {r}"
    assert np.all((ids >= 0) & (ids < 960))

    # self-queries from the smallest and largest shards both resolve
    _, ids2 = idx.ann_batch(np.concatenate([vecs[:32], vecs[-32:]]), 1, 40)
    want = np.concatenate([np.arange(32), np.arange(960 - 32, 960)])
    assert np.mean(ids2[:, 0] == want) > 0.95


def test_concurrent_cluster_build():
    """cluster_build=True + concurrent=True: every shard cluster-builds
    at once under shard_map (parallel.sharded_cluster) — same recall
    family as the sequential per-shard cluster builds, valid global ids,
    and the seeded serving stack composes on top of the per-shard
    cluster representatives."""
    vecs = gen_rand_vecs(N, DIM, seed=6)
    queries = gen_rand_vecs(24, DIM, seed=7)
    flat = FlatIndex(DIM)
    flat.add(vecs)
    _, truth = flat.search(queries, 10, exact=True)

    idx = ShardedHNSW(M, DIM, n_shards=4, mesh=make_mesh(1, 4))
    idx.insert_bulk(
        vecs, cluster_build=True,
        cluster_kwargs=dict(points_per_cluster=24, fanout=4, pool_p=64),
    )
    assert len(idx) == N and idx.shards == []  # concurrent path taken
    assert idx._cluster_reps is not None
    _, ids = idx.ann_batch(queries, 10, 60)
    r = recall(ids, truth)
    assert r > 0.95, f"concurrent cluster sharded recall {r}"
    assert np.all((ids >= 0) & (ids < N))

    seq = ShardedHNSW(M, DIM, n_shards=4, mesh=make_mesh(1, 4))
    seq.insert_bulk(
        vecs, cluster_build=True, concurrent=False,
        cluster_kwargs=dict(points_per_cluster=24, fanout=4, pool_p=64),
    )
    _, ids_s = seq.ann_batch(queries, 10, 60)
    rs = recall(ids_s, truth)
    assert r >= rs - 0.03, f"concurrent {r} vs sequential {rs}"

    # seeded serving over the concurrent build's cluster reps
    idx.finalize(pivots=64)
    _, ids2 = idx.ann_batch(queries, 10, 60)
    assert recall(ids2, truth) > 0.9

    # self-queries resolve to their own global id
    _, ids3 = idx.ann_batch(vecs[:64], 1, 40)
    assert np.mean(ids3[:, 0] == np.arange(64)) > 0.95


def test_concurrent_cluster_build_recall_at_scale():
    """The shard-concurrent cluster build gated against a
    flat exact oracle at >=10k points (the small-N tests can hide
    cluster-granularity pathologies — the round-3 megacluster bug was
    invisible below ~1k). 8 shards, clustered data, seeded serving (the
    production mode for cluster-built graphs). ~40 s on the virtual mesh
    warm; the module's persistent compile cache amortizes the cold run."""
    from hnsw_rs_tpu.utils.datasets import synthetic_clustered

    n, d, k = 12288, 24, 10
    ds = synthetic_clustered(n, d, n_queries=64, seed=13)
    flat = FlatIndex(d)
    flat.add(ds.train)
    _, truth = flat.search(ds.test, k, exact=True)

    idx = ShardedHNSW(12, d, n_shards=8, mesh=make_mesh(1, 8))
    idx.insert_bulk(
        ds.train, cluster_build=True,
        cluster_kwargs=dict(points_per_cluster=64, fanout=4, pool_p=96,
                            select_alg4=False, merge_slots=24),
    )
    assert len(idx) == n
    idx.finalize(pivots=n // 24)
    _, ids = idx.ann_batch(ds.test, k, 64)
    r = recall(ids, truth)
    assert r >= 0.95, f"sharded cluster recall at {n}: {r}"
    assert np.all((ids >= 0) & (ids < n))
