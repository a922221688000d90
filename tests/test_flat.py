"""FlatIndex (exact brute force) against a numpy oracle, and the topk /
graph primitives."""

import numpy as np
import jax.numpy as jnp
import pytest

from hnsw_rs_tpu import FlatIndex
from hnsw_rs_tpu.errors import DimensionMismatch, SelfConnection
from hnsw_rs_tpu.graphs import LayeredGraph, degrees, empty_adjacency
from hnsw_rs_tpu.ops import dedup_ids, quantize, dequantize, topk_dist_id
from hnsw_rs_tpu.utils import brute_force_nns, gen_rand_vecs


def numpy_oracle(queries, store, k):
    """Exact top-k over quantized space, ties by id, pure numpy."""
    qs = np.asarray(dequantize(*quantize(jnp.asarray(queries))))
    xs = np.asarray(dequantize(*quantize(jnp.asarray(store))))
    d2 = np.sum((qs[:, None, :] - xs[None, :, :]) ** 2, axis=-1)
    order = np.lexsort((np.arange(store.shape[0])[None, :].repeat(len(qs), 0), d2), axis=-1)
    return order[:, :k]


def test_flat_matches_numpy_oracle():
    store = gen_rand_vecs(500, 32, seed=0)
    queries = gen_rand_vecs(20, 32, seed=1)
    idx = FlatIndex(32)
    ids = idx.add(store)
    assert len(idx) == 500 and ids[-1] == 499
    expect = numpy_oracle(queries, store, 10)
    _, got_exact = idx.search(queries, 10, exact=True)
    np.testing.assert_array_equal(got_exact, expect)
    # matmul form: same set (float assoc. differences may permute near-ties)
    _, got_mxu = idx.search(queries, 10)
    overlap = np.mean(
        [len(set(a) & set(b)) / 10.0 for a, b in zip(got_mxu, expect)]
    )
    assert overlap > 0.99


def test_brute_force_nns_helper():
    store = gen_rand_vecs(200, 16, seed=2)
    queries = gen_rand_vecs(8, 16, seed=3)
    codes, scales = quantize(jnp.asarray(store))
    got = brute_force_nns(queries, codes, scales, 5)
    expect = numpy_oracle(queries, store, 5)
    np.testing.assert_array_equal(got, expect)


def test_flat_dim_mismatch_raises():
    idx = FlatIndex(8)
    idx.add(gen_rand_vecs(10, 8))
    with pytest.raises(DimensionMismatch):
        idx.add(gen_rand_vecs(10, 16))


def test_topk_tie_break_by_id():
    # equal distances, different ids coexist and order by id
    # (the Dist contract, graph/src/dist.rs:30-38 and results.rs:219-231)
    d = jnp.asarray([[0.5, 0.0, 0.5, 0.0]])
    i = jnp.asarray([[3, 4, 1, 2]], dtype=jnp.int32)
    td, ti = topk_dist_id(d, i, 4)
    np.testing.assert_array_equal(np.asarray(ti), [[2, 4, 1, 3]])
    np.testing.assert_allclose(np.asarray(td), [[0.0, 0.0, 0.5, 0.5]])


def test_dedup_ids():
    d = jnp.asarray([[0.1, 0.2, 0.1, 0.3]])
    i = jnp.asarray([[7, 5, 7, 5]], dtype=jnp.int32)
    dd, di = dedup_ids(d, i)
    kept = np.asarray(di)[np.isfinite(np.asarray(dd))]
    assert sorted(kept.tolist()) == [5, 7]


def test_graph_edge_symmetry_and_removal():
    g = LayeredGraph(m=4, n=10)
    g.ensure_level(0)
    g.add_edge(0, 1, 2)
    g.add_edge(0, 1, 3)
    assert set(g.neighbors(0, 1)) == {2, 3}
    assert set(g.neighbors(0, 2)) == {1}
    # no one-way connections (graph/src/graph.rs:306-315)
    for a in range(10):
        for b in g.neighbors(0, a):
            assert a in g.neighbors(0, int(b))
    g.remove_edge(0, 1, 2)
    assert set(g.neighbors(0, 1)) == {3}
    assert g.degree(0, 2) == 0


def test_graph_rejects_self_loops():
    g = LayeredGraph(m=4, n=4)
    g.ensure_level(0)
    with pytest.raises(SelfConnection):
        g.add_edge(0, 1, 1)


def test_graph_add_edge_idempotent():
    g = LayeredGraph(m=4, n=4)
    g.ensure_level(0)
    g.add_edge(0, 0, 1)
    g.add_edge(0, 0, 1)
    assert g.degree(0, 0) == 1


def test_replace_neighbors():
    g = LayeredGraph(m=4, n=8)
    g.ensure_level(0)
    g.add_edge(0, 0, 1)
    g.add_edge(0, 0, 2)
    g.replace_neighbors(0, 0, [3, 4])
    assert set(g.neighbors(0, 0)) == {3, 4}


def test_degrees_and_caps():
    adj = empty_adjacency(4, 3)
    assert np.all(np.asarray(degrees(adj)) == 0)
    g = LayeredGraph(m=2, n=4)
    g.ensure_level(1)
    assert g.layer_cap(0) == 4 and g.layer_cap(1) == 2

def test_flat_tiled_matches_sort_path():
    # the tiled streaming top-k (N > _SORT_PATH_MAX) must agree with the
    # small-N sort path on the same data
    import jax.numpy as jnp
    from hnsw_rs_tpu.models.flat import (
        _SORT_PATH_MAX, _flat_search, _flat_search_tiled,
    )
    from hnsw_rs_tpu.ops.distance import point_normsq
    from hnsw_rs_tpu.ops.quant import dequantize, quantize

    n = _SORT_PATH_MAX + 1337  # forces padding in the tiled path
    rng = np.random.default_rng(5)
    codes, scales = quantize(jnp.asarray(rng.random((n, 12), np.float32)))
    normsq = point_normsq(codes, scales)
    q = dequantize(*quantize(jnp.asarray(rng.random((8, 12), np.float32))))
    # same affine distances through the full two-key sort (apples to apples)
    from hnsw_rs_tpu.ops.distance import pairwise_l2sq_mxu
    from hnsw_rs_tpu.ops.topk import topk_dist_id

    d2 = pairwise_l2sq_mxu(q, codes, scales, normsq)
    ids = jnp.broadcast_to(jnp.arange(n, dtype=jnp.int32), d2.shape)
    d_sort, i_sort = topk_dist_id(d2, ids, 10)
    d_tile, i_tile = _flat_search_tiled(q, codes, scales, normsq, 10)
    np.testing.assert_array_equal(np.asarray(i_sort), np.asarray(i_tile))
    np.testing.assert_allclose(
        np.sqrt(np.asarray(d_sort)), np.asarray(d_tile), rtol=1e-5
    )
    # the public API routes large-N inexact searches through the tiled path
    d_api, i_api = _flat_search(q, codes, scales, normsq, 10, False)
    np.testing.assert_array_equal(np.asarray(i_api), np.asarray(i_tile))


def test_merge_sorted_equals_full_sort():
    # bitonic merge of two sorted (d2, id) runs == full two-key sort
    from hnsw_rs_tpu.ops.topk import merge_sorted_dist_id, sort_dist_id

    rng = np.random.default_rng(44)
    for la, lb in [(128, 32), (6, 10), (1, 1), (33, 31)]:
        da, ia = sort_dist_id(
            jnp.asarray(rng.choice(40, (3, la)).astype(np.float32)),
            jnp.asarray(rng.integers(0, 99, (3, la)).astype(np.int32)),
        )
        db, ib = sort_dist_id(
            jnp.asarray(rng.choice(40, (3, lb)).astype(np.float32)),
            jnp.asarray(rng.integers(0, 99, (3, lb)).astype(np.int32)),
        )
        md, mi = merge_sorted_dist_id(da, ia, db, ib)
        rd, ri = sort_dist_id(
            jnp.concatenate([da, db], -1), jnp.concatenate([ia, ib], -1)
        )
        np.testing.assert_array_equal(np.asarray(mi), np.asarray(ri))
        np.testing.assert_array_equal(np.asarray(md), np.asarray(rd))
        # bool payload rides along exactly (keys here are unique pairs)
        ea = jnp.asarray((np.asarray(ia) % 2).astype(bool))
        eb = jnp.asarray((np.asarray(ib) % 2).astype(bool))
        _, mi2, me = merge_sorted_dist_id(da, ia, db, ib, ea, eb)
        np.testing.assert_array_equal(
            np.asarray(me), (np.asarray(mi2) % 2).astype(bool)
        )
