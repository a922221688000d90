"""Traversal-layer tests: batched greedy descent, flagged-beam
search_layer, and select_heuristic against scalar numpy oracles on random
graphs with integer-exact arithmetic (no float-tie flakiness)."""

import numpy as np
import jax.numpy as jnp

from hnsw_rs_tpu.heuristic import select_heuristic
from hnsw_rs_tpu.ops.topk import PAD_ID
from hnsw_rs_tpu.search import ann_search, greedy_descent, search_layer, seed_entry

from oracle import beam_search_oracle, d2, greedy_oracle, heuristic_oracle


def make_int_points(n, d, rng, hi=16):
    """Integer-valued points via (codes, scales=(0,1)): dequantized values
    equal the codes exactly, so all f32 distance sums are exact."""
    codes = rng.integers(0, hi, size=(n, d), dtype=np.uint8)
    scales = np.tile(np.asarray([[0.0, 1.0]], np.float32), (n, 1))
    return jnp.asarray(codes), jnp.asarray(scales), codes.astype(np.float32)


def make_rand_adj(n, cap, rng, p_empty=0.2):
    adj = np.full((n, cap), -1, np.int32)
    for i in range(n):
        k = rng.integers(0, cap + 1)
        if rng.random() < p_empty:
            k = 0
        others = [j for j in range(n) if j != i]
        picks = rng.choice(others, size=min(k, len(others)), replace=False)
        adj[i, : len(picks)] = picks
    return jnp.asarray(adj)


def test_greedy_descent_matches_oracle():
    rng = np.random.default_rng(0)
    n, d, cap, b = 60, 8, 6, 16
    codes, scales, X = make_int_points(n, d, rng)
    adj = make_rand_adj(n, cap, rng)
    q = rng.integers(0, 16, size=(b, d)).astype(np.float32)
    starts = rng.integers(0, n, size=b)
    e_d2 = np.asarray([d2(q[i], X[starts[i]]) for i in range(b)], np.float32)
    got_d2, got_ids = greedy_descent(
        adj, codes, scales, jnp.asarray(q), jnp.asarray(e_d2),
        jnp.asarray(starts, jnp.int32),
    )
    for i in range(b):
        od2, oid = greedy_oracle(np.asarray(adj), X, q[i], int(starts[i]))
        assert int(got_ids[i]) == oid and float(got_d2[i]) == od2


def test_search_layer_matches_oracle():
    rng = np.random.default_rng(1)
    n, d, cap, b, ef = 80, 8, 8, 12, 10
    codes, scales, X = make_int_points(n, d, rng)
    adj = make_rand_adj(n, cap, rng, p_empty=0.0)
    q = rng.integers(0, 16, size=(b, d)).astype(np.float32)
    starts = rng.integers(0, n, size=b)
    e_d2 = np.asarray([[d2(q[i], X[starts[i]])] for i in range(b)], np.float32)
    e_ids = np.asarray(starts, np.int32)[:, None]
    got_d2, got_ids = search_layer(
        adj, codes, scales, jnp.asarray(q), jnp.asarray(e_d2),
        jnp.asarray(e_ids), ef, max_iters=200,
    )
    for i in range(b):
        expect = beam_search_oracle(
            np.asarray(adj), X, q[i], [(float(e_d2[i, 0]), int(starts[i]))], ef
        )
        got = [
            (float(got_d2[i, j]), int(got_ids[i, j]))
            for j in range(ef)
            if int(got_ids[i, j]) != PAD_ID
        ]
        assert got == expect, f"query {i}: {got} != {expect}"


def test_search_layer_forbid_self():
    rng = np.random.default_rng(2)
    n, d, cap, b, ef = 40, 4, 6, 8, 6
    codes, scales, X = make_int_points(n, d, rng)
    adj = make_rand_adj(n, cap, rng, p_empty=0.0)
    q = X[:b]  # queries are the first b points themselves
    starts = rng.integers(0, n, size=b)
    forbid = np.arange(b, dtype=np.int32)
    e_d2 = np.asarray([[d2(q[i], X[starts[i]])] for i in range(b)], np.float32)
    e_ids = np.asarray(starts, np.int32)[:, None]
    got_d2, got_ids = search_layer(
        adj, codes, scales, jnp.asarray(q), jnp.asarray(e_d2),
        jnp.asarray(e_ids), ef, max_iters=200, forbid=jnp.asarray(forbid),
    )
    for i in range(b):
        ids = [int(x) for x in got_ids[i] if int(x) != PAD_ID]
        assert i not in ids
        expect = beam_search_oracle(
            np.asarray(adj), X, q[i],
            [(float(e_d2[i, 0]), int(starts[i]))], ef, forbid=int(forbid[i]),
        )
        got = [
            (float(got_d2[i, j]), int(got_ids[i, j]))
            for j in range(ef)
            if int(got_ids[i, j]) != PAD_ID
        ]
        # entry == forbidden self -> oracle still reports it (it was the
        # entry); our kernel marks it visited up front. Compare sans self.
        expect = [e for e in expect if e[1] != int(forbid[i])]
        assert got == expect


def test_select_heuristic_matches_oracle():
    rng = np.random.default_rng(3)
    n, d, cap, b, ef, m = 70, 8, 6, 10, 8, 4
    codes, scales, X = make_int_points(n, d, rng)
    adj = make_rand_adj(n, cap, rng, p_empty=0.0)
    q = rng.integers(0, 16, size=(b, d)).astype(np.float32)
    # candidate sets: random distinct ids with true distances
    cand_ids = np.stack([
        rng.choice(n, size=ef, replace=False) for _ in range(b)
    ]).astype(np.int32)
    cand_d2 = np.asarray(
        [[d2(q[i], X[cand_ids[i, j]]) for j in range(ef)] for i in range(b)],
        np.float32,
    )
    for extend in (False, True):
        for keep in (False, True):
            got_d2, got_ids = select_heuristic(
                adj, codes, scales, jnp.asarray(q), jnp.asarray(cand_d2),
                jnp.asarray(cand_ids), m, extend_cands=extend, keep_pruned=keep,
            )
            for i in range(b):
                cands = [(float(cand_d2[i, j]), int(cand_ids[i, j])) for j in range(ef)]
                expect = heuristic_oracle(
                    np.asarray(adj), X, q[i], cands, m, extend=extend, keep_pruned=keep
                )
                got = [
                    (float(got_d2[i, j]), int(got_ids[i, j]))
                    for j in range(m)
                    if int(got_ids[i, j]) != PAD_ID
                ]
                assert got == expect, (
                    f"extend={extend} keep={keep} q{i}: {got} != {expect}"
                )


def test_ann_search_runs_end_to_end():
    rng = np.random.default_rng(4)
    n, d = 50, 8
    codes, scales, X = make_int_points(n, d, rng)
    adj0 = make_rand_adj(n, 8, rng, p_empty=0.0)
    adj1 = make_rand_adj(n, 4, rng, p_empty=0.5)
    q = rng.integers(0, 16, size=(4, d)).astype(np.float32)
    dists, ids = ann_search(
        (adj0, adj1), codes, scales, jnp.asarray(q), jnp.asarray(0), ef=8, k=5,
        max_iters=100,
    )
    assert dists.shape == (4, 5) and ids.shape == (4, 5)
    assert np.all(np.diff(np.asarray(dists), axis=1) >= 0)


def test_seed_entry():
    rng = np.random.default_rng(5)
    codes, scales, X = make_int_points(10, 4, rng)
    q = X[:3]
    e_d2, e_ids = seed_entry(codes, scales, jnp.asarray(q), jnp.asarray(7))
    assert np.all(np.asarray(e_ids) == 7)
    for i in range(3):
        assert float(e_d2[i, 0]) == d2(q[i], X[7])

def test_packed_search_matches_plain():
    # packed-neighbor serving layout must return bit-identical results
    import numpy as np
    from hnsw_rs_tpu import HNSW
    from hnsw_rs_tpu.utils import gen_rand_vecs

    vecs = gen_rand_vecs(400, 24, seed=31)
    index = HNSW(8, dim=24)
    index.insert_bulk(vecs)
    q = gen_rand_vecs(32, 24, seed=32)
    d1, i1 = index.ann_batch(q, 10, 48)
    index.finalize()
    d2, i2 = index.ann_batch(q, 10, 48)
    np.testing.assert_array_equal(i1, i2)
    # same dequantize math, but XLA fusion order may differ by 1 ULP
    np.testing.assert_allclose(d1, d2, rtol=1e-6)
    # stale pack after insert is bypassed, not served
    index.insert_vec(gen_rand_vecs(1, 24, seed=33)[0])
    v = index.get_point(400).values
    ids = index.ann_by_vector(v, 1, 48)
    assert int(ids[0]) == 400
    # re-finalize picks the new point back up on the packed path
    index.finalize()
    ids = index.ann_by_vector(v, 1, 48)
    assert int(ids[0]) == 400

def test_expand_e_recall_not_worse():
    # E-way expansion: recall per ef must be >= the exact E=1 beam
    import numpy as np
    from hnsw_rs_tpu import HNSW
    from hnsw_rs_tpu.utils import brute_force_nns, gen_rand_vecs

    vecs = gen_rand_vecs(600, 16, seed=41)
    q = gen_rand_vecs(32, 16, seed=42)
    index = HNSW(8, dim=16)
    index.insert_bulk(vecs)
    truth = brute_force_nns(q, index.points.codes, index.points.scales, 10)
    index.finalize(expand=1)
    _, i1 = index.ann_batch(q, 10, 32)
    index.finalize(expand=4)
    _, i4 = index.ann_batch(q, 10, 32)
    r1 = np.mean([len(set(a) & set(t)) / 10 for a, t in zip(i1, truth)])
    r4 = np.mean([len(set(a) & set(t)) / 10 for a, t in zip(i4, truth)])
    assert r4 >= r1 - 1e-9, (r4, r1)
    # no duplicate ids in any result row
    for row in np.asarray(i4):
        real = row[row != np.iinfo(np.int32).max]
        assert len(set(real.tolist())) == len(real)


def test_pivot_seeded_serving_recall():
    # pivot-seeded serving (finalize(pivots=...)) reaches at least the
    # default path's recall at equal ef, and its ids are real neighbors
    import numpy as np
    from hnsw_rs_tpu import HNSW
    from hnsw_rs_tpu.utils import brute_force_nns, gen_rand_vecs

    vecs = gen_rand_vecs(1500, 24, seed=51)
    q = gen_rand_vecs(48, 24, seed=52)
    index = HNSW(12, dim=24)
    index.insert_bulk(vecs)
    truth = brute_force_nns(q, index.points.codes, index.points.scales, 10)
    index.finalize()
    _, i0 = index.ann_batch(q, 10, 48)
    index.finalize(pivots=256)
    assert index._pivots is not None
    _, i1 = index.ann_batch(q, 10, 48)
    r0 = np.mean([len(set(a) & set(t)) / 10 for a, t in zip(i0, truth)])
    r1 = np.mean([len(set(a) & set(t)) / 10 for a, t in zip(i1, truth)])
    assert r1 >= r0 - 0.02, (r0, r1)
    assert r1 > 0.9
    # finalize() without pivots turns the seeded path back off
    index.finalize()
    assert index._pivots is None


def test_pivot_seeds_exact_when_refine_covers_pool():
    """Seed selection is a two-stage approx->exact top-k: whenever the
    2*ef oversample covers the whole pivot pool, the ef seeds are
    EXACTLY the (d2, position)-best pivots — including under adversarial
    duplicate/tied pivot vectors (the round-3 single-stage approx_max_k
    dropped the true nearest seed ~1 query in 20, a whole-query miss on
    tail data)."""
    from hnsw_rs_tpu.search import _pivot_seeds

    rng = np.random.default_rng(5)
    p, d, ef, b = 64, 8, 32, 16
    vecs = rng.random((p, d), np.float32)
    # adversarial: half the pool are duplicates of the first rows (ties)
    vecs[p // 2:] = vecs[: p // 2]
    ids = np.arange(p, dtype=np.int32)
    q = rng.random((b, d), np.float32)
    e_d2, e_ids = _pivot_seeds(
        jnp.asarray(ids), jnp.asarray(vecs), jnp.asarray(q), ef
    )
    e_ids = np.asarray(e_ids)
    d2m = ((q[:, None, :] - vecs[None]) ** 2).sum(-1)
    for i in range(b):
        want = set(np.argsort(d2m[i], kind="stable")[:ef].tolist())
        got = set(e_ids[i].tolist())
        # tie groups may resolve to either duplicate id; compare by
        # DISTANCE multiset instead of id where tied
        wd = np.sort(d2m[i][np.argsort(d2m[i])[:ef]])
        gd = np.sort(d2m[i][e_ids[i]])
        np.testing.assert_allclose(gd, wd, rtol=1e-5, atol=1e-6)
        # and the unique true nearest (if untied) must be present
        top = np.argsort(d2m[i], kind="stable")[0]
        tied = np.flatnonzero(np.abs(d2m[i] - d2m[i][top]) < 1e-9)
        assert set(tied.tolist()) & got, (i, top, tied)
        del want


def test_probed_shortlist_serving():
    """finalize(pivot_shortlist=T): probed serving injects each probed
    pivot's local top-T into the beam exactly scored — recall at fixed
    (ef, max_iters) must not drop vs plain seeded serving, and returned
    ids/distances stay exact-form (sqrt of true quantized-space d2)."""
    import jax.numpy as jnp
    import numpy as np

    from hnsw_rs_tpu import HNSW
    from hnsw_rs_tpu.ops.quant import dequantize, quantize
    from hnsw_rs_tpu.utils import brute_force_nns
    from hnsw_rs_tpu.utils.datasets import synthetic_clustered

    n, d, k = 3000, 24, 10
    ds = synthetic_clustered(n, d, n_queries=48, seed=21)
    idx = HNSW(10, dim=d)
    idx.insert_bulk(ds.train)
    truth = brute_force_nns(ds.test, idx.points.codes, idx.points.scales, k)

    idx.finalize(pivots=256)
    _, a0 = idx.ann_batch(ds.test, k, 24, max_iters=12)
    r0 = np.mean([len(set(a) & set(t)) / k
                  for a, t in zip(a0.tolist(), truth.tolist())])

    idx.finalize(pivots=256, pivot_shortlist=8)
    assert idx._pivot_shortlist.shape == (256, 8)
    d1, a1 = idx.ann_batch(ds.test, k, 24, max_iters=12)
    r1 = np.mean([len(set(a) & set(t)) / k
                  for a, t in zip(a1.tolist(), truth.tolist())])
    assert r1 >= r0 - 0.01, (r1, r0)

    # distances are true quantized-space distances for the returned ids
    qq = np.asarray(dequantize(*quantize(jnp.asarray(ds.test))))
    x0 = np.asarray(dequantize(idx.points.codes[a1[0]],
                               idx.points.scales[a1[0]]))
    np.testing.assert_allclose(
        d1[0], np.sqrt(((qq[0][None] - x0) ** 2).sum(-1)),
        rtol=1e-4, atol=1e-4,
    )

    # finalize without the flag clears the probed mode
    idx.finalize(pivots=256)
    assert idx._pivot_shortlist is None


def test_packed_probe_matches_narrow_probe():
    """ann_search_seeded_probe_packed scores the SAME candidates as the
    narrow-gather probe path (the packed rows decode to identical
    codes/scales/ids), so returned ids match exactly and distances to
    numerical tolerance."""
    import jax.numpy as jnp
    import numpy as np

    from hnsw_rs_tpu import HNSW
    from hnsw_rs_tpu.models.hnsw import (
        _ann_seeded_probe_jit,
        _ann_seeded_probe_packed_jit,
    )
    from hnsw_rs_tpu.ops.quant import dequantize, quantize
    from hnsw_rs_tpu.utils.datasets import synthetic_clustered

    n, d, k, t, probes = 3000, 24, 10, 8, 6
    ds = synthetic_clustered(n, d, n_queries=32, seed=23)
    idx = HNSW(10, dim=d)
    idx.insert_bulk(ds.train)
    idx.finalize(pivots=256, pivot_shortlist=t)
    assert idx._pivot_sl_pack is not None
    assert idx._pivot_sl_pack.shape == (256, t * (d + 12))

    q = dequantize(*quantize(jnp.asarray(ds.test)))
    dn, an = _ann_seeded_probe_jit(
        idx._packed0, idx._pivots[0], idx._pivots[1],
        idx._pivot_shortlist, idx.points.codes, idx.points.scales,
        q, 24, k, 12, probes,
    )
    dp, ap = _ann_seeded_probe_packed_jit(
        idx._packed0, idx._pivots[0], idx._pivots[1],
        idx._pivot_sl_pack, t, d, q, 24, k, 12, probes,
    )
    np.testing.assert_array_equal(np.asarray(an), np.asarray(ap))
    np.testing.assert_allclose(np.asarray(dn), np.asarray(dp),
                               rtol=1e-5, atol=1e-5)

    # the model dispatch prefers the packed path and must agree with it
    idx.serve_probes = probes
    dm, am = idx.ann_batch(ds.test, k, 24, max_iters=12)
    np.testing.assert_array_equal(am, np.asarray(ap)[: len(ds.test)])


def test_build_shortlist_chunked_matches_single_dispatch():
    """_build_shortlist chunks the pivot-query batch (a 32k-pivot single
    dispatch holds a 16 GB [B, tile] temp);
    chunked output must equal the one-dispatch result row-for-row."""
    import jax.numpy as jnp
    import numpy as np

    from hnsw_rs_tpu.models.hnsw import _build_shortlist
    from hnsw_rs_tpu.ops.quant import quantize
    from hnsw_rs_tpu.utils import gen_rand_vecs

    n, d, p, t = 500, 16, 96, 6
    codes, scales = quantize(jnp.asarray(gen_rand_vecs(n, d, seed=3)))
    from hnsw_rs_tpu.ops.quant import dequantize

    vecs = dequantize(codes[:p], scales[:p])
    one = np.asarray(_build_shortlist(vecs, codes, scales, t, chunk=p))
    many = np.asarray(_build_shortlist(vecs, codes, scales, t, chunk=40))
    np.testing.assert_array_equal(one, many)
    assert one.shape == (p, t)
    # each pivot's own row is its nearest stored point
    assert (one[:, 0] == np.arange(p)).mean() > 0.95
