"""k-center pivot fill (ops/cover.py): coverage of low-density regions.

Density-proportional pivot sampling starves rare clusters (the
heavy-tailed 1M serving failure — seeds ~3x further than the true
neighbor); the k-center fill
must pick uncovered regions first."""

import jax.numpy as jnp
import numpy as np

from hnsw_rs_tpu import HNSW
from hnsw_rs_tpu.ops.cover import kcenter_fill
from hnsw_rs_tpu.utils import gen_rand_vecs


def _blob_data():
    rng = np.random.default_rng(0)
    blobs = [
        rng.normal(c, 0.05, (300, 8)).astype(np.float32)
        for c in (0.0, 1.0, 2.0)
    ]
    tail = rng.normal(40.0, 0.05, (5, 8)).astype(np.float32)
    return np.concatenate(blobs + [tail])  # tail rows: 900..904


def test_kcenter_covers_far_blob_first():
    x = _blob_data()
    base = np.array([0, 300, 600])  # one pivot per dense blob, none in tail
    fill = kcenter_fill(jnp.asarray(x), base, 8, batch=4)
    # the first greedy batch must land in the uncovered far blob
    assert np.isin(fill, np.arange(900, 905)).sum() >= 4
    assert not np.isin(fill, base).any()
    assert fill.size == np.unique(fill).size <= 8


def test_kcenter_degenerate_budget():
    x = _blob_data()[:4]
    fill = kcenter_fill(jnp.asarray(x), np.array([0]), 100, batch=7)
    assert fill.size <= 3 and not np.isin(fill, [0]).any()
    assert kcenter_fill(jnp.asarray(x), np.arange(4), 5).size == 0


def test_finalize_cover_fill_unique_and_budget():
    v = gen_rand_vecs(2000, 16, seed=3)
    idx = HNSW(8, ef_cons=32, dim=16)
    idx.insert_bulk(v)
    idx.finalize(pivots=256)  # default pivot_fill="cover"
    ids = np.asarray(idx._pivots[0])
    assert ids.shape == (256,) and np.unique(ids).size == 256
    # legacy strided fill still reachable and budget-true
    idx.finalize(pivots=256, pivot_fill="stride")
    assert np.asarray(idx._pivots[0]).shape == (256,)


def test_finalize_cover_beats_stride_on_tailed_data():
    """Recall with coverage-filled pivots >= strided pivots on data with
    a rare far cluster (both served seeded, equal ef)."""
    rng = np.random.default_rng(5)
    head = rng.normal(0.0, 1.0, (1900, 12)).astype(np.float32)
    tail = rng.normal(25.0, 0.05, (100, 12)).astype(np.float32)
    v = np.concatenate([head, tail])
    q = np.concatenate(
        [
            rng.normal(0.0, 1.0, (16, 12)),
            rng.normal(25.0, 0.05, (16, 12)),
        ]
    ).astype(np.float32)
    from hnsw_rs_tpu import FlatIndex

    flat = FlatIndex(12)
    flat.add(v)
    _, truth = flat.search(q, 10, exact=True)

    idx = HNSW(8, ef_cons=48, dim=12)
    idx.insert_bulk(v)

    def rec(fill):
        idx.finalize(pivots=64, pivot_fill=fill)
        _, ids = idx.ann_batch(q, 10, 48)
        return np.mean(
            [len(set(a) & set(t)) / 10 for a, t in zip(ids, truth)]
        )

    assert rec("cover") >= rec("stride")
