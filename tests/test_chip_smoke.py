"""``chip_smoke.py``'s phases on the CPU at tiny widths: the device check
refuses a CPU, and the parity and hnsw phases run their checks end to
end against their numpy references."""

import numpy as np
import pytest

import chip_smoke
from hnsw_rs_tpu.utils.datasets import synthetic_clustered

# a tiny-N cluster build: the 1M cell's select_alg4=False/merge_slots
# leave ~10% of points unreachable at a few thousand points
SMALL_CLUSTER = {"pool_p": 32, "points_per_cluster": 48, "fanout": 4}


def test_device_phase_refuses_cpu():
    with pytest.raises(chip_smoke.SmokeFailure, match="no gpu"):
        chip_smoke.device_phase()


def test_device_phase_accepts_wanted_platform():
    out = chip_smoke.device_phase(need=4, platform="cpu", cache_dir="x")
    assert out["platform"] == "cpu" and out["count"] >= 4
    with pytest.raises(chip_smoke.SmokeFailure, match="need 64"):
        chip_smoke.device_phase(need=64, platform="cpu")


def test_parity_phase_tiny():
    ds = synthetic_clustered(3000, 16, n_queries=64, seed=0)
    out = chip_smoke.parity_phase(ds.train, ds.test, n_pair=1024,
                                  nq_pair=64, nq_flat=32)
    assert out["l2_err_over_tol"] <= 1.0
    assert out["traversal_mismatches"] == 0
    assert out["flat_shape"] == [32, 3000]


def test_topk_f64_matches_argsort():
    rng = np.random.default_rng(0)
    q = rng.random((5, 8))
    x = rng.random((300, 8))
    d, i = chip_smoke._topk_f64(q, x, 7, chunk=64)
    full = ((q[:, None] - x[None]) ** 2).sum(-1)
    want = np.argsort(full, axis=1, kind="stable")[:, :7]
    np.testing.assert_array_equal(i, want)
    np.testing.assert_allclose(d, np.take_along_axis(full, want, 1),
                               rtol=1e-9, atol=1e-12)


def test_hnsw_phase_tiny():
    ds = synthetic_clustered(5000, 16, n_queries=512, seed=1)
    out = chip_smoke.hnsw_phase(
        ds.train, ds.test, m=12, ef_cons=64, pivots=256, n_recall=256,
        cluster_kwargs=SMALL_CLUSTER, n_insert=8, n_reload=64, seed=1,
    )
    assert out["recall_at_10"] >= chip_smoke.GATE
    assert out["insert_rank0"] == "8/8"
    assert out["qps_device"] > 0 and out["n"] == 5000


def test_hnsw_phase_fails_when_gate_unreachable():
    ds = synthetic_clustered(2000, 16, n_queries=128, seed=2)
    with pytest.raises(chip_smoke.SmokeFailure, match="reached recall"):
        chip_smoke.hnsw_phase(
            ds.train, ds.test, m=8, ef_cons=32, pivots=64, n_recall=128,
            ladder=((1, 1),), cluster_kwargs=SMALL_CLUSTER,
        )
