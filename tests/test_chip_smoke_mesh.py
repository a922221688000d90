"""``chip_smoke.py``'s four-card phase on four virtual CPU devices at tiny
size: the sharded cluster build, one shard per device, and recall
against exact truth over the whole collection."""

import chip_smoke

from test_chip_smoke import SMALL_CLUSTER


def test_four_cards_phase_on_virtual_mesh():
    train, test = chip_smoke.sharded_regime(4, 1500, 16, 256, seed=3)
    assert train.shape == (6000, 16) and test.shape == (256, 16)
    out = chip_smoke.four_cards_phase(
        train, test, n_shards=4, m=12, ef_cons=64, pivots=128,
        cluster_kwargs=SMALL_CLUSTER, platform="cpu",
    )
    assert out["shards_on_distinct_cards"]
    assert out["recall_at_10"] >= chip_smoke.GATE
    assert len(out["peak_bytes_in_use"]) == 4
