"""Measuring entry points name their card and refuse the CPU."""

import pytest

from hnsw_rs_tpu.utils import device


@pytest.mark.parametrize("card, watts", [
    ("NVIDIA H100 80GB HBM3, 700.00 W", 700.0),
    ("NVIDIA H100 80GB HBM3, 350.00 W", 350.0),
    ("nvidia-smi unavailable: [Errno 2] No such file", None),
])
def test_power_limit_w(card, watts):
    assert device.power_limit_w(card) == watts


def test_require_gpu_refuses_cpu():
    with pytest.raises(RuntimeError, match="need a GPU"):
        device.require_gpu()
