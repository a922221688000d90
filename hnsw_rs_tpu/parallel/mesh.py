"""Device-mesh helpers.

The reference's only parallelism is a shared-memory OS-thread pool
(``hnsw/src/template.rs:403-440``); the device-native equivalents are laid out
over a ``jax.sharding.Mesh`` with two axes:

- ``data``  — query data-parallelism: batches of queries split across
  devices, index replicated (the serving fan-out).
- ``shard`` — index partitioning: each device owns a contiguous slice of
  the collection with its own sub-graph; queries fan out to every shard
  and per-shard top-k results merge over collectives (the memory
  scale-out; BASELINE.json configs 4-5).
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(
    n_data: int = 1, n_shard: int = 1, devices=None
) -> Mesh:
    """A (data, shard) mesh over the first ``n_data * n_shard`` devices."""
    if devices is None:
        devices = jax.devices()
    need = n_data * n_shard
    if len(devices) < need:
        raise ValueError(f"need {need} devices, have {len(devices)}")
    dev = np.asarray(devices[:need]).reshape(n_data, n_shard)
    return Mesh(dev, axis_names=("data", "shard"))


def data_sharding(mesh: Mesh) -> NamedSharding:
    """Batch-dim sharding over the ``data`` axis (queries)."""
    return NamedSharding(mesh, P("data"))


def shard_sharding(mesh: Mesh) -> NamedSharding:
    """Leading-dim sharding over the ``shard`` axis (per-shard stacks)."""
    return NamedSharding(mesh, P("shard"))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
