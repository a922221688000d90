"""Multi-host (multi-process) execution wiring.

The reference is strictly single-process (its entire "communication
layer" is shared memory + mutexes, ``hnsw/src/template.rs:422-439``).
The scale-out path for BASELINE configs 4-5 (10M-100M vectors) is
multi-host SPMD: every host runs the same program,
``jax.distributed.initialize`` wires the GRPC coordinator, and the
(data, shard) mesh simply spans all hosts' devices — the same
``shard_map`` collectives then ride the devices' interconnect within a
host and the network across hosts with no code changes in the
query/build paths.

``benchmarks/multihost_smoke.py`` runs the full sharded query path
across two real OS processes on a virtual CPU mesh; the same wiring
applies to real multi-host GPU clusters, where each host launches with
its coordinator address, process count and process_id.
"""

from __future__ import annotations

import os

import jax


def init_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    local_device_count: int | None = None,
) -> None:
    """Initialize multi-process JAX (idempotent).

    With no arguments, defers to ``jax.distributed.initialize()``'s
    auto-detection from the cluster environment (e.g. SLURM); explicit
    arguments come
    from the launcher (one process per host). ``local_device_count``
    forces an N-device virtual CPU backend per process (testing).
    Call BEFORE any other JAX operation.
    """
    if local_device_count is not None:
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_num_cpu_devices", local_device_count)
    kwargs = {}
    if coordinator_address is not None:
        kwargs = dict(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    jax.distributed.initialize(**kwargs)


def global_mesh(n_data: int = 1, n_shard: int | None = None):
    """(data, shard) mesh over ALL processes' devices (the multi-host
    form of ``mesh.make_mesh``)."""
    import numpy as np
    from jax.sharding import Mesh

    devices = jax.devices()  # global across processes
    if n_shard is None:
        n_shard = len(devices) // n_data
    need = n_data * n_shard
    if len(devices) < need:
        raise ValueError(f"need {need} devices, have {len(devices)}")
    dev = np.asarray(devices[:need]).reshape(n_data, n_shard)
    return Mesh(dev, axis_names=("data", "shard"))


def shard_from_local(mesh, spec, local_rows):
    """Assemble a global sharded array from this process's local rows
    (the multi-host replacement for ``jax.device_put(x, sharding)``,
    which requires every device to be addressable)."""
    from jax.sharding import NamedSharding

    return jax.make_array_from_process_local_data(
        NamedSharding(mesh, spec), local_rows
    )
