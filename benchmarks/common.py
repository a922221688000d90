"""Shared benchmark harness: device selection, warmup + repeat loops
timed with ``jax.block_until_ready``, one-line reports."""

from __future__ import annotations

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def setup_jax(cpu: bool = False):
    """Enable the compile cache and pick the backend: the GPU (refusing to
    run without one), or the CPU when ``cpu`` is asked for explicitly.
    Prints the device every later number was taken on."""
    import jax

    from hnsw_rs_tpu.utils.cache import enable_compile_cache
    from hnsw_rs_tpu.utils.device import nvidia_smi_cards, require_gpu

    enable_compile_cache()
    if cpu:
        jax.config.update("jax_platforms", "cpu")
        dev = jax.devices()[0]
        print(f"device: {dev.platform} {dev.device_kind}")
    else:
        dev = require_gpu()[0]
        print(f"device: {dev.platform} {dev.device_kind} "
              f"({nvidia_smi_cards()[0]})")
    return jax


def bench_device(label: str, fn, *args, seconds: float = 2.0, unit_count: int = 1):
    """Time a jitted fn until its outputs are ready on device.
    Prints ms/call and unit throughput."""
    import jax

    jfn = jax.jit(fn)
    jax.block_until_ready(jfn(*args))  # warm / compile
    t0 = time.perf_counter()
    it = 0
    while time.perf_counter() - t0 < seconds or it < 3:
        jax.block_until_ready(jfn(*args))
        it += 1
    dt = (time.perf_counter() - t0) / it
    rate = unit_count / dt
    print(f"{label:55s} {dt * 1e3:10.3f} ms   {rate:14.0f} /s")
    return dt


def bench_host(label: str, fn, seconds: float = 2.0, unit_count: int = 1):
    """Time a host-side callable end to end."""
    fn()  # warm
    t0 = time.perf_counter()
    it = 0
    while time.perf_counter() - t0 < seconds or it < 2:
        fn()
        it += 1
    dt = (time.perf_counter() - t0) / it
    print(f"{label:55s} {dt * 1e3:10.3f} ms   {unit_count / dt:14.0f} /s")
    return dt
