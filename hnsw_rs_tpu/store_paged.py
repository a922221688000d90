"""Paged on-disk point storage + out-of-core exact search.

Parity-and-beyond for the reference's paged store and disk reader, which
are WIP there (``points/src/points/block_points.rs`` — blocks of
``MAX_PER_BLOCK = 32`` points with ``id = block_id * 32 + pos`` so lookup
is pure arithmetic, ``block_points.rs:101-108``; ``hnsw/src/disk.rs:22-109``
— a pread-based block reader whose graph part is stubbed and whose only
test is commented out). Here the equivalent is complete:

- :class:`BlockStore` — fixed-size blocks on disk, arithmetic offsets,
  positioned reads (native ``pread`` via ``native/fastio.cpp`` when
  available), an LRU block cache (the ``PointsDisk`` HashMap buffer
  analogue, ``disk.rs:35-99``);
- streaming **exact search**: blocks are streamed through the device in
  large contiguous chunks (accelerator-friendly sequential IO — no per-point
  gather) with a running top-k merge, so collections far larger than HBM
  can be searched exactly.

Block file layout (fixed-size records make offsets arithmetic):
``magic 'HTBS' | version u32 | point_size u32 | max_per_block u32`` then
per block ``block_id u16 | nb_points u16 | point_size u16`` (the
``BlockHeader`` fields, ``block/header.rs:5-45``) + ``max_per_block``
point records ``level u8 | min f32 BE | delta f32 BE | codes u8[d]`` (the
reference's Point codec, ``points/src/point.rs:46-76``).
"""

from __future__ import annotations

import collections
import os
import struct
import threading

import numpy as np

MAGIC = b"HTBS"
VERSION = 1
MAX_PER_BLOCK = 32
FILE_HEADER = 16
BLOCK_HEADER = 6


def _record_size(dim: int) -> int:
    return 9 + dim  # level + min + delta + codes


def write_block_store(
    path: str, codes: np.ndarray, scales: np.ndarray, levels: np.ndarray
) -> None:
    """Write a quantized collection as a paged block file."""
    n, d = codes.shape
    ps = _record_size(d)
    nb = max(1, -(-n // MAX_PER_BLOCK))
    with open(path, "wb") as f:
        f.write(MAGIC)
        f.write(struct.pack("<III", VERSION, ps, MAX_PER_BLOCK))
        rec = np.zeros((nb * MAX_PER_BLOCK, ps), np.uint8)
        rec[:n, 0] = np.asarray(levels, np.uint8)
        rec[:n, 1:5] = np.frombuffer(
            np.asarray(scales[:, 0], ">f4").tobytes(), np.uint8
        ).reshape(n, 4)
        rec[:n, 5:9] = np.frombuffer(
            np.asarray(scales[:, 1], ">f4").tobytes(), np.uint8
        ).reshape(n, 4)
        rec[:n, 9:] = codes
        for b in range(nb):
            lo = b * MAX_PER_BLOCK
            hi = min(n, lo + MAX_PER_BLOCK)
            f.write(struct.pack("<HHH", b, hi - lo, ps))
            f.write(rec[lo : lo + MAX_PER_BLOCK].tobytes())


def _decode_records(raw: np.ndarray, dim: int):
    """records u8[k, 9+d] -> (codes, scales, levels)."""
    levels = raw[:, 0].astype(np.int32)
    mins = np.frombuffer(raw[:, 1:5].tobytes(), ">f4").astype(np.float32)
    deltas = np.frombuffer(raw[:, 5:9].tobytes(), ">f4").astype(np.float32)
    return raw[:, 9:], np.stack([mins, deltas], 1), levels


class BlockStore:
    """Read-side paged access to a block file with an LRU block cache."""

    def __init__(self, path: str, cache_blocks: int = 256):
        self.path = path
        with open(path, "rb") as f:
            head = f.read(FILE_HEADER)
        if head[:4] != MAGIC:
            raise ValueError(f"{path} is not a block store")
        self.version, self.point_size, self.max_per_block = struct.unpack(
            "<III", head[4:16]
        )
        self.dim = self.point_size - 9
        self._block_bytes = BLOCK_HEADER + self.max_per_block * self.point_size
        size = os.path.getsize(path)
        self.nb_blocks = (size - FILE_HEADER) // self._block_bytes
        self._cache: collections.OrderedDict[int, tuple] = collections.OrderedDict()
        self._cache_blocks = cache_blocks
        # the LRU is shared with HybridPagedHNSW's speculative prefetch
        # thread (models/paged.py) — guard mutation; the lock is cheap
        # next to the positioned read it protects
        self._cache_lock = threading.Lock()
        # count of points in the last block
        _, _, lv = self._load_block(self.nb_blocks - 1)
        self._n = (self.nb_blocks - 1) * self.max_per_block + lv.shape[0]

    def __len__(self) -> int:
        return self._n

    def _block_offset(self, block_id: int) -> int:
        # arithmetic offset (block_points.rs:101-108 / disk.rs:72-81)
        return FILE_HEADER + block_id * self._block_bytes

    def _read_bytes(self, offset: int, nbytes: int) -> np.ndarray:
        from .native import pread_block

        got = pread_block(self.path, offset, nbytes)
        if got is not None:
            return got
        with open(self.path, "rb") as f:
            f.seek(offset)
            return np.frombuffer(f.read(nbytes), np.uint8)

    def _load_block(self, block_id: int):
        """Block (codes, scales, levels), via the LRU cache."""
        with self._cache_lock:
            hit = self._cache.get(block_id)
            if hit is not None:
                self._cache.move_to_end(block_id)
                return hit
        raw = self._read_bytes(self._block_offset(block_id), self._block_bytes)
        bid, nb_points, ps = struct.unpack("<HHH", raw[:BLOCK_HEADER].tobytes())
        rec = raw[BLOCK_HEADER:].reshape(self.max_per_block, self.point_size)
        out = _decode_records(rec[:nb_points], self.dim)
        with self._cache_lock:
            self._cache[block_id] = out
            if len(self._cache) > self._cache_blocks:
                self._cache.popitem(last=False)
        return out

    def get_point(self, idx: int):
        """(codes u8[d], (min, delta), level) for a point id
        (``PointsDisk::get_point``, ``disk.rs:35-99``)."""
        if idx < 0 or idx >= self._n:
            return None
        codes, scales, levels = self._load_block(idx // self.max_per_block)
        pos = idx % self.max_per_block
        return codes[pos], scales[pos], int(levels[pos])

    def get_values(self, idx: int) -> np.ndarray:
        """Dequantized values of one point."""
        codes, scales, _level = self.get_point(idx)
        return codes.astype(np.float32) * scales[1] + scales[0]

    def iter_chunks(self, chunk_blocks: int = 64):
        """Stream (codes, scales, start_id) over contiguous block chunks —
        sequential large reads, the accelerator-friendly out-of-core access
        pattern."""
        for b0 in range(0, self.nb_blocks, chunk_blocks):
            bks = min(chunk_blocks, self.nb_blocks - b0)
            raw = self._read_bytes(self._block_offset(b0), bks * self._block_bytes)
            raw = raw.reshape(bks, self._block_bytes)
            counts = np.frombuffer(
                raw[:, :BLOCK_HEADER].tobytes(), "<u2"
            ).reshape(bks, 3)[:, 1]
            rec = raw[:, BLOCK_HEADER:].reshape(
                bks * self.max_per_block, self.point_size
            )
            keep = (
                np.arange(bks * self.max_per_block) % self.max_per_block
                < np.repeat(counts, self.max_per_block)
            )
            codes, scales, _ = _decode_records(rec[keep], self.dim)
            yield codes, scales, b0 * self.max_per_block

    def search_streaming(
        self, queries: np.ndarray, k: int, chunk_blocks: int = 256
    ) -> tuple[np.ndarray, np.ndarray]:
        """Exact top-k over the whole on-disk collection, streaming chunks
        through the device with a running (dist, id) merge. Memory use is
        O(chunk + k), independent of collection size."""
        import jax.numpy as jnp

        from .ops.distance import pairwise_l2sq_exact
        from .ops.quant import dequantize, quantize
        from .ops.topk import PAD_ID, sort_dist_id

        qf = dequantize(*quantize(jnp.asarray(queries, jnp.float32)))
        b = qf.shape[0]
        best_d = jnp.full((b, k), jnp.inf, jnp.float32)
        best_i = jnp.full((b, k), PAD_ID, jnp.int32)
        for codes, scales, start in self.iter_chunks(chunk_blocks):
            d2 = pairwise_l2sq_exact(qf, jnp.asarray(codes), jnp.asarray(scales))
            ids = start + jnp.arange(codes.shape[0], dtype=jnp.int32)
            md = jnp.concatenate([best_d, d2], 1)
            mi = jnp.concatenate(
                [best_i, jnp.broadcast_to(ids, d2.shape)], 1
            )
            md, mi = sort_dist_id(md, mi)
            best_d, best_i = md[:, :k], mi[:, :k]
        return np.sqrt(np.asarray(best_d)), np.asarray(best_i)
