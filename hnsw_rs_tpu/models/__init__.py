"""Index model families: exact flat search (matmul brute force), the HNSW
graph index, IVF-Flat (inverted file, the device-native block design), and
the out-of-core paged HNSW reader."""

from .flat import FlatIndex
from .ivf import IVFFlatIndex

__all__ = ["FlatIndex", "HNSW", "IVFFlatIndex", "IVFPQIndex", "PagedHNSW", "save_paged"]


def __getattr__(name):
    if name == "HNSW":
        from .hnsw import HNSW

        return HNSW
    if name == "IVFPQIndex":
        from .ivfpq import IVFPQIndex

        return IVFPQIndex
    if name in ("PagedHNSW", "save_paged"):
        from . import paged

        return getattr(paged, name)
    raise AttributeError(name)
