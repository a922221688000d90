"""hnsw_rs_tpu — a batched HNSW approximate-nearest-neighbor engine.

A JAX/XLA implementation with the capabilities of the reference Rust
workspace (Gumo-A/hnsw_rs): quantized vector storage, HNSW index
construction (bulk + incremental), batched greedy-beam queries,
persistence, and GloVe evaluation — redesigned for an accelerator (dense
adjacency arrays in device memory, lockstep batched traversal, matmul
distance kernels, mesh-sharded scale-out) rather than ported.

Layer map (mirrors SURVEY.md §1):
- ``ops``      — numeric kernels (the ``vectors`` crate analogue)
- ``graphs``   — layered dense adjacency (the ``graph`` crate analogue)
- ``store``    — quantized point storage (the ``points`` crate analogue)
- ``models``   — index algorithms: ``HNSW``, ``FlatIndex`` (the ``hnsw`` crate)
- ``parallel`` — mesh sharding: query DP + sharded sub-indexes
- ``utils``    — datasets, progress, CLI, serialization (``helpers`` +
  ``eval_glove`` analogues)
"""

def _disable_numpy_thp_madvise() -> None:
    """Stop numpy from madvise(MADV_HUGEPAGE)-ing large allocations.

    On hosts with THP enabled=madvise and defrag=madvise, every 2 MB
    hugepage fault triggers synchronous compaction, so first-touching a
    large fresh numpy buffer can take tens of times longer than with the
    madvise disabled, and host-side build phases (quantize temps, member
    tables) then vary with host memory fragmentation. Big-array THP upside
    is negligible next to that; opt back in with HNSW_NUMPY_HUGEPAGE=1. Runtime toggle (not the NUMPY_MADVISE_HUGEPAGE
    env var) because the interpreter's sitecustomize imports numpy
    before any user code runs."""
    import os as _os

    if _os.environ.get("HNSW_NUMPY_HUGEPAGE"):
        return
    try:
        import numpy as _np

        _np._core.multiarray._set_madvise_hugepage(False)
    except (ImportError, AttributeError):
        try:
            _np.core.multiarray._set_madvise_hugepage(False)  # numpy < 2
        except Exception:
            pass


_disable_numpy_thp_madvise()

from .params import Params, get_default_ml
from .store import PointStore
from .models.flat import FlatIndex
from .models.ivf import IVFFlatIndex

__version__ = "0.1.0"

__all__ = [
    "Params",
    "get_default_ml",
    "PointStore",
    "FlatIndex",
    "IVFFlatIndex",
    "HNSW",
    "__version__",
]


def __getattr__(name):
    if name == "HNSW":
        from .models.hnsw import HNSW

        return HNSW
    raise AttributeError(name)
