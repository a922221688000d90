"""CLI argument parsing — the structured replacement for the reference's
four hand-rolled positional argv parsers (``hnsw/src/helpers/args.rs:3-47``:
dim/lim, dim/lim/m, lim/m/ef_cons variants)."""

from __future__ import annotations

import argparse


def eval_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="hnsw_rs_tpu.eval_glove",
        description="Build an HNSW index over GloVe embeddings and evaluate "
        "recall/QPS against on-device brute force.",
    )
    p.add_argument("--model", choices=("hnsw", "flat", "ivf", "pq"), default="hnsw",
                   help="index family to evaluate")
    p.add_argument("--n-lists", type=int, default=0,
                   help="IVF lists (0 = sqrt(N))")
    p.add_argument("--probe", type=int, nargs="+", default=[8],
                   help="IVF n_probe value(s) to sweep")
    p.add_argument("--metric", choices=("l2", "cosine"), default="l2")
    p.add_argument("--store", default="test-data/store.txt",
                   help="GloVe text file with stored vectors")
    p.add_argument("--queries", default="test-data/queries.txt",
                   help="GloVe text file with query vectors (default: store)")
    p.add_argument("--lim", type=int, default=0,
                   help="max rows to load (0 = all)")
    p.add_argument("--m", type=int, default=12, help="HNSW M parameter")
    p.add_argument("--ef-cons", type=int, default=None,
                   help="construction beam width (default 2*M)")
    p.add_argument("--ef", type=int, nargs="+", default=[100],
                   help="query beam width(s) to sweep")
    p.add_argument("--build-expand", type=int, default=1,
                   help="beam pops per construction-search iteration "
                   "(E>1: ~E× fewer lockstep iterations, build knob)")
    p.add_argument("--build-seeded", action="store_true",
                   help="seed layer-0 construction searches from the "
                   "level>=1 pivot skeleton (one matmul) instead of "
                   "greedy descent; pair with a tighter --build-mi")
    p.add_argument("--cluster-build", action="store_true",
                   help="cluster-bulk build: device k-means + dense "
                   "pools replace construction beam searches on every "
                   "layer (the measured-fastest bulk builder; "
                   "recall-gated, see build_cluster.py)")
    p.add_argument("--build-mi", type=int, default=None,
                   help="construction-search iteration cap (default "
                   "2*ef_cons+16; the lockstep beam runs to the cap, so "
                   "this is a direct build speed/quality knob)")
    p.add_argument("--expand", type=int, default=1,
                   help="beam pops per serving-search iteration (packed "
                   "layout; E>1 amortizes per-iteration fixed costs)")
    p.add_argument("--pivots", type=int, default=0,
                   help="enable pivot-seeded serving with this many "
                   "upper-layer pivots (one matmul replaces the "
                   "greedy descent; the million-scale headline path)")
    p.add_argument("--pq-m", type=int, default=0,
                   help="enable PQ-coded serving with this many bytes/"
                   "point (requires --pivots; ADC beams + exact rerank "
                   "— the beyond-HBM memory mode)")
    p.add_argument("--k", type=int, default=10, help="neighbors per query")
    p.add_argument("--batch", type=int, default=0,
                   help="query batch size for the QPS measurement "
                   "(0 = one pass over the query set)")
    p.add_argument("--save", default=None, help="save the index to this dir")
    p.add_argument("--load", default=None, help="load an index instead of building")
    p.add_argument("--import-reference", default=None,
                   help="import a reference-format (Rust hnsw_rs) index dir")
    p.add_argument("--words", action="store_true",
                   help="interactive nearest-word REPL after evaluation")
    p.add_argument("--cpu", action="store_true", help="force the CPU backend")
    p.add_argument("--quiet", action="store_true")
    return p
