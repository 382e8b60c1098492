"""Build a k-NN index over an embedding database (counterpart of
`scripts/train_searcher.py`):

    python -m ealdm_torch.scripts.train_searcher -d <image dir or .npz>
        -t <index.npz> [--size 256] [--num_leaves N] [--device cuda]

An `.npz` database is indexed as it is; an image folder (PNG and `.npy`) is
embedded first by `retrieval.build_image_database` (the ResNet-50 trunk's
pooled features, seeded weights). `--num_leaves` forces a partitioned
index probed max(N // 20, 1) leaves at a time; without it
`auto_build_searcher` chooses by size. The index loads in both packages'
`Searcher.load`.
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def main(argv=None):
    """Run the tool on `argv` (sys.argv[1:] if None); returns the Searcher."""
    from ..retrieval import Searcher, auto_build_searcher, build_image_database
    from ..utils.device import resolve_device

    p = argparse.ArgumentParser()
    p.add_argument("-d", "--database", type=str, required=True,
                   help="image dir or .npz embedding database")
    p.add_argument("-t", "--target_path", type=str, required=True,
                   help="output index path (.npz)")
    p.add_argument("-k", "--knn", type=int, default=10)
    p.add_argument("--size", type=int, default=256)
    p.add_argument("--num_leaves", type=int, default=None,
                   help="force a partitioned index with this many leaves "
                        "(default: size-based selection)")
    p.add_argument("--device", type=str, default="cuda",
                   help="where to run: cuda (the default; raises without a card) or cpu")
    opt = p.parse_args(argv)
    dev = resolve_device(opt.device)

    if opt.database.endswith(".npz"):
        db = dict(np.load(opt.database))
    else:
        db = build_image_database(opt.database, size=opt.size, device=dev)
    if opt.num_leaves:
        searcher = Searcher.from_database(db, device=dev)
        searcher.build_partitions(opt.num_leaves)
        # persist a probe count, else the loaded index searches exactly
        searcher.default_leaves_to_search = max(opt.num_leaves // 20, 1)
    else:
        searcher = auto_build_searcher(db, device=dev)
    os.makedirs(os.path.dirname(opt.target_path) or ".", exist_ok=True)
    searcher.save(opt.target_path)
    print(f"Index with {searcher.num_entries} entries of dim {searcher.dim} saved to "
          f"{opt.target_path}")
    return searcher


if __name__ == "__main__":
    main(sys.argv[1:])
