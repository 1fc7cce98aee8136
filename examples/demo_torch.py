"""Load-or-build demo on the PyTorch/CUDA port (parity with the original
system's examples/demo.rs, and with examples/demo.py).

Generates a test-vector file if absent, builds (or loads) the index, and
runs one default-parameter search. It runs on the first CUDA device and
raises when there is none; ``--cpu`` runs it on the CPU.

    python examples/demo_torch.py [--count 50000] [--dim 128] [--cpu]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

# Runnable from any cwd in a source checkout (pip installs don't need this).
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--count", type=int, default=50_000)
    p.add_argument("--dim", type=int, default=128)
    p.add_argument("--work-dir", default="demo_work_torch")
    p.add_argument("--cpu", action="store_true", help="run on the CPU instead of cuda:0")
    args = p.parse_args()

    import vector_indexer_tpu_torch as vx
    from vector_indexer_tpu_torch.device import resolve_device
    from vector_indexer_tpu_torch.utils import generate_test_vectors
    from vector_indexer_tpu_torch.utils.tracing import enable_console_logging

    device = resolve_device("cpu" if args.cpu else None)  # raises without a card
    enable_console_logging()

    vec_file = os.path.join(args.work_dir, f"test_vectors_{args.count}.bin")
    cfg = (
        vx.VectorIndexerConfig(args.dim)
        .with_index_dir(os.path.join(args.work_dir, "index"))
        .with_shards_dir(os.path.join(args.work_dir, "shards"))
        .with_device(device)
    )

    os.makedirs(args.work_dir, exist_ok=True)
    if not os.path.exists(vec_file):
        print(f"generating {args.count} x {args.dim} test vectors...")
        generate_test_vectors(vec_file, args.count, args.dim, seed=42)

    # Load-or-build (demo.rs:12-23).
    try:
        indexer = vx.VectorIndexer.load(cfg)
        print("loaded existing index")
    except FileNotFoundError:
        print("building index...")
        t0 = time.time()
        indexer = vx.VectorIndexer(cfg).build_from_vector_file(vec_file)
        print(f"built in {time.time() - t0:.1f}s")

    query = np.random.default_rng(7).uniform(-1, 1, args.dim).astype(np.float32)
    t0 = time.time()
    results = indexer.search_sync(indexer.search_request(query))
    print(f"search took {(time.time() - t0) * 1000:.1f} ms")
    for r in results:
        print(f"  external_id={r.external_id}  distance={r.distance:.4f}")


if __name__ == "__main__":
    main()
