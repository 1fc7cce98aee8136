"""Readings behind the comparison's limits, several seeds in one process.

    python3 portbench/calibrate.py --workload <cell> --seeds 11,12,13 --seconds 5 \
        [--fault unchanged]

For each seed it runs the cell as ``run.py`` does (set-up, a window of
``--seconds``, the comparison) and prints one JSON line: the program's
numbers (the lower readings), each control's (``compare.CONTROLS``: the
reference in the program's place one precision below what the
configuration states: the upper readings), and the run's end-to-end
metrics.
``--fault unchanged`` plants a fault instead: every Lloyd step returns its
centroids unchanged (the build cell's upper reading for ``lloyd_shift``).
Lines also go to ``--out``. The benchmark's own runs never run this.
"""

import argparse
import json
import os
import sys
import time
from pathlib import Path

for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ.setdefault(_var, "1")  # as run.py runs

ROOT = Path(__file__).resolve().parent.parent
sys.path[0] = str(ROOT)


def unchanged_lloyd(data, init_centroids, gen, k, max_iters, tol, chunk, spherical=False):
    """A Lloyd loop whose every step returns its state unchanged."""
    return init_centroids.clone(), max_iters, False


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--fault", choices=("none", "unchanged"), default="none")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch

    from portbench import harness, roofline

    torch.set_num_threads(1)

    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    if args.fault == "unchanged":
        from vector_indexer_tpu_torch.models import kmeans

        kmeans._lloyd_loop = unchanged_lloyd
    man = harness.manifest()
    device = torch.device("cuda", 0)
    card = roofline.power_limit()
    out = open(args.out, "a") if args.out else None
    for seed in [int(s) for s in args.seeds.split(",")]:
        t0 = time.perf_counter()
        r = harness.run_cell(man, args.workload, seed, args.seconds, False, device, t0,
                             control=args.fault == "none")
        line = json.dumps({
            "workload": args.workload, "seed": seed, "fault": args.fault, "card": card,
            "correct": r["correct"], "attempted": r["attempted"], "failed": r["failed"],
            "program": {k: v["value"] for k, v in r["checks"].items()},
            "control": r.get("control"),
            "metrics": {k: v["value"] for k, v in r["metrics"].items()},
            "memory_peak_bytes": r["device"]["memory_peak_bytes"],
            "seconds": time.perf_counter() - t0})
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
