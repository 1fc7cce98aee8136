"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell, its configuration, traffic mix and limits come from BENCHMARK.json
and the files it names (see README.md). The run needs as many CUDA cards as
the cell asks for, and exits 2 without a result where they are missing: it
never falls back to the CPU. With ``--trace 0`` the result carries the
cell's end-to-end metrics, with ``--trace 1`` its per-layer metrics and the
device breakdown. The numbers compared to decide ``correct`` are printed
last on standard error, each beside its limit, and under ``checks`` as the
result's last key. The last line of standard output is the result.
"""

import time

T_START = time.perf_counter()  # set-up counts from the process's first line

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

# One process with one CPU thread, on one core, drives the card: host-clock
# timings of the host-bound cells spread less than with a pool of threads
# waking per op, or a thread that moves between cores.
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ.setdefault(_var, "1")
if hasattr(os, "sched_setaffinity"):
    os.sched_setaffinity(0, {max(os.sched_getaffinity(0))})

ROOT = Path(__file__).resolve().parent.parent
sys.path[0] = str(ROOT)  # the checkout, not this folder, so the port beside it imports


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from portbench import harness

    torch.set_num_threads(1)

    man = harness.manifest()
    cell = harness.cell_of(man, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {args.workload} needs {cell['chips']} CUDA card(s), found {found}",
              file=sys.stderr)
        return 2
    import vector_indexer_tpu_torch as port

    if not Path(port.__file__).resolve().is_relative_to(ROOT):
        print(f"portbench: imported the port from {port.__file__}, outside {ROOT}",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    result = harness.run_cell(man, args.workload, args.seed, args.seconds, bool(args.trace),
                              device, T_START)
    bad = harness.forbidden_modules()
    if bad:
        print(f"portbench: forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    print(f"window attempted {result['attempted']} failed {result['failed']} requests "
          f"{result.get('requests')}", file=sys.stderr)
    print(f"correct {result['correct']}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
