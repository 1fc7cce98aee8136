"""Run one cell several times, one process a run, as the checker does.

    python3 portbench/series.py --workload <cell> --seeds 1,2,3 --seconds 10 --trace 0 --out FILE

Each run is ``python3 portbench/run.py --workload <cell> --seed <s>
--seconds <n> --trace <t>``; its result line (or, where it printed none,
the end of its standard error) goes to ``--out`` as JSON lines, with the
card's name and power limit, and a short summary is printed. At the end it
prints each end-to-end metric's spread (quartile distance over the median)
over the runs.
"""

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[0] = str(HERE.parent)

from portbench import roofline, stats  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", default="10")
    ap.add_argument("--trace", default="0")
    ap.add_argument("--out", required=True)
    ap.add_argument("--timeout", type=float, default=1300.0)
    args = ap.parse_args(argv)
    card = roofline.power_limit()
    print(f"card: {card}", flush=True)
    values = {}
    with open(args.out, "a") as out:
        for seed in args.seeds.split(","):
            cmd = [sys.executable, str(HERE / "run.py"), "--workload", args.workload, "--seed",
                   seed, "--seconds", args.seconds, "--trace", args.trace]
            t0 = time.perf_counter()
            p = subprocess.run(cmd, capture_output=True, text=True, timeout=args.timeout,
                               cwd=HERE.parent)
            wall = time.perf_counter() - t0
            lines = p.stdout.strip().splitlines()
            try:
                res = json.loads(lines[-1]) if p.returncode == 0 and lines else None
            except json.JSONDecodeError:
                res = None
            rec = {"workload": args.workload, "seed": int(seed), "trace": int(args.trace),
                   "rc": p.returncode, "wall_s": wall, "card": card, "result": res}
            if res is None:
                rec["stderr_tail"] = p.stderr[-3000:]
            out.write(json.dumps(rec) + "\n")
            out.flush()
            if res is None:
                print(f"seed {seed} rc {p.returncode} wall {wall:.1f}\n{p.stderr[-2000:]}",
                      flush=True)
                continue
            m = {k: v["value"] for k, v in res["metrics"].items()}
            for k, v in m.items():
                values.setdefault(k, []).append(v)
            checks = {k: v["value"] for k, v in res["checks"].items()}
            print(f"seed {seed} rc 0 wall {wall:.1f} correct {res['correct']} {json.dumps(m)} "
                  f"peak {res['device']['memory_peak_bytes']} "
                  f"busy {res['device'].get('busy_s')} win {res['device'].get('window_s')} "
                  f"checks {json.dumps(checks)}", flush=True)
    for k, v in values.items():
        if len(v) >= 2:
            print(f"spread {k} {stats.spread(v)!r} median "
                  f"{sorted(v)[len(v) // 2]!r} n {len(v)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
