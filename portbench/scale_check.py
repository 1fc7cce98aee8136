"""Draw and ground-truth a corpus larger than one card, as a configuration with
``"corpus": "host"`` has it done, and print the times and memory peaks.

    python3 portbench/scale_check.py --config portbench/configs/sift1m-l2.json \
        --n 200000000 --seed 1 [--agree-n 2000000] [--cell sift1m.batch-np128] [--out FILE]

Three parts, each printing JSON lines (also appended to ``--out``):

1. ``agree``: at ``--agree-n`` rows, a size one card holds, the host draw
   against the draw on the card, bit for bit, and the streamed top-10 over
   every card against ``reference.ground_truth`` on the first: ids that
   differ, and how many of those are rows equal to the reference's.
2. ``cell`` (with ``--cell``): one untraced and one traced run of that cell's
   files with ``"corpus": "host"`` on every card the machine has, as a cell
   asking for that many chips would run: the result line's ``device``.
3. ``scale``: at ``--n`` rows, the seconds to draw the corpus into host
   memory, and to work out the pool's exact top-10 over one card and over
   every card, with the process's host memory peak and each card's peak.

The configuration gives d, the metric, the query pool and the generator;
``--n`` replaces its n. The benchmark's own runs never run this.
"""

import argparse
import copy
import json
import os
import resource
import sys
import time
from pathlib import Path

for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ.setdefault(_var, "1")  # as run.py runs

ROOT = Path(__file__).resolve().parent.parent
sys.path[0] = str(ROOT)


def mem_available() -> int:
    """The host's available memory in bytes (``MemAvailable``)."""
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) * 1024
    return -1


def host_peak() -> int:
    """This process's peak resident host memory in bytes."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--n", type=int, required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--agree-n", type=int, default=2_000_000)
    ap.add_argument("--cell", default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch

    from portbench import datagen, harness, reference, roofline

    if not torch.cuda.is_available():
        print("scale_check: no CUDA card", file=sys.stderr)
        return 2
    cards = harness.cell_devices(torch.device("cuda", 0), torch.cuda.device_count())
    torch.cuda.set_device(cards[0])
    cfg = harness.load_json(ROOT / args.config)
    gen = {k: v for k, v in cfg["generator"].items() if k != "kind"}
    draw = getattr(datagen, cfg["generator"]["kind"])
    d, nq, metric = cfg["d"], cfg["query_pool"], cfg["metric"]
    out = open(args.out, "a") if args.out else None

    def emit(**rec):
        rec.update(card=roofline.power_limit(), cards=len(cards))
        line = json.dumps(rec)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    def sync():
        for c in cards:
            torch.cuda.synchronize(c)

    def peaks():
        return [int(torch.cuda.max_memory_allocated(c)) for c in cards]

    def reset():
        harness.free(*cards)
        for c in cards:
            torch.cuda.reset_peak_memory_stats(c)

    # 1. Agreement at a size one card holds.
    xb_dev, xq = draw(args.agree_n, d, nq, args.seed, device=cards[0], **gen)
    xb_host, xq_host = draw(args.agree_n, d, nq, args.seed, device=cards[0], host=True, **gen)
    same_bits = bool(torch.equal(xb_dev.cpu(), xb_host) and torch.equal(xq, xq_host))
    ref = reference.ground_truth(xb_dev, xq, metric, 10)
    got = reference.ground_truth_streamed(xb_host, xq, metric, 10, cards)
    diff = (got != ref).nonzero().tolist()
    equal_rows = sum(bool(torch.equal(xb_host[got[i, p].item()], xb_host[ref[i, p].item()]))
                     for i, p in diff)
    gap = 0.0
    if diff:
        q = reference.prepare(xq_host.cpu(), metric, torch.float64)
        for i, p in diff[:1000]:
            a, b = got[i, p].item(), ref[i, p].item()
            da, db = (reference.distances(q[i:i + 1], reference.prepare(
                xb_host[r:r + 1], metric, torch.float64), metric).item() for r in (a, b))
            gap = max(gap, abs(da - db) / max(abs(db), 1e-30))
    emit(part="agree", n=args.agree_n, d=d, same_bits=same_bits, ids_differ=len(diff),
         differ_equal_rows=equal_rows, widest_rel_gap_f64=gap,
         set_differ=int(sum(len(set(got[i].tolist()) ^ set(ref[i].tolist())) > 0
                            for i in range(got.shape[0]))))
    del xb_dev, xq, xb_host, xq_host, ref, got
    reset()

    # 2. A cell's files with its corpus on the host, on every card.
    if args.cell:
        man = copy.deepcopy(harness.manifest())
        cell = harness.cell_of(man, args.cell)
        cell["chips"] = len(cards)
        cell_cfg = dict(harness.config_of(man, cell["config"]), corpus="host")
        for trace in (False, True):
            t0 = time.perf_counter()
            r = harness.run_cell(man, args.cell, args.seed + trace, 5.0, trace, cards[0], t0,
                                 config=cell_cfg)
            emit(part="cell", workload=args.cell, trace=trace, correct=r["correct"],
                 metrics={k: v["value"] for k, v in r["metrics"].items()}, device=r["device"],
                 checks={k: v["value"] for k, v in r["checks"].items()},
                 seconds=time.perf_counter() - t0)
            reset()

    # 3. The corpus at --n rows, in host memory.
    avail = mem_available()
    need = args.n * d * 4
    if need > avail:
        emit(part="scale", n=args.n, skipped=True, need_bytes=need, mem_available=avail)
        return 0
    t0 = time.perf_counter()
    xb, xq = draw(args.n, d, nq, args.seed, device=cards[0], host=True, **gen)
    sync()
    draw_s = time.perf_counter() - t0
    emit(part="scale", step="draw", n=args.n, d=d, seconds=draw_s, mem_available=avail,
         host_peak_bytes=host_peak(), card_peaks=peaks())
    for use in ([cards[0]], cards) if len(cards) > 1 else ([cards[0]],):
        reset()
        t0 = time.perf_counter()
        gt = reference.ground_truth_streamed(xb, xq, metric, 10, use).cpu()
        gt_s = time.perf_counter() - t0
        emit(part="scale", step="ground_truth", n=args.n, nq=nq, on_cards=len(use),
             seconds=gt_s, host_peak_bytes=host_peak(), card_peaks=peaks(),
             gt_head=gt[0].tolist())
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
