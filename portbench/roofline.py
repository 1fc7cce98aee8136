"""The least time the card could take for a search's work: a frozen copy of
``chip_smoke.py``'s ``bound`` arithmetic and the H100's data-sheet peaks.

Peaks are NVIDIA's for one H100 SXM at its 700 W limit, dense, without
sparsity. A card set below 700 W runs slower under load, so every share is
stated against these peaks with the card's power limit (``power_limit``)
beside it.
"""

from __future__ import annotations

import subprocess

HBM_BYTES_S = 3.35e12
F32_FLOP_S = 67e12
TF32_FLOP_S = 495e12
INT8_OP_S = 1979e12

# Peak of the products a table's rows need against f32 queries, by the rows'
# precision: an f32 row takes three TF32 products for f32 accuracy
# (3xTF32), a bf16 row is exact in TF32 against a query split in two TF32
# parts, int8 rows run at the int8 rate. Each is the fastest the card
# reaches at that precision, so no implementation of a route beats the
# bound it gives.
PEAK = {"f32": TF32_FLOP_S / 3, "bf16": TF32_FLOP_S / 2, "int8": INT8_OP_S}


def bound(nbytes: float, ops: float, rate: float) -> dict:
    """The least time (s) for a function that must move ``nbytes`` and do
    ``ops`` operations of a type peaking at ``rate``."""
    t_bytes, t_ops = nbytes / HBM_BYTES_S, ops / rate
    return dict(bound_s=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else "operations")


def search_bound(nq: int, d: int, k: int, nlist: int, distinct_rows: int, pair_rows: int,
                 row_bytes: float, precision: str) -> dict:
    """One search call: each distinct probed row read once with its 4-byte
    norm, the centroids, the f32 queries and the outputs (f32 distance and
    int64 id per result) moved; 2 d operations per
    (query, probed row) pair (``pair_rows`` summed over the queries) plus
    the coarse scan's 2 d per (query, centroid), at the ``PEAK`` of the
    table's ``precision``. ``row_bytes``: bytes per element of the table."""
    nbytes = (distinct_rows * (d * row_bytes + 4) + nlist * d * 4 + nq * d * 4
              + nq * k * (4 + 8))
    ops = 2.0 * d * (pair_rows + nq * nlist)
    return bound(nbytes, ops, PEAK[precision])


def power_limit() -> str:
    """The first card's name and power limit as nvidia-smi reports them, or
    'not read' where nvidia-smi is absent."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return "not read"
    lines = out.stdout.strip().splitlines()
    return lines[0] if out.returncode == 0 and lines else "not read"
