"""Single-source search-method dispatch.

One module decides which search program runs for an (nq, n_probe, k)
operating point: the dense-vs-stream byte model, the fused-kernel gates and
the stream slot/tile sizing. ``IvfIndex.search_batch_device`` binds the
returned ``Decision`` to a program (index/programs.py).

Port of ``vector_indexer_tpu/index/dispatch.py``. The constants are the
reference's, calibrated on a TPU v5e and copied unchanged so that both
packages pick the same programs; ROADMAP Queue 1 item 10 re-measures them
on the H100. Differences from the reference:

* the fused programs are always available (the reference gates them on a
  TPU backend); on the CPU their kernels run their plain versions;
* ``dense`` below the fused gate (n <= 50k, d % 128 != 0, or no fused
  plan) runs one plain PyTorch dense program, program name ``dense_torch``;
* programs outside the ported slice raise ``NotImplementedError`` naming
  their ROADMAP item.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

_QUERY_TILE = 256  # queries per tile in the tiled search programs

# Fixed per-query overhead of the stream path in byte-equivalents
# (the reference's v5e calibration).
STREAM_FIXED_QBYTES = 160 << 10

# Block-major query sharing (stream_shared, kernel K5) wins only at huge
# probed footprints (the reference's v5e calibration).
SHARED_MIN_PROBED_ROWS = 512 << 10
SHARED_MIN_NQ = 1024

STREAM_ITEMSIZE = 2  # the ported stream table is bf16


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def pick_q_tile(nq: int, budget: int, d: int, mem_cap_bytes: int = 3 << 29) -> int:
    """Query tile so per-tile intermediates stay under ~mem_cap bytes."""
    per_query = max(1, budget * d * 4)
    qt = max(8, min(_QUERY_TILE, mem_cap_bytes // per_query))
    qt = min(qt, _round_up(nq, 8))
    return max(8, (qt // 8) * 8)


def mean_slot_rows_of(lengths_np, chunk: int) -> float:
    """Expected chunk-aligned probed rows per cell (mean over cells)."""
    chunk = max(chunk, 1)
    if len(lengths_np) == 0:
        return 0.0
    return float(np.ceil(lengths_np / chunk).mean()) * chunk


def shared_gate(nq: int, n_probe: int, mean_slot_rows: float) -> bool:
    """The shared-kernel upgrade rule."""
    return nq >= SHARED_MIN_NQ and n_probe * mean_slot_rows >= SHARED_MIN_PROBED_ROWS


def choose_sweep_body(
    lengths_np, n_rows: int, d: int, itemsize: int, nq: int, n_probe: int,
    chunk: int, allow_shared: bool = False,
) -> str:
    """Dense-vs-stream byte model. Per query: stream costs the expected
    chunk-aligned probed bytes (+15% task overhead) plus
    STREAM_FIXED_QBYTES; dense costs the whole table once per query tile."""
    if n_rows == 0 or len(lengths_np) == 0:
        return "dense"
    mean_slot_rows = mean_slot_rows_of(lengths_np, chunk)
    stream_q = n_probe * mean_slot_rows * d * itemsize * 1.15 + STREAM_FIXED_QBYTES
    q_tile_d = pick_q_tile(nq, max(n_rows * 4 // d, 1), d)
    dense_q = -(-nq // q_tile_d) * n_rows * d * 4 / max(nq, 1)
    if dense_q <= stream_q:
        return "dense"
    if allow_shared and shared_gate(nq, n_probe, mean_slot_rows):
        return "stream_shared"
    return "stream"


def stream_params(
    lengths_np, d: int, itemsize: int, nq: int, n_probe: int,
    chunk: Optional[int] = None,
) -> Tuple[int, int, int]:
    """Static sizing of the (bf16, unshared) stream program: (chunk,
    t_fixed, q_tile). ``chunk=None`` derives the chunk build_stream_table
    picks."""
    from ..ops.block_stream import SMEM_TASK_CAP, per_query_slots, pick_chunk

    if chunk is None:
        chunk = pick_chunk(lengths_np, d, itemsize)
    t_fixed = per_query_slots(lengths_np, n_probe, chunk=chunk)
    q_tile = max(8, min(_QUERY_TILE, (SMEM_TASK_CAP // max(t_fixed, 1)) // 8 * 8))
    q_tile = min(q_tile, _round_up(nq, 8))
    return chunk, t_fixed, q_tile


@dataclasses.dataclass
class Decision:
    """A resolved search method: the concrete program and the static
    parameters that size its work. ``method`` is the user-facing resolved
    label; ``program`` names the code path."""

    method: str
    program: str  # 'dense_fused' | 'dense_torch' | 'stream'
    q_tile: int = 0
    plan: Optional[Tuple[int, int, int]] = None  # fused (w, q_tile, c_groups)
    t_fixed: int = 0  # stream task slots per query
    chunk: int = 0  # stream block rows


_NOT_PORTED = {
    "stream_exact": "the f32 stream table (ROADMAP Queue 2, K2 f32-exact mode)",
    "stream_shared": "kernel K5 (ROADMAP Queue 2)",
    "stream_shared_exact": "kernel K5 (ROADMAP Queue 2)",
    "gather": "the packed-gather program (ROADMAP Queue 1 item 5)",
    "gather_dma": "kernel K6 (ROADMAP Queue 2)",
    "flat": "the flat programs (ROADMAP Queue 1 item 7)",
    "flat_exact": "the flat programs (ROADMAP Queue 1 item 7)",
    "flat_fused": "the flat programs (ROADMAP Queue 1 item 7)",
    "flat_int8": "the int8 modes of K3 (ROADMAP Queue 2)",
    "flat_int8x1": "the int8 modes of K3 (ROADMAP Queue 2)",
    "dense_int8": "the int8 modes of K3 (ROADMAP Queue 2)",
    "dense_int8x1": "the int8 modes of K3 (ROADMAP Queue 2)",
    "staged": "host-staged serving (ROADMAP Queue 1 item 13)",
}


def resolve(core, nq: int, n_probe: int, k: int = 100, method: str = "auto") -> Decision:
    """Resolve ``method`` (possibly 'auto') for an IvfIndex at one
    (nq, n_probe, k) point into the concrete program and its parameters."""
    lay = core.layout
    d = core.dimension
    n_probe = min(n_probe, core.num_clusters)
    table_rows = lay.vectors.shape[0]

    if method == "auto":
        method = core.choose_method(nq, n_probe)
    if method in _NOT_PORTED:
        raise NotImplementedError(
            f"search method {method!r} needs {_NOT_PORTED[method]}, not ported yet"
        )

    if method in ("dense", "dense_exact", "dense_fused"):
        want_fused = method == "dense_fused" or (method == "dense" and lay.n > 50_000)
        if want_fused and d % 128 == 0:
            from ..ops.flat_sweep import plan_fused

            plan = plan_fused(table_rows, d, nq, k)
            if plan is not None:
                return Decision(
                    method=method, program="dense_fused", q_tile=plan[1], plan=plan,
                )
        return Decision(
            method=method, program="dense_torch",
            q_tile=pick_q_tile(nq, table_rows * 4 // d, d),
        )

    if method == "stream":
        chunk, t_fixed, q_tile = stream_params(
            np.asarray(lay.lengths), d, STREAM_ITEMSIZE, nq, n_probe
        )
        return Decision(
            method=method, program="stream", q_tile=q_tile, t_fixed=t_fixed, chunk=chunk,
        )
    raise ValueError(f"unknown search method: {method}")
