"""Single-source search-method dispatch.

One module decides which search program runs for an (nq, n_probe, k)
operating point: the dense-vs-stream byte model, the fused-kernel gates and
the stream slot/tile sizing. ``IvfIndex.search_batch_device`` binds the
returned ``Decision`` to a program (index/programs.py).

Port of ``vector_indexer_tpu/index/dispatch.py``. The constants are the
reference's, calibrated on a TPU v5e and copied unchanged so that both
packages pick the same programs; ROADMAP Queue 1 item 4 re-measures them
on the H100. A host-resident index resolves to ``staged`` whatever the
method (index/staged.py), and ``staged`` on any other index raises, as in
the reference. Differences from the reference:

* the fused programs are always available (the reference gates them on a
  TPU backend); on the CPU their kernels run their plain versions. So on
  the CPU the reference's ``flat_int8`` becomes ``flat``, and the port's
  does not;
* the stream table's itemsize comes from the index's ``stream_dtype``
  (bf16 by default; int8 after offload), and the ``*_exact`` stream
  methods size an f32 table, as in the reference;
* ``dense`` and ``flat`` below the fused gate (n <= 50k, d % 128 != 0,
  or no fused plan) run plain PyTorch programs, ``dense_torch`` and
  ``flat_torch`` (exact top-k where the reference's ``flat_xla`` uses
  ``approx_min_k``);
* ``gather_dma`` always runs kernel K6. The reference falls back to
  ``gather`` when d % 128 != 0, when the (p, max_len, d) VMEM scratch
  would pass 12 MB, or when the budget passes 32,768 slots: limits of the
  TPU kernel (lane tiling, VMEM, slot clamping) that the CUDA kernel does
  not have (it reads each list in place and, past 12,288 dims, the query
  partly through L1, so it serves any d). Both programs return the same
  sets, so the two packages agree on results where their programs differ.
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


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def stream_itemsize(dtype) -> int:
    """Bytes per element of a stream table of this torch dtype."""
    import torch

    return torch.empty((), dtype=dtype).element_size()


def pick_q_tile(nq: int, budget: int, d: int, mem_cap_bytes: int = 3 << 29) -> int:
    """Query tile so per-tile intermediates stay under ~mem_cap bytes."""
    per_query = max(1, budget * d * 4)
    qt = max(8, min(_QUERY_TILE, mem_cap_bytes // per_query))
    qt = min(qt, _round_up(nq, 8))
    return max(8, (qt // 8) * 8)


def fused_sweep_fits(d: int) -> bool:
    """The fused sweeps' (K3) width gate, for every searcher: the
    reference's TPU lane tile."""
    return d % 128 == 0


def stream_q_tile(t_fixed: int) -> int:
    """Queries per stream tile: as many as keep its ``t_fixed`` task slots
    per query under SMEM_TASK_CAP, 8 to 256 in steps of 8."""
    from ..ops.block_stream import SMEM_TASK_CAP

    return max(8, min(_QUERY_TILE, (SMEM_TASK_CAP // max(t_fixed, 1)) // 8 * 8))


def mean_slot_rows_of(lengths_np, chunk: int) -> float:
    """Expected chunk-aligned probed rows per cell (mean over cells): the
    footprint unit the stream gates are calibrated in."""
    chunk = max(chunk, 1)
    if len(lengths_np) == 0:
        return 0.0
    return float(np.ceil(lengths_np / chunk).mean()) * chunk


def shared_gate(nq: int, n_probe: int, mean_slot_rows: float) -> bool:
    """The one shared-kernel (K5) upgrade rule, for both the
    device-resident (``choose_sweep_body``) and the offloaded branch of
    ``IvfIndex.choose_method``."""
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
    *, exact: bool = False, shared: bool = False, chunk: Optional[int] = None,
) -> Tuple[int, int, int, int]:
    """Static sizing of a stream program: (chunk, t_fixed, q_tile, t_cap).
    ``exact`` sizes worst-case slots (no chunk is ever dropped); ``shared``
    tiles up to 1024 queries (sharing grows with the tile) and halves the
    tile until the task budget t_cap fits SMEM_TASK_CAP and the per-tile
    plane + query rows (Q_SHARE * (chunk + d) * 4 B per task) fit 256 MB.
    ``chunk=None`` derives the chunk build_stream_table picks."""
    from ..ops.block_stream import (
        Q_SHARE,
        SMEM_TASK_CAP,
        per_query_slots,
        pick_chunk,
        shared_task_cap,
    )

    if chunk is None:
        chunk = pick_chunk(lengths_np, d, itemsize)
    t_fixed = per_query_slots(lengths_np, n_probe, worst_case=exact, chunk=chunk)
    q_tile = stream_q_tile(t_fixed)
    t_cap = 0
    if shared:
        q_tile = max(8, min(1024, _round_up(nq, 8)))
        while True:
            t_cap = shared_task_cap(lengths_np, n_probe, q_tile, t_fixed,
                                    worst_case=exact, chunk=chunk)
            if q_tile <= 8 or (
                t_cap <= SMEM_TASK_CAP
                and t_cap * Q_SHARE * (chunk + d) * 4 <= (256 << 20)
            ):
                break
            q_tile = max(8, q_tile // 2)
    q_tile = min(q_tile, _round_up(nq, 8))
    return chunk, t_fixed, q_tile, t_cap


@dataclasses.dataclass
class Decision:
    """A resolved search method: the concrete program and the static
    parameters that size its work. ``method`` is the user-facing resolved
    label; ``program`` names the code path."""

    method: str
    program: str  # 'flat_fused' | 'flat_torch' | 'dense_fused' | 'dense_torch' |
    #               'stream' | 'stream_shared' | 'gather' | 'gather_dma' | 'staged'
    q_tile: int = 0
    plan: Optional[Tuple[int, int, int]] = None  # fused (w, q_tile, c_groups)
    precision: str = "highest"  # fused sweep precision: 'highest' (f32), 'int8', 'int8x1'
    budget: int = 0  # gather candidate budget (slots per query)
    t_fixed: int = 0  # stream task slots per query
    chunk: int = 0  # stream block rows
    t_cap: int = 0  # shared-kernel task budget per tile
    exact: bool = False  # *_exact stream variant (f32 table, exact selection)


_SWEEP_METHODS = (
    "flat", "flat_exact", "flat_fused", "flat_int8", "flat_int8x1",
    "dense", "dense_exact", "dense_fused", "dense_int8", "dense_int8x1",
)

def resolve(core, nq: int, n_probe: int, k: int = 100, method: str = "auto") -> Decision:
    """Resolve ``method`` (possibly 'auto') for an IvfIndex at one
    (nq, n_probe, k) point into the concrete program and its parameters."""
    if getattr(core, "host_resident", False):
        return Decision(method="staged", program="staged")
    lay, tables = core.layout, core.tables()
    d = core.dimension
    n_probe = min(n_probe, core.num_clusters)

    if method == "auto":
        method = core.choose_method(nq, n_probe)
    if method == "staged":
        raise RuntimeError("method='staged' requires a host-resident index (load with "
                           "resident='host' or call to_host_resident())")

    from ..ops.flat_sweep import plan_fused

    if method in _SWEEP_METHODS:
        kind = "flat" if method.startswith("flat") else "dense"
        fits = fused_sweep_fits(d)
        # The int8 fixed-point sweeps, or their f32 twins where no plan fits.
        if method.endswith(("_int8", "_int8x1")):
            prec = "int8x1" if method.endswith("x1") else "int8"
            plan = plan_fused(tables.rows, d, nq, k, precision=prec) if fits else None
            if plan is not None:
                return Decision(method=method, program=f"{kind}_fused", q_tile=plan[1],
                                plan=plan, precision=prec)
            method = kind
        # flat_fused below the size gate still runs the plain flat program.
        want_fused = method == "dense_fused" or (
            method in ("flat", "flat_fused", "dense") and lay.n > 50_000)
        if want_fused and fits:
            plan = plan_fused(tables.rows, d, nq, k)
            if plan is not None:
                return Decision(method=method, program=f"{kind}_fused", q_tile=plan[1], plan=plan)
        return Decision(
            method=method, program=f"{kind}_torch",
            q_tile=pick_q_tile(nq, tables.rows * 4 // d, d),
        )

    if method in ("stream", "stream_exact", "stream_shared", "stream_shared_exact"):
        exact = method.endswith("_exact")
        shared = method.startswith("stream_shared")
        itemsize = 4 if exact else stream_itemsize(core.stream_dtype)
        chunk, t_fixed, q_tile, t_cap = stream_params(
            np.asarray(lay.lengths), d, itemsize, nq, n_probe, exact=exact, shared=shared,
        )
        return Decision(
            method=method, program="stream_shared" if shared else "stream", q_tile=q_tile,
            t_fixed=t_fixed, chunk=chunk, t_cap=t_cap, exact=exact,
        )

    if method in ("gather", "gather_dma"):
        budget = tables.budget(n_probe)
        return Decision(method=method, program=method, budget=budget,
                        q_tile=pick_q_tile(nq, budget, d))
    raise ValueError(f"unknown search method: {method}")
