"""Packed-CSR candidate enumeration for IVF posting lists, and the shape
quantization shared by the stream-slot and gather-budget sizing.

Port of ``vector_indexer_tpu/ops/gather.py``. Each query packs its probed
lists head to tail: with per-probe lengths ``ln`` and inclusive prefix sums
``cum``, candidate slot j belongs to probe ``seg = searchsorted(cum, j)``
and is row ``starts[seg] + j - cum[seg - 1]``. The budget C then scales
with the sum of the probed lists' lengths, not with n_probe x the longest
list. Probes come in nearest-centroid order, so a budget that truncates
drops the farthest probes' rows first.
"""

from __future__ import annotations

import numpy as np
import torch


def packed_candidate_rows(starts: torch.Tensor, lengths: torch.Tensor, budget: int,
                          pad_row: int):
    """(q, p) probed list starts and lengths -> (rows (q, C) int64, valid
    (q, C) bool); invalid slots hold ``pad_row``. The reference unrolls a
    loop over p (a gather-free form for the TPU); ``searchsorted`` gives the
    same rows."""
    q = starts.shape[0]
    cum = torch.cumsum(lengths.long(), dim=1)  # inclusive prefix sums
    j = torch.arange(budget, device=starts.device).expand(q, budget).contiguous()
    seg = torch.searchsorted(cum.contiguous(), j, right=True)  # first cum > j
    valid = j < cum[:, -1:]
    seg = seg.clamp_max(max(starts.shape[1] - 1, 0))
    cum_prev = torch.gather(cum - lengths.long(), 1, seg)
    rows = torch.gather(starts.long(), 1, seg) + j - cum_prev
    return torch.where(valid, rows, torch.full_like(rows, pad_row)), valid


def quantize_up(x: int) -> int:
    """Round up to the {2^m, 1.5*2^m} grid (<= 33% overshoot). The stream
    program's slot count and the gather budget land on this grid, as in the
    reference, so that both packages size the same work."""
    if x <= 1:
        return 1
    m = 1 << (x - 1).bit_length()  # next pow2 >= x
    # 0.75*m is the grid point between 2^(m-1) and 2^m.
    return m - (m >> 2) if x <= m - (m >> 2) else m


BUDGET_ALIGN = 128


def candidate_budget(lengths_np, n_probe: int) -> int:
    """Static budget C: the sum of the n_probe longest lists (never
    truncates), quantized up to the {2^m, 1.5*2^m} grid and 128-aligned."""
    ln = np.sort(np.asarray(lengths_np))[::-1]
    c = int(ln[: min(n_probe, len(ln))].sum())
    c = max(BUDGET_ALIGN, quantize_up(c))
    return -(-c // BUDGET_ALIGN) * BUDGET_ALIGN
