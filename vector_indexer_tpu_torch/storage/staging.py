"""Host rows onto a card through two pinned staging buffers.

A copy to a card from pageable host memory waits for the card; from a
pinned buffer it is only enqueued. Two buffers take turns: the host fills
one while the copy out of the other runs, and a buffer is filled again only
once the copy enqueued from it has finished. The parallel packing of each
card's slice (``parallel/sharded.py``) and the offload table's build
(``index/offload.py``) both read a host table this way.
"""

from __future__ import annotations

from typing import Callable, Iterator, Tuple

import numpy as np
import torch

STAGE_BYTES = 256 << 20  # each of the two buffers


def staged_rows(end: int, d: int, fill: Callable[[int, int, np.ndarray], None],
                cuda: bool) -> Iterator[Tuple[int, int, torch.Tensor]]:
    """Yield (lo, hi, buffer) for rows 0:end in steps of STAGE_BYTES of
    float32 rows of width ``d``: ``fill(lo, hi, out)`` has written rows
    lo:hi into ``out``, the numpy view of ``buffer`` (a (hi - lo, d)
    float32 CPU tensor, pinned where ``cuda``). The caller enqueues
    its copy of ``buffer`` onward before it asks for the next step: the
    buffer is not written again until that copy, enqueued on the current
    stream, has run. On return every copy has run."""
    rows = max(1, min(STAGE_BYTES // (4 * d), end))
    bufs = [torch.empty((rows, d), dtype=torch.float32, pin_memory=cuda) for _ in range(2)]
    done = [None, None]
    for i, lo in enumerate(range(0, end, rows)):
        hi = min(lo + rows, end)
        if done[i % 2] is not None:
            done[i % 2].synchronize()  # the buffer's last copy has finished
        buf = bufs[i % 2][: hi - lo]
        fill(lo, hi, buf.numpy())
        yield lo, hi, buf
        if cuda:
            done[i % 2] = torch.cuda.Event()
            done[i % 2].record()
    for ev in done:
        if ev is not None:
            ev.synchronize()
