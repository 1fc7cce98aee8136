"""Shape quantization shared by the stream-slot sizing."""

from __future__ import annotations


def quantize_up(x: int) -> int:
    """Round up to the {2^m, 1.5*2^m} grid (<= 33% overshoot). The stream
    program's slot count lands on this grid so that nearby n_probe values
    size the same task grid, as in the reference."""
    if x <= 1:
        return 1
    m = 1 << (x - 1).bit_length()  # next pow2 >= x
    # 0.75*m is the grid point between 2^(m-1) and 2^m.
    return m - (m >> 2) if x <= m - (m >> 2) else m
