"""Error-correction table for offloaded serving: a second int8 residual layer
over the stream table's quantization error.

Port of ``vector_indexer_tpu/ops/correction.py``. Offload mode frees the f32
main table and serves from a compact quantized stream table; exact
distances then need the host mirror (rerank='host'). rerank='device' keeps
the re-rank on the device instead: it stores q2 = round(err / s2), where
err = r - r^ is the stream table's own quantization error and
s2 = max_cluster|err| / 127, so that the reconstruction

    x^ = c + r^ + s2 * q2

carries ~14 effective bits per component for an int8 stream table
(s2 ~ s1 / 127). Re-ranking the widened shortlist against x^ gives
distances about two orders closer to exact f32 than the int8 ranking, with
no host work. Device bytes: d + 4 per row on top of the stream table (q2
and |x^|^2), plus the main-row -> stream-row map.

Plain PyTorch and numpy: no kernel here.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .block_stream import _TILE_BYTES, StreamTable, _stream_maps

_SENTINEL = 1e30


@dataclasses.dataclass
class CorrectionTable:
    """Second-layer int8 correction aligned with a StreamTable's rows."""

    q2: torch.Tensor  # (m_pad, d) int8 quantized quantization error
    scales2: torch.Tensor  # (kc,) f32 per-cluster dequant scale of q2
    norms_abs: torch.Tensor  # (m_pad,) f32 |x^|^2 ABSOLUTE norms; 1e30 on pads
    inv: torch.Tensor  # (n_pad_main,) int64 main layout row -> stream row
    m_pad: int

    @property
    def nbytes(self) -> int:
        return (self.q2.numel() + 4 * self.norms_abs.numel() + 8 * self.inv.numel()
                + 4 * self.scales2.numel())


def _inv_map(to_main: np.ndarray, main_pad_row: int, n_pad: int) -> np.ndarray:
    """Main layout row -> stream row. Rows outside to_main's image (gaps, the
    pad row) map to stream row 0: they are never selected (their kernel
    distances are sentinels), the 0 only keeps gathers in bounds."""
    inv = np.zeros(n_pad, np.int64)
    real = to_main != main_pad_row
    inv[to_main[real]] = np.flatnonzero(real)
    return inv


def _maps(layout, st: StreamTable, n_pad: int):
    main_pad_row = n_pad - 1
    chunk, _, m_pad, to_main, row_cid = _stream_maps(
        layout.lengths, layout.offsets[:-1], layout.dim, st.vecs.element_size(),
        main_pad_row, st.chunk,
    )
    if m_pad != st.m_pad or chunk != st.chunk:
        raise ValueError("correction table must match the stream table")
    return main_pad_row, to_main, row_cid


def build_correction_table(layout, st: StreamTable) -> CorrectionTable:
    """Device build (``offload_main_table``: layout.vectors still on the
    device). Two passes over row tiles of _TILE_BYTES of f32 (2^19 rows at
    d 128): the per-cluster max|err|,
    then quantize and take the absolute norms. The first layer is read from
    the live stream table, so the correction is exact against what the
    kernels sweep."""
    dev = layout.vectors.device
    n_pad = layout.vectors.shape[0]
    main_pad_row, to_main, row_cid = _maps(layout, st, n_pad)
    kc = len(layout.lengths)
    m_pad = st.m_pad
    to_main_t = torch.as_tensor(to_main, device=dev)
    row_cid_t = torch.as_tensor(row_cid, device=dev)
    real = to_main_t != main_pad_row
    R = max(1, _TILE_BYTES // (4 * layout.dim))

    def err_tile(lo, hi):
        ct = row_cid_t[lo:hi]
        res = layout.vectors[to_main_t[lo:hi]]
        res.sub_(st.cent[ct]).mul_(real[lo:hi, None])
        deq1 = st.vecs[lo:hi].to(torch.float32) * st.scales[ct][:, None]
        return res.sub_(deq1), deq1

    s2max = torch.zeros(kc, dtype=torch.float32, device=dev)
    for lo in range(0, m_pad, R):
        hi = min(lo + R, m_pad)
        m = err_tile(lo, hi)[0].abs().amax(dim=1) * real[lo:hi]
        s2max.scatter_reduce_(0, row_cid_t[lo:hi], m, reduce="amax")
    scales2 = (s2max / 127.0).clamp_min(1e-12)

    q2 = torch.empty((m_pad, layout.dim), dtype=torch.int8, device=dev)
    norms = torch.empty(m_pad, dtype=torch.float32, device=dev)
    for lo in range(0, m_pad, R):
        hi = min(lo + R, m_pad)
        ct = row_cid_t[lo:hi]
        err, deq1 = err_tile(lo, hi)
        s2 = scales2[ct][:, None]
        q = torch.round(err / s2).clamp_(-127, 127)
        q2[lo:hi] = q.to(torch.int8)
        xhat = st.cent[ct] + deq1 + q * s2
        norms[lo:hi] = torch.where(real[lo:hi], torch.sum(xhat * xhat, dim=1),
                                   torch.tensor(_SENTINEL, device=dev))
    return CorrectionTable(
        q2=q2, scales2=scales2, norms_abs=norms,
        inv=torch.as_tensor(_inv_map(to_main, main_pad_row, n_pad), device=dev),
        m_pad=m_pad,
    )


def build_correction_table_host(layout, st: StreamTable) -> CorrectionTable:
    """Host (numpy) twin for host-staged layouts (``offload_from_host``):
    only the compact q2 / norms / inv arrays are uploaded to the stream
    table's device; the f32 corpus never reaches it. The first layer is
    re-derived with build_stream_table_host's formulas (bit-identical on the
    host) instead of copying the table back."""
    dev = st.vecs.device
    vecs_host = np.asarray(layout.vectors)
    n_pad = vecs_host.shape[0]
    main_pad_row, to_main, row_cid = _maps(layout, st, n_pad)
    kc = len(layout.lengths)
    m_pad = st.m_pad
    cent = st.cent.cpu().numpy()
    s1 = st.scales.cpu().numpy()
    real = to_main != main_pad_row
    R = max(1, _TILE_BYTES // (4 * layout.dim))

    def err_tile(lo, hi):
        cids = row_cid[lo:hi]
        res = vecs_host[to_main[lo:hi]].astype(np.float32, copy=True)
        res -= cent[cids]
        res[~real[lo:hi]] = 0.0
        if st.dtype == torch.int8:
            s = s1[cids][:, None]
            deq1 = np.clip(np.round(res / s), -127, 127) * s
        else:
            deq1 = torch.from_numpy(res).to(st.dtype).to(torch.float32).numpy()
        return res - deq1, deq1

    s2max = np.zeros(kc, np.float32)
    for lo in range(0, m_pad, R):
        hi = min(lo + R, m_pad)
        m = np.abs(err_tile(lo, hi)[0]).max(axis=1) * real[lo:hi]
        np.maximum.at(s2max, row_cid[lo:hi], m.astype(np.float32))
    scales2 = np.maximum(s2max / np.float32(127.0), np.float32(1e-12))

    q2 = np.empty((m_pad, layout.dim), np.int8)
    norms = np.empty(m_pad, np.float32)
    for lo in range(0, m_pad, R):
        hi = min(lo + R, m_pad)
        cids = row_cid[lo:hi]
        err, deq1 = err_tile(lo, hi)
        s2 = scales2[cids][:, None]
        q = np.clip(np.round(err / s2), -127, 127)
        q2[lo:hi] = q.astype(np.int8)
        xhat = cent[cids] + deq1 + q * s2
        norms[lo:hi] = np.where(real[lo:hi], (xhat * xhat).sum(axis=1), np.float32(_SENTINEL))
    return CorrectionTable(
        q2=torch.as_tensor(q2, device=dev),
        scales2=torch.as_tensor(scales2, device=dev),
        norms_abs=torch.as_tensor(norms, device=dev),
        inv=torch.as_tensor(_inv_map(to_main, main_pad_row, n_pad), device=dev),
        m_pad=m_pad,
    )
