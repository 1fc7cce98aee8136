"""Shared helpers for the PyTorch-port parity tests (tests/test_torch_*.py).

Inputs are made with numpy from a seed and handed to both packages; the
port runs on the CPU, where every kernel wrapper takes its plain version.
"""

import numpy as np
import torch

CPU = torch.device("cpu")


def t(x, dtype=None):
    """numpy (or jax) array -> CPU tensor."""
    a = np.asarray(x)
    out = torch.as_tensor(a.copy())
    return out if dtype is None else out.to(dtype)


def reference_arrays(idx) -> dict:
    """The state of a vector_indexer_tpu IvfIndex as numpy arrays, in the
    form vector_indexer_tpu_torch.convert takes."""
    lay = idx.layout
    return dict(
        centroids=np.asarray(idx.centroids),
        centroids_to_shard=np.asarray(idx.centroids_to_shard),
        num_shards=idx.num_shards,
        metric=idx.metric,
        external_ids=np.asarray(idx.external_ids),
        timestamps=np.asarray(idx.timestamps),
        vectors=np.asarray(lay.vectors),
        row_norms=np.asarray(lay.row_norms),
        offsets=np.asarray(lay.offsets),
        lengths=np.asarray(lay.lengths),
        perm=np.asarray(lay.perm),
        n=lay.n,
        max_list_len=lay.max_list_len,
    )


def stream_table_arrays(st) -> dict:
    """A vector_indexer_tpu StreamTable as numpy arrays, in the form
    vector_indexer_tpu_torch.convert.stream_table_from_reference_arrays
    takes."""
    names = ("vecs", "norms", "to_main", "sblk0", "lengths", "cent", "blk_cid", "scales")
    return dict({n: np.asarray(getattr(st, n)) for n in names}, m_pad=st.m_pad, chunk=st.chunk)


def correction_table_arrays(ct) -> dict:
    """A vector_indexer_tpu CorrectionTable as numpy arrays."""
    names = ("q2", "scales2", "norms_abs", "inv")
    return dict({n: np.asarray(getattr(ct, n)) for n in names}, m_pad=ct.m_pad)


def set_overlap(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Per-row |A & B| / |A| over the non-negative ids of two (nq, k) sets."""
    out = []
    for ra, rb in zip(a, b):
        sa = set(int(x) for x in ra if x >= 0)
        sb = set(int(x) for x in rb if x >= 0)
        out.append(len(sa & sb) / max(len(sa), 1) if sa or sb else 1.0)
    return np.asarray(out)


def near_tie_ok(lab_a, lab_b, score_fn, rel=1e-5):
    """Labels agree except where the two picks' scores are within
    rel * |score| of each other (f32 summation order decides those)."""
    diff = np.flatnonzero(lab_a != lab_b)
    for i in diff:
        sa, sb = score_fn(i, lab_a[i]), score_fn(i, lab_b[i])
        assert abs(sa - sb) <= rel * max(abs(sa), abs(sb), 1.0), (i, sa, sb)
    return len(diff)
