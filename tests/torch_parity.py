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


def reference_search(ref, program: str, xq, k: int, n_probe: int, precision: str = "highest"):
    """The reference's counterpart of the port's ``program`` (a dispatch
    ``Decision.program``, with its ``precision``), called directly on a
    vector_indexer_tpu IvfIndex with its Pallas kernels in interpret mode:
    (D, layout rows) numpy. The reference's own dispatch gates its fused
    and int8 programs on a TPU backend, so on the CPU it would run others."""
    import jax.numpy as jnp

    from vector_indexer_tpu.index import ivf
    from vector_indexer_tpu.ops.pallas.flat_sweep import plan_fused, quantize_table_int8

    lay = ref.layout
    q = jnp.asarray(xq)
    nq, d = xq.shape
    n_pad = lay.vectors.shape[0]
    metric = ref.metric if ref.metric != "cosine" else "ip"
    tables = (lay.vectors, lay.row_norms, None, None)
    if precision != "highest":
        x8, r8, sx = quantize_table_int8(lay.vectors)
        tables = (x8, lay.row_norms, r8 if precision == "int8" else None, sx)
    if program == "flat_torch":  # the reference's flat_xla, exact selection
        out = ivf._flat_search_program(q, lay.vectors, lay.row_norms, k=k, q_tile=nq,
                                       approx=False, metric=metric)
    elif program == "flat_fused":
        w, q_tile, c = plan_fused(n_pad, d, nq, k, precision=precision)
        out = ivf._flat_search_fused_program(q, *tables, k=k, q_tile=q_tile, w=w, c_groups=c,
                                             metric=metric, precision=precision, interpret=True)
    elif program == "dense_fused":
        w, q_tile, c = plan_fused(n_pad, d, nq, k, precision=precision)
        run_starts_b, c_ord, c_sq = ref._run_tables()
        x, norms, resid, scales = tables
        out = ivf._ivf_search_dense_fused_program(
            q, c_ord, c_sq, x, norms, run_starts_b, jnp.int32(n_probe), resid, scales, k=k,
            q_tile=q_tile, w=w, c_groups=c, metric=metric, precision=precision, interpret=True)
    elif program == "gather":
        centroids, c_sq = ref._device_tables()
        out = ivf._ivf_search_program(q, centroids, c_sq, lay.vectors, lay.row_norms,
                                      lay.offsets[:-1], lay.lengths, k=k, n_probe=n_probe,
                                      budget=ref._budget_for(n_probe), q_tile=nq, metric=metric)
    elif program == "gather_dma":  # inline in search_batch_device; interpret on the CPU
        out = ref.search_batch_device(xq, k, n_probe, method="gather_dma")
    elif program == "stream":  # its dispatch runs the stream kernels in interpret mode
        out = ref.search_batch_device(xq, k, n_probe, method="stream")
    else:
        raise ValueError(program)
    return tuple(np.asarray(a)[:nq] for a in out)


def split_bounds(n_steps: int, split: int, splits: int):
    """[m0, m1) of a group's ``n_steps`` steps that block ``split`` of the
    fused sweep kernel (csrc/flat_sweep.cu) handles."""
    return n_steps * split // splits, n_steps * (split + 1) // splits


def split_planes_reference(queries, vectors, row_norms, mask_b=None, vec_resid=None,
                           scale_row=None, *, metric: str = "l2", w: int = 8, c_groups: int = 8,
                           precision: str = "highest", splits: int = 1):
    """Plain model of the fused sweep kernel's split sweep: each group's
    steps are cut into ``splits`` contiguous ranges (``split_bounds``, as
    the kernel cuts them) and each range is folded on its own. -> [(vals,
    rows)] per split, in split order; ``flat_sweep.merge_top2_planes`` of
    them is the sweep's planes."""
    from vector_indexer_tpu_torch.ops import flat_sweep as fs

    fs._check(queries, vectors, row_norms, mask_b, vec_resid, scale_row, w, precision)
    nj = -(-vectors.shape[0] // (fs.S * w))
    parts = [fs._empty_planes(queries.shape[0], c_groups, queries.device) for _ in range(splits)]
    for j0, wv, wrow in fs._window_minima(queries, vectors, row_norms, mask_b, vec_resid,
                                          scale_row, metric=metric, w=w, precision=precision):
        for jl in range(wv.shape[1]):
            j = j0 + jl
            g, m = j % c_groups, j // c_groups
            n_steps = -(-(nj - g) // c_groups)
            split = next(s for s in range(splits)
                         if split_bounds(n_steps, s, splits)[0] <= m
                         < split_bounds(n_steps, s, splits)[1])
            fs._fold_minima(*parts[split], j, wv[:, jl], wrow[:, jl])
    return [fs._planes_out(*p) for p in parts]


def tf32_rna(a):
    """cvt.rna.tf32.f32 on the f32 bits: keep 10 mantissa bits, rounding
    the 13 dropped bits to nearest, ties away from zero."""
    b = np.asarray(a, np.float32).view(np.uint32).astype(np.uint64)
    return ((b + 0x1000) & 0xFFFFE000).astype(np.uint32).view(np.float32)


def round_toward_zero(x):
    """float64 -> float32 rounded toward zero (the tensor cores' f32
    accumulation, as modelled here)."""
    r = x.astype(np.float32)
    away = np.abs(r.astype(np.float64)) > np.abs(x)
    r[away] = np.nextafter(r[away], np.float32(0))
    return r


def tensor_core_cross(qb, qs, xb, xs, promote_dims):
    """The 3xTF32 kernels' f32 cross term (K3's f32 mode and K1): per k8
    step the products qb.xs, qs.xb, qb.xb (in that order, each an exact sum
    of 8 products; K1 passes the points as q and the centroids as x) enter an f32
    accumulator that rounds toward zero; every ``promote_dims`` dims the
    partial sum is added to the tile's sum in round-to-nearest f32, and the
    last partial sum takes that sum at the end."""
    f64 = np.float64
    partials = []
    for p0 in range(0, qb.shape[1], promote_dims):
        acc = np.zeros((qb.shape[0], xb.shape[0]), np.float32)
        for k0 in range(p0, min(p0 + promote_dims, qb.shape[1]), 8):
            for a, b in ((qb, xs), (qs, xb), (qb, xb)):
                acc = round_toward_zero(acc.astype(f64)
                                         + a[:, k0:k0 + 8].astype(f64) @ b[:, k0:k0 + 8].astype(f64).T)
        partials.append(acc)
    total = np.zeros_like(partials[0])
    for part in partials[:-1]:
        total = total + part
    return partials[-1] + total if len(partials) > 1 else partials[-1]
