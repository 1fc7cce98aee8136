"""Build, load and count the port's CUDA kernels.

All kernel sources live in ``vector_indexer_tpu_torch/csrc``. At first use
each source is compiled by its own ``nvcc`` for Hopper (``sm_90a``), all of
them at once, and the objects are linked into ONE shared library with a
plain C interface, which is loaded with ``ctypes``. No PyTorch header is
compiled, so the build takes seconds. The library's file
name carries a hash of the sources and flags, so an edited source is never
served by a stale build. The build directory is ``build/torch_kernels`` at
the root of the checkout (listed in ``.gitignore``).

Every C entry point takes its pointers and the CUDA stream as ``void*``,
launches on that stream, and returns ``cudaGetLastError()``; ``launch``
raises when that is not 0. There is no fallback: a failed build, a missing
library or a refused launch raises.

Launch counters: each kernel wrapper calls ``launch`` exactly where it
launches its kernel, which adds one to that kernel's count. The stream
kernels count per table type, as ``name[bf16]``, ``name[int8]`` or
``name[f32]``, and the fused sweep per int8 precision
(``flat_sweep_topk_plane[int8]``, ``[int8x1]``; the f32 sweep keeps the
plain name). A caller resets the counts before a run and reads them after
it to prove which kernels (and modes) the run went through.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, Optional

import torch

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int

# C entry point -> argument types (pointers and the stream as void*).
_SIGNATURES = {
    # x, c, c_sq, n, k, d, csplit, best_score, best_idx, stream
    "vitorch_assign_argmin": (_P, _P, _P, _I, _I, _I, _P, _P, _P, _P),
    # queries, cent, cid2d, blk2d, nval2d (or null), bias2d, vecs, norms,
    # scales, nq, t_fixed, chunk, d, is_l2, row_type, nch, lpr, spb, panel,
    # out, stream
    "vitorch_stream_distances": (
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P,
    ),
    # queries, cent, cid2d, blk2d, nval2d, bias2d, vecs, norms, scales, nq,
    # t_fixed, t_sub, chunk, groups, d, is_l2, row_type, nch, lpr, sub_rows,
    # row_align, panel, stage_bytes, dist_plane, slot_plane, stream
    "vitorch_stream_fused_plane": (
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
        _I, _I, _I, _I, _I, _I, _P, _P, _P,
    ),
    # queries, cent, cid2d, blk2d, nval2d, bias2d, vecs, norms, scales, nq,
    # t_fixed, t_sub, chunk, groups, d, is_l2, row_type, slice, parts,
    # sub_rows, stage_bytes, part_dots, dist_plane, slot_plane, stream
    "vitorch_stream_fused_split": (
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
        _I, _I, _I, _I, _P, _P, _P, _P,
    ),
    # qc, blk_t, scl_t, vecs, norms, t_cap, q_share, chunk, d, is_l2,
    # row_type, panel_rows, stages, kpanel, plane, stream
    "vitorch_stream_shared_plane": (
        _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P,
    ),
    # q (or q8), qr8, sq, x (or x8), r8, scales, norms, mask, tile_any, nq,
    # n_rows, d, w, c_groups, splits, mcols, tcols, is_l2, precision, qsplit,
    # part, vals, rows, stream
    "vitorch_flat_sweep_topk_plane": (
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
        _P, _P, _P, _P, _P,
    ),
    # q, x, norms, mask, tile_any, nq, n_rows, d, w, mcols, tcols, is_l2,
    # qsplit, vals, rows, stream
    "vitorch_flat_sweep_minreduce": (
        _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P,
    ),
    # q, vectors, starts, lengths, offs, nq, p, d, qres, max_len_pad,
    # width, is_l2, dist, rows, stream
    "vitorch_ivf_gather_distances": (
        _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P,
    ),
    # q, vectors, starts, lengths, offs, nq, p, d, item_rows, items, panel,
    # max_len_pad, width, is_l2, dist, rows, stream
    "vitorch_ivf_gather_items": (
        _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P,
    ),
}

# Stream-table element type -> (row_type code of the C entry points, label).
ROW_TYPES = {
    torch.bfloat16: (0, "bf16"),
    torch.int8: (1, "int8"),
    torch.float32: (2, "f32"),
}

# Kernel name (as reported; the stream kernels per table type) -> launches
# since the last reset.
_LAUNCHES: Dict[str, int] = {
    "assign_argmin": 0,
    "stream_distances[bf16]": 0,
    "stream_distances[int8]": 0,
    "stream_distances[f32]": 0,
    "stream_fused_plane[bf16]": 0,
    "stream_fused_plane[int8]": 0,
    "flat_sweep_topk_plane": 0,
    "stream_shared_plane[bf16]": 0,
    "stream_shared_plane[int8]": 0,
    "stream_shared_plane[f32]": 0,
    "flat_sweep_topk_plane[int8]": 0,
    "flat_sweep_topk_plane[int8x1]": 0,
    "flat_sweep_minreduce": 0,
    "ivf_gather_distances": 0,
}

_LIB: Optional[ctypes.CDLL] = None
_BUILD_INFO: dict = {}


def reset_launch_counts() -> None:
    for name in _LAUNCHES:
        _LAUNCHES[name] = 0


def launch_counts() -> Dict[str, int]:
    return dict(_LAUNCHES)


def sources() -> list:
    return sorted(CSRC_DIR.glob("*.cu"))


def _nvcc() -> str:
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    cands.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in cands:
        if c.is_file():
            return str(c)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME): the port's CUDA kernels are "
            "built from vector_indexer_tpu_torch/csrc at first use"
        )
    return found


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC_DIR.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _run_all(cmds) -> str:
    """Run the commands at once; raise naming the first that failed.
    Returns their joined output."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for c, p, o in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}):\n{' '.join(c)}\n{o}")
    return "\n".join(outs)


def build_library() -> Path:
    """Compile csrc/*.cu into the hashed shared library (no-op when it is
    already built): one nvcc per source, all started together, then one
    link. Records the wall seconds and nvcc's report (registers, shared
    memory, spills from ``-Xptxas -v``) in ``build_info()``."""
    out = BUILD_DIR / f"libvitorch_kernels_{_digest()}.so"
    if out.is_file():
        _BUILD_INFO.setdefault("path", str(out))
        _BUILD_INFO.setdefault("seconds", 0.0)
        _BUILD_INFO.setdefault("log", "")
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=out.parent) as tmpdir:
        objs = [str(Path(tmpdir) / f"{src.stem}.o") for src in sources()]
        log = _run_all([[nvcc, *NVCC_FLAGS, "-I", str(CSRC_DIR), "-c", str(src), "-o", obj]
                        for src, obj in zip(sources(), objs)])
        tmp = str(Path(tmpdir) / out.name)
        log += _run_all([[nvcc, "-shared", "-o", tmp, *objs]])
        os.replace(tmp, out)  # atomic: a concurrent build sees all or none
    _BUILD_INFO.update(path=str(out), seconds=time.perf_counter() - t0, log=log.strip())
    return out


def build_info() -> dict:
    return dict(_BUILD_INFO)


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build_library()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        lib.vitorch_error_string.argtypes = [ctypes.c_int]
        lib.vitorch_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of a CUDA device (an input of the launch
    plans that spread a few queries over the whole card)."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def launch(kernel: str, entry: str, *args) -> None:
    """Call C entry point ``entry`` (which launches kernel ``kernel``),
    raise on a non-zero cudaGetLastError(), and count the launch."""
    lib = library()
    rc = getattr(lib, entry)(*args)
    if rc != 0:
        msg = lib.vitorch_error_string(rc).decode()
        raise RuntimeError(f"{kernel}: CUDA launch failed ({rc}: {msg})")
    _LAUNCHES[kernel] += 1


def ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def require_cuda(name: str, *tensors: torch.Tensor) -> None:
    """Kernel wrappers' device check: every operand on one CUDA device and
    contiguous. Raises instead of moving anything."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"{name}: all operands must be on one CUDA device")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
